"""The port's copula, multivariate and marginal nodes and
``QuantileTransform``, on the CPU.

What the input fixes is held to the JAX package exactly: the calibration
and validation helpers (``theta_from_tau``, ``rho_from_tau``,
``corr_cholesky``, ``validate``, ``validate_elliptical``,
``empirical_pseudo_observations``), ``QuantileTransform`` through
``sample_from_quantiles`` down to q = 1e-30 on the wide families, scipy's
``rvs`` fallback (seeded by the column's first quantile) bitwise,
``from_reference`` carrying each node across, and ``cuda_exec.supports``
refusing each node type where ``pallas_exec.supports`` does.  The draws
come from generators keyed by the node's column (jax keys cannot be
reproduced), so the sampled copulas are held to their laws, as the JAX
package's ``tests/test_copulas.py`` holds its own (ported here without
its mesh and path-process cases, ROADMAP A12, A11).
"""

import numpy as np
import pytest
import torch
from scipy import stats
from scipy.integrate import quad

import probabilit_tpu as jax_pkg
from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.engine import pallas_exec
from probabilit_tpu.ops import copulas as jax_copulas
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec, streaming
from probabilit_tpu_torch.models.distributions import (
    CopulaDistribution,
    Distribution,
    EllipticalCopulaDistribution,
    MarginalDistribution,
    MultivariateDistribution,
    QuantileTransform,
)
from probabilit_tpu_torch.models.factories import (
    ClaytonCopula,
    EmpiricalCopula,
    FrankCopula,
    GaussianCopula,
    GumbelCopula,
    TCopula,
)
from probabilit_tpu_torch.models.graph import Constant
from probabilit_tpu_torch.ops import copulas, multivariate
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


def _draw(family, theta, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return copulas.sample(family, gen, shape, theta, torch.float32, torch.device("cpu")).numpy()


def _frank_tau(theta):
    t = abs(theta)
    d1 = quad(lambda x: x / np.expm1(x), 0, t)[0] / t
    return float(np.sign(theta) * (1 - 4 / t * (1 - d1)))


# --- Exact against the JAX package ---------------------------------------------------


@pytest.mark.parametrize(
    "family,tau", [("clayton", 0.5), ("clayton", 0.1), ("gumbel", 0.3), ("frank", 0.45663),
                   ("frank", -0.45663), ("frank", 0.95)])
def test_theta_from_tau_matches_jax(family, tau):
    assert copulas.theta_from_tau(family, tau) == jax_copulas.theta_from_tau(family, tau)


def test_calibration_and_validation_match_jax():
    for tau in (-0.9, -0.2, 0.0, 0.5, 0.99):
        assert copulas.rho_from_tau(tau) == jax_copulas.rho_from_tau(tau)
    corr = np.array([[1, 0.5, 0.2], [0.5, 1, 0.3], [0.2, 0.3, 1]])
    for ours, ref in zip(copulas.corr_cholesky(corr), jax_copulas.corr_cholesky(corr)):
        np.testing.assert_array_equal(ours, ref)
    for family, theta, d in (("clayton", 2, 3), ("gumbel", 1, 2), ("frank", -30, 2)):
        assert copulas.validate(family, theta, d) == jax_copulas.validate(family, theta, d)
    assert copulas.validate_elliptical("t", corr, 4)[1:] == jax_copulas.validate_elliptical(
        "t", corr, 4)[1:]
    bad = [
        (lambda m: m.validate("gaussian", 1.0, 2)), (lambda m: m.validate("clayton", 1.0, 1)),
        (lambda m: m.validate("clayton", 0.0, 2)), (lambda m: m.validate("gumbel", 0.5, 2)),
        (lambda m: m.validate("frank", -2.0, 3)), (lambda m: m.validate("frank", 0.0, 2)),
        (lambda m: m.validate("frank", -100.0, 2)), (lambda m: m.theta_from_tau("clayton", -0.5)),
        (lambda m: m.theta_from_tau("gauss", 0.5)), (lambda m: m.rho_from_tau(1.5)),
        (lambda m: m.theta_from_tau("frank", -0.9)), (lambda m: m.theta_from_tau("frank", -1.5)),
        (lambda m: m.corr_cholesky([[1, 0.5], [0.5, 2.0]])),
        (lambda m: m.corr_cholesky([[1, 1.5], [1.5, 1]])),
        (lambda m: m.corr_cholesky([[1, 0.5], [0.4, 1]])), (lambda m: m.corr_cholesky(np.eye(1))),
        (lambda m: m.validate_elliptical("t", np.eye(2), 0.0)),
        (lambda m: m.validate_elliptical("gaussian", np.eye(2), 4.0)),
        (lambda m: m.validate_elliptical("cauchy", np.eye(2), None)),
        (lambda m: m.empirical_pseudo_observations(np.ones((5,)))),
        (lambda m: m.empirical_pseudo_observations(np.array([[1.0, np.nan], [2.0, 3.0]]))),
        (lambda m: m.empirical_pseudo_observations(np.ones((1, 2)))),
    ]
    for case in bad:
        with pytest.raises(ValueError) as ours:
            case(copulas)
        with pytest.raises(ValueError) as ref:
            case(jax_copulas)
        assert str(ours.value) == str(ref.value)


def test_empirical_pseudo_observations_match_jax():
    data = np.random.default_rng(0).normal(size=(300, 3))
    data[5:9, 1] = 0.25  # ties share their midrank
    np.testing.assert_array_equal(
        copulas.empirical_pseudo_observations(data), jax_copulas.empirical_pseudo_observations(data))


@pytest.mark.parametrize("family,args", [("norm", (1.0, 2.0)), ("lognorm", (0.5,)),
                                         ("expon", ()), ("gamma", (2.0,))])
@pytest.mark.parametrize("scale", [1.0, 1e-12, 1e-23])
def test_quantile_transform_matches_jax_down_to_1e30(family, args, scale):
    """``QuantileTransform`` of a uniform of a small scale: derived
    quantiles down to ~6e-31, which the wide families (norm, lognorm)
    resolve as the JAX package does."""
    q = np.random.default_rng(1).uniform(size=(512, 1)).astype(np.float32)
    q[:8, 0] = [0.0, 2.0**-24, 1e-6, 0.5, 0.999, 1.0, 1e-3, 0.25]
    ref = jax_pkg.QuantileTransform(jax_pkg.Distribution("uniform", loc=0.0, scale=scale),
                                    family, *args)
    port = interop.from_reference(ref)[ref._id]
    expected = np.asarray(ref.sample_from_quantiles(q))
    got = port.sample_from_quantiles(q).numpy()
    assert np.isfinite(got).all()
    # The quantiles' standard scores agree to 1e-3 (ROADMAP's tail
    # tolerance); the values to 4 float32 ulps where that is looser.
    top = max(np.abs(expected).max(), 1.0)
    np.testing.assert_allclose(got, expected, rtol=4 * 2.0**-23, atol=2e-3 * top)
    if family in ("norm", "lognorm"):  # the wide ppfs, against scipy
        clamped = np.clip(q[:, 0], 2.0**-24, 1 - 2.0**-24).astype(np.float64)  # the matrix's clamp
        u = np.clip(clamped * scale, 1e-37, 1 - 2.0**-24)
        score = stats.norm.ppf(u)
        value = (got - args[0]) / args[1] if family == "norm" else np.log(got) / args[0]
        np.testing.assert_allclose(value, score, rtol=5e-4, atol=1e-3)


def test_scipy_rvs_fallback_is_bitwise_jax():
    """A multivariate family without a sampler of its own: scipy's rvs on
    the host, seeded with int(q[0] * 2^20), in both packages."""
    ref_mv = jax_pkg.Distribution("multivariate_t", [0.0, 1.0], [[1.0, 0.3], [0.3, 2.0]], 3)
    ref = jax_pkg.models.distributions.MarginalDistribution(ref_mv, d=1)
    sink = ref * 2.0
    port = interop.from_reference(sink)[sink._id]
    q = np.random.default_rng(3).uniform(size=(512, 1))
    np.testing.assert_array_equal(
        port.sample_from_quantiles(q).numpy(), np.asarray(sink.sample_from_quantiles(q)))


def _reference_graphs():
    corr = [[1.0, 0.5], [0.5, 1.0]]
    data = np.random.default_rng(0).normal(size=(50, 2))
    c = jax_pkg.ClaytonCopula(2.0, d=3)
    return {
        "copula": c[0] + c[2],
        "quantile": jax_pkg.QuantileTransform(jax_pkg.GumbelCopula(1.5)[1], "lognorm", 0.5),
        "frank": jax_pkg.FrankCopula(-5.0)[0] * 1.0,
        "gaussian": jax_pkg.GaussianCopula(corr)[1] + 1.0,
        "t": jax_pkg.QuantileTransform(jax_pkg.TCopula(corr, df=4)[0], "norm"),
        "empirical": jax_pkg.EmpiricalCopula(data)[0] + 0.0,
        "dirichlet": list(jax_pkg.MultivariateDistribution("dirichlet", alpha=[1, 2]))[0] + 1.0,
        "quantile_of_uniform": jax_pkg.QuantileTransform(jax_pkg.Distribution("uniform"), "norm"),
    }


@pytest.mark.parametrize("label", list(_reference_graphs()))
def test_supports_and_from_reference_agree_with_jax(label):
    ref = _reference_graphs()[label]
    mapping = interop.from_reference(ref)
    port = mapping[ref._id]
    plan, ref_plan = tcompile.get_plan(port), jax_compile.get_plan(ref)
    assert cuda_exec.supports(plan, {port._id}) is False
    assert pallas_exec.supports(ref_plan, frozenset({ref._id})) is False
    assert [type(n).__name__ for n in plan.topo] == [type(n).__name__ for n in ref_plan.topo]
    assert [n._static_signature() for n in plan.topo] == [n._static_signature() for n in ref_plan.topo]
    x = port.sample(2048, random_state=0)
    assert x.shape == (2048,) and torch.isfinite(x).all()
    with pytest.raises(ValueError, match="copula and QuantileTransform"):
        port.sample(64, random_state=0, gc_strategy=[], executor="cuda")


# --- The samplers' laws (ports of tests/test_copulas.py) ---------------------------------


@pytest.mark.parametrize(
    "family,theta,tau_true",
    [("clayton", 2.0, 0.5), ("clayton", 0.5, 0.2), ("clayton", 0.7, 0.7 / 2.7),
     ("gumbel", 2.0, 0.5), ("gumbel", 1.5, 1 - 1 / 1.5), ("gumbel", 1.0, 0.0),
     ("frank", 5.0, _frank_tau(5.0)), ("frank", 20.0, _frank_tau(20.0)),
     ("frank", -2.0, _frank_tau(-2.0)), ("frank", -20.0, _frank_tau(-20.0))],
)
def test_kendall_tau_and_uniform_marginals(family, theta, tau_true):
    U = _draw(family, theta, (15000, 2), 1)
    assert U.min() > 0.0 and U.max() < 1.0
    assert abs(stats.kendalltau(U[:, 0], U[:, 1]).statistic - tau_true) < 0.03
    for j in range(2):
        assert stats.kstest(U[:8000, j], "uniform").pvalue > 0.005, (family, j)


def test_tail_dependence():
    U = _draw("clayton", 2.0, (200000, 2), 2)
    lo = np.mean((U[:, 0] < 0.01) & (U[:, 1] < 0.01)) / 0.01
    hi = np.mean((U[:, 0] > 0.99) & (U[:, 1] > 0.99)) / 0.01
    assert lo > 3 * hi and abs(lo - 2 ** (-1 / 2.0)) < 0.15
    U = _draw("gumbel", 2.0, (200000, 2), 2)
    lo = np.mean((U[:, 0] < 0.01) & (U[:, 1] < 0.01)) / 0.01
    hi = np.mean((U[:, 0] > 0.99) & (U[:, 1] > 0.99)) / 0.01
    assert hi > 3 * lo and abs(hi - (2 - 2**0.5)) < 0.15


def test_log_series_pmf():
    p = 0.8
    v = copulas._log_series(torch.Generator().manual_seed(0), (100000,), float(np.log1p(-p)),
                            torch.float32, torch.device("cpu")).numpy()
    assert v.min() >= 1.0
    norm = -np.log1p(-p)
    for k in (1, 2, 3, 4):
        assert abs(np.mean(v == k) - p**k / (k * norm)) < 0.006, k


def test_theta_from_tau_round_trips():
    for fam, theta in [("clayton", 2.0), ("gumbel", 2.5), ("frank", 5.0)]:
        U = _draw(fam, theta, (20000, 2), 0)
        est = copulas.theta_from_tau(fam, stats.kendalltau(U[:, 0], U[:, 1]).statistic)
        assert abs(est - theta) / theta < 0.08, (fam, est)


def test_chi2_draws_and_t_cdf():
    gen = torch.Generator().manual_seed(4)
    for df in (1, 4, 7, 2.5):
        w = copulas._special.chi2_draws(gen, df, 20000, torch.float32, "cpu")
        assert w.min() > 0 and stats.kstest(w.numpy(), "chi2", args=(df,)).pvalue > 1e-3, df
    x = torch.linspace(-8, 8, 101)
    np.testing.assert_allclose(copulas._special.t_cdf(x, 4.0).numpy(), stats.t.cdf(x.numpy(), 4),
                               rtol=2e-5, atol=1e-7)
    x64 = x.double()
    np.testing.assert_allclose(copulas._special.t_cdf(x64, 3.5).numpy(), stats.t.cdf(x64.numpy(), 3.5),
                               rtol=1e-9)  # 100 continued-fraction pairs: 2.3e-10 measured


def test_factories_unpack_marginal_nodes():
    u1, u2, u3 = ClaytonCopula(theta=1.0, d=3)
    assert all(isinstance(u, MarginalDistribution) for u in (u1, u2, u3))
    assert isinstance(u1.distr, CopulaDistribution) and u1.distr is u2.distr
    assert repr(u1) == 'MarginalDistribution(CopulaDistribution("clayton", theta=1, d=3), d=0)'


def test_end_to_end_marginals_and_tau():
    u1, u2 = ClaytonCopula(theta=2.0)
    x1 = QuantileTransform(u1, "lognorm", s=0.5)
    x2 = QuantileTransform(u2, "expon", scale=2.0)
    (x1 + x2).sample(30000, random_state=0)
    s1, s2 = x1.samples_.numpy(), x2.samples_.numpy()
    assert stats.kstest(s1[:8000], "lognorm", args=(0.5,)).pvalue > 0.01
    assert stats.kstest(s2[:8000], "expon", args=(0, 2.0)).pvalue > 0.01
    assert abs(stats.kendalltau(s1[:15000], s2[:15000]).statistic - 0.5) < 0.03


def test_reproducible_and_copyable():
    for build in (lambda: GumbelCopula(theta=1.8), lambda: TCopula([[1, 0.6], [0.6, 1]], df=4),
                  lambda: EmpiricalCopula(np.random.default_rng(1).normal(size=(300, 2)))):
        a, b = build()
        m = QuantileTransform(a, "norm") + QuantileTransform(b, "norm")
        r1 = m.sample(1024, random_state=7).numpy()
        np.testing.assert_array_equal(m.sample(1024, random_state=7).numpy(), r1)
        np.testing.assert_array_equal(m.copy().sample(1024, random_state=7).numpy(), r1)
        assert not np.array_equal(m.sample(1024, random_state=8).numpy(), r1)


def test_dependence_moves_the_sum_variance():
    parts = [QuantileTransform(u, "norm") for u in GumbelCopula(theta=1.8, d=3)]
    assert (parts[0] + parts[1] + parts[2]).sample(30000, random_state=1).numpy().var() > 4.0
    u1, u2 = FrankCopula(theta=-5.0)
    s = (QuantileTransform(u1, "norm") + QuantileTransform(u2, "norm")).sample(20000, random_state=0)
    assert s.numpy().var() < 1.5


def test_streaming_estimate_of_a_copula_model():
    u1, u2 = FrankCopula(theta=5.0)
    model = QuantileTransform(u1, "norm") * QuantileTransform(u2, "norm")
    assert streaming.estimate(model, 65536, block_size=8192, random_state=1)["mean"] > 0.3


def test_streamed_blocks_never_collide():
    """The generator is keyed by two quantiles' bits: small streamed
    blocks draw distinct copulas."""
    u1, u2 = ClaytonCopula(theta=2.0)
    out = streaming.sample_streaming(u1 + u2, 65536, block_size=64, random_state=0)
    blocks = out.reshape(-1, 64)
    assert len(np.unique(blocks, axis=0)) == blocks.shape[0]


def test_elliptical_tau_and_tails():
    C = [[1, 0.5, 0.2], [0.5, 1, 0.3], [0.2, 0.3, 1]]
    g, t = GaussianCopula(C), TCopula(C, df=3)
    (g[0] + g[1] + g[2]).sample(8000, random_state=0)
    (t[0] + t[1] + t[2]).sample(8000, random_state=0)
    expect = 2 / np.pi * np.arcsin(0.5)
    for trio in (g, t):
        a, b = trio[0].samples_.numpy(), trio[1].samples_.numpy()
        assert abs(stats.kendalltau(a, b).statistic - expect) < 0.02
        assert stats.kstest(a[:8000], "uniform").pvalue > 0.005

    def jt(a, b, q=0.99):
        return np.mean((a > q) & (b > q)) / (1 - q)

    g1, g2 = GaussianCopula([[1, 0.5], [0.5, 1]])
    t1, t2 = TCopula([[1, 0.5], [0.5, 1]], df=3)
    (g1 + g2).sample(40000, random_state=1)
    (t1 + t2).sample(40000, random_state=1)
    assert jt(t1.samples_.numpy(), t2.samples_.numpy()) > 2 * jt(g1.samples_.numpy(),
                                                                 g2.samples_.numpy())
    with pytest.raises(ValueError, match="t copula only"):
        EllipticalCopulaDistribution("gaussian", np.eye(2), df=4.0)


def test_empirical_rank_dependence_reproduced():
    rng = np.random.default_rng(0)
    common = rng.exponential(size=2000)
    data = np.column_stack([common + rng.normal(size=2000) * 0.4,
                            common**1.5 + rng.normal(size=2000) * 0.4])
    u1, u2 = EmpiricalCopula(data)
    (QuantileTransform(u1, "lognorm", s=0.4) + QuantileTransform(u2, "expon")).sample(
        30000, random_state=1)
    tau = stats.kendalltau(u1.samples_.numpy()[:15000], u2.samples_.numpy()[:15000]).statistic
    assert abs(tau - stats.kendalltau(data[:, 0], data[:, 1]).statistic) < 0.03


def test_quantile_transform_nodes():
    with pytest.raises(TypeError, match="graph node"):
        QuantileTransform(0.5, "norm")
    u = Distribution("uniform")
    x = QuantileTransform(u, "gamma", 2.0, scale=3.0)
    x.sample(4096, random_state=5)
    ref = stats.gamma.ppf(u.samples_.numpy().astype(np.float64), 2.0, scale=3.0)
    np.testing.assert_allclose(x.samples_.numpy(), ref, rtol=5e-4, atol=5e-6)
    loc = Distribution("norm", loc=10.0, scale=0.001)
    s = QuantileTransform(Distribution("uniform"), "norm", loc=loc, scale=1.0).sample(
        8192, random_state=0)
    assert abs(s.numpy().mean() - 10.0) < 0.05
    s = QuantileTransform(Constant(1.0), "norm").sample(8, random_state=0).numpy()
    assert np.isfinite(s).all() and (s > 5).all()


def test_copulas_cannot_join_correlate():
    u1, _ = ClaytonCopula(theta=2.0)
    x = Distribution("norm")
    sink = u1 + x
    sink.correlate(u1.distr, x, corr_mat=np.array([[1.0, 0.5], [0.5, 1.0]]))
    with pytest.raises(ValueError, match="vector-valued"):
        tcompile.get_plan(sink)


# --- Multivariate distributions ---------------------------------------------------------


@pytest.mark.parametrize("name,kwargs,means", [
    ("dirichlet", {"alpha": [1.0, 2.0, 3.0]}, [1 / 6, 2 / 6, 3 / 6]),
    ("multinomial", {"n": 10, "p": [0.1, 0.2, 0.7]}, [1.0, 2.0, 7.0]),
    ("multivariate_normal", {"mean": [1.0, -2.0], "cov": [[1.0, 0.6], [0.6, 2.0]]}, [1.0, -2.0]),
])
def test_multivariate_marginals_have_their_laws(name, kwargs, means):
    parts = list(MultivariateDistribution(name, **kwargs))
    assert len(parts) == len(means) and parts[0].distr is parts[1].distr
    sink = parts[0]
    for p in parts[1:]:
        sink = sink + p
    sink.sample(40000, random_state=2)
    for part, mu in zip(parts, means):
        v = part.samples_.double().numpy()
        assert abs(v.mean() - mu) <= 5 * v.std() / np.sqrt(v.size), (name, mu)
    values = parts[0].distr.samples_
    if name == "multinomial":
        assert torch.equal(values.sum(1), torch.full((40000,), 10.0))
    if name == "dirichlet":
        np.testing.assert_allclose(values.sum(1).numpy(), 1.0, rtol=1e-5)
    if name == "multivariate_normal":
        c = np.cov(values.double().numpy().T)
        np.testing.assert_allclose(c, kwargs["cov"], atol=0.05)


def test_multivariate_generator_is_keyed_by_the_column():
    q = torch.tensor([0.25, 0.5, 0.75])
    a = torch.rand(4, generator=multivariate._key_from_q(q))
    assert torch.equal(a, torch.rand(4, generator=multivariate._key_from_q(q.clone())))
    b = torch.rand(4, generator=multivariate._key_from_q(torch.tensor([0.25, 0.5000001])))
    assert not torch.equal(a, b)
    single = torch.rand(4, generator=multivariate._key_from_q(torch.tensor([0.25])))
    assert single.shape == (4,)
