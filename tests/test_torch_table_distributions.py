"""The table nodes (Empirical, Cumulative, Discrete) against the JAX package.

Each node is built in the JAX package, carried over with
``interop.from_reference``, and sampled by both from one seeded quantile
matrix (``sample_from_quantiles``).  Tolerances:

* Discrete (numeric and string), Empirical by an exact ``method=``: equal,
  with the same dtype (int32 for integer values, as ``jnp.take`` gives);
* linear Empirical and Cumulative: equal, float32.  The port follows
  ``jnp.interp`` as XLA compiles it on the CPU (the grid's division by a
  constant is a multiply by the rounded reciprocal, and the multiply-add
  is fused: computed in float64 and rounded once), measured bitwise on
  every case here; the tests allow one float32 ulp for that double
  rounding;
* the correlated recolour branch on one quantile matrix: 1e-4 of each
  node's largest value, as ``test_torch_correlation.py`` holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.models import factories as jax_factories
from probabilit_tpu.models.distributions import CumulativeDistribution as JaxCumulative
from probabilit_tpu.models.distributions import DiscreteDistribution as JaxDiscrete
from probabilit_tpu.models.distributions import Distribution as JaxDistribution
from probabilit_tpu.models.distributions import EmpiricalDistribution as JaxEmpirical
from probabilit_tpu.ops import correlation as jax_correlation
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.models.distributions import (
    CumulativeDistribution,
    DiscreteDistribution,
    Distribution,
    EmpiricalDistribution,
)
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


REL_TOL = 1e-4
N = 1 << 16


def _quantiles(seed, d=1, n=N):
    """Uniforms on the generators' 2^-24 grid."""
    return np.random.default_rng(seed).integers(1, 2**24, size=(n, d)) / 2.0**24


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max()


_RNG = np.random.default_rng(20)
NODES = {
    "empirical_lognormal_512": lambda: JaxEmpirical(_RNG.lognormal(3.0, 1.0, 512)),
    "empirical_normal_50": lambda: JaxEmpirical(_RNG.normal(size=50)),
    "empirical_one_point": lambda: JaxEmpirical([4.5]),
    "empirical_ints": lambda: JaxEmpirical(_RNG.integers(0, 100, 40)),
    "empirical_closest_observation": lambda: JaxEmpirical(
        _RNG.integers(0, 100, 40), method="closest_observation"),
    "empirical_midpoint": lambda: JaxEmpirical(_RNG.integers(0, 100, 40), method="midpoint"),
    "empirical_weibull": lambda: JaxEmpirical(_RNG.normal(size=30), method="weibull"),
    "cumulative_elicited": lambda: JaxCumulative([0, 0.1, 0.5, 0.9, 1], [10, 15, 20, 25, 40]),
    "cumulative_crossing_zero": lambda: JaxCumulative([0, 0.3, 1], [-5.0, 0.0, 5.0]),
    "discrete_ints": lambda: JaxDiscrete(_RNG.integers(-5, 9, 12), _RNG.dirichlet(np.ones(12))),
    "discrete_floats_512": lambda: JaxDiscrete(np.arange(512.0), _RNG.dirichlet(np.ones(512))),
    "discrete_uniform": lambda: JaxDiscrete([1.5, 2.5, 7.0]),
    "discrete_strings": lambda: JaxDiscrete(["a", "b", "c"], [0.25, 0.5, 0.25]),
    "discrete_bools": lambda: JaxDiscrete([True, False], [0.3, 0.7]),
}
INTERP = ("empirical_lognormal_512", "empirical_normal_50", "empirical_one_point",
          "empirical_ints", "cumulative_elicited", "cumulative_crossing_zero")


@pytest.mark.parametrize("name", list(NODES))
def test_node_matches_jax(name):
    ref = NODES[name]()
    port = interop.from_reference(ref)[ref._id]
    assert type(port).__name__ == type(ref).__name__
    q = _quantiles(list(NODES).index(name))
    a = np.asarray(ref.sample_from_quantiles(q))
    b = port.sample_from_quantiles(q)
    b = b.numpy() if isinstance(b, torch.Tensor) else b
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if name in INTERP:
        assert _ulps(a, b) <= 1
    else:
        np.testing.assert_array_equal(a, b)


def test_integer_discrete_is_int32_on_the_plain_path():
    node = DiscreteDistribution([1, 2, 3], [0.25, 0.5, 0.25])
    assert node.sample(100, random_state=0).dtype == torch.int32
    config.set_dtype(torch.float64)
    try:
        assert node.sample(100, random_state=0).dtype == torch.int64
    finally:
        config.set_dtype(torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_boundary_equal_quantiles(dtype):
    # Cumulative boundaries 0.25 and 0.75 are quantiles of the 2^-24 grid:
    # side "right" gives the next value at the boundary itself.
    node = DiscreteDistribution([1, 2, 3], [0.25, 0.5, 0.25])
    q = np.array([[2.0**-24], [0.25 - 2.0**-24], [0.25], [0.75 - 2.0**-24], [0.75], [1 - 2.0**-24]])
    config.set_dtype(getattr(torch, dtype))
    try:
        got = node.sample_from_quantiles(q)
    finally:
        config.set_dtype(torch.float32)
    np.testing.assert_array_equal(got.numpy(), [1, 1, 2, 2, 3, 3])
    ref = JaxDiscrete([1, 2, 3], [0.25, 0.5, 0.25]).sample_from_quantiles(q)
    np.testing.assert_array_equal(np.asarray(ref), [1, 1, 2, 2, 3, 3])


def test_cumulative_validation_errors():
    with pytest.raises(ValueError, match="quantiles must form a strictly increasing"):
        CumulativeDistribution([0, 0.5, 0.5, 1], [1, 2, 3, 4])
    with pytest.raises(ValueError, match="cumulatives must form a strictly increasing"):
        CumulativeDistribution([0, 0.5, 1], [1, 1, 3])
    with pytest.raises(ValueError, match="Lowest quantile level must be 0"):
        CumulativeDistribution([0.1, 0.5, 1], [1, 2, 3])
    with pytest.raises(ValueError, match="Lowest quantile level must be 0"):
        JaxCumulative([0.1, 0.5, 1], [1, 2, 3])


def test_discrete_validation_errors():
    with pytest.raises(ValueError, match="Length mismatch"):
        DiscreteDistribution([1, 2], [1.0])
    with pytest.raises(ValueError, match="Probabilities must sum to 1"):
        DiscreteDistribution([1, 2], [0.5, 0.6])
    with pytest.raises(ValueError, match="Probabilities are not non-negative"):
        DiscreteDistribution([1, 2, 3], [1.2, -0.4, 0.2])
    with pytest.raises(ValueError, match="Probabilities must sum to 1"):
        JaxDiscrete([1, 2], [0.5, 0.6])


def test_signatures_follow_the_data():
    a = EmpiricalDistribution([1.0, 2.0, 3.0])
    assert a._static_signature() == EmpiricalDistribution([1.0, 2.0, 3.0])._static_signature()
    assert a._static_signature() != EmpiricalDistribution([1.0, 2.0, 4.0])._static_signature()
    long = [str(i) for i in range(2000)]
    assert DiscreteDistribution(long)._static_signature() != DiscreteDistribution(
        long[:-1] + ["x"])._static_signature()
    assert Distribution("poisson", mu=3)._static_signature() == (
        JaxDistribution("poisson", mu=3)._static_signature())


def test_string_discrete_through_sample_and_sample_streaming():
    values = np.array(["low", "mid", "high"])
    node = DiscreteDistribution(values, [0.2, 0.5, 0.3])
    x = node.sample(30000, random_state=1)
    assert isinstance(x, np.ndarray) and x.dtype == values.dtype
    assert set(np.unique(x)) == set(values)
    y = node.sample_streaming(30000, block_size=1 << 13, random_state=1)
    assert isinstance(y, np.ndarray) and y.dtype == values.dtype
    for v, p in zip(values, [0.2, 0.5, 0.3]):
        assert abs(np.mean(x == v) - p) < 0.015 and abs(np.mean(y == v) - p) < 0.015


def test_estimate_refuses_a_string_sink():
    node = DiscreteDistribution(["a", "b"])
    with pytest.raises(ValueError, match="numeric sink"):
        node.estimate(1000, block_size=256, random_state=0)
    # A numeric Discrete streams as its values.
    st = DiscreteDistribution([1, 2, 3], [0.25, 0.5, 0.25]).estimate(
        1 << 16, block_size=1 << 14, random_state=0)
    assert abs(st["mean"] - 2.0) < 5 * st["sem"]


def test_plan_collects_finalizers():
    strings = DiscreteDistribution(["a", "b"])
    numbers = DiscreteDistribution([1.0, 2.0])
    plan = tcompile.get_plan(numbers + EmpiricalDistribution([1.0, 2.0]))
    assert plan.finalizers == {}
    plan = tcompile.get_plan(strings)
    assert list(plan.finalizers) == [strings._id]
    np.testing.assert_array_equal(plan.finalizers[strings._id](torch.tensor([1, 0])), ["b", "a"])


def test_table_drivers_are_generatable():
    assert all(tcompile._generatable(n) for n in (
        EmpiricalDistribution([1.0, 2.0]), CumulativeDistribution([0, 1], [0, 1]),
        DiscreteDistribution([1, 2]), Distribution("poisson", mu=3), Distribution("skewnorm", 3),
    ))
    assert not tcompile._generatable(DiscreteDistribution(["a", "b"]))
    assert not tcompile._generatable(Distribution("multivariate_normal", mean=[0, 0]))
    assert not tcompile._generatable(Distribution("no_such_family"))


def test_multivariate_node_names_a8():
    # Ported since: the multivariate node samples (n, d) from a generator
    # keyed by its column, its marginals are slices, and it is no table
    # (the kernels refuse it).
    from probabilit_tpu_torch.engine import cuda_exec
    from probabilit_tpu_torch.models.distributions import MultivariateDistribution

    a, b = MultivariateDistribution("multivariate_normal", mean=[0, 0], cov=[[1, 0.8], [0.8, 1]])
    sink = a + b + 1.0
    x = sink.sample(20000, random_state=0).numpy()
    assert x.shape == (20000,) and abs(x.mean() - 1.0) < 0.05 and abs(x.var() - 3.6) < 0.15
    assert not cuda_exec._table_node_ok(a.distr)
    assert not cuda_exec.supports(tcompile.get_plan(sink), {sink._id})


def _jax_table_risk_correlated(seed=2027):
    """``benchmarks.table_risk_correlated`` built with the JAX package's nodes,
    in the same order."""
    rng = np.random.default_rng(seed)
    price = JaxDistribution("norm", loc=100.0, scale=15.0)
    unit_cost = JaxEmpirical(rng.lognormal(mean=4.0, sigma=0.3, size=512))
    lead_time = JaxCumulative([0.0, 0.1, 0.5, 0.9, 1.0], [10.0, 15.0, 20.0, 25.0, 40.0])
    orders = JaxDistribution("poisson", mu=400)
    margin = orders * (price - unit_cost) - lead_time * 50.0
    margin.correlate(price, unit_cost, lead_time, orders, corr_mat=_TARGET)
    return margin


_TARGET = np.array([
    [1.0, 0.5, -0.3, 0.6],
    [0.5, 1.0, 0.2, 0.4],
    [-0.3, 0.2, 1.0, -0.2],
    [0.6, 0.4, -0.2, 1.0],
])


def test_correlated_table_graph_matches_jax_generated_branch():
    jax_sink = _jax_table_risk_correlated()
    mapping = interop.from_reference(jax_sink)
    sink = mapping[jax_sink._id]
    ref_plan = jax_compile.Plan(jax_sink)
    plan = tcompile.get_plan(sink)
    assert [mapping[v._id] for v in ref_plan.corr_vars] == plan.corr_vars
    np.testing.assert_allclose(plan.corr_matrix, ref_plan.corr_matrix, rtol=0, atol=1e-12)
    q = _quantiles(21, plan.d, 1 << 14).astype(np.float32)
    ref_keep = [node._id for node in ref_plan.topo]
    ref, _ = jax_compile.build_body(
        ref_plan, jax_correlation.ImanConover, ref_keep, generated_ok=True
    )(jnp.asarray(q), gen_key=jax.random.PRNGKey(0))
    got = tcompile.build_body(plan, [n._id for n in plan.topo], generated=True)(torch.from_numpy(q))
    for ref_node in ref_plan.topo:
        a = np.asarray(ref[ref_node._id], np.float64)
        b = got[mapping[ref_node._id]._id].double().numpy()
        assert np.abs(a - b).max() <= REL_TOL * max(np.abs(a).max(), 1e-30), ref_node
    # The same graph through sample(): the sort-free branch.
    x = sink.sample(1 << 14, random_state=0)
    assert torch.isfinite(x).all()


def test_benchmark_graph_matches_its_jax_twin():
    jax_sink = _jax_table_risk_correlated()
    port = interop.from_reference(jax_sink)[jax_sink._id]
    sink, _ = benchmarks.table_risk_correlated()
    q = _quantiles(22, 4, 4096)
    a = port.sample_from_quantiles(q)
    b = sink.sample_from_quantiles(q)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lognormal_factory_through_from_reference():
    ref = jax_factories.Lognormal(mean=10.0, std=3.0) * 2.0
    mapping = interop.from_reference(ref)
    port = mapping[ref._id]
    lognorm = [n for n in mapping.values() if isinstance(n, Distribution)]
    assert len(lognorm) == 1 and lognorm[0].distr == "lognorm"
    q = _quantiles(23)
    a = np.asarray(ref.sample_from_quantiles(q), np.float64)
    b = port.sample_from_quantiles(q).double().numpy()
    assert np.abs(a - b).max() <= REL_TOL * np.abs(a).max()
    assert abs(b.mean() - 20.0) < 0.2
