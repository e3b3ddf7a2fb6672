"""The port's factories and the correlated portfolio against the JAX package.

* ``Uniform``, ``Normal``, ``TruncatedNormal``, ``Lognormal`` (and
  ``from_log_params``), ``PERT``, ``_pert_to_beta`` and ``Triangular``
  (the percentile fit) give the JAX factories' parameters and reprs, and
  sampled through ``sample_from_quantiles`` on one quantile matrix agree
  per node within 1e-4 of its largest value (the beta of ``PERT`` is a
  Newton ppf: measured 1.1e-5);
* ``examples/03_portfolio_var.py``'s ``build_portfolio`` (a t(df = 4), a
  lognormal and a normal, correlated to an analyst's guess repaired by
  ``nearest_correlation_matrix``), built in both packages on the port's
  ``build_corrmat`` and ``ops/ncm``: the four-sort branch
  (``sample_from_quantiles``) and the sort-free branch (``build_body``
  with the engine's uniforms) compared as ``test_torch_correlation.py``
  compares ``mixed_correlated_50`` (the sort-free branch within 1e-4 of
  each node's largest value but on at most 1e-3 of the rows, and 1e-3
  there: a float32 ulp of the t driver's recoloured quantile in its upper
  tail), and ``sample(executor=None)`` reaching the repaired target in the
  drivers' normal scores within 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import scipy.stats
import torch

import probabilit_tpu_torch as pt
from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.models import factories as jax_factories
from probabilit_tpu.models.distributions import Distribution as JaxDistribution
from probabilit_tpu.ops import correlation as jax_correlation
from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.models import benchmarks, factories
from probabilit_tpu_torch.ops import ppf
from probabilit_tpu_torch.ops.ncm import nearest_correlation_matrix
from probabilit_tpu_torch.utils import build_corrmat
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

N = 65536
REL_TOL = 1e-4
NEAR_TIE_SHARE = 1e-3
CORR_TOL = 2e-3
T_TAIL_TOL = 1e-3


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


def _grid_quantiles(seed, shape):
    """Uniforms on the generators' 2^-23 grid."""
    return np.random.default_rng(seed).integers(1, 2**23, size=shape) / 2.0**23


@pytest.mark.parametrize(
    "args", [(0, 3 / 4, 1), (0, 6, 10), (-5.0, 1.0, 2.0, 2.5), (100, 150, 400, 6.0)]
)
def test_pert_to_beta_matches_jax(args):
    assert factories._pert_to_beta(*args) == jax_factories._pert_to_beta(*args)


@pytest.mark.parametrize(
    "build",
    [
        lambda f: f.PERT(0, 6, 10),
        lambda f: f.PERT(2, 3, 9, gamma=2.0),
        lambda f: f.TruncatedNormal(1.0, 2.0, 0.0, 5.0),
        lambda f: f.Triangular(3, 8, 10),
        lambda f: f.Triangular(1, 5, 9, low_perc=0, high_perc=1),
        lambda f: f.Triangular(0.5, 2.0, 7.5, low_perc=0.05, high_perc=0.8),
        lambda f: f.Uniform(2, 7),
        lambda f: f.Normal(3.0, 0.5),
        lambda f: f.Lognormal.from_log_params(0.5, 0.25),
    ],
    ids=["pert", "pert_gamma", "truncnorm", "triangular", "triangular_exact",
         "triangular_skewed", "uniform", "normal", "lognormal_log_params"],
)
def test_factory_parameters_and_repr_match_jax(build):
    got, ref = build(factories), build(jax_factories)
    assert got.distr == ref.distr
    assert set(got.kwargs) == set(ref.kwargs) and len(got.args) == len(ref.args)
    for k, v in ref.kwargs.items():
        if isinstance(v, (int, float)):
            assert got.kwargs[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
    if not list(got.get_parents()):
        assert repr(got) == repr(ref)


def test_factory_errors_match_jax():
    for bad in (lambda f: f.PERT(5, 3, 9), lambda f: f.PERT(0, 1, 2, gamma=0.0),
                lambda f: f.Triangular(3, 1, 10), lambda f: f.Triangular(1, 2, 3, 0.9, 0.1)):
        with pytest.raises(ValueError) as got:
            bad(factories)
        with pytest.raises(ValueError) as ref:
            bad(jax_factories)
        assert str(got.value) == str(ref.value)


def test_factories_are_exported():
    for name in factories.__all__:
        assert getattr(pt, name) is getattr(factories, name)


def _factory_graph(f):
    nodes = [
        f.PERT(0, 6, 10),
        f.TruncatedNormal(1.0, 2.0, 0.0, 5.0),
        f.Triangular(3, 8, 10),
        f.Lognormal(10.0, 2.0),
        f.Uniform(2, 7),
        f.Normal(3.0, 0.5),
    ]
    sink = nodes[0]
    for node in nodes[1:]:
        sink = sink + node
    return sink, nodes


def test_factory_samples_match_jax():
    jsink, jnodes = _factory_graph(jax_factories)
    sink, nodes = _factory_graph(factories)
    plan = tcompile.get_plan(sink)
    q = _grid_quantiles(7, (N, plan.d))
    jsink.sample_from_quantiles(q)
    sink.sample_from_quantiles(q)
    for jn, n in zip(jnodes + [jsink], nodes + [sink]):
        a = np.asarray(jn.samples_, np.float64)
        b = n.samples_.double().numpy()
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() <= REL_TOL * np.abs(a).max(), jn


def test_sampling_pert_truncnorm_and_t_through_the_plain_executor():
    x = pt.PERT(0, 6, 10) + pt.TruncatedNormal(1.0, 2.0, 0.0, 5.0) + pt.Distribution("t", df=4)
    s = x.sample(20000, random_state=0, executor=None)
    assert s.shape == (20000,) and torch.isfinite(s).all()
    # Means: PERT 5.6667, the truncated normal 2.2275 (scipy), t 0.
    expected = 0 + 6 * 4 / 6 + 10 / 6 + scipy.stats.truncnorm(-0.5, 2.0, loc=1, scale=2).mean()
    assert abs(s.double().mean().item() - expected) < 0.05


def _jax_portfolio(target):
    equities = JaxDistribution("lognorm", s=0.25, scale=1.0)
    bonds = JaxDistribution("norm", loc=1.02, scale=0.05)
    commodities = JaxDistribution("t", df=4, loc=1.0, scale=0.15)
    portfolio = 0.5 * equities + 0.3 * bonds + 0.2 * commodities
    portfolio.correlate(equities, bonds, commodities, corr_mat=target)
    return portfolio


def _portfolios():
    port, assets = benchmarks.portfolio_var()
    target = nearest_correlation_matrix(build_corrmat([
        ((0, 1), np.array([[1.0, 0.4], [0.4, 1.0]])),
        ((0, 2), np.array([[1.0, 0.6], [0.6, 1.0]])),
        ((1, 2), np.array([[1.0, -0.3], [-0.3, 1.0]])),
    ]))
    return _jax_portfolio(target), port


def test_portfolio_plans_match():
    jsink, sink = _portfolios()
    ref_plan, plan = jax_compile.Plan(jsink), tcompile.get_plan(sink)
    np.testing.assert_allclose(plan.corr_matrix, ref_plan.corr_matrix, rtol=0, atol=1e-12)
    assert [v.distr for v in plan.corr_vars] == [v.distr for v in ref_plan.corr_vars]
    assert plan.d == ref_plan.d == 3


def test_portfolio_four_sort_branch_matches_jax():
    jsink, sink = _portfolios()
    plan = tcompile.get_plan(sink)
    q = _grid_quantiles(14, (N, plan.d))
    jsink.sample_from_quantiles(q)
    sink.sample_from_quantiles(q)
    for ref_var, var in zip(jax_compile.Plan(jsink).corr_vars, plan.corr_vars):
        a = np.asarray(ref_var.samples_, np.float64)
        b = var.samples_
        own = ppf.call(var.distr, torch.from_numpy(q[:, plan.col_of[var._id]]).float(),
                       *var.args, **var.kwargs)
        assert torch.equal(torch.sort(b).values, torch.sort(own).values)
        b = b.double().numpy()
        tol = REL_TOL * np.abs(a).max()
        assert np.abs(np.sort(a) - np.sort(b)).max() <= tol
        assert np.mean(np.abs(a - b) > tol) <= NEAR_TIE_SHARE
    a, b = np.asarray(jsink.samples_), sink.samples_.numpy()
    assert np.mean(np.abs(a - b) > REL_TOL * np.abs(a).max()) <= NEAR_TIE_SHARE


def test_portfolio_sort_free_branch_matches_jax():
    jsink, sink = _portfolios()
    ref_plan, plan = jax_compile.Plan(jsink), tcompile.get_plan(sink)
    q = np.random.default_rng(13).random((N, plan.d)).astype(np.float32)
    q = np.clip(q, 2.0**-24, 1 - 2.0**-24)
    ref, _ = jax_compile.build_body(
        ref_plan, jax_correlation.ImanConover, [n._id for n in ref_plan.topo], generated_ok=True
    )(jnp.asarray(q), gen_key=jax.random.PRNGKey(0))
    got = tcompile.build_body(plan, [n._id for n in plan.topo], generated=True)(torch.from_numpy(q))
    for ref_node, node in zip(ref_plan.topo, plan.topo):
        a = np.asarray(ref[ref_node._id], np.float64)
        b = got[node._id].double().numpy()
        err, scale = np.abs(a - b), max(np.abs(a).max(), 1e-30)
        # The t driver's quantile is clamp(ndtr(y)): one float32 ulp of it
        # in the upper tail (6e-8 of a 5e-5 tail) moves t(4) by a quarter
        # of that relative (measured 1.6e-4 of max |t| on one row of 65,536).
        assert err.max() <= T_TAIL_TOL * scale, ref_node
        assert np.mean(err > REL_TOL * scale) <= NEAR_TIE_SHARE, ref_node


def test_portfolio_plain_sample_reaches_the_target():
    _, sink = _portfolios()
    plan = tcompile.get_plan(sink)
    n = 200_000
    sink.sample(n, random_state=0, gc_strategy=plan.corr_vars, executor=None)
    X = torch.stack([v.samples_ for v in plan.corr_vars]).double().numpy()
    scores = np.stack([
        scipy.special.ndtri(getattr(scipy.stats, v.distr)(*v.args, **v.kwargs).cdf(x))
        for v, x in zip(plan.corr_vars, X)
    ])
    np.testing.assert_allclose(np.corrcoef(scores), plan.corr_matrix, atol=CORR_TOL)
