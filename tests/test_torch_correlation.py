"""The port's correlated sampling path against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances, each with what was measured at writing:

* ``nearest_correlation_matrix``: 1e-12 (measured 0: the same numpy code);
* ``_recolor_scores(z)`` on one (K, n) float32 z: 1e-4 of max |y|
  (measured 2.0e-7);
* the plain twin's recolour transform ``(A, b)``, from the statistics
  kernel's sums, applied to z, against the JAX ``_recolor_scores(z)``:
  1e-4 of max |y| (measured 1.2e-7);
* the generated branch of ``build_body`` on ``mixed_correlated_50``,
  n = 65,536, one quantile matrix: 1e-4 of each node's max magnitude
  (measured 3.7e-6);
* the four-sort branch (``sample_from_quantiles``): each correlated
  column holds exactly the multiset of its own inverse CDF's values,
  sorted columns agree with the JAX package's within 1e-4 of max |x|, and
  rows differ (beyond that tolerance) only where near-tied correlated
  scores swap ranks: at most 1e-3 of the rows (measured 2.3e-4).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.engine import pallas_exec
from probabilit_tpu.models import benchmarks as jax_benchmarks
from probabilit_tpu.models import graph as jg
from probabilit_tpu.models.distributions import Distribution as JaxDistribution
from probabilit_tpu.ops import correlation as jax_correlation
from probabilit_tpu.ops import ncm as jax_ncm
from probabilit_tpu.ops import ppf as jax_ppf
from probabilit_tpu.ops import sort as jax_sort
from probabilit_tpu.ops import special as jax_special
from probabilit_tpu.utils import build_corrmat as jax_build_corrmat
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.ops import correlation, ncm, ppf, sort, special
from probabilit_tpu_torch.utils import build_corrmat
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
N = 65536
REL_TOL = 1e-4
NEAR_TIE_SHARE = 1e-3


@pytest.fixture(autouse=True)
def on_the_cpu():
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


def _pair(build):
    """(JAX sink, port sink, {JAX id: port node}) for one graph."""
    jax_sink = build()
    mapping = interop.from_reference(jax_sink)
    return jax_sink, mapping[jax_sink._id], mapping


def _grid_quantiles(seed, shape):
    """Uniforms on the generators' 2^-23 grid, where the tails' 1e-3
    tolerance on the standard score holds."""
    return np.random.default_rng(seed).integers(1, 2**23, size=shape) / 2.0**23


# --- Host-side pieces: NCM repair, build_corrmat ------------------------


def _targets():
    bad = np.array([[1, 0.9, -0.9], [0.9, 1, 0.9], [-0.9, 0.9, 1.0]])
    readme = np.array([[1, 0.9, 0], [0.9, 1, 0.8], [0, 0.8, 1.0]])
    ones = np.ones((3, 3))
    return {"bad": bad, "readme": readme, "ones": ones}


@pytest.mark.parametrize("name", list(_targets()))
@pytest.mark.parametrize("weighted", [False, True])
def test_ncm_matches_reference(name, weighted):
    G = _targets()[name]
    weights = np.random.default_rng(1).random(G.shape) + 0.5 if weighted else None
    if weights is not None:
        weights = (weights + weights.T) / 2
    got = ncm.nearest_correlation_matrix(G, weights=weights)
    ref = jax_ncm.nearest_correlation_matrix(G, weights=weights)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_plan_repairs_mixed_correlated_50_like_the_reference():
    jax_sink, sink, mapping = _pair(jax_benchmarks.mixed_correlated_50)
    ref_plan = jax_compile.Plan(jax_sink)
    plan = tcompile.get_plan(sink)
    np.testing.assert_allclose(plan.corr_matrix, ref_plan.corr_matrix, rtol=0, atol=1e-12)
    assert not np.allclose(plan.corr_matrix[0, :3], [1, 0.9, -0.9])  # repaired
    # interop carries the correlations: same variables, same order, same columns.
    assert [v._id for v in plan.corr_vars] == [mapping[v._id]._id for v in ref_plan.corr_vars]
    assert plan.col_of == {mapping[k]._id: c for k, c in ref_plan.col_of.items()}
    # The port's own builder gives the same graph.
    own = tcompile.get_plan(benchmarks.mixed_correlated_50())
    np.testing.assert_array_equal(own.corr_matrix, plan.corr_matrix)
    assert [own.col_of[v._id] for v in own.corr_vars] == [plan.col_of[v._id] for v in plan.corr_vars]
    assert len(own.topo) == len(plan.topo) == len(ref_plan.topo)


def test_build_corrmat_matches_reference():
    parts = [((0, 2), np.array([[1, 0.5], [0.5, 1]])), ((1, 3), np.array([[1, -0.2], [-0.2, 1]]))]
    np.testing.assert_array_equal(build_corrmat(parts), jax_build_corrmat(parts))


def test_plan_analysis_is_cached_and_validated():
    a, b, c = Distribution("norm"), Distribution("norm"), Distribution("uniform")
    sink = (a + b + c).correlate(a, b, corr_mat=np.array([[1.0, 0.4], [0.4, 1.0]]))
    plan = tcompile.get_plan(sink)
    key = build_corrmat([((0, 1), np.array([[1.0, 0.4], [0.4, 1.0]]))]).tobytes()
    assert key in tcompile._NCM_CACHE
    assert tcompile.get_plan(sink) is plan
    sink.correlate(b, c, corr_mat=np.eye(2))  # a mutation drops the cached plan
    assert tcompile.get_plan(sink) is not plan
    bad = a * 2
    with pytest.raises(ValueError, match="Cannot correlate variable"):
        tcompile.get_plan((bad + c).correlate(bad, c, corr_mat=np.eye(2)))
    twice = (a + b).correlate(a, b, corr_mat=np.eye(2)).correlate(b, a, corr_mat=np.eye(2))
    with pytest.raises(ValueError, match="more than once"):
        tcompile.get_plan(twice)
    with pytest.raises(ValueError, match="not an ancestor"):
        (a + b).correlate(a, c, corr_mat=np.eye(2))


# --- Special functions and score shortcuts -----------------------------


def test_ndtr_fast_matches_reference():
    x = np.linspace(-9, 9, 20001, dtype=np.float32)
    got = special.ndtr_fast(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_special.ndtr_fast(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=4e-7, atol=0)


def test_ndtri_fast_wide_matches_reference():
    q = np.concatenate([np.geomspace(1e-37, 0.5, 4000), 1 - np.geomspace(1e-7, 0.5, 2000)])
    q = q.astype(np.float32)
    got = special.ndtri_fast_wide(torch.from_numpy(q)).numpy()
    ref = np.asarray(jax_special.ndtri_fast_wide(jnp.asarray(q)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    exact = special.ndtri_fast_wide(torch.from_numpy(q.astype(np.float64)))
    np.testing.assert_allclose(exact.numpy(), scipy.special.ndtri(q.astype(np.float64)), rtol=1e-12)


@pytest.mark.parametrize("family,args", [("norm", (1.5, 2.0)), ("lognorm", (0.3, 1.0, 10.0))])
def test_score_call_matches_reference(family, args):
    y = np.random.default_rng(2).standard_normal(1000).astype(np.float32)
    got = ppf.score_call(family, torch.from_numpy(y), *args).numpy()
    ref = np.asarray(jax_ppf.score_call(family, jnp.asarray(y), *args))
    np.testing.assert_allclose(got, ref, rtol=2e-6)
    assert ppf.score_call("expon", torch.from_numpy(y)) is None


# --- Sorts, ranks and the correlators ----------------------------------


def test_sort_helpers_match_reference():
    X = np.random.default_rng(3).integers(0, 50, size=(4, 300)).astype(np.float32)
    got_sorted, got_order = sort.rowsort_with_order(torch.from_numpy(X), stable=True)
    ref_sorted, ref_order = jax_sort.rowsort_with_order(jnp.asarray(X), stable=True)
    np.testing.assert_array_equal(got_sorted.numpy(), np.asarray(ref_sorted))
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(ref_order))
    payload = np.random.default_rng(4).random((4, 300)).astype(np.float32)
    np.testing.assert_array_equal(
        sort.apply_inverse_permutation_rows(got_order, torch.from_numpy(payload)).numpy(),
        np.asarray(jax_sort.apply_inverse_permutation_rows(ref_order, jnp.asarray(payload))),
    )
    np.testing.assert_array_equal(
        sort.invert_permutation(got_order.T).numpy(),
        np.asarray(jax_sort.invert_permutation(ref_order.T)),
    )


@pytest.mark.parametrize("method", ["average", "ordinal"])
def test_rankdata_matches_reference(method):
    X = np.random.default_rng(5).integers(0, 20, size=(500, 3)).astype(np.float32)  # many ties
    got = correlation.rankdata(torch.from_numpy(X), method=method).numpy()
    ref = np.asarray(jax_correlation.rankdata(jnp.asarray(X), method=method))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        correlation.rankdata(torch.from_numpy(X[:, 0]), method=method).numpy(), ref[:, 0]
    )
    with pytest.raises(ValueError, match="method"):
        correlation.rankdata(X, method="dense")


def _bad_targets():
    return [
        [[1.0, 0.5], [0.5, 1.0]],  # a list, not an array
        np.ones(3),
        np.ones((2, 3)),
        np.array([[2.0, 0.5], [0.5, 1.0]]),
        np.array([[1.0, 0.5], [0.4, 1.0]]),
        np.array([[1.0, 2.0], [2.0, 1.0]]),
    ]


@pytest.mark.parametrize("case", range(6), ids=["list", "ndim", "square", "diag", "sym", "pd"])
def test_set_target_errors_match_reference(case):
    target = _bad_targets()[case]
    with pytest.raises((TypeError, ValueError)) as ref:
        jax_correlation.ImanConover().set_target(target)
    with pytest.raises(ref.type) as got:
        correlation.ImanConover().set_target(target)
    assert str(got.value) == str(ref.value)


def test_correlator_validates_x():
    ic = correlation.ImanConover()
    with pytest.raises(correlation.CorrelatorError, match="No target set"):
        ic(np.ones((10, 2)))
    ic.set_target(np.eye(2))
    with pytest.raises(ValueError, match="3 columns"):
        ic(np.ones((10, 3)))
    with pytest.raises(ValueError, match="more observations than variables"):
        ic(np.ones((2, 2)))
    with pytest.raises(TypeError, match="torch tensor"):
        ic([[1.0, 2.0]])
    with pytest.raises(ValueError, match="ties"):
        correlation.ImanConover(ties="dense")


def _data(seed=6, n=4000):
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.lognormal(size=n), rng.standard_normal(n), rng.integers(0, 4, n).astype(float)], axis=1
    ).astype(np.float32)


def test_cholesky_matches_reference():
    X = _data()
    C = np.array([[1.0, 0.6, -0.3], [0.6, 1.0, 0.2], [-0.3, 0.2, 1.0]])
    got = correlation.Cholesky().set_target(C)(X).numpy()
    ref = np.asarray(jax_correlation.Cholesky().set_target(C)(X))
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())
    np.testing.assert_allclose(np.corrcoef(got, rowvar=False), C, atol=1e-5)


@pytest.mark.parametrize("ties", ["average", "ordinal"])
def test_iman_conover_matches_reference(ties):
    X = _data()
    if ties == "ordinal":
        # The JAX package sorts ordinal ties unstably (its _transform_rows
        # passes no stable=), so tied columns are compared in
        # test_ordinal_ties_follow_position instead.
        X = X[:, :2]
    C = np.array([[1.0, 0.6, -0.3], [0.6, 1.0, 0.2], [-0.3, 0.2, 1.0]])[: X.shape[1], : X.shape[1]]
    got = correlation.ImanConover(ties=ties).set_target(C)(X).numpy()
    ref = np.asarray(jax_correlation.ImanConover(ties=ties).set_target(C)(X))
    for k in range(X.shape[1]):  # marginals exactly preserved
        np.testing.assert_array_equal(np.sort(got[:, k]), np.sort(X[:, k]))
    assert np.mean(np.any(got != ref, axis=1)) <= NEAR_TIE_SHARE
    with pytest.raises(ValueError, match="Rank data correlation not positive definite"):
        correlation.ImanConover(ties=ties).set_target(np.eye(2))(np.stack([X[:, 0], X[:, 0]], axis=1))


def test_ordinal_ties_follow_position():
    X = torch.tensor([[2.0, 1.0, 2.0, 1.0, 2.0, 1.0]])
    ic = correlation.ImanConover(ties="ordinal")
    X_sorted, order = ic._sort_rows(X)
    np.testing.assert_array_equal(order.numpy(), [[1, 3, 5, 0, 2, 4]])
    scores, _, _ = ic._scores_rows(X_sorted, order)
    s = special.ndtri_fast_wide(torch.arange(1, 7, dtype=torch.float32) / 7)
    np.testing.assert_array_equal(scores.numpy()[0], s[[3, 0, 4, 1, 5, 2]].numpy())


def test_decorrelate_matches_reference():
    X = _data().astype(np.float64)
    for remove in (True, False):
        np.testing.assert_allclose(
            correlation.decorrelate(X, remove_variance=remove),
            jax_correlation.decorrelate(X, remove_variance=remove), rtol=1e-12,
        )
    got = correlation.decorrelate(torch.from_numpy(X.astype(np.float32))).numpy()
    np.testing.assert_allclose(np.corrcoef(got, rowvar=False), np.eye(3), atol=1e-5)


def test_recolor_scores_matches_reference():
    jax_sink, sink, _ = _pair(jax_benchmarks.mixed_correlated_50)
    C = tcompile.get_plan(sink).corr_matrix
    z = np.random.default_rng(7).standard_normal((10, N)).astype(np.float32)
    got = correlation.ImanConover().set_target(C)._recolor_scores(torch.from_numpy(z)).numpy()
    ref = np.asarray(jax_correlation.ImanConover().set_target(C)._recolor_scores(jnp.asarray(z)))
    assert np.abs(got - ref).max() <= REL_TOL * np.abs(ref).max()
    np.testing.assert_allclose(np.corrcoef(got), C, atol=1e-5)


def test_statistics_matrix_products_run_without_tf32(monkeypatch):
    seen = []
    cholesky = torch.linalg.cholesky

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return cholesky(*args, **kwargs)

    monkeypatch.setattr(torch.linalg, "cholesky", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    ic = correlation.ImanConover().set_target(np.array([[1.0, 0.5], [0.5, 1.0]]))
    z = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 500)).astype(np.float32))
    ic._recolor_scores(z)
    ic._apply_rows(z)
    correlation.Cholesky().set_target(np.eye(2))(z.T)
    correlation.decorrelate(z.T)
    assert seen == [False] * 4
    assert torch.backends.cuda.matmul.allow_tf32  # restored afterwards


# --- The recolour transform of the CUDA path, through its plain twin ---


def test_twin_recolor_transform_matches_reference_recolor_scores():
    jax_sink, sink, _ = _pair(jax_benchmarks.mixed_correlated_50)
    plan = tcompile.get_plan(sink)
    words = cuda_exec.seed_words(11)
    columns = [plan.col_of[v._id] for v in plan.corr_vars]
    ab = cuda_exec.recolor_transform(plan, words, N, device="cpu").double().numpy()
    K = len(columns)
    z = special.ndtri_fast(cuda_exec.philox_uniforms(words, N, K, columns=columns)).T
    y = ab[: K * K].reshape(K, K) @ z.double().numpy() + ab[K * K :, None]
    ref = np.asarray(
        jax_correlation.ImanConover().set_target(plan.corr_matrix)._recolor_scores(jnp.asarray(z.numpy()))
    )
    assert np.abs(y - ref).max() <= REL_TOL * np.abs(ref).max()
    # The statistics twin sums what it says, in float64 and in chunks.
    sums = cuda_exec.corr_stats_reference(words, N, columns, chunk=5000).numpy()
    zd = z.double().numpy()
    np.testing.assert_allclose(sums[:K], zd.sum(axis=1), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(sums[K:], (zd @ zd.T)[np.triu_indices(K)], rtol=1e-9)


def test_recolor_transform_refuses_a_singular_target():
    plan = tcompile.get_plan(benchmarks.mixed_correlated_50())
    sums = cuda_exec.corr_stats_reference((1, 2), 1000, [0, 1])
    with pytest.raises(ValueError, match="not positive definite"):
        cuda_exec.solve_recolor(sums.numpy(), 1000, np.ones((2, 2)))
    assert cuda_exec.solve_recolor(sums.numpy(), 1000, plan.corr_matrix[:2, :2]).shape == (6,)


def test_correlated_tape_twin_matches_plain_executor():
    sink = benchmarks.mixed_correlated_50()
    plan = tcompile.get_plan(sink)
    keep = frozenset([sink._id] + [v._id for v in plan.corr_vars[:6]])
    assert cuda_exec.supports(plan, keep)
    order = cuda_exec.keep_order(plan, keep)
    tape = cuda_exec.lower(plan, order)
    assert tape.n_corr == 10 and tape.n_slots <= cuda_exec.MAX_SLOTS
    words = cuda_exec.seed_words(12)
    ab = cuda_exec.recolor_transform(plan, words, N, device="cpu")
    U = cuda_exec.philox_uniforms(words, N, plan.d)
    got = cuda_exec.run_tape(tape, U, ab)
    ref = tcompile.build_body(plan, keep, generated=True)(U)
    for k, nid in enumerate(order):
        scale = ref[nid].abs().max().item()
        assert (got[k] - ref[nid]).abs().max().item() <= REL_TOL * scale
    with pytest.raises(ValueError, match="recolour transform"):
        cuda_exec.run_tape(tape, U)
    launches = cuda_exec.STATS_LAUNCHES
    out, flag = cuda_exec.run(tape, words, 4096, ab)
    assert cuda_exec.STATS_LAUNCHES == launches and int(flag) == 0 and out.shape == (7, 4096)


# --- The two branches of phase 2 against the JAX package ---------------


def test_generated_branch_matches_reference():
    jax_sink, sink, mapping = _pair(jax_benchmarks.mixed_correlated_50)
    ref_plan = jax_compile.Plan(jax_sink)
    plan = tcompile.get_plan(sink)
    q = np.random.default_rng(13).random((N, plan.d)).astype(np.float32)
    q = np.clip(q, 2.0**-24, 1 - 2.0**-24)
    ref_keep = [node._id for node in ref_plan.topo]
    ref, _ = jax_compile.build_body(
        ref_plan, jax_correlation.ImanConover, ref_keep, generated_ok=True
    )(jnp.asarray(q), gen_key=jax.random.PRNGKey(0))
    got = tcompile.build_body(plan, [n._id for n in plan.topo], generated=True)(torch.from_numpy(q))
    for ref_node in ref_plan.topo:
        a = np.asarray(ref[ref_node._id], np.float64)
        b = got[mapping[ref_node._id]._id].double().numpy()
        assert np.abs(a - b).max() <= REL_TOL * max(np.abs(a).max(), 1e-30), ref_node


def test_four_sort_branch_matches_reference():
    jax_sink, sink, mapping = _pair(jax_benchmarks.mixed_correlated_50)
    plan = tcompile.get_plan(sink)
    q = _grid_quantiles(14, (N, plan.d))
    jax_sink.sample_from_quantiles(q)
    sink.sample_from_quantiles(q)
    for ref_var, var in zip(jax_compile.Plan(jax_sink).corr_vars, plan.corr_vars):
        a = np.asarray(ref_var.samples_, np.float64)
        b = var.samples_
        own = ppf.call(var.distr, torch.from_numpy(q[:, plan.col_of[var._id]]).float(), *var.args, **var.kwargs)
        assert torch.equal(torch.sort(b).values, torch.sort(own).values)
        b = b.double().numpy()
        tol = REL_TOL * np.abs(a).max()
        assert np.abs(np.sort(a) - np.sort(b)).max() <= tol
        assert np.mean(np.abs(a - b) > tol) <= NEAR_TIE_SHARE
    a, b = np.asarray(jax_sink.samples_), sink.samples_.numpy()
    assert np.mean(np.abs(a - b) > REL_TOL * np.abs(a).max()) <= NEAR_TIE_SHARE


@pytest.mark.parametrize("correlator", ["imanconover", "cholesky"])
def test_sampled_correlation_reaches_the_repaired_target(correlator):
    sink = benchmarks.portfolio_model()
    plan = tcompile.get_plan(sink)
    sink.sample(20000, random_state=0, gc_strategy=plan.corr_vars, correlator=correlator)
    X = torch.stack([v.samples_ for v in plan.corr_vars]).double().numpy()
    # Lognormal marginals: Pearson of the logs is the Gaussian-copula target.
    target = np.log(X) if correlator == "imanconover" else X
    np.testing.assert_allclose(np.corrcoef(target), plan.corr_matrix, atol=2e-3)


def test_rows_guard_and_correlator_arguments():
    sink = benchmarks.mixed_correlated_50()
    message = r"more observations than variables \(rows > columns\); X has shape \(10, 10\)"
    with pytest.raises(ValueError, match=message):
        sink.sample(10, random_state=0)
    with pytest.raises(ValueError, match=message):
        sink.sample_from_quantiles(np.full((10, 10), 0.5))
    assert sink.sample(50, random_state=0).shape == (50,)
    t = sink.sample(100, random_state=0, correlator="tcopula")  # the Student-t copula
    assert t.shape == (100,) and bool(torch.isfinite(t).all())
    # The correlator is only resolved for correlated graphs.
    assert benchmarks.mixed_dag_20().sample(10, correlator="tcopula").shape == (10,)
    # An instance carries its configuration.
    ordinal = correlation.ImanConover(ties="ordinal")
    assert tcompile.correlator_token(ordinal) == ("ImanConover", "ordinal")
    assert tcompile.instantiate_correlator(ordinal) is ordinal
    assert sink.sample(500, random_state=0, correlator=ordinal).shape == (500,)


def test_cuda_executor_refuses_other_correlators_and_wide_correlations():
    sink = benchmarks.mixed_correlated_50()
    with pytest.raises(ValueError, match="correlator='imanconover' only"):
        sink.sample(100, gc_strategy=[], executor="cuda", correlator="cholesky")
    wide = benchmarks.portfolio_model(d=17)
    with pytest.raises(ValueError, match="at most 16 correlated variables"):
        wide.sample(100, gc_strategy=[], executor="cuda")
    # Without a card the environment check refuses the rest, with no fallback.
    launches = (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES)
    with pytest.raises(ValueError, match="executor='cuda'"):
        sink.sample(100, gc_strategy=[], executor="cuda")
    assert (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES) == launches


def _supports(jax_sink, extra=()):
    mapping = interop.from_reference(jax_sink)
    ids = frozenset({jax_sink._id, *extra})
    port_ids = frozenset(mapping[i]._id for i in ids)
    return (
        pallas_exec.supports(jax_compile.Plan(jax_sink), ids),
        cuda_exec.supports(tcompile.get_plan(mapping[jax_sink._id]), port_ids),
    )


def test_supports_agrees_with_pallas_exec_on_correlated_graphs():
    a, b, c = JaxDistribution("norm"), JaxDistribution("triang", c=0.2), JaxDistribution("expon")
    composite = JaxDistribution("norm", loc=jg.Constant(1.0) + 2, scale=2.0)
    small = (a + b * c + composite).correlate(a, b, composite, corr_mat=np.eye(3) * 0.5 + 0.5)
    cases = [
        (jax_benchmarks.mixed_correlated_50(), ()),
        (jax_benchmarks.portfolio_model(), ()),
        (jax_benchmarks.portfolio_model(d=16), ()),
        (jax_benchmarks.portfolio_model(d=17), ()),
        (small, ()),
        (small, (a._id, c._id)),
    ]
    for sink, extra in cases:
        ref, got = _supports(sink, extra)
        assert ref == got, (sink, extra)
    assert _supports(jax_benchmarks.portfolio_model(d=16)) == (True, True)
    assert _supports(jax_benchmarks.portfolio_model(d=17)) == (False, False)


def test_device_defaults_to_cuda_and_raises_without_a_card():
    code = (
        "import torch\n"
        "from probabilit_tpu_torch import config\n"
        "from probabilit_tpu_torch.models.benchmarks import mixed_correlated_50\n"
        "assert config.device() == torch.device('cuda'), config.device()\n"
        "if torch.cuda.is_available():\n"
        "    raise SystemExit(0)\n"
        "for call in (lambda s: s.sample(100, random_state=0),\n"
        "             lambda s: s.sample_from_quantiles([[0.5] * 10] * 20)):\n"
        "    try:\n"
        "        call(mixed_correlated_50())\n"
        "    except (RuntimeError, AssertionError):\n"
        "        continue\n"
        "    raise SystemExit('sampled without a card')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_sources_share_the_caps_and_the_math():
    csrc = ROOT / "probabilit_tpu_torch" / "csrc"
    sink = benchmarks.mixed_correlated_50()
    generated = cuda_exec.lowered(tcompile.get_plan(sink), [sink._id]).source
    stats = (csrc / "corr_stats.cu").read_text()
    assert f"kMaxCorr = {cuda_exec.MAX_CORR_K};" in stats and "kCorr = 10;" in generated
    # K2 keeps sampling_math's normal scores; the closed forms' fast_math.cuh
    # is the generated kernel's alone.
    assert '#include "fast_math.cuh"' in generated and "fast_math" not in stats
    for src in (generated, stats):
        assert '#include "sampling_math.cuh"' in src
        # Both kernels draw whole groups from the one shared generator.
        assert "philox_group(g, " in src and "philox_group(uint64_t" not in src
        assert "float ndtri_fast(" not in src
