"""The port's single-shot scenario sweeps (``engine/sweep.py``) on the CPU:
the scenario dict's two key forms and errors, the evaluation on one
explicit quantile matrix against the JAX package's, the rule that picks
the scenario axis's design (one batched evaluation, or one a scenario),
common random numbers, the ``sem`` column, the refusals and
``Node.sweep``.

Parity runs both packages on one matrix: the JAX package's ``build_body``
vmapped over the scenario rows, as its ``_build_sweep_fn`` builds it with
the draw taken out, against the port's ``_build_sweep_fn(...)(theta,
q)``, in float32 and float64, for ``mean``, ``var``, ``std``, ``q0.9``,
``cvar0.9``, a callable and the ``sem`` column, on ``mixed_dag_20`` (one
slot, and a 3 x 3 meshgrid of two slots), a correlated graph (the
sort-free recolouring on drawn uniforms), a GBM spot ladder and a joint
node's indexed slot ``"s0[1]"`` (their slabs on an explicit matrix).
Tolerances: each statistic within 1e-5 (float32) or 1e-11 (float64) of
max(1, |value|), as for the gradients' values; the packages sum float32
samples in different orders.  Messages are compared with the JAX
package's verbatim.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probabilit_tpu as jax_pkg
import probabilit_tpu_torch as pt
from probabilit_tpu import config as jax_config
from probabilit_tpu.engine import compile as jax_compile
from probabilit_tpu.engine import sensitivity as jax_sens
from probabilit_tpu.engine import sweep as jax_sweep
from probabilit_tpu.models import benchmarks as jax_benchmarks
from probabilit_tpu.models import graph as jax_graph
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec, streaming
from probabilit_tpu_torch.engine import sweep as tsweep
from probabilit_tpu_torch.models.benchmarks import mixed_dag_20
from test_torch_graph import vector_math_initialised  # noqa: F401  (autouse)

TOL = {"float32": 1e-5, "float64": 1e-11}
N = 1 << 11
STATISTICS = ["mean", "var", "std", "q0.9", "cvar0.9", "callable"]
COLUMNS = STATISTICS + ["sem"]


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


@pytest.fixture(params=["float32", "float64"])
def both_dtypes(request):
    """Both packages in one float mode (JAX's float64 is ``jax_enable_x64``)."""
    config.set_dtype(getattr(torch, request.param))
    jax_config.set_dtype(getattr(jnp, request.param))
    try:
        yield request.param
    finally:
        config.set_dtype(torch.float32)
        jax_config.set_dtype(jnp.float32)


def _square_mean(x):
    """A callable statistic both packages evaluate (operators only)."""
    return (x * x).mean()


def _jax_sweep_stats(sink, pairs, theta, q, drawn):
    """The JAX package's (S, 7) statistics on ``q``: its ``build_body``
    vmapped over the rows of ``theta`` with the slots swapped, as its
    ``_build_sweep_fn`` evaluates them, the sem in the float type."""
    plan = jax_compile.get_plan(sink)
    correlator = jax_compile.resolve_correlator("imanconover")
    generated = drawn and jax_compile.recolor_eligible(plan, correlator)
    body = jax_compile.build_body(plan, correlator, keep_ids=frozenset([sink._id]),
                                  check_finite=False, generated_ok=generated)
    fns = [_square_mean if s == "callable" else jax_sens._resolve_statistic(s)[0]
           for s in STATISTICS]
    gen_key = jax.random.PRNGKey(0) if drawn else None
    size = q.shape[0]

    def stats_of(row):
        saved = jax_sens._save_slots(pairs)
        try:
            for (node, slot), th in zip(pairs, row):
                jax_sens._write_slot(node, slot, th)
            x = body(jnp.asarray(q), gen_key=gen_key)[0][sink._id]
            sem = jnp.std(x, ddof=1) / jnp.sqrt(jnp.asarray(size, x.dtype))
            return jnp.stack([f(x) for f in fns] + [sem])
        finally:
            jax_sens._restore_slots(saved)

    th = jnp.asarray(theta, jax_config.float_dtype())
    return np.asarray(jax.jit(jax.vmap(stats_of))(th), np.float64)


def _port_sweep_stats(sink, pairs, theta, q, drawn):
    plan = tcompile.get_plan(sink)
    specs = [_square_mean if s == "callable" else s for s in STATISTICS]
    fn = tsweep._build_sweep_fn(plan, pairs, specs, True,
                                tcompile.resolve_correlator("imanconover"), drawn)
    dtype = config.float_dtype()
    return fn(torch.as_tensor(theta, dtype=dtype), torch.as_tensor(q, dtype=dtype)).T


def _dag_one_slot():
    sink = jax_benchmarks.mixed_dag_20()
    price = jax_compile.get_plan(sink).isns[0]  # lognorm(s=0.25, scale=50)
    return sink, [(price, "scale")], np.linspace(40.0, 60.0, 5)[:, None], True


def _dag_meshgrid():
    sink = jax_benchmarks.mixed_dag_20()
    isns = jax_compile.get_plan(sink).isns
    a, b = np.meshgrid([40.0, 50.0, 60.0], [0.1, 0.25, 0.4])
    theta = np.stack([b.ravel(), a.ravel()], axis=1)
    return sink, [(isns[0], "s"), (isns[0], "scale")], theta, True


def _correlated():
    a = jax_pkg.Distribution("norm", loc=1.0, scale=2.0)
    b = jax_pkg.Distribution("lognorm", 0.4, scale=3.0)
    c = jax_pkg.Distribution("triang", 0.3, loc=-1.0, scale=4.0)
    sink = a * b + c
    target = np.array([[1.0, 0.5, -0.3], [0.5, 1.0, 0.2], [-0.3, 0.2, 1.0]])
    sink.correlate(a, b, c, corr_mat=target)
    theta = np.array([[0.0, 2.0], [1.0, 3.0], [2.0, 4.0]])
    return sink, [(a, "loc"), (b, "scale")], theta, True


def _gbm_ladder():
    g = jax_pkg.GeometricBrownianMotion(s0=100.0, mu=0.05, sigma=0.2, steps=8)
    sink = g.terminal() * 1.0
    return sink, [(g, "s0")], np.linspace(80.0, 120.0, 5)[:, None], False


def _joint_slot():
    a, b = jax_pkg.CorrelatedGBM([100, 50], [0.03, 0.02], [0.2, 0.3], [[1, 0.6], [0.6, 1]],
                                 steps=8)
    sink = 0.5 * a.terminal() + 0.5 * b.terminal()
    return sink, [(a.joint, "s0[1]")], np.array([[40.0], [50.0], [60.0]]), False


GRAPHS = {
    "dag_one_slot": _dag_one_slot,
    "dag_meshgrid": _dag_meshgrid,
    "correlated": _correlated,
    "gbm_ladder": _gbm_ladder,
    "joint_slot": _joint_slot,
}
_REFERENCE = {}


def _reference(graph, dtype):
    """((S, 7) JAX statistics, (S, 7) port statistics) on one matrix, once
    per graph and float mode (one JAX compile for every column)."""
    if (graph, dtype) not in _REFERENCE:
        sink, pairs, theta, drawn = GRAPHS[graph]()
        plan = jax_compile.get_plan(sink)
        q = np.random.default_rng(17).integers(1, 2**23, (N, plan.d if drawn else plan.d_total))
        q = q / 2**23
        ref = _jax_sweep_stats(sink, pairs, theta, q, drawn)
        mapping = interop.from_reference(sink)
        port_pairs = [(mapping[node._id], slot) for node, slot in pairs]
        got = _port_sweep_stats(mapping[sink._id], port_pairs, theta, q, drawn)
        _REFERENCE[(graph, dtype)] = (ref, got)
    return _REFERENCE[(graph, dtype)]


@pytest.mark.parametrize("column", COLUMNS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_evaluation_on_one_matrix_matches_jax(graph, column, both_dtypes):
    ref, got = _reference(graph, both_dtypes)
    j = COLUMNS.index(column)
    want = ref[:, j]
    assert np.all(np.isfinite(want)) and got.shape == ref.shape
    np.testing.assert_allclose(got[:, j], want, rtol=0,
                               atol=TOL[both_dtypes] * max(1.0, float(np.abs(want).max())))


# --- scenario dicts -------------------------------------------------------------------------


def _both_normalized(build):
    """Run ``build(pkg)`` -> (graph sink, scenarios) in both packages and
    return each package's ``_normalize_scenarios`` result or message."""
    out = []
    for pkg, mod, compile_ in ((jax_pkg, jax_sweep, jax_compile), (pt, tsweep, tcompile)):
        sink, scenarios = build(pkg)
        try:
            pairs, theta = mod._normalize_scenarios(compile_.get_plan(sink), scenarios)
            out.append(([(type(n).__name__, s) for n, s in pairs], theta))
        except ValueError as exc:
            out.append(str(exc).replace("probabilit_tpu_torch", "probabilit_tpu"))
    return out


def _two_nodes(pkg):
    x = pkg.Distribution("norm", loc=0.0, scale=1.0)
    y = pkg.Distribution("lognorm", 0.5, scale=2.0)
    return x, y, x + y


SCENARIO_CASES = {
    "tuple_keys": lambda x, y: {(y, "scale"): [1.0, 2.0], (x, "loc"): [0.0, 1.0]},
    "nested": lambda x, y: {x: {"loc": [0.0, 1.0], "scale": 2.0}},
    "mixed_forms": lambda x, y: {(x, "loc"): [0.0, 1.0], y: {0: [0.4, 0.6]}},
    "scalars_broadcast": lambda x, y: {(x, "loc"): 1.5, (y, "scale"): [1.0, 2.0, 3.0]},
    "duplicate": lambda x, y: {(x, "loc"): [0.0], x: {"loc": [1.0]}},
    "lengths": lambda x, y: {(x, "loc"): [0.0, 1.0], (y, "scale"): [1.0, 2.0, 3.0]},
    "non_finite": lambda x, y: {(x, "loc"): [0.0, np.nan]},
    "two_dimensional": lambda x, y: {(x, "loc"): [[0.0, 1.0]]},
    "bad_key": lambda x, y: {x: [0.0, 1.0]},
    "empty": lambda x, y: {},
    "not_a_dict": lambda x, y: [(x, "loc")],
    "unknown_slot": lambda x, y: {(x, "shape"): [1.0]},
}


@pytest.mark.parametrize("case", sorted(SCENARIO_CASES))
def test_normalize_scenarios_matches_jax(case):
    def build(pkg):
        x, y, sink = _two_nodes(pkg)
        return sink, SCENARIO_CASES[case](x, y)

    ref, got = _both_normalized(build)
    if isinstance(ref, str):
        assert got == ref
    else:
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1], ref[1])


# --- common random numbers, sem, seeds ------------------------------------------------------


def test_crn_scenarios_share_one_matrix_and_equal_sample():
    """Identical scenarios give identical statistics; scenario s is the
    sample() of the graph with its slot set to theta_s (same seed)."""
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    y = x * x
    res = pt.sweep(y, {(x, "loc"): [0.5, 0.5, 1.5]}, size=4096, random_state=1,
                   statistics=("mean", "q0.9"))
    assert res["mean"][0] == res["mean"][1] and res["q0.9"][0] == res["q0.9"][1]
    x.kwargs["loc"] = 1.5
    try:
        direct = y.sample(4096, random_state=1)
    finally:
        x.kwargs["loc"] = 0.0
    assert res["mean"][2] == pytest.approx(float(direct.mean()), rel=1e-6)
    again = pt.sweep(y, {(x, "loc"): [0.5, 0.5, 1.5]}, size=4096, random_state=1,
                     statistics=("mean", "q0.9"))
    assert all(np.array_equal(res[k], again[k]) for k in res.keys())
    assert x.kwargs == {"loc": 0.0, "scale": 1.0}


def test_independent_streams_without_crn():
    """common_random_numbers=False: scenario i draws from
    _derive_seed(seed, 4, i), so identical scenarios differ."""
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    y = x * x
    res = pt.sweep(y, {(x, "loc"): [0.5, 0.5]}, size=4096, random_state=1,
                   common_random_numbers=False)
    assert res["mean"][0] != res["mean"][1]
    assert np.abs(res["mean"] - 1.25).max() < 0.15  # E[(L + Z)^2] = 1.25
    x.kwargs["loc"] = 0.5
    try:
        for i in range(2):
            direct = y.sample(4096, random_state=streaming._derive_seed(1, 4, i))
            assert res["mean"][i] == pytest.approx(float(direct.mean()), rel=1e-6)
    finally:
        x.kwargs["loc"] = 0.0


@pytest.mark.parametrize("method,has_sem", [(None, True), ("antithetic", True),
                                            ("sobol", False), ("halton", False),
                                            ("lhs", False)])
def test_sem_column_follows_the_method(method, has_sem):
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    res = pt.sweep(2.0 * x + 1.0, {(x, "loc"): [-1.0, 0.0, 1.0]}, size=1024, random_state=0,
                   method=method, statistics=("mean", "std"))
    assert ("sem" in res.keys()) is has_sem
    assert np.abs(res["mean"] - np.array([-1.0, 1.0, 3.0])).max() < 0.3
    if has_sem:
        np.testing.assert_allclose(res["sem"], res["std"] / np.sqrt(1024), rtol=1e-5)


def _rule_cases():
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    g = pt.Distribution("gamma", 2.0, scale=1.0)
    a = pt.Distribution("norm", loc=0.0, scale=1.0)
    b = pt.Distribution("lognorm", 0.5, scale=1.0)
    corr = a * b
    corr.correlate(a, b, corr_mat=np.array([[1.0, 0.5], [0.5, 1.0]]))
    gbm = pt.GeometricBrownianMotion(s0=100.0, mu=0.05, sigma=0.2, steps=4)
    dag = mixed_dag_20()
    price = tcompile.get_plan(dag).isns[0]
    return {
        "mixed_dag_20": (dag, [(price, "scale")], True, True),
        "arithmetic": (pt.Max(2.0 * x + 1.0, x * x) - pt.Exp(x), [(x, "loc")], True, True),
        "off_path_newton": (x + g, [(x, "loc")], True, True),
        "independent_streams": (x + 1.0, [(x, "loc")], False, False),
        "newton_family": (g * 1.0, [(g, 0)], True, False),
        "newton_downstream": (pt.Distribution("gamma", x * 0.0 + 2.0) * 1.0, [(x, "loc")], True,
                              False),
        "quantile_transform": (pt.QuantileTransform(pt.Distribution("uniform", loc=0.0,
                                                                    scale=0.5), "norm") * 1.0,
                               None, True, False),
        "correlated": (corr, [(a, "loc")], True, False),
        "path_node": (gbm.terminal() * 1.0, [(gbm, "s0")], True, False),
    }


@pytest.mark.parametrize("case", sorted(_rule_cases()))
def test_scenario_axis_rule_follows_the_structure(case):
    """``_batchable`` decides from the graph alone: batched when the
    scenarios share the matrix, nothing is correlated and every node on a
    slot's path is a closed-form family of the five or arithmetic."""
    sink, pairs, crn, want = _rule_cases()[case]
    plan = tcompile.get_plan(sink)
    if pairs is None:  # the uniform under a QuantileTransform
        pairs = [(plan.isns[0], "scale")]
    assert tsweep._batchable(plan, pairs, crn) is want


@pytest.mark.parametrize("batched", [True, False])
def test_one_evaluation_per_chunk_or_per_scenario(batched, monkeypatch):
    """The batch evaluates the body once for all scenarios, the loop once a
    scenario, and they agree; no kernel is launched."""
    sink = mixed_dag_20()
    price = tcompile.get_plan(sink).isns[0]
    calls = []
    real_body = tsweep._sweep_body

    def counting(*args):
        body = real_body(*args)

        def counted(q):
            calls.append(q.shape[0])
            return body(q)
        return counted

    monkeypatch.setattr(tsweep, "_sweep_body", counting)
    if not batched:
        monkeypatch.setattr(tsweep, "_batchable", lambda *args: False)
    before = (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES)
    res = pt.sweep(sink, {(price, "scale"): [40.0, 50.0, 60.0]}, size=2048, random_state=3,
                   statistics=("mean", "q0.9", _square_mean))
    assert calls == ([2048] if batched else [2048] * 3)
    assert (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES) == before
    monkeypatch.undo()
    other = pt.sweep(sink, {(price, "scale"): [40.0, 50.0, 60.0]}, size=2048, random_state=3,
                     statistics=("mean", "q0.9", _square_mean))
    for key in res.keys():
        np.testing.assert_allclose(res[key], other[key], rtol=1e-6)


def test_batches_are_chunked(monkeypatch):
    """Past ``_BATCH_ELEMENTS`` values the scenarios split into chunks."""
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    monkeypatch.setattr(tsweep, "_BATCH_ELEMENTS", 2 * 1024)
    res = pt.sweep(2.0 * x, {(x, "loc"): [0.0, 1.0, 2.0, 3.0, 4.0]}, size=1024, random_state=0,
                   statistics=("mean", "cvar0.9"))
    monkeypatch.undo()
    whole = pt.sweep(2.0 * x, {(x, "loc"): [0.0, 1.0, 2.0, 3.0, 4.0]}, size=1024,
                     random_state=0, statistics=("mean", "cvar0.9"))
    for key in res.keys():
        np.testing.assert_allclose(res[key], whole[key], rtol=1e-6)


def test_node_sweep_and_result():
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    y = 2.0 * x + 1.0
    a = y.sweep({(x, "loc"): [0.0, 1.0]}, size=2048, random_state=3, statistics=["mean", "var"])
    b = pt.sweep(y, {(x, "loc"): [0.0, 1.0]}, size=2048, random_state=3,
                 statistics=["mean", "var"])
    assert all(np.array_equal(a[k], b[k]) for k in a.keys())
    assert a.n == 2 and a.size == 2048 and list(a.keys()) == ["mean", "var", "sem"]
    assert repr(a) == "SweepResult(2 scenarios x 2048 draws; statistics: mean, var, sem)"
    np.testing.assert_array_equal(a.scenarios[(x, "loc")], [0.0, 1.0])
    callable_res = pt.sweep(y, {(x, "loc"): [0.0, 1.0]}, size=2048, random_state=3,
                            statistics=_square_mean)
    assert list(callable_res.keys()) == ["stat0"]


# --- refusals -------------------------------------------------------------------------------


def _refusal_cases(pkg):
    x = pkg.Distribution("norm", loc=0.0, scale=1.0)
    a = pkg.Distribution("norm", loc=0.0, scale=1.0)
    b = pkg.Distribution("norm", loc=1.0, scale=1.0)
    corr = a + b
    corr.correlate(a, b, corr_mat=np.array([[1.0, 0.5], [0.5, 1.0]]))
    u = pkg.ClaytonCopula(theta=2.0)[0]
    seeded = pkg.QuantileTransform(u, "norm") + x
    poisson = pkg.Distribution("poisson", 3.0)
    ladder = {(x, "loc"): [0.0, 1.0]}
    sweep = jax_sweep.sweep if pkg is jax_pkg else tsweep.sweep
    sqrt = jax_graph.Sqrt if pkg is jax_pkg else pt.Sqrt
    return {
        "integer_sink": lambda: sweep((x > 0) + 0, ladder, size=64),
        "non_finite": lambda: sweep(sqrt(x) * 1.0, {(x, "loc"): [1.0, -50.0]}, size=64,
                                    random_state=0),
        "size": lambda: sweep(x, ladder, size=1),
        "duplicate_statistics": lambda: sweep(x, ladder, size=64, statistics=("mean", "mean")),
        "bad_statistic": lambda: sweep(x, ladder, size=64, statistics="median"),
        "method": lambda: sweep(x, ladder, size=64, method="fourier"),
        "key_seeded_method": lambda: sweep(seeded, ladder, size=64, method="sobol"),
        "streamed_qmc_correlated": lambda: sweep(corr, {(a, "loc"): [0.0]}, size=64,
                                                 method="sobol", block_size=32),
        "streamed_cholesky": lambda: sweep(corr, {(a, "loc"): [0.0]}, size=64, block_size=32,
                                           correlator="cholesky"),
        "streamed_callable": lambda: sweep(x, ladder, size=64, block_size=32,
                                           statistics=_square_mean),
        "replicates": lambda: sweep(x, ladder, size=64, replicates=1),
        "divisible": lambda: sweep(x, ladder, size=65, replicates=2),
        "target_without_replicates": lambda: sweep(x, ladder, size=64, target_sem=0.1),
        "target_not_positive": lambda: sweep(x, ladder, size=64, target_sem=0.0, replicates=2),
        "target_callable": lambda: sweep(x, ladder, size=64, target_sem=0.1, replicates=2,
                                         statistics=_square_mean),
        "max_size_below_size": lambda: sweep(x, ladder, size=64, target_sem=0.1, replicates=2,
                                             max_size=32),
        "max_size_alone": lambda: sweep(x, ladder, size=64, max_size=128),
        "string_sink": lambda: sweep(pkg.DiscreteDistribution(["a", "b"]), ladder, size=64),
        "discrete_family": lambda: sweep(poisson * 1.0, {(poisson, 0): [1.0, 2.0]}, size=64),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases(pt)))
def test_refusals_match_jax(case):
    """The same exception type and message as the JAX package."""
    caught = []
    for pkg in (jax_pkg, pt):
        with pytest.raises((ValueError, FloatingPointError, TypeError)) as info:
            _refusal_cases(pkg)[case]()
        caught.append((info.type, str(info.value)))
    assert caught[1] == caught[0]
