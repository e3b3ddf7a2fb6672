"""The port's streamed, replicated and sequential sweeps (``engine/sweep.py``)
on the CPU.

A streamed sweep (``block_size=``) draws block b as
``estimate(executor=None)`` does, so with common random numbers scenario
s is the estimate of the graph with its slots set to theta_s by hand:
mean, var (the sweep's ``M2 / (n - 1)`` against the estimate's ``M2 /
n``, rescaled), q and cvar within 1e-6 of max(1, |value|) (the same
draws and float64 folds; the scenario's parameter enters as a 0-dim
float32 tensor where the hand-set graph holds a Python float).  Also: a
partial last block, a correlated stream, the streamed QMC refusal,
Sobol-sequence streams against one shot (within 1e-6 of max(1,
|value|): float32 sums in other orders), replicates' seeds, and the
sequential loop: convergence, the budget cap, and R2's fix (an explicit
``max_size`` of 128 rounds runs 128 rounds; the JAX package stops at
64).  Sizes are 2^10 to 2^15 draws a scenario.
"""

import numpy as np
import pytest

import probabilit_tpu_torch as pt
from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import streaming
from probabilit_tpu_torch.models.benchmarks import mixed_dag_20
from test_torch_graph import one_torch_thread, vector_math_initialised  # noqa: F401  (autouse)

TOL = 1e-6
SCALES = [40.0, 45.0, 50.0, 55.0, 60.0]  # float32-exact: the hand-set graph holds the same value


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


def _close(got, want):
    assert abs(got - want) <= TOL * max(1.0, abs(want)), (got, want)


def _estimate_with(sink, node, slot, value, size, block, seed, **kwargs):
    saved = node.kwargs[slot]
    node.kwargs[slot] = value
    try:
        return streaming.estimate(sink, size, block_size=block, random_state=seed,
                                  executor=None, **kwargs)
    finally:
        node.kwargs[slot] = saved


@pytest.mark.parametrize("size,block", [(1 << 14, 1 << 12), ((1 << 13) + 137, 1 << 12)])
def test_streamed_scenarios_are_the_estimates(size, block):
    """Each scenario against estimate(executor=None) with the slot set by
    hand; the second size leaves a partial last block."""
    sink = mixed_dag_20()
    price = tcompile.get_plan(sink).isns[0]  # lognorm(s=0.25, scale=50)
    res = pt.sweep(sink, {(price, "scale"): SCALES}, size=size, block_size=block,
                   random_state=5, statistics=("mean", "var", "std", "q0.95", "cvar0.95"))
    assert res.n == len(SCALES) and np.all(np.diff(res["mean"]) > 0)
    for s in (0, len(SCALES) - 1):
        est = _estimate_with(sink, price, "scale", SCALES[s], size, block, 5,
                             quantiles=(0.95,), cvar=(0.95,))
        _close(res["mean"][s], est["mean"])
        _close(res["var"][s], est["var"] * size / (size - 1.0))
        _close(res["std"][s], np.sqrt(est["var"] * size / (size - 1.0)))
        _close(res["q0.95"][s], est["q0.95"])
        _close(res["cvar0.95"][s], est["cvar0.95"])
        _close(res["sem"][s], np.sqrt(res["var"][s] / size))


def test_streamed_independent_streams_are_their_estimates():
    """common_random_numbers=False: scenario i streams from
    _derive_seed(seed, 4, i)."""
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    y = x * x
    res = pt.sweep(y, {(x, "loc"): [0.5, 0.5]}, size=1 << 12, block_size=1 << 10,
                   random_state=2, common_random_numbers=False, statistics=("mean", "q0.5"))
    assert res["mean"][0] != res["mean"][1]
    for i in range(2):
        est = _estimate_with(y, x, "loc", 0.5, 1 << 12, 1 << 10,
                             streaming._derive_seed(2, 4, i), quantiles=(0.5,))
        _close(res["mean"][i], est["mean"])
        _close(res["q0.5"][i], est["q0.5"])


def test_streamed_correlated_sweep_and_qmc_refusal():
    a = pt.Distribution("norm", loc=1.0, scale=2.0)
    b = pt.Distribution("lognorm", 0.4, scale=3.0)
    sink = a * b
    sink.correlate(a, b, corr_mat=np.array([[1.0, 0.6], [0.6, 1.0]]))
    res = pt.sweep(sink, {(a, "loc"): [0.0, 1.0, 2.0]}, size=1 << 13, block_size=1 << 11,
                   random_state=3, statistics=("mean", "q0.9"))
    est = _estimate_with(sink, a, "loc", 2.0, 1 << 13, 1 << 11, 3, quantiles=(0.9,))
    _close(res["mean"][2], est["mean"])
    _close(res["q0.9"][2], est["q0.9"])
    with pytest.raises(ValueError, match="Streamed QMC sweeps require a correlation-free"):
        pt.sweep(sink, {(a, "loc"): [0.0]}, size=1 << 10, block_size=1 << 8, method="sobol")


@pytest.mark.parametrize("method", ["sobol", "halton", "antithetic"])
def test_streamed_method_equals_one_shot(method):
    """The streamed method's blocks are rows b * block .. of the one-shot
    sequence: the statistics agree up to the order of float sums."""
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    y = pt.Exp(0.3 * x) + x
    opts = dict(size=1 << 12, random_state=4, method=method, statistics=("mean", "var"))
    whole = pt.sweep(y, {(x, "scale"): [0.5, 1.0, 2.0]}, **opts)
    blocks = pt.sweep(y, {(x, "scale"): [0.5, 1.0, 2.0]}, block_size=1 << 10, **opts)
    for name in ("mean", "var"):
        for s in range(3):
            _close(blocks[name][s], whole[name][s])


def test_replicates_draw_their_own_streams():
    """Replicate r is the sweep under _derive_seed(seed, 1, r); the result
    averages them and reports their spread."""
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    y = 2.0 * x + 1.0
    ladder = {(x, "loc"): [-1.0, 0.0, 1.0]}
    res = pt.sweep(y, ladder, size=1 << 13, block_size=1 << 10, random_state=0, replicates=4,
                   statistics=("mean", "std", "q0.9"))
    reps = [pt.sweep(y, ladder, size=1 << 11, block_size=1 << 10,
                     random_state=streaming._derive_seed(0, 1, r),
                     statistics=("mean", "std", "q0.9")) for r in range(4)]
    for name in ("mean", "std", "q0.9"):
        arr = np.stack([r[name] for r in reps])
        np.testing.assert_allclose(res[name], arr.mean(axis=0), rtol=1e-12)
        np.testing.assert_allclose(res[name + "_sem"], arr.std(axis=0, ddof=1) / 2.0, rtol=1e-12)
    np.testing.assert_array_equal(res["sem"], res["mean_sem"])
    assert np.abs(res["mean"] - np.array([-1.0, 1.0, 3.0])).max() < 5 * res["sem"].max()


def _sequential(replicates=2, **kwargs):
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    return pt.sweep(x * 1.0, {(x, "loc"): [0.0, 1.0]}, size=64, random_state=6,
                    replicates=replicates, **kwargs)


def test_sequential_sweep_converges():
    res = _sequential(replicates=4, target_sem=0.03)
    assert res.converged and res.rounds >= 2 and res.size == 64 * res.rounds
    assert res["sem"].max() <= 0.03
    assert set(res.keys()) == {"mean", "mean_sem", "sem"}


def test_sequential_budget_cap():
    res = _sequential(target_sem=1e-9, max_size=64 * 3)
    assert not res.converged and res.rounds == 3 and res.size == 64 * 3


def test_sequential_default_cap_is_64_rounds():
    res = _sequential(target_sem=1e-9)
    assert not res.converged and res.rounds == 64


def test_explicit_max_size_is_honoured_past_64_rounds():
    """R2 fixed: the JAX package stops this run at min(128, 64) rounds."""
    res = _sequential(target_sem=1e-9, max_size=128 * 64)
    assert not res.converged and res.rounds == 128 and res.size == 128 * 64


def test_sequential_rounds_draw_their_own_streams():
    """Round k of replicate r draws from _derive_seed(seed, 3, r, k)."""
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    res = pt.sweep(x * 1.0, {(x, "loc"): [0.0, 1.0]}, size=64, random_state=6, replicates=2,
                   target_sem=1e-9, max_size=64 * 2)
    rounds = [[pt.sweep(x * 1.0, {(x, "loc"): [0.0, 1.0]}, size=32,
                        random_state=streaming._derive_seed(6, 3, r, k))["mean"]
               for k in range(2)] for r in range(2)]
    per_rep = np.stack([np.mean(np.stack(r), axis=0) for r in rounds])
    np.testing.assert_allclose(res["mean"], per_rep.mean(axis=0), rtol=1e-12)


def test_streamed_chunks_fold_as_one_block(monkeypatch):
    """Past ``_BATCH_ELEMENTS`` values a block's scenarios fold chunk by
    chunk; the statistics are those of the whole block at once."""
    from probabilit_tpu_torch.engine import sweep as tsweep

    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    opts = dict(size=1 << 12, block_size=1 << 11, random_state=7,
                statistics=("mean", "var", "q0.9", "cvar0.9"))
    ladder = {(x, "loc"): [0.0, 0.5, 1.0, 1.5, 2.0]}
    whole = pt.sweep(pt.Exp(0.5 * x), ladder, **opts)
    monkeypatch.setattr(tsweep, "_BATCH_ELEMENTS", 2 << 11)
    chunked = pt.sweep(pt.Exp(0.5 * x), ladder, **opts)
    for name in whole.keys():
        np.testing.assert_allclose(chunked[name], whole[name], rtol=1e-12)
