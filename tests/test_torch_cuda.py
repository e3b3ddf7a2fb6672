"""The CUDA kernels against their plain twins, on the card.

Every test here needs an sm_90 card and skips without one; the decision
is made inside a fixture.  The file imports only the port, so on the
machine with the card it runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the megakernel, per kept node, max |kernel - twin| <=
1e-4 * max |twin| (correlated graphs given the same recolour transform;
a Newton family's node on the samples whose uniforms lie in
[0.001, 0.999], the sum of such nodes within the sum of their
tolerances);
the statistics kernel, each sum within 1e-5 * n of the twin's (every sum
is of n terms of magnitude about 1: z_k, z_j z_k).  They differ only where
nvcc contracts a*b+c into FMAs, where CUDA's libm rounds differently from
PyTorch's, in the order of float32 partial sums and, for the statistics
kernel, in its products' TF32 halves (about 2^-22 of a product) and the
tensor cores' truncating sums (about 1.3e-6 of a diagonal sum).  The three sort
kernels move bits and compare, so they equal their twins bitwise.  The
path processes run no kernel (the plain executor on the card): each
factory's slab on the card within 1e-4 of each path's largest magnitude
of the CPU's (a Newton factory on uniforms in [0.001, 0.999]).  The
megakernel is generated and built per graph structure at its first run
here (a few seconds each).
"""

import numpy as np
import pytest
import torch

from probabilit_tpu_torch import _build, config
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec, newton_tier, streaming
from probabilit_tpu_torch.models import benchmarks, graph as tg
from probabilit_tpu_torch.models.distributions import Distribution, EmpiricalDistribution
from probabilit_tpu_torch.ops import bitonic_sort as bs
from probabilit_tpu_torch.ops import fast_math

REL_TOL = 1e-4
STATS_TOL = 1e-5
N = 1 << 20


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; tests ask for their device."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available() or cuda_exec.environment_issue("cuda") is not None:
        pytest.skip("needs an sm_90 CUDA card")
    previous = config.device()
    config.set_device("cuda")
    try:
        yield
    finally:
        config.set_device(previous)


def _composite():
    a = Distribution("uniform", loc=1.0, scale=2.0)
    b = Distribution("norm", loc=a, scale=a * 0.5)
    c = Distribution("lognorm", s=0.2, scale=b * b + 1)
    return tg.Avg(a, b, c) + Distribution("triang", c=0.3, loc=b, scale=2)


def _many_ops():
    """Every transform the tape has, on float operands."""
    x = Distribution("uniform", loc=0.1, scale=0.8)
    y = Distribution("norm")
    z = Distribution("expon", scale=2.0)
    return tg.Add(
        tg.Max(x, y, 0.2), tg.Min(x, y), tg.FloorDivide(y, x), tg.Mod(y, -x),
        tg.Power(x, y), tg.Arctan2(y, x), tg.Sign(y) * tg.Abs(y),
        tg.Floor(y) + tg.Ceil(x), tg.IsClose(x, x * 1.000001) * 1.0,
        tg.All(x > 0.5, y > 0) * 2.0, tg.Any(x > 0.5, y < -1) * 3.0,
        tg.Equal(x, x) * 1.0 + tg.NotEqual(x, y) * 2.0 + (x <= y) * 3.0 - (x >= y),
        tg.Log(x) + tg.Log10(x) + tg.Log1p(z) + tg.Sqrt(z) + tg.Square(y),
        tg.Sin(y) + tg.Cos(y) + tg.Tan(x) + tg.Arcsin(x) + tg.Arccos(x) + tg.Arctan(y),
        tg.Sinh(x) + tg.Cosh(x) + tg.Tanh(y) + tg.Arcsinh(y) + tg.Arccosh(z + 1),
        tg.Arctanh(x) + tg.Expm1(x) + tg.Exp(-z) - (x / (z + 1)) + (-y),
        tg.Avg(x, y, z),
    )


GRAPHS = {
    "mixed_dag_20": benchmarks.mixed_dag_20,
    "height_model": benchmarks.height_model,
    "composite": _composite,
    "many_ops": _many_ops,
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRAPHS))
def test_kernel_matches_twin(cuda_card, name):
    sink = GRAPHS[name]()
    plan = tcompile.get_plan(sink)
    others = [node._id for node in plan.topo if node is not sink][-15:]
    order = cuda_exec.keep_order(plan, frozenset(others + [sink._id]))
    tape = cuda_exec.lowered(plan, order, "cuda")
    launches = cuda_exec.LAUNCHES
    got, nonfinite = cuda_exec.run(tape, (3, 4), N)
    ref = cuda_exec.run_reference(tape, (3, 4), N)
    assert cuda_exec.LAUNCHES == launches + 1
    assert int(nonfinite) == int((~torch.isfinite(ref)).any())
    for k in range(tape.n_keep):
        scale = ref[k].abs().max().item()
        assert (got[k] - ref[k]).abs().max().item() <= REL_TOL * scale, order[k]


@pytest.mark.cuda
def test_sample_through_the_kernel(cuda_card):
    sink = benchmarks.mixed_dag_20()
    launches = cuda_exec.LAUNCHES
    a = sink.sample(N, random_state=5, gc_strategy=[], executor="cuda")
    b = sink.sample(N, random_state=5, gc_strategy=[], executor="cuda")
    assert cuda_exec.LAUNCHES == launches + 2
    assert a.device.type == "cuda" and a.shape == (N,) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # deterministic per seed


@pytest.mark.cuda
def test_kernel_flags_non_finite_values(cuda_card):
    sink = tg.Log(Distribution("norm"))
    with pytest.raises(ValueError, match="non-finite"):
        sink.sample(N, random_state=0, gc_strategy=[], executor="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k, start, n",
    [(k, 0, N) for k in range(1, 17)]
    + [(k, start, n) for k in (10, 16) for start, n in ((5, N + 3), (7, N - 1), (3, 1), (2, 6))],
)
def test_stats_kernel_matches_twin(cuda_card, k, start, n):
    columns = [3 * j + 1 for j in range(k)]
    launches = cuda_exec.STATS_LAUNCHES
    got = cuda_exec.corr_stats((7, 8), n, columns, "cuda", start=start)
    again = cuda_exec.corr_stats((7, 8), n, columns, "cuda", start=start)
    ref = cuda_exec.corr_stats_reference((7, 8), n, columns, "cuda", start=start)
    assert cuda_exec.STATS_LAUNCHES == launches + 2
    assert got.dtype == torch.float64 and got.shape == (k + k * (k + 1) // 2,)
    torch.testing.assert_close(got, again, rtol=0, atol=0)  # no atomics: deterministic
    assert (got - ref).abs().max().item() <= max(STATS_TOL * n, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixed_correlated_50", "portfolio_model"])
def test_recoloured_kernel_matches_twin(cuda_card, name):
    sink = getattr(benchmarks, name)()
    plan = tcompile.get_plan(sink)
    keep = frozenset([sink._id] + [v._id for v in plan.corr_vars])
    order = cuda_exec.keep_order(plan, keep)
    tape = cuda_exec.lower(plan, order).to("cuda")
    ab = cuda_exec.recolor_transform(plan, (5, 6), N)
    got, _ = cuda_exec.run(tape, (5, 6), N, ab)
    ref = cuda_exec.run_reference(tape, (5, 6), N, ab)
    for k in range(tape.n_keep):
        scale = ref[k].abs().max().item()
        assert (got[k] - ref[k]).abs().max().item() <= REL_TOL * scale, order[k]
    # The recoloured scores carry the repaired target exactly (up to
    # float32): norm values, and the logs of lognorm values with loc = 0,
    # are linear in them.
    linear = {"norm": lambda x: x, "lognorm": torch.log}
    idx = [i for i, v in enumerate(plan.corr_vars) if v.distr in linear]
    y = torch.stack(
        [linear[plan.corr_vars[i].distr](got[order.index(plan.corr_vars[i]._id)]) for i in idx]
    )
    corr = torch.corrcoef(y.double()).cpu().numpy()
    np.testing.assert_allclose(corr, plan.corr_matrix[np.ix_(idx, idx)], atol=2e-3)


@pytest.mark.cuda
def test_correlated_sample_through_both_kernels(cuda_card):
    sink = benchmarks.mixed_correlated_50()
    launches = (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES)
    a = sink.sample(N, random_state=5, gc_strategy=[], executor="cuda")
    b = sink.sample(N, random_state=5, gc_strategy=[], executor="cuda")
    assert (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES) == (launches[0] + 2, launches[1] + 2)
    assert a.device.type == "cuda" and a.shape == (N,) and bool(torch.isfinite(a).all())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="imanconover"):
        sink.sample(N, gc_strategy=[], executor="cuda", correlator="cholesky")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixed_dag_20", "mixed_correlated_50"])
def test_kernels_match_their_twins_at_a_later_start(cuda_card, name):
    sink = getattr(benchmarks, name)()
    plan = tcompile.get_plan(sink)
    tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, {sink._id})).to("cuda")
    words, start = (11, 12), 3 * N  # the fourth block of a stream of N-blocks
    ab = None
    if plan.corr_vars:
        columns = [plan.col_of[v._id] for v in plan.corr_vars]
        got = cuda_exec.corr_stats(words, N, columns, "cuda", start=start)
        ref = cuda_exec.corr_stats_reference(words, N, columns, "cuda", start=start)
        first = cuda_exec.corr_stats_reference(words, N, columns, "cuda")
        assert (got - ref).abs().max().item() <= STATS_TOL * N
        assert (ref - first).abs().max().item() > 10 * STATS_TOL * N  # start moves the sums
        ab = cuda_exec.recolor_transform(plan, words, N, start=start, solve=streaming.RECOLOR_SOLVE)
    got, _ = cuda_exec.run(tape, words, N, ab, start=start)
    ref = cuda_exec.run_reference(tape, words, N, ab, start=start)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= REL_TOL * scale
    first = cuda_exec.run_reference(tape, words, N, ab)
    assert not torch.equal(ref, first)


@pytest.mark.cuda
@pytest.mark.parametrize("start,n", [(5, (1 << 18) + 3), (3, 1), (2, 3), (7, 6), (4, 1 << 18)])
@pytest.mark.parametrize("name", ["mixed_dag_20", "mixed_correlated_50"])
def test_kernels_at_a_start_and_n_that_are_no_multiples_of_four(cuda_card, name, start, n):
    sink = getattr(benchmarks, name)()
    plan = tcompile.get_plan(sink)
    others = [node._id for node in plan.topo if node is not sink][-3:]
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, frozenset(others + [sink._id])), "cuda")
    words, ab = (13, 14), None
    if plan.corr_vars:
        columns = [plan.col_of[v._id] for v in plan.corr_vars]
        got = cuda_exec.corr_stats(words, n, columns, "cuda", start=start)
        ref = cuda_exec.corr_stats_reference(words, n, columns, "cuda", start=start)
        assert (got - ref).abs().max().item() <= max(STATS_TOL * n, 1e-4)
        ab = cuda_exec.recolor_transform(plan, words, 1 << 18)
    got, flag = cuda_exec.run(tape, words, n, ab, start=start)
    ref = cuda_exec.run_reference(tape, words, n, ab, start=start)
    assert got.shape == (4, n) and int(flag) == 0
    for k in range(tape.n_keep):
        scale = ref[k].abs().max().item()
        assert (got[k] - ref[k]).abs().max().item() <= REL_TOL * scale
    # The same samples as rows of a run from 0 over a multiple of 4 (one
    # float4 store a row and group there): bitwise.
    whole, _ = cuda_exec.run(tape, words, -(-(start + n) // 4) * 4, ab)
    torch.testing.assert_close(got, whole[:, start:start + n], rtol=0, atol=0)


@pytest.mark.cuda
def test_graphs_that_differ_in_constants_share_one_build(cuda_card):
    def priced(loc, scale):
        x = Distribution("norm", loc=loc, scale=scale)
        return tg.Exp(x * 0.25) - Distribution("expon", scale=scale)

    outs, tapes = [], []
    for params in ((1.0, 2.0), (-3.5, 0.25)):
        sink = priced(*params)
        tape = cuda_exec.lowered(tcompile.get_plan(sink), [sink._id], "cuda")
        got, _ = cuda_exec.run(tape, (1, 2), N)
        ref = cuda_exec.run_reference(tape, (1, 2), N)
        assert (got - ref).abs().max().item() <= REL_TOL * ref.abs().max().item()
        if not tapes:
            libraries = len(_build._LIBS)  # the first run built and loaded the structure
        outs.append(got)
        tapes.append(tape)
    assert tapes[0].source == tapes[1].source and tapes[0].consts != tapes[1].consts
    assert len(_build._LIBS) == libraries and not torch.equal(outs[0], outs[1])
    key = _build.generated_key(tapes[0].source, cuda_exec._HEADERS)
    assert (_build.BUILD_DIR / f"graph_megakernel-{key}.so").exists()


@pytest.mark.cuda
def test_a_failed_build_raises_and_runs_nothing_else(cuda_card, monkeypatch, tmp_path):
    def forbidden(*args, **kwargs):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(cuda_exec, "run_reference", forbidden)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "--no-such-flag"))
    sink = tg.Tanh(Distribution("norm")) * 3.0
    launches = cuda_exec.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sink.sample(N, random_state=0, gc_strategy=[], executor="cuda")
    assert cuda_exec.LAUNCHES == launches and not list(tmp_path.glob("*.so"))


def _sort_inputs(key_dtype, payload_dtype, shape, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if key_dtype.is_floating_point:
        keys = torch.randn(shape, generator=g, device="cuda").to(key_dtype)
        flat = keys.view(-1)
        flat[::7] = torch.floor(flat[::7] * 4)  # duplicates (and no -0.0)
    else:
        keys = torch.randint(0, 500, shape, generator=g, device="cuda").to(key_dtype)
    payload = torch.arange(keys.numel(), device="cuda").reshape(shape).to(payload_dtype)
    return keys, payload


SORT_TYPES = [
    (torch.float32, torch.int32),
    (torch.int32, torch.float32),
    (torch.float64, torch.int64),
    (torch.int64, torch.float32),
    (torch.float32, torch.float64),
    (torch.int32, torch.int64),
    (torch.float64, torch.float32),
    (torch.int64, torch.float64),
]


def _bitwise(got, ref):
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("key_dtype, payload_dtype", SORT_TYPES)
def test_sort_kernels_match_their_twins(cuda_card, key_dtype, payload_dtype):
    # Tiles of 2^14 (4+4, 4+8, 8+4 bytes) and 2^13 (8+8: stage 14 takes a
    # K4 pass); K3 at T = 13 (sort_runs) and at the row sort's tile, over
    # rows of 2^15 (stage T descending in every other tile) and of 2^T;
    # stages 14 and 15 over whole rows, then stage 15 over rows of 2^16 (a
    # partial stage: its groups stay inside half a row).
    keys, payload = _sort_inputs(key_dtype, payload_dtype, (16, 64, 128))
    tile = bs._tile_log(keys.element_size(), payload.element_size())
    for n_pad_log in (15, tile):
        k, p = (t.reshape(-1).clone() for t in (keys, payload))
        bs._sort_tiles_(k, p, n_pad_log, tile)  # K3 in place
        _bitwise((k, p), bs.sort_tiles_reference(keys.reshape(-1), payload.reshape(-1), tile,
                                                 n_pad_log))
    odd = tuple(t[:15] for t in (keys, payload))
    _bitwise(bs.sort_runs(*odd), bs.sort_runs_reference(*odd))  # K3 at T = 13, odd R
    launches = (bs.RUNS_LAUNCHES, bs.EXCHANGE_LAUNCHES, bs.TAIL_LAUNCHES)
    runs = bs.sort_runs(keys, payload)  # K3
    _bitwise(runs, bs.sort_runs_reference(keys, payload))
    k4 = tuple(t[:4].reshape(1, 4, 64, 128) for t in runs)
    s14 = bs.merge_stage(*k4, 14)
    _bitwise(s14, bs.merge_stage_reference(*k4, 14))
    s15 = bs.merge_stage(*s14, 15)
    _bitwise(s15, bs.merge_stage_reference(*s14, 15))
    k8 = tuple(t.reshape(2, 8, 64, 128) for t in runs)
    m14 = bs.merge_stage_reference(*k8, 14)
    partial = bs.merge_stage(*m14, 15)
    _bitwise(partial, bs.merge_stage_reference(*m14, 15))
    passes = sum(len(bs._merge_plan(stage, tile)) - 1 for stage in (14, 15, 15))
    assert (bs.RUNS_LAUNCHES, bs.EXCHANGE_LAUNCHES, bs.TAIL_LAUNCHES) == (
        launches[0] + 1, launches[1] + passes, launches[2] + 3,
    )
    # Rows of 100,000 (2^17 padded) and of 12,000 (2^14: at T = 14 stage 14
    # is the last stage and runs inside K3's one launch).
    for n, merges in ((100_000, 17 - tile), (12_000, 14 - tile)):
        rows = tuple(t.reshape(3, -1) for t in _sort_inputs(key_dtype, payload_dtype, (3, n), 1))
        launches = (bs.RUNS_LAUNCHES, bs.TAIL_LAUNCHES)
        got = bs.bitonic_sort_rows(*rows)
        assert (bs.RUNS_LAUNCHES, bs.TAIL_LAUNCHES) == (launches[0] + 1, launches[1] + merges)
        _bitwise(got, bs.bitonic_sort_rows_reference(*rows))
        _bitwise((got[0],), (torch.sort(rows[0], dim=1).values,))


@pytest.mark.cuda
def test_sort_kernels_refuse_what_they_do_not_take(cuda_card, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(bs, "bitonic_sort_rows_reference", forbidden)
    keys = torch.randn((2, 1000), device="cuda")
    with pytest.raises(TypeError, match="keys"):
        bs.bitonic_sort_rows(keys.half(), torch.zeros_like(keys))
    with pytest.raises(TypeError, match="payload"):
        bs.bitonic_sort_rows(keys, torch.zeros((2, 1000), dtype=torch.int16, device="cuda"))
    with pytest.raises(ValueError, match="lie on"):
        bs.bitonic_sort_rows(keys, torch.zeros((2, 1000)))


@pytest.mark.cuda
def test_sample_streaming_equals_sample(cuda_card):
    sink = benchmarks.mixed_dag_20()
    launches = cuda_exec.LAUNCHES
    streamed = sink.sample_streaming(3 * N + 5, block_size=N, random_state=8, executor="cuda")
    assert cuda_exec.LAUNCHES == launches + 4
    single = sink.sample(3 * N + 5, random_state=8, gc_strategy=[], executor="cuda")
    np.testing.assert_array_equal(streamed, single.cpu().numpy())


@pytest.mark.cuda
def test_estimate_runs_the_kernels_block_by_block(cuda_card):
    sink = benchmarks.mixed_correlated_50()
    launches = (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES)
    st = sink.estimate(
        5 * N, block_size=N, random_state=0, quantiles=(0.5,), histogram=(0.0, 50.0, 20)
    )
    assert (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES) == (launches[0] + 5, launches[1] + 5)
    h = st["histogram"]
    assert h["counts"].sum() + h["underflow"] + h["overflow"] == 5 * N
    plan = tcompile.get_plan(sink)
    assert streaming._resolve_executor(plan, frozenset({sink._id}), "auto", "imanconover") == "cuda"


FAMILY_GRAPHS = list(benchmarks.family_graphs())
NEWTON_CENTRAL = (0.001, 0.999)


@pytest.mark.cuda
@pytest.mark.parametrize("label", FAMILY_GRAPHS)
def test_family_branches_match_twin(cuda_card, label):
    """Every kept node of a family graph; a Newton node on the samples
    whose uniforms lie in [0.001, 0.999] (in the float32 tails the kernel's
    and the twin's rounding freeze a lane at different points)."""
    sink, nodes = benchmarks.family_graphs()[label]
    plan = tcompile.get_plan(sink)
    keep = {sink._id} | {node._id for _, node in nodes}
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep), "cuda")
    words = cuda_exec.seed_words(8)
    got, flag = cuda_exec.run(tape, words, N)
    U = cuda_exec.philox_uniforms(words, N, plan.d, device="cuda")
    ref = cuda_exec.run_tape(tape, U)
    assert int(flag) == 0
    central = (U >= NEWTON_CENTRAL[0]) & (U <= NEWTON_CENTRAL[1])
    terms = sum(ref[k].abs().max() for k, nid in enumerate(tape.keep_order) if nid != sink._id)
    for k, nid in enumerate(tape.keep_order):
        err = (got[k] - ref[k]).abs()
        if label != "newton":
            assert err.max() <= REL_TOL * ref[k].abs().max(), k
        elif nid == sink._id:
            assert err[central.all(dim=1)].max() <= REL_TOL * terms
        else:
            assert err[central[:, plan.col_of[nid]]].max() <= REL_TOL * ref[k].abs().max(), k
    if label == "newton":
        # The Newton tier against its transcription on the same quantiles.
        args = {name: a for name, a, _ in benchmarks.FAMILY_SWEEP}
        for name, node in nodes:
            q = U[:, plan.col_of[node._id]]
            x = newton_tier.ppf(name, q, args[name])[0]
            want = node.kwargs.get("loc", 0.0) + node.kwargs.get("scale", 1.0) * x
            k = tape.keep_order.index(node._id)
            held = central[:, plan.col_of[node._id]]
            assert (got[k] - want).abs()[held].max() <= REL_TOL * want.abs().max(), name


# The closed forms alone: FAMILY_SWEEP's parameters, the first five's here.
FIRST_FIVE = {
    "uniform": ((), {"loc": 1.0, "scale": 2.0}),
    "norm": ((), {"loc": 1.0, "scale": 2.0}),
    "expon": ((), {"scale": 2.0}),
    "lognorm": ((0.5,), {"scale": 2.0}),
    "triang": ((0.4,), {"loc": 1.0, "scale": 2.0}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", cuda_exec._CLOSED_FORM_FAMILIES)
def test_each_closed_form_family_alone_matches_twin_and_transcription(cuda_card, name):
    # At an unaligned start: the first and last groups are partial.  The
    # rewritten bodies (csrc/fast_math.cuh) are also held to their PyTorch
    # transcription (ops/fast_math.py) on the same uniforms.
    sweep = {family: (a, k) for family, a, k in benchmarks.FAMILY_SWEEP}
    args, kwargs = FIRST_FIVE.get(name) or sweep[name]
    sink = Distribution(name, *args, **kwargs)
    tape = cuda_exec.lowered(tcompile.get_plan(sink), [sink._id], "cuda")
    words = cuda_exec.seed_words(10)
    start, n = 5, N + 3
    got, flag = cuda_exec.run(tape, words, n, start=start)
    U = cuda_exec.philox_uniforms(words, n, 1, device="cuda", start=start)
    ref = cuda_exec.run_tape(tape, U)
    assert int(flag) == 0
    scale = ref.abs().max()
    assert (got - ref).abs().max() <= REL_TOL * scale
    if name in fast_math.FAMILIES:
        want = fast_math.value(name, U[:, 0], args, kwargs)
        assert (got[0] - want).abs().max() <= REL_TOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("name", cuda_exec.INCOMPLETE_FAMILY_CAPS)
def test_each_newton_family_alone_matches_twin(cuda_card, name):
    # One Newton node: a turn covers NEWTON_SLOTS groups a thread (48 KB
    # of quantiles in shared memory).
    args = {family: a for family, a, _ in benchmarks.FAMILY_SWEEP}[name]
    sink = Distribution(name, *args)
    plan = tcompile.get_plan(sink)
    tape = cuda_exec.lowered(plan, [sink._id], "cuda")
    assert tape.newton_groups == cuda_exec.NEWTON_SLOTS
    words = cuda_exec.seed_words(6)
    got, flag = cuda_exec.run(tape, words, N)
    U = cuda_exec.philox_uniforms(words, N, plan.d, device="cuda")
    ref = cuda_exec.run_tape(tape, U)
    assert int(flag) == 0
    held = (U[:, 0] >= NEWTON_CENTRAL[0]) & (U[:, 0] <= NEWTON_CENTRAL[1])
    assert (got[0] - ref[0]).abs()[held].max() <= REL_TOL * ref[0].abs().max()


@pytest.mark.cuda
def test_newton_graph_at_an_unaligned_start(cuda_card):
    # The block's solves cover partial first and last groups; every row
    # equals the aligned run's, and the twin's as phase 14 holds them.
    sink, nodes = benchmarks.family_graphs()["newton"]
    plan = tcompile.get_plan(sink)
    keep = {sink._id} | {node._id for _, node in nodes}
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep), "cuda")
    words = cuda_exec.seed_words(9)
    start, n = 5, (1 << 22) + 3
    got, flag = cuda_exec.run(tape, words, n, start=start)
    whole, _ = cuda_exec.run(tape, words, -(-(start + n) // 4) * 4)
    assert int(flag) == 0
    assert torch.equal(got, whole[:, start:start + n])
    for tiny in (1, 2, 3, 6):
        part, _ = cuda_exec.run(tape, words, tiny, start=start - 2)
        assert torch.equal(part, whole[:, start - 2:start - 2 + tiny])
    U = cuda_exec.philox_uniforms(words, n, plan.d, device="cuda", start=start)
    ref = cuda_exec.run_tape(tape, U)
    central = (U >= NEWTON_CENTRAL[0]) & (U <= NEWTON_CENTRAL[1])
    for k, nid in enumerate(tape.keep_order):
        if nid != sink._id:
            err = (got[k] - ref[k]).abs()[central[:, plan.col_of[nid]]].max()
            assert err <= REL_TOL * ref[k].abs().max(), k


@pytest.mark.cuda
def test_portfolio_through_both_kernels(cuda_card):
    sink, _ = benchmarks.portfolio_var()
    plan = tcompile.get_plan(sink)
    keep = {sink._id} | {v._id for v in plan.corr_vars}
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep), "cuda")
    words = cuda_exec.seed_words(2)
    ab = cuda_exec.recolor_transform(plan, words, N, device="cuda")
    got, flag = cuda_exec.run(tape, words, N, ab)
    ref = cuda_exec.run_reference(tape, words, N, ab)
    assert int(flag) == 0
    for k in range(tape.n_keep):
        assert (got[k] - ref[k]).abs().max() <= REL_TOL * ref[k].abs().max(), k
    # K1 in blocks, as a stream launches it, equals one launch bitwise.
    blocks = [cuda_exec.run(tape, words, min(N // 3, N - lo), ab, start=lo)[0]
              for lo in range(0, N, N // 3)]
    assert torch.equal(torch.cat(blocks, dim=1), got)
    launches, stats = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES
    x = sink.sample(N, random_state=0, gc_strategy=[], executor="cuda")
    assert cuda_exec.LAUNCHES == launches + 1 and cuda_exec.STATS_LAUNCHES == stats + 1
    assert x.device.type == "cuda" and bool(torch.isfinite(x).all())


def _table_nodes(sink, nodes):
    """The table rows of a lowered graph: every kept node but the sink is a
    table node fed by a drawn column, which the kernel computes bitwise as
    the twin does (searches, and one rounding per interval operation)."""
    return {node._id for node in nodes.values()} - {sink._id}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["large_table", "table_risk"])
def test_table_branch_matches_twin(cuda_card, name):
    if name == "large_table":
        sink = benchmarks.large_table()
        nodes = {"poisson": next(iter(sink.get_parents()))}
    else:
        sink, nodes = benchmarks.table_risk()
    plan = tcompile.get_plan(sink)
    keep = {sink._id} | {node._id for node in nodes.values()}
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep), "cuda")
    words = cuda_exec.seed_words(12)
    launches = cuda_exec.LAUNCHES
    got, flag = cuda_exec.run(tape, words, N)
    ref = cuda_exec.run_reference(tape, words, N)
    assert cuda_exec.LAUNCHES == launches + 1 and int(flag) == 0
    tables = _table_nodes(sink, nodes)
    for k, nid in enumerate(tape.keep_order):
        if nid in tables:
            assert torch.equal(got[k], ref[k]), k
        else:
            assert (got[k] - ref[k]).abs().max() <= REL_TOL * ref[k].abs().max(), k
    x = sink.sample(N, random_state=3, gc_strategy=[], executor="cuda")
    assert x.device.type == "cuda" and bool(torch.isfinite(x).all())


@pytest.mark.cuda
def test_tables_above_48_kb_of_shared_memory(cuda_card):
    rng = np.random.default_rng(4)
    parts = [EmpiricalDistribution(rng.lognormal(size=512)) for _ in range(12)]
    sink = tg.Add(*parts)
    plan = tcompile.get_plan(sink)
    keep = {sink._id} | {p._id for p in parts}
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep), "cuda")
    assert 48 * 1024 < tape.shared_bytes <= cuda_exec.MAX_SHARED_BYTES
    words = cuda_exec.seed_words(13)
    got, flag = cuda_exec.run(tape, words, N)
    ref = cuda_exec.run_reference(tape, words, N)
    assert int(flag) == 0
    for k, nid in enumerate(tape.keep_order):
        if nid == sink._id:
            assert (got[k] - ref[k]).abs().max() <= REL_TOL * ref[k].abs().max()
        else:
            assert torch.equal(got[k], ref[k]), k


def _tables_at_the_cap(newton):
    """Empirical tables of 512 points summed until the block's shared memory
    is nearly full: 22 beside 16 correlated normals, or 14 beside a gamma
    and a beta node (the Newton tier's quantiles).  Their guides shrink."""
    rng = np.random.default_rng(6)
    parts = [EmpiricalDistribution(rng.lognormal(size=512)) for _ in range(14 if newton else 22)]
    if newton:
        return tg.Add(*parts, Distribution("gamma", 2.5), Distribution("beta", 2.0, 3.0)), parts
    drivers = [Distribution("norm") for _ in range(16)]
    sink = tg.Add(*parts, *drivers)
    sink.correlate(*drivers, corr_mat=np.eye(16) * 0.5 + 0.5)
    return sink, parts


@pytest.mark.cuda
@pytest.mark.parametrize("newton", [False, True])
def test_tables_at_the_shared_memory_cap_with_shrunk_guides(cuda_card, newton):
    sink, parts = _tables_at_the_cap(newton)
    plan = tcompile.get_plan(sink)
    keep = {sink._id} | {p._id for p in parts[:15]}
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep), "cuda")
    assert tape.guides and tape.shared_bytes <= cuda_exec.MAX_SHARED_BYTES
    words = cuda_exec.seed_words(15)
    ab = cuda_exec.recolor_transform(plan, words, N, device="cuda") if tape.n_corr else None
    got, flag = cuda_exec.run(tape, words, N, ab)
    ref = cuda_exec.run_reference(tape, words, N, ab)
    assert int(flag) == 0
    for k, nid in enumerate(tape.keep_order):
        if nid == sink._id:
            assert (got[k] - ref[k]).abs().max() <= REL_TOL * ref[k].abs().max()
        else:
            assert torch.equal(got[k], ref[k]), k


@pytest.mark.cuda
def test_correlated_table_drivers_through_both_kernels(cuda_card):
    sink, nodes = benchmarks.table_risk_correlated()
    plan = tcompile.get_plan(sink)
    keep = {sink._id} | {v._id for v in plan.corr_vars}
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep), "cuda")
    words = cuda_exec.seed_words(14)
    ab = cuda_exec.recolor_transform(plan, words, N, device="cuda")
    got, flag = cuda_exec.run(tape, words, N, ab)
    ref = cuda_exec.run_reference(tape, words, N, ab)
    assert int(flag) == 0
    # The count's quantile went through the hardware's ndtr_fast: it may
    # cross a CDF step, and then the sink moves by one order's margin.  The
    # sink is held where the counts agree.
    k_orders = tape.keep_order.index(nodes["orders"]._id)
    err = (got[k_orders] - ref[k_orders]).abs()
    assert err.max() <= 1 and (err > 0).float().mean() <= 1e-3
    same = err == 0
    for k, nid in enumerate(tape.keep_order):
        if k != k_orders:
            err = (got[k] - ref[k]).abs()[same]
            assert err.max() <= REL_TOL * ref[k].abs().max(), k


def _held_where_typed_nodes_agree(got, ref, typed):
    """K1 against its twin on a breach graph: the int and bool rows
    ``typed`` equal but on at most 1e-4 of the samples (a cost within
    the kernel's rounding of a budget), and off by at most 1 there; the
    float rows within REL_TOL where every typed row agrees."""
    same = torch.ones(got.shape[1], dtype=torch.bool, device=got.device)
    for k in typed:
        err = (got[k] - ref[k]).abs()
        assert err.max() <= 1 and (err > 0).float().mean() <= 1e-4, k
        same &= err == 0
    for k in range(got.shape[0]):
        if k not in typed:
            err = (got[k] - ref[k]).abs()[same]
            assert err.max() <= REL_TOL * ref[k].abs().max(), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["breach_count", "breach_count_correlated"])
def test_breach_count_kernel_matches_twin(cuda_card, name):
    loss, nodes = getattr(benchmarks, name)()
    plan = tcompile.get_plan(loss)
    typed_ids = [nodes[k]._id for k in ("overruns", "late", "tier")]
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, {loss._id, *typed_ids}), "cuda")
    words = cuda_exec.seed_words(15)
    ab = cuda_exec.recolor_transform(plan, words, N, device="cuda") if plan.corr_vars else None
    got, flag = cuda_exec.run(tape, words, N, ab)
    ref = cuda_exec.run_reference(tape, words, N, ab)
    assert int(flag) == 0
    _held_where_typed_nodes_agree(got, ref, [tape.keep_order.index(i) for i in typed_ids])


@pytest.mark.cuda
def test_typed_ops_kernel_equals_twin_bitwise(cuda_card):
    sink, leaves, _ = benchmarks.typed_ops()
    plan = tcompile.get_plan(sink)
    ids = [node._id for node in leaves.values()]
    words = cuda_exec.seed_words(16)
    for i in range(0, len(ids), 15):
        tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, {sink._id, *ids[i:i + 15]}), "cuda")
        got, _ = cuda_exec.run(tape, words, N)
        torch.testing.assert_close(got, cuda_exec.run_reference(tape, words, N), rtol=0, atol=0)


@pytest.mark.cuda
def test_severe_estimate_through_the_kernel(cuda_card):
    """estimate(severe) on K1 is the probability of three or more
    overruns, 0.1693, sequentially and with a checkpoint."""
    _, nodes = benchmarks.breach_count()
    severe = nodes["severe"]
    launches = cuda_exec.LAUNCHES
    st = streaming.estimate(severe, 1 << 22, block_size=1 << 20, random_state=0,
                            executor="cuda", target_rel_sem=2e-3)
    assert cuda_exec.LAUNCHES > launches and st["converged"]
    assert abs(st["mean"] - 0.1693) < 5 * st["sem"] + 5e-5
    cuda = streaming.estimate(severe, 1 << 22, block_size=1 << 20, random_state=1, executor="cuda")
    plain = streaming.estimate(severe, 1 << 22, block_size=1 << 20, random_state=1, executor=None)
    assert abs(cuda["mean"] - plain["mean"]) < 5 * np.hypot(cuda["sem"], plain["sem"])


@pytest.mark.cuda
def test_estimate_many_runs_on_the_card(cuda_card):
    """The NoOp sink runs the plain executor on the card: the carries lie on
    the card, each node's mean agrees with its own estimate within 5
    standard errors, and executor="cuda" refuses the NoOp sink."""
    sink = benchmarks.mixed_dag_20()
    plan = tcompile.get_plan(sink)
    nodes = [node for node in plan.topo if not isinstance(node, tg.Constant)][-4:]
    carry = streaming._many_carry(nodes, 1 << 21, 1 << 19, 3, "auto", quantiles=(0.5,),
                                  covariance=True)
    assert all(v.device.type == "cuda" for v in carry)
    out = streaming.estimate_many(nodes, 1 << 21, block_size=1 << 19, random_state=3,
                                  quantiles=(0.5,), covariance=True)
    for node in nodes:
        one = streaming.estimate(node, 1 << 21, block_size=1 << 19, random_state=4)
        st = out[node]
        assert abs(st["mean"] - one["mean"]) <= 5 * np.hypot(st["sem"], one["sem"])
        assert st["cov"].shape == (len(nodes),)
    with pytest.raises(ValueError, match="not eligible for executor='cuda'"):
        streaming.estimate_many(nodes, 1 << 20, block_size=1 << 19, executor="cuda")
    assert config.device().type == "cuda"


@pytest.mark.cuda
def test_scalar_transform_on_the_card(cuda_card):
    """torch.vmap of f(x, y) = x * y + 1 on the card within 1 float32 ulp of
    the operators; an untraceable function runs the host loop and its
    result comes back to the card."""
    sink = benchmarks.mixed_dag_20()
    x, y = [node for node in tcompile.get_plan(sink).topo if node._is_distribution][:2]
    f = tg.scalar_transform(lambda a, b: a * b + 1)
    out = f(x, y).sample(1 << 20, random_state=0)
    want = x.samples_ * y.samples_ + 1
    assert out.device.type == "cuda"
    assert ((out - want).abs() <= torch.finfo(torch.float32).eps * want.abs()).all()

    @tg.scalar_transform
    def positive_part(a):
        if a > 0:
            return a
        return 0.0

    with pytest.warns(UserWarning, match="host loop"):
        host = positive_part(x - 50.0).sample(1000, random_state=0)
    assert host.device.type == "cuda" and bool((host >= 0).all())
    with pytest.raises(ValueError, match="scalar_transform"):
        f(x, y).sample(1000, random_state=0, gc_strategy=[], executor="cuda")


# --- The path processes: plain PyTorch on the card, no kernel ----------------------------


def _path_uniforms(n, d, seed, newton):
    q = np.random.default_rng(seed).integers(1, 2**23, (n, d)) / 2**23
    return 0.001 + 0.998 * q if newton else q


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(benchmarks.path_families(steps=16)))
def test_path_family_on_the_card_equals_the_cpu(cuda_card, name):
    """One slab through each factory on the card and on the CPU: every path
    within 1e-4 of its largest magnitude (the CPU parity tolerance; a
    Newton factory on uniforms in [0.001, 0.999]); no kernel launched."""
    fam = benchmarks.path_families(steps=32)[name]
    node = getattr(fam.surface, "joint", fam.surface)
    q = _path_uniforms(4096, tcompile.get_plan(node).d_total, 3, fam.newton)
    launches = cuda_exec.LAUNCHES
    on_card = node.sample_from_quantiles(q)
    assert on_card.device.type == "cuda" and cuda_exec.LAUNCHES == launches
    config.set_device("cpu")
    try:
        on_cpu = node.sample_from_quantiles(q).double()
    finally:
        config.set_device("cuda")
    rows = on_cpu.reshape(4096, -1)
    err = (on_card.cpu().double().reshape(4096, -1) - rows).abs().amax(dim=1)
    assert bool((err <= REL_TOL * rows.abs().amax(dim=1)).all()), name


@pytest.mark.cuda
def test_path_graph_runs_without_the_kernels(cuda_card):
    """A path graph launches neither K1 nor K2 under executor="auto", and
    executor="cuda" refuses it; a streamed Sobol run equals one shot."""
    fam = benchmarks.path_families(steps=64)["gbm"]
    g = fam.surface
    payoff = (g.maximum() < 130) * (g.terminal() - 100)
    launches, stats = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES
    st = streaming.estimate(g.terminal(), 1 << 18, block_size=1 << 16, random_state=0,
                            executor="auto")
    assert (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES) == (launches, stats)
    assert abs(st["mean"] - fam.mean) <= 5 * st["sem"]
    with pytest.raises(ValueError, match="path processes"):
        payoff.sample(1 << 10, random_state=0, gc_strategy=[], executor="cuda")
    t = g.terminal()
    full = t.sample(1 << 16, random_state=1, method="sobol").cpu().numpy()
    blocks = streaming.sample_streaming(t, 1 << 16, block_size=1 << 13, random_state=1,
                                        method="sobol")
    np.testing.assert_array_equal(full, blocks)


# --- Sensitivities and Sobol' indices: autograd through the plain executor --------------


@pytest.mark.cuda
def test_sensitivity_on_the_card_equals_the_cpu(cuda_card):
    """mixed_dag_20's 16 parameter gradients on one 2^18 quantile matrix:
    the card within 1e-4 of max(1, |gradient|) of the CPU; no kernel."""
    from probabilit_tpu_torch.engine import sensitivity as sens

    sink = benchmarks.mixed_dag_20()
    plan = tcompile.get_plan(sink)
    pairs = [(n, s) for n in plan.isns for s in sens._numeric_slots(n)]
    theta = [float(sens._read_slot(n, s)) for n, s in pairs]
    fn = sens._build_grad_fn(plan, pairs, torch.mean, tcompile.resolve_correlator("imanconover"),
                             drawn=False)
    q = np.random.default_rng(16).integers(1, 2**23, (1 << 18, plan.d)) / 2**23
    launches, stats = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES

    def on(device):
        value, grad = fn(torch.tensor(theta, device=device),
                         torch.as_tensor(q, dtype=torch.float32, device=device))
        return float(value), grad.cpu().double().numpy()

    card = on("cuda")
    cpu = on("cpu")
    assert (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES) == (launches, stats)
    assert abs(card[0] - cpu[0]) <= 1e-5 * abs(cpu[0])
    assert np.all(np.abs(card[1] - cpu[1]) <= REL_TOL * np.maximum(1.0, np.abs(cpu[1])))


@pytest.mark.cuda
def test_streamed_sensitivity_and_sobol_run_without_the_kernels(cuda_card):
    """A streamed gradient, a correlated one and Sobol' indices on the card
    launch neither K1 nor K2; the streamed value is the estimate's."""
    from probabilit_tpu_torch.engine import sensitivity as sens

    sink = benchmarks.mixed_dag_20()
    isns = tcompile.get_plan(sink).isns
    launches, stats = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES
    res = sens.sensitivity(sink, wrt=isns, size=1 << 22, block_size=1 << 20, random_state=4)
    est = streaming.estimate(sink, 1 << 22, block_size=1 << 20, random_state=4, executor=None)
    assert abs(res.value - est["mean"]) <= 1e-6 * abs(est["mean"])
    a, b = Distribution("norm"), Distribution("norm", loc=1.0, scale=2.0)
    s = (a + b) ** 2
    s.correlate(a, b, corr_mat=np.array([[1.0, 0.7], [0.7, 1.0]]))
    corr = sens.sensitivity(s, wrt={b: ["scale"]}, size=1 << 20, block_size=1 << 18,
                            random_state=0)
    assert abs(corr[(b, "scale")] - 5.4) <= 0.05 * 5.4
    sob = sens.sobol_indices(sink, size=1 << 16, random_state=0)
    assert 0.0 < sob.variance and all(np.isfinite(list(sob.first_order.values())))
    assert (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES) == (launches, stats)
