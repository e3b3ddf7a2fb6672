"""The fold kernel (``csrc/block_fold.cu``) against its plain twin, and the
packed carry it folds into.

The CPU tests hold the dispatch (a block on the CPU takes the plain twin,
``streaming._block_moments`` and ``_merge``, and launches nothing) and the
packed carry's layout (its 13 views equal the plain carry field by field
and dtype by dtype).  The card tests need an sm_90 card and skip without
one; the decision is made inside a fixture.  The file imports only the
port, so on the machine with the card it runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_block_fold.py

On the card each case folds one block into a carry with the kernel and
with the plain twin on the same tensors.  Both accumulate every sample in
float64 but sum in other orders (the twin: one pass over the block; the
kernel: a two-pass over 16 samples a thread, Pébay merges after), so the
float64 fields agree to rounding: within FOLD_TOL of their scale (the
mean and y's mean against their standard deviations, M2, M2y and M4
relative, M3 against n sd^3, Cxy against sqrt(M2 M2y)).  The count, min,
max and the finite flag are exact.
"""

import numpy as np
import pytest
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import cuda_exec, streaming
from probabilit_tpu_torch.models.distributions import Distribution

FOLD_TOL = 1e-10
BLOCK = 1 << 24


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


def _graph_with_aux():
    """A sink, a control of known mean 1 that it depends on, and a
    condition that accepts about a third of its samples."""
    control = Distribution("norm", loc=1.0, scale=0.5)
    sink = Distribution("lognorm", s=0.5, scale=2.0) * 3.0 + control
    return sink, control, sink > 8.0


# --- On the CPU -------------------------------------------------------


AUX = ["none", "control", "where"]


def _cpu_carry(aux, moments, size=3 * 4096 + 17, block=4096):
    sink, control, cond = _graph_with_aux()
    return streaming._estimate_carry(
        sink, size, block, 11, None, quantiles=(0.5,), histogram=(0.0, 400.0, 8),
        moments=moments, control_node=control if aux == "control" else None,
        where_node=cond if aux == "where" else None,
    )


@pytest.mark.parametrize("aux", AUX)
def test_cpu_blocks_take_the_plain_twin(aux):
    """A CPU ``_estimate_carry`` launches no fold kernel and equals the
    plain twin's fold of the very blocks it draws."""
    sink, control, cond = _graph_with_aux()
    node = {"none": None, "control": control, "where": cond}[aux]
    size, block = 2 * 4096 + 5, 4096
    launches = cuda_exec.FOLD_LAUNCHES
    carry = streaming._estimate_carry(
        sink, size, block, 3, None, moments=True,
        control_node=node if aux == "control" else None,
        where_node=node if aux == "where" else None,
    )
    assert cuda_exec.FOLD_LAUNCHES == launches
    _, run = streaming._block_program(sink, block, None, extra=node, total_size=size)
    want = streaming._initial_carry(0, 0, "cpu")
    for b, cnt in enumerate((block, block, 5)):
        x, y = run(b, 3)
        stats = streaming._block_moments(x.to(torch.float32), y, cnt, aux == "where", True)
        want = streaming._merge(want, (*stats, want[6], want[10]), aux == "where", True)
    for got, ref in zip(carry, want):
        assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("aux", AUX)
def test_packed_carry_views_equal_the_plain_carry(aux, moments):
    carry = _cpu_carry(aux, moments)
    packed = cuda_exec.pack_moments(carry)
    assert packed.dtype == torch.float64 and packed.shape == (cuda_exec.FOLD_FIELDS,)
    views = cuda_exec.unpack_moments(packed, carry[6], carry[10])
    assert len(views) == len(carry) == 13
    for i, (got, ref) in enumerate(zip(views, carry)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, i
        assert torch.equal(got, ref), i
    for i in cuda_exec.PACKED_FIELDS:
        if i != 5:  # finite is a bool made from its 1.0 / 0.0
            assert views[i].untyped_storage().data_ptr() == packed.untyped_storage().data_ptr()


def test_packed_empty_carry_is_the_kernels_identity():
    packed = cuda_exec.pack_moments(streaming._initial_carry(2, 3, "cpu"))
    want = [0.0, 0.0, 0.0, np.inf, -np.inf, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    assert packed.tolist() == want


def test_block_fold_takes_cuda_tensors_only():
    carry = cuda_exec.pack_moments(streaming._initial_carry(0, 0, "cpu"))
    launches = cuda_exec.FOLD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_exec.block_fold(carry, torch.ones(8), None, 8, False, True, (None, None))
    assert cuda_exec.FOLD_LAUNCHES == launches


# --- On the card ------------------------------------------------------


def _lognormal(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.lognormal(1.0, 0.75, size=n).astype(np.float32)).cuda()


def _carry_with(blocks, where_mode=False, moments=True):
    """A plain carry on the card holding ``blocks`` ((x, y) pairs)."""
    carry = streaming._initial_carry(0, 0, "cuda")
    for x, y in blocks:
        stats = streaming._block_moments(x, y, x.numel(), where_mode, moments)
        carry = streaming._merge(carry, (*stats, carry[6], carry[10]), where_mode, moments)
    return carry


def _fold_both(carry, x, y, cnt, where_mode, moments):
    """(kernel, plain twin): ``carry`` with the block folded in."""
    packed = cuda_exec.pack_moments(carry)
    cuda_exec.block_fold(packed, x, y, cnt, where_mode, moments, cuda_exec.fold_scratch("cuda"))
    got = cuda_exec.unpack_moments(packed, carry[6], carry[10])
    stats = streaming._block_moments(x, y, cnt, where_mode, moments)
    want = streaming._merge(carry, (*stats, carry[6], carry[10]), where_mode, moments)
    return _scalars(got), _scalars(want)


def _scalars(carry):
    """A carry's fields as Python numbers (None for the quantile sums and
    histogram counts, which these folds leave empty)."""
    return [v.item() if v.dim() == 0 else None for v in carry]


def _assert_fold_close(got, want, finite=True):
    n, mean, m2, lo, hi, fin, _, my, m2y, cxy, _, m3, m4 = want
    assert got[0] == n and got[5] == fin
    np.testing.assert_array_equal([got[3], got[4]], [lo, hi])
    if not finite:
        assert not fin
        return
    sd = (m2 / n) ** 0.5 if n else 0.0
    sd_y = (m2y / n) ** 0.5 if n else 0.0
    scales = {
        1: sd, 2: m2, 7: sd_y, 8: m2y, 9: (m2 * m2y) ** 0.5, 11: n * sd**3, 12: m4,
    }
    for i, scale in scales.items():
        assert abs(got[i] - want[i]) <= FOLD_TOL * scale, (i, got[i], want[i])


@pytest.mark.cuda
@pytest.mark.parametrize("moments", [False, True])
def test_fold_matches_twin(cuda_card, moments):
    x = _lognormal(BLOCK, 1)
    got, want = _fold_both(streaming._initial_carry(0, 0, "cuda"), x, None, BLOCK, False, moments)
    _assert_fold_close(got, want)
    if not moments:
        assert got[11] == got[12] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_fold_with_a_control_matches_twin(cuda_card, dtype):
    """A control of another dtype than float32 or float64 is folded as float64."""
    x = _lognormal(BLOCK, 2)
    y = (0.5 * x.double().log() + torch.randn(BLOCK, device="cuda", dtype=torch.float64))
    y = (y * 10.0).to(dtype) if dtype == torch.int32 else y.to(dtype)
    got, want = _fold_both(streaming._initial_carry(0, 0, "cuda"), x, y, BLOCK, False, True)
    _assert_fold_close(got, want)
    assert want[9] > 0.1 * (want[2] * want[8]) ** 0.5  # a correlated control


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype", [torch.bool, torch.int32, torch.float32, torch.float64, torch.int64, torch.float16]
)
@pytest.mark.parametrize("accepts", ["some", "none"])
def test_fold_under_where_matches_twin(cuda_card, dtype, accepts):
    """Rejected samples are NaN or inf: the kernel never reads them in.  A
    condition of another dtype than bool, int32, float32 or float64 is
    folded as ``y != 0``."""
    x = _lognormal(BLOCK, 3)
    keep = x > 3.0 if accepts == "some" else torch.zeros(BLOCK, dtype=torch.bool, device="cuda")
    x = torch.where(keep | (torch.arange(BLOCK, device="cuda") % 3 != 0), x, torch.nan)
    x = torch.where(keep | (torch.arange(BLOCK, device="cuda") % 3 != 1), x, -torch.inf)
    prior = _carry_with([(_lognormal(4096, 4), torch.ones(4096, device="cuda"))], True)
    got, want = _fold_both(prior, x, keep.to(dtype), BLOCK, True, True)
    _assert_fold_close(got, want)
    assert want[5]
    if accepts == "none":
        assert got == _scalars(prior)  # a no-op merge


@pytest.mark.cuda
@pytest.mark.parametrize("cnt", [1, 3, 4097, (1 << 20) + 12345])
def test_partial_block_folds_its_first_cnt_samples(cuda_card, cnt):
    x = _lognormal(1 << 21, 5)
    x[cnt:] = torch.nan  # never read
    y = _lognormal(1 << 21, 6)
    for aux in (None, y):
        got, want = _fold_both(streaming._initial_carry(0, 0, "cuda"), x, aux, cnt, False, True)
        if cnt == 1:
            assert got[0] == 1.0 and got[1] == want[1] and got[2] == 0.0
        _assert_fold_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["nan", "inf", "-inf", "both_inf"])
def test_nonfinite_block_clears_finite(cuda_card, bad):
    x = _lognormal(BLOCK, 7)
    if bad in ("nan", "inf", "-inf"):
        x[123457] = {"nan": torch.nan, "inf": torch.inf, "-inf": -torch.inf}[bad]
    else:
        x[99] = torch.inf
        x[BLOCK - 7] = -torch.inf
    got, want = _fold_both(streaming._initial_carry(0, 0, "cuda"), x, None, BLOCK, False, True)
    _assert_fold_close(got, want, finite=False)


@pytest.mark.cuda
def test_fold_into_a_carry_with_prior_blocks(cuda_card):
    prior = _carry_with([(_lognormal(BLOCK, 8), None), (_lognormal(BLOCK, 9) + 3.0, None)])
    got, want = _fold_both(prior, _lognormal(BLOCK, 10) * 2.0, None, BLOCK, False, True)
    _assert_fold_close(got, want)
    y = [_lognormal(1 << 20, 11), _lognormal(1 << 20, 12)]
    prior = _carry_with([(_lognormal(1 << 20, 13), y[0])])
    got, want = _fold_both(prior, _lognormal(1 << 20, 14), y[1], 1 << 20, False, True)
    _assert_fold_close(got, want)


@pytest.mark.cuda
def test_misaligned_views_are_folded_alike(cuda_card):
    x, y = _lognormal(BLOCK + 1, 15), _lognormal(BLOCK + 1, 16)
    got, want = _fold_both(streaming._initial_carry(0, 0, "cuda"), x[1:], y[1:], BLOCK, False, True)
    _assert_fold_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("aux", ["none", "control", "where"])
def test_a_repeat_is_bitwise_equal(cuda_card, aux):
    x = _lognormal(BLOCK, 17)
    y = {"none": None, "control": _lognormal(BLOCK, 18), "where": x > 2.0}[aux]
    start = cuda_exec.pack_moments(_carry_with([(_lognormal(4096, 19), None)]))
    scratch = cuda_exec.fold_scratch("cuda")
    folded = []
    for _ in range(3):
        packed = start.clone()
        cuda_exec.block_fold(packed, x, y, BLOCK - 3, aux == "where", True, scratch)
        folded.append(packed)
    assert torch.equal(folded[0], folded[1]) and torch.equal(folded[0], folded[2])


@pytest.mark.cuda
def test_estimate_folds_every_block_with_the_kernel(cuda_card):
    """One fold launch a block, beside one K1 launch a block (the bool
    condition is no output K1 keeps, so that stream runs the plain
    executor on the card and folds its condition as uint8), and the
    streamed moments equal numpy's float64 over the very blocks."""
    sink, control, cond = _graph_with_aux()
    size, block = 3 * (1 << 20) + 4099, 1 << 20
    for kwargs, k1 in (({}, 4), ({"control": (control, 1.0)}, 4), ({"where": cond}, 0)):
        launches = (cuda_exec.LAUNCHES, cuda_exec.FOLD_LAUNCHES)
        st = sink.estimate(size, block_size=block, random_state=21, moments=True, **kwargs)
        assert (cuda_exec.LAUNCHES, cuda_exec.FOLD_LAUNCHES) == (launches[0] + k1, launches[1] + 4)
        assert np.isfinite(st["mean"])
    xs = np.asarray(
        sink.sample_streaming(size, block_size=block, random_state=21, executor="cuda"),
        dtype=np.float64,
    )
    st = sink.estimate(size, block_size=block, random_state=21, moments=True)
    assert st["mean"] == pytest.approx(xs.mean(), rel=1e-12)
    assert st["std"] == pytest.approx(xs.std(), rel=1e-9)
    assert (st["min"], st["max"]) == (xs.min(), xs.max())
