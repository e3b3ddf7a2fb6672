"""The bitonic row sort's plain twins against the JAX package's kernels.

On the CPU the port's ``sort_runs``, ``merge_stage`` and
``bitonic_sort_rows`` run their twins; the JAX package's functions run
their Pallas kernels in interpret mode.  Inputs are made with numpy from
a seed and handed to both; keys *and* payloads must be equal bit for
bit, duplicates included.  The CUDA kernels are held against the twins
on the card by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilit_tpu.ops import pallas_sort as ps
from probabilit_tpu_torch.ops import bitonic_sort as bs
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

SRC = Path(__file__).resolve().parent.parent / "probabilit_tpu_torch" / "csrc" / "bitonic_sort.cu"


def _both(jax_fn, port_fn, *arrays, **kwargs):
    """(JAX result, port result) as numpy, from the same numpy inputs."""
    ref = jax_fn(*(jnp.asarray(a) for a in arrays), interpret=True, **kwargs)
    got = port_fn(*(torch.from_numpy(np.array(a)) for a in arrays), **kwargs)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_bitwise(ref, got):
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape
        np.testing.assert_array_equal(r.view(np.uint8), g.view(np.uint8))


@pytest.mark.parametrize("keys", ["normal", "duplicates"])
def test_sort_runs_twin_matches_reference(keys):
    rng = np.random.default_rng(0)
    shape = (4, 64, 128)
    k = (
        rng.normal(size=shape) if keys == "normal" else rng.integers(0, 50, size=shape)
    ).astype(np.float32)
    p = np.arange(k.size, dtype=np.int32).reshape(shape)
    ref, got = _both(ps.sort_runs, bs.sort_runs, k, p)
    _assert_bitwise(ref, got)
    for g in range(4):  # alternating directions, payload at its key
        flat = got[0][g].reshape(-1)
        want = np.sort(k[g].reshape(-1))
        np.testing.assert_array_equal(flat, want if g % 2 == 0 else want[::-1])
        np.testing.assert_array_equal(k.reshape(-1)[got[1][g].reshape(-1)], flat)


def test_merge_stages_twin_match_reference():
    rng = np.random.default_rng(1)
    k = rng.integers(0, 2000, size=(8, 64, 128)).astype(np.float32)  # with duplicates
    p = np.arange(k.size, dtype=np.int32).reshape(k.shape)
    runs = [np.asarray(a) for a in ps.sort_runs(jnp.asarray(k), jnp.asarray(p), interpret=True)]
    k4, p4 = (a.reshape(2, 4, 64, 128) for a in runs)
    ref14, got14 = _both(ps.merge_stage, bs.merge_stage, k4, p4, stage=14)
    _assert_bitwise(ref14, got14)
    ref15, got15 = _both(ps.merge_stage, bs.merge_stage, *ref14, stage=15)
    _assert_bitwise(ref15, got15)
    rows = got15[0].reshape(2, -1)
    np.testing.assert_array_equal(rows, np.sort(k.reshape(2, -1), axis=1))


@pytest.mark.parametrize("N", [8192, 16384, 40000])
def test_bitonic_sort_rows_twin_matches_reference(N):
    rng = np.random.default_rng(N)
    keys = rng.normal(size=(3, N)).astype(np.float32)
    keys[:, ::5] = rng.integers(-20, 20, size=keys[:, ::5].shape)  # duplicates, no -0.0
    payload = np.tile(np.arange(N, dtype=np.int32), (3, 1))
    ref, got = _both(ps.bitonic_sort_rows, bs.bitonic_sort_rows, keys, payload)
    _assert_bitwise(ref, got)
    sk, sp = got
    torch.testing.assert_close(
        torch.from_numpy(sk), torch.sort(torch.from_numpy(keys), dim=1).values, rtol=0, atol=0
    )
    np.testing.assert_array_equal(np.take_along_axis(keys, sp.astype(np.int64), axis=1), sk)


def test_int32_permutation_keys_carry_a_float_payload():
    rng = np.random.default_rng(7)
    N = 12000
    perm = np.stack([rng.permutation(N), rng.permutation(N)]).astype(np.int32)
    vals = rng.normal(size=(2, N)).astype(np.float32)
    ref, got = _both(ps.bitonic_sort_rows, bs.bitonic_sort_rows, perm, vals)
    _assert_bitwise(ref, got)
    for r in range(2):
        np.testing.assert_array_equal(got[0][r], np.arange(N))
        want = np.empty(N, np.float32)
        want[perm[r]] = vals[r]
        np.testing.assert_array_equal(got[1][r], want)


def test_keys_equal_to_the_sentinel_trade_places_with_pad_slots():
    """Reference defect R6, kept for bitwise parity: real keys equal to the
    pad sentinel (+inf, INT_MAX) tie with the pad and may come out with a
    pad's payload 0."""
    rng = np.random.default_rng(3)
    N = 10000
    keys = rng.normal(size=(2, N)).astype(np.float32)
    keys[:, rng.choice(N, 300, replace=False)] = np.inf
    payload = np.tile(np.arange(1, N + 1, dtype=np.int32), (2, 1))
    ref, got = _both(ps.bitonic_sort_rows, bs.bitonic_sort_rows, keys, payload)
    _assert_bitwise(ref, got)
    np.testing.assert_array_equal(got[0], np.sort(keys, axis=1))
    assert (got[1] == 0).sum() > 0  # pad payloads among the first N
    finite = np.isfinite(got[0])
    assert (got[1][finite] > 0).all()  # the finite keys keep their own


def test_signed_zeros_and_nan_keep_their_payloads():
    # Outside the JAX package's contract (its min/max may move zero bits
    # or spread a NaN): here -0.0 and +0.0 tie and never swap, and NaN
    # compares false, so every key keeps its own payload.
    keys = torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0, -1.0, float("nan"), 2.0] * 2048])  # no pad
    payload = torch.arange(keys.numel(), dtype=torch.int32).reshape(keys.shape)
    sk, sp = bs.bitonic_sort_rows(keys, payload)
    bits = keys.view(torch.int32)[0]
    assert torch.equal(sk.view(torch.int32)[0], bits[sp[0].long()])


def test_padding_matches_reference():
    for N in [1, 8191, 8192, 8193, 16384, 16385, 40000, 100_000, 10_000_000]:
        want = max(2, int(2 ** np.ceil(np.log2(max(N, 8192) / 8192))))
        assert bs.padded_blocks(N) == want, N


def test_cpu_tensors_run_the_twin_and_launch_nothing():
    rng = np.random.default_rng(4)
    keys = torch.from_numpy(rng.normal(size=(2, 9000)).astype(np.float32))
    payload = torch.arange(18000, dtype=torch.int64).reshape(2, 9000)
    counts = (bs.RUNS_LAUNCHES, bs.EXCHANGE_LAUNCHES, bs.TAIL_LAUNCHES)
    got = bs.bitonic_sort_rows(keys, payload)
    ref = bs.bitonic_sort_rows_reference(keys, payload)
    assert (bs.RUNS_LAUNCHES, bs.EXCHANGE_LAUNCHES, bs.TAIL_LAUNCHES) == counts
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    # float64 keys with an 8-byte payload, in the twin
    k64 = keys.double()
    s64, p64 = bs.bitonic_sort_rows(k64, payload)
    torch.testing.assert_close(s64, torch.sort(k64, dim=1).values, rtol=0, atol=0)
    torch.testing.assert_close(torch.gather(k64, 1, p64 - torch.tensor([[0], [9000]])), s64)


def test_other_devices_and_bad_shapes_raise(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(bs, "bitonic_sort_rows_reference", forbidden)
    monkeypatch.setattr(bs, "sort_runs_reference", forbidden)
    meta = torch.empty((2, 100), device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        bs.bitonic_sort_rows(meta, meta)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        bs.sort_runs(torch.empty((2, 64, 128), device="meta"), torch.empty((2, 64, 128), device="meta"))
    with pytest.raises(ValueError, match="differ"):
        bs.bitonic_sort_rows(torch.zeros(2, 10), torch.zeros(2, 11))
    with pytest.raises(ValueError, match=r"\(R, 64, 128\)"):
        bs.sort_runs(torch.zeros(2, 64, 64), torch.zeros(2, 64, 64))
    with pytest.raises(ValueError, match="stage"):
        bs.merge_stage(torch.zeros(1, 2, 64, 128), torch.zeros(1, 2, 64, 128), 15)


def test_kernel_source_matches_the_wrapper():
    src = SRC.read_text()
    type_names = {torch.float32: "float", torch.int32: "int32_t", torch.float64: "double",
                  torch.int64: "int64_t"}
    for dtype, code in bs._KEY_CODE.items():
        assert f"case {code}: return Launcher<{type_names[dtype]}, P>" in src
    common = ["void* keys", "void* payload", "int key_type", "int payload_bytes"]
    signatures = {
        "bitonic_sort_runs": common + ["int64_t tiles", "int n_pad_log", "int tile_log",
                                       "void* stream"],
        "bitonic_block_exchange": common + ["int64_t rows", "int n_pad_log", "int stage",
                                            "int j_top", "int steps", "void* stream"],
        "bitonic_tail": common + ["int64_t rows", "int n_pad_log", "int stage", "int tile_log",
                                  "void* stream"],
    }
    for name, params in signatures.items():
        found = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert found, name
        assert [" ".join(p.split()) for p in found.group(1).split(",")] == params, name
    assert f"kRunLog = {bs.RUN_LOG};" in src and "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert f"kMaxFuse = {bs.FUSE};" in src and f"kMaxSmem = {bs.SMEM_BYTES};" in src
    assert "constexpr int pad(int e) { return e + (e >> 5); }" in src  # the tile rule's pad
    tail = src[src.index("tail_kernel(K* keys"):src.index("constexpr int kMaxGrid")]
    assert tail.count("__syncthreads()") == 3
    # K3: steps j <= 4 in registers, 5..9 inside a warp (__syncwarp()),
    # block barriers only around the steps j >= 10 of stages
    # 11..T: two a stage, one after the load and one before the store,
    # 2 + 2 (T - 10) a tile (10 at T = 14; the shared-memory kernel it
    # replaced had 91).
    k3 = src[src.index("// ---- K3 ----"):src.index("// ---- end of K3 ----")]
    kernel = k3[k3.index("sort_tiles_kernel(K* keys"):]
    warp_loop = kernel[kernel.index("// Stages 6..10"):kernel.index("// Stages 11..T")]
    block_loop = kernel[kernel.index("// Stages 11..T"):]
    assert "__syncthreads()" not in k3[:k3.index("sort_tiles_kernel(K* keys")]
    assert "__syncthreads()" not in warp_loop and warp_loop.count("__syncwarp()") == 2
    assert "for (int S = 11; S <= T; ++S)" in block_loop
    assert kernel.count("__syncthreads()") == 4 and block_loop.count("__syncthreads()") == 3
    assert "run_steps" not in src  # the replaced shared-memory steps, a barrier each


@pytest.mark.parametrize("sizes, tile", [((4, 4), 14), ((4, 8), 14), ((8, 4), 14), ((8, 8), 13)])
def test_tail_tile_is_the_largest_that_fits(sizes, tile):
    key_bytes, payload_bytes = sizes
    assert bs._tile_log(key_bytes, payload_bytes) == tile
    slots = lambda t: (1 << t) + (1 << (t - 5))  # the tile and its pad slots
    assert slots(tile) * (key_bytes + payload_bytes) <= bs.SMEM_BYTES
    assert slots(tile + 1) * (key_bytes + payload_bytes) > bs.SMEM_BYTES


@pytest.mark.parametrize("tile_log", [13, 14])
@pytest.mark.parametrize("fuse", [1, 3, bs.FUSE])
def test_merge_plan_covers_each_step_once(tile_log, fuse):
    for stage in range(14, 25):
        plan = bs._merge_plan(stage, tile_log, fuse)
        *passes, tail = plan
        assert [j for group in plan for j in group] == list(range(stage - 1, -1, -1))
        assert tail == tuple(range(tile_log - 1, -1, -1))
        for group in passes:
            assert 1 <= len(group) <= fuse and min(group) >= tile_log


@pytest.mark.parametrize("shape, launches", [((50, 10_000_000), (1, 15, 10)),
                                             ((128, 1 << 17), (1, 3, 3))])
def test_plan_launches_at_the_measured_shapes(shape, launches):
    """The counts PERF.md states for float32 keys and int32 payloads: K3
    runs stages 1..14, the merge loop starts at stage 15."""
    n_pad = bs.padded_blocks(shape[1]) * bs.RUN
    tile = bs._tile_log(4, 4)
    stages = bs._merge_stages(n_pad.bit_length() - 1, tile)
    assert stages[0] == 15
    passes = sum(len(bs._merge_plan(s, tile)) - 1 for s in stages)
    assert (1, passes, len(stages)) == launches


def _run_plan(keys, payload, stage, tile_log, fuse):
    """``merge_stage``'s steps, group by group as the wrapper launches them."""
    K = keys.shape[0]
    length = keys[0].numel()
    k, p = keys.reshape(K, length), payload.reshape(K, length)
    for group in bs._merge_plan(stage, tile_log, fuse):
        for j in group:
            k, p = bs._step(k, p, j, bs._desc_bits(length, stage, j, k.device))
    return k.reshape(keys.shape), p.reshape(keys.shape)


@pytest.fixture(scope="module", params=["normal", "duplicates"])
def merged_by_jax(request):
    """Sorted runs of (2, 4) blocks and the JAX package's stages 14 and 15,
    and the inputs they were made from."""
    rng = np.random.default_rng(5)
    shape = (8, 64, 128)
    k = (rng.normal(size=shape) if request.param == "normal"
         else rng.integers(0, 300, size=shape)).astype(np.float32)
    p = np.arange(k.size, dtype=np.int32).reshape(shape)
    runs = [np.array(a).reshape(2, 4, 64, 128)
            for a in ps.sort_runs(jnp.asarray(k), jnp.asarray(p), interpret=True)]
    s14 = [np.array(a) for a in ps.merge_stage(*map(jnp.asarray, runs), 14, interpret=True)]
    s15 = [np.asarray(a) for a in ps.merge_stage(*map(jnp.asarray, s14), 15, interpret=True)]
    return runs, s14, s15, (k, p)


@pytest.mark.parametrize("tile_log, fuse", [(14, bs.FUSE), (13, bs.FUSE), (13, 1)])
def test_plan_groups_equal_the_twin_and_the_jax_stages(merged_by_jax, tile_log, fuse):
    runs, s14, s15, _ = merged_by_jax
    got14 = _run_plan(*map(torch.from_numpy, runs), 14, tile_log, fuse)
    _assert_bitwise(s14, [t.numpy() for t in got14])
    got15 = _run_plan(*got14, 15, tile_log, fuse)
    _assert_bitwise(s15, [t.numpy() for t in got15])
    # Deeper stages, where the plan has several K4 groups, against the twin:
    # rows of 16 blocks after the twin's stages 14..s-1.
    rng = np.random.default_rng(tile_log * 10 + fuse)
    keys = torch.from_numpy(rng.integers(0, 5000, size=(32, 64, 128)).astype(np.float32))
    payload = torch.arange(keys.numel(), dtype=torch.int32).reshape(keys.shape)
    k, p = (t.reshape(2, 16, 64, 128) for t in bs.sort_runs_reference(keys, payload))
    for stage in range(14, 18):
        ref = bs.merge_stage_reference(k, p, stage)
        got = _run_plan(k, p, stage, tile_log, fuse)
        _assert_bitwise([t.numpy() for t in ref], [t.numpy() for t in got])
        k, p = ref
    np.testing.assert_array_equal(k.reshape(2, -1).numpy(),
                                  np.sort(keys.reshape(2, -1).numpy(), axis=1))


@pytest.mark.parametrize("tile_log", [13, 14])
def test_tile_twin_equals_the_jax_runs_and_stage_14(merged_by_jax, tile_log):
    """K3's twin on rows of four runs (2^15): at T = 13 the JAX package's
    ``sort_runs``, at T = 14 that followed by its ``merge_stage(14)``."""
    runs, s14, _, (k, p) = merged_by_jax
    got = bs.sort_tiles_reference(torch.from_numpy(k).reshape(2, -1),
                                  torch.from_numpy(p).reshape(2, -1), tile_log, 15)
    want = runs if tile_log == 13 else s14
    _assert_bitwise([w.reshape(2, -1) for w in want], [t.numpy() for t in got])


@pytest.mark.parametrize("R", [1, 5])
def test_sort_runs_twin_is_the_tile_twin_at_13(R):
    """Odd R: the last run pairs with nothing, and ascends iff R - 1 is even."""
    rng = np.random.default_rng(R)
    k = torch.from_numpy(rng.integers(0, 100, size=(R, 64, 128)).astype(np.int32))
    p = torch.from_numpy(rng.normal(size=(R, 64, 128)).astype(np.float32))
    got = bs.sort_runs(k, p)
    _assert_bitwise([t.numpy() for t in bs.sort_tiles_reference(k, p, 13, 14)],
                    [t.numpy() for t in got])
    for g in range(R):
        want = np.sort(k[g].reshape(-1).numpy())
        np.testing.assert_array_equal(got[0][g].reshape(-1).numpy(),
                                      want if g % 2 == 0 else want[::-1])


def test_bitonic_sort_rows_twin_equals_tiles_then_merge_stages():
    """The order the kernels run: stages 1..14 in K3, then 15.. (K4, K5)."""
    rng = np.random.default_rng(9)
    keys = torch.from_numpy(rng.integers(-50, 50, size=(2, 40000)).astype(np.float32))
    payload = torch.arange(80000, dtype=torch.int64).reshape(2, -1)
    kp, pp = bs._pad(keys, payload)
    n_pad_log = kp.shape[1].bit_length() - 1
    k, p = bs.sort_tiles_reference(kp, pp, 14, n_pad_log)
    blocks = kp.shape[1] // bs.RUN
    for stage in bs._merge_stages(n_pad_log, 14):
        k, p = bs.merge_stage_reference(k.reshape(2, blocks, 64, 128),
                                        p.reshape(2, blocks, 64, 128), stage)
    ref = bs.bitonic_sort_rows_reference(keys, payload)
    _assert_bitwise([t.numpy() for t in ref],
                    [t.reshape(2, -1)[:, :40000].numpy() for t in (k, p)])


# ---------------------------------------------------------------------
# K3's schedule, emulated: the kernel's index maps and step groups
# ---------------------------------------------------------------------

def _slot(e):
    return e + (e >> 5)  # the kernel's pad()


def _k3_bases(T):
    """Per thread: layout A's, B's and C's base slot, as the kernel forms them."""
    tid = torch.arange(1 << (T - 5))
    return _slot(tid), _slot(((tid >> 5) << 10) | (tid & 31)), _slot(tid << 5)


class _K3:
    """``sort_tiles_kernel`` over every tile at once: registers ``k``,
    ``p`` of shape (tiles, threads, 32), shared memory of pad(2^T) slots a
    tile.  Layout changes store and load by the kernel's slot formulas;
    every step is ascending on keys reversed (a float's sign bit flipped,
    an integer's every bit) where their stage sorts descending, as the
    kernel's ``reverse_keys``; register steps go through the twin's
    ``_step`` on the register axis."""

    def __init__(self, keys, payload, T, n_pad_log):
        self.T, self.top = T, T - 5
        tiles = keys.numel() >> T
        self.tid = torch.arange(1 << self.top)
        self.reg = torch.arange(32)
        first = torch.arange(tiles) << T
        self.row_bits = (first[:, None] & ((1 << n_pad_log) - 1)) | (self.tid[None, :] << 5)
        self.elems_a = (self.reg[None, :] << self.top) | self.tid[:, None]
        gk, gp = keys.reshape(tiles, -1), payload.reshape(tiles, -1)
        self.k, self.p = gk[:, self.elems_a], gp[:, self.elems_a]
        self.sk = torch.zeros((tiles, _slot(1 << T)), dtype=keys.dtype)
        self.sp = torch.zeros((tiles, _slot(1 << T)), dtype=payload.dtype)

    def _slots(self, shift, base):
        return base[:, None] + _slot(self.reg[None, :] << shift)

    def store(self, shift, base):
        slots = self._slots(shift, base)
        self.sk[:, slots] = self.k
        self.sp[:, slots] = self.p

    def load(self, shift, base):
        slots = self._slots(shift, base)
        self.k, self.p = self.sk[:, slots], self.sp[:, slots]

    def bit(self, s):
        return ((self.row_bits >> s) & 1).bool()

    def reverse(self, mask, uniform):
        odd = torch.tensor([bin(r & mask).count("1") % 2 == 1 for r in range(32)])
        flip = uniform[:, :, None] ^ odd[None, None, :]
        bits = {4: torch.int32, 8: torch.int64}[self.k.element_size()]
        width = 8 * self.k.element_size()
        every = -(1 << (width - 1)) if self.k.dtype.is_floating_point else -1
        flipped = self.k.view(bits) ^ torch.tensor(every, dtype=bits)
        self.k = torch.where(flip, flipped.view(self.k.dtype), self.k)

    def register_steps(self, bits, low=0):
        for b in range(bits - 1, low - 1, -1):
            self.k, self.p = bs._step(self.k, self.p, b, torch.tensor(False))

    def run(self):
        T, top = self.T, self.top
        a0, b0, c0 = _k3_bases(T)
        none = torch.zeros_like(self.bit(0))
        self.store(top, a0)
        self.load(0, c0)
        self.reverse(2, none)
        for S in range(1, T + 1):
            if S <= 5:
                self.register_steps(S)
            else:
                self.store(0, c0)
                if S <= 10:
                    self.load(5, b0)
                    self.register_steps(S - 5)
                else:
                    self.load(top, a0)
                    self.register_steps(S - top, 10 - top)
                    self.store(top, a0)
                    self.load(5, b0)
                    self.register_steps(5)
                self.store(5, b0)
                self.load(0, c0)
                self.register_steps(5)
            if S < T:
                if S < 4:
                    self.reverse(3 << S, none)
                elif S == 4:
                    self.reverse(1 << 4, self.bit(5))
                else:
                    self.reverse(0, self.bit(S + 1) ^ self.bit(S))
        self.reverse(0, self.bit(T))
        self.store(0, c0)
        self.load(top, a0)
        out_k, out_p = torch.empty_like(self.sk[:, : 1 << T]), torch.empty_like(self.sp[:, : 1 << T])
        out_k[:, self.elems_a], out_p[:, self.elems_a] = self.k, self.p
        return out_k, out_p


@pytest.mark.parametrize("T", [13, 14])
def test_k3_layouts_are_bank_free_permutations(T):
    """Each layout's slots are pad(element) for a permutation of the tile;
    a warp's 32 lanes hit 32 banks at every register; a warp's B and C
    elements are the same 1024 (a __syncwarp() between them suffices)."""
    tid = torch.arange(1 << (T - 5))[:, None]
    r = torch.arange(32)[None, :]
    lane, warp = tid & 31, tid >> 5
    elems = {"A": (r << (T - 5)) | tid, "B": (warp << 10) | (r << 5) | lane, "C": (tid << 5) | r}
    shifts = {"A": T - 5, "B": 5, "C": 0}
    for (name, e), base in zip(elems.items(), _k3_bases(T)):
        slots = base[:, None] + _slot(r << shifts[name])
        assert torch.equal(slots, _slot(e)), name
        assert torch.equal(torch.sort(e.reshape(-1)).values, torch.arange(1 << T)), name
        banks = (slots % 32).reshape(-1, 32, 32)  # (warp, lane, register)
        assert all(len(set(banks[w, :, i].tolist())) == 32
                   for w in range(banks.shape[0]) for i in range(32)), name
    for w in range(1 << (T - 10)):
        rows = slice(32 * w, 32 * w + 32)
        assert set(elems["B"][rows].reshape(-1).tolist()) == set(elems["C"][rows].reshape(-1).tolist())


@pytest.mark.parametrize("key_dtype", ["float32", "int32", "float64", "int64"])
@pytest.mark.parametrize("T, n_pad_log", [(13, 14), (14, 14), (14, 15)])
def test_k3_schedule_equals_the_tile_twin(T, n_pad_log, key_dtype):
    """The emulated kernel, step group by step group, against
    ``sort_tiles_reference`` bitwise: duplicates, and for float keys NaN
    and signed zeros; integer keys span their whole range."""
    rng = np.random.default_rng(T * 100 + n_pad_log)
    n = 4 << T
    if key_dtype.startswith("float"):
        keys = rng.normal(size=n).astype(key_dtype)
        keys[rng.choice(n, 40, replace=False)] = np.nan
        keys[rng.choice(n, 40, replace=False)] = -0.0
    else:
        info = np.iinfo(key_dtype)
        keys = rng.integers(info.min, info.max, size=n, dtype=key_dtype, endpoint=True)
    keys[::3] = rng.integers(-8, 8, size=keys[::3].shape)
    if key_dtype.startswith("int"):
        keys[1:5] = [info.min, info.max, -1, 0]
    k, p = torch.from_numpy(keys), torch.arange(n, dtype=torch.int32)
    got = _K3(k, p, T, n_pad_log).run()
    ref = bs.sort_tiles_reference(k, p, T, n_pad_log)
    _assert_bitwise([t.numpy() for t in ref], [t.reshape(-1).numpy() for t in got])
