"""Blocked bitonic (key, payload) row sort: three CUDA kernels and their twins.

The port's counterpart of ``probabilit_tpu/ops/pallas_sort.py``, with the
same public functions and layouts:

* ``sort_runs(keys, payload)`` on ``(R, 64, 128)``: stages 1..13 of a
  bitonic network, every 8192-element run sorted, run g ascending iff g
  is even (kernel K3, ``_local_sort_kernel``);
* ``merge_stage(keys, payload, stage)`` on ``(K, n_blocks, 64, 128)``:
  one stage, steps j = stage-1..0.  The TPU runs steps 13 and up as
  passes between partner 8192-blocks (``_block_exchange_kernel``), then
  12..0 inside each block (``_tail_kernel``).  Here ``_merge_plan``
  groups steps stage-1..T, T = log2 of the tile (14, or 13 for 8+8
  bytes; ``_tile_log``), into passes of up to ``FUSE`` distances (kernel
  K4), then runs T-1..0 inside each 2^T tile (kernel K5);
* ``bitonic_sort_rows(keys, payload)`` on ``(K, N)``: rows padded with
  sentinel keys to ``n_blocks = max(2, 2^ceil(log2(ceil(N/8192))))``
  blocks, stages 1..T inside each 2^T tile (K3, ``sort_tiles_reference``
  its twin: ``sort_runs`` and stage 14 for T = 14), then stages
  T+1..log2(n_pad) (``_merge_stages``); the first N columns.

Element e of a run is its flat position (the JAX package's row-major
(64, 128) run layout is the same order), and the direction of stage s is
bit s of the lo element's index within its row (for stage 13 of
``sort_runs``: the parity of the global run index, as the TPU kernel;
K3 reads it as bit 13 of the index in rows of 2^14 elements).
Every grouping runs the same compare-exchanges in the same order on each
element, so the result does not depend on the plan.

Every step keeps the JAX package's rules, so keys *and* payloads equal
its output bit for bit, duplicates included: a pair swaps iff it is
strictly out of order (ties never swap); the payload moves with its key;
sentinels are ``+inf`` for floats and ``iinfo.max`` for integers.  The
JAX kernel writes ``min``/``max`` and moves a payload iff its key value
changed, which is the same exchange for ordinary keys.  It is not for:

* NaN keys.  ``jnp.minimum`` spreads a NaN over both slots of a pair;
  here every comparison with NaN is false, so a NaN never moves, keys and
  payloads stay paired, and the row is sorted only between its NaNs.
* -0.0 against +0.0.  They compare equal here and never swap, so each
  zero keeps its payload; ``jnp.minimum`` may hand either zero's bits to
  either slot while the payloads stay.
* A real key equal to the sentinel (``+inf``, ``iinfo.max``) ties with
  the pad slots and may trade places with one, so the first N payloads
  can include a pad's payload 0.  The port keeps this (it follows from
  the network) and so equals the JAX package there too.

On tensors that lie on the CPU each function runs its plain twin
(``*_reference``): the same network in PyTorch, a step at distance 2^j a
reshape to ``(..., 2, 2^j)`` and a compare of the halves; no
``torch.sort``.  On CUDA tensors they launch the kernels of
``csrc/bitonic_sort.cu``, counting launches in ``RUNS_LAUNCHES``,
``EXCHANGE_LAUNCHES`` and ``TAIL_LAUNCHES``, or raise.  The kernels take
float32, int32, float64 and int64 keys with any 4- or 8-byte payload
(moved as raw bits) and work in place on the padded copies; the public
functions return new tensors (``bitonic_sort_rows`` returns views of its
padded buffers).
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = [
    "RUNS_LAUNCHES",
    "EXCHANGE_LAUNCHES",
    "TAIL_LAUNCHES",
    "padded_blocks",
    "sort_runs",
    "sort_runs_reference",
    "sort_tiles_reference",
    "merge_stage",
    "merge_stage_reference",
    "bitonic_sort_rows",
    "bitonic_sort_rows_reference",
]

RUN = 8192  # elements per phase-1 run and per merge block
SUB, LANES = 64, 128  # the JAX package's (sublane, lane) run layout
RUN_LOG = 13
FUSE = 5  # K4: the most steps (distances) one pass runs
SMEM_BYTES = 232448  # dynamic shared memory one block may use on sm_90 (227 KB)

# Launches of K3 (stages 1..T of every tile), K4 (one block-exchange
# pass) and K5 (one tail), by the wrappers below.
RUNS_LAUNCHES = 0
EXCHANGE_LAUNCHES = 0
TAIL_LAUNCHES = 0

# Key dtypes the kernels take, by their code in csrc/bitonic_sort.cu.
_KEY_CODE = {torch.float32: 0, torch.int32: 1, torch.float64: 2, torch.int64: 3}
_PAYLOAD_BYTES = (4, 8)


def padded_blocks(n):
    """8192-blocks per row after padding ``n`` columns: a power of two, >= 2."""
    blocks = -(-max(n, RUN) // RUN)
    return max(2, 1 << (blocks - 1).bit_length())


def _tile_log(key_bytes, payload_bytes):
    """log2 of K3's and K5's tile: the most elements, a power of two, whose
    keys and payloads fit in one block's shared memory with the kernels'
    pad slot after every 32 (14 for 4+4, 4+8 and 8+4 bytes, 13 for 8+8).
    The kernels take it as an argument."""
    return (SMEM_BYTES * 32 // 33 // (key_bytes + payload_bytes)).bit_length() - 1


def _merge_stages(n_pad_log, tile_log):
    """The stages a row sort runs after K3's stages 1..tile_log."""
    return range(tile_log + 1, n_pad_log + 1)


def _merge_plan(stage, tile_log, fuse=FUSE):
    """The step groups of one merge stage, as tuples of descending j: the
    K4 passes (steps stage-1..tile_log, up to ``fuse`` a pass), then the
    K5 tail (steps tile_log-1..0), always the last group."""
    js = range(stage - 1, tile_log - 1, -1)
    passes = [tuple(js[i : i + fuse]) for i in range(0, len(js), fuse)]
    return passes + [tuple(range(tile_log - 1, -1, -1))]


def _sentinel(dtype):
    return math.inf if dtype.is_floating_point else torch.iinfo(dtype).max


# ---------------------------------------------------------------------
# Plain twins: the same network in PyTorch ops
# ---------------------------------------------------------------------


def _step(keys, payload, j, desc):
    """Compare-exchange at distance 2^j along the last axis.

    ``desc`` (bool) broadcasts against the ``(..., G, 1)`` pair groups:
    True where the group sorts descending.  A pair swaps iff it is
    strictly out of order.
    """
    shape = keys.shape
    split = (*shape[:-1], shape[-1] >> (j + 1), 2, 1 << j)
    k, p = keys.reshape(split), payload.reshape(split)
    lo, hi = k[..., 0, :], k[..., 1, :]
    swap = torch.where(desc, lo < hi, hi < lo)
    k = torch.stack((torch.where(swap, hi, lo), torch.where(swap, lo, hi)), dim=-2)
    p_lo, p_hi = p[..., 0, :], p[..., 1, :]
    p = torch.stack((torch.where(swap, p_hi, p_lo), torch.where(swap, p_lo, p_hi)), dim=-2)
    return k.reshape(shape), p.reshape(shape)


def _desc_bits(length, stage, j, device):
    """Bit ``stage`` of each pair group's lo index, for rows of ``length``
    at step j: ``(G, 1)`` bool, G = length / 2^(j+1)."""
    group = torch.arange(length >> (j + 1), device=device)
    return ((group >> (stage - j - 1)) & 1).bool()[:, None]


def sort_tiles_reference(keys, payload, tile_log, n_pad_log):
    """The plain twin of K3: stages 1..tile_log inside each 2^tile_log
    tile of the flat keys, the direction of stage s bit s of an element's
    index within its row of 2^n_pad_log (for the last stage: of the tile's
    first index)."""
    tile = 1 << tile_log
    k, p = keys.reshape(-1, tile), payload.reshape(-1, tile)
    first = torch.arange(k.shape[0], device=keys.device) << tile_log
    last = (((first & ((1 << n_pad_log) - 1)) >> tile_log) & 1).bool()[:, None, None]
    for stage in range(1, tile_log + 1):
        for j in range(stage - 1, -1, -1):
            desc = last if stage == tile_log else _desc_bits(tile, stage, j, keys.device)
            k, p = _step(k, p, j, desc)
    return k.reshape(keys.shape), p.reshape(keys.shape)


def sort_runs_reference(keys, payload):
    """The plain twin of ``sort_runs``: stage 13's direction, the run's
    parity, is bit 13 of the index in rows of two runs."""
    _check_runs(keys, payload)
    return sort_tiles_reference(keys, payload, RUN_LOG, RUN_LOG + 1)


def merge_stage_reference(keys, payload, stage):
    """The plain twin of ``merge_stage``: steps stage-1..0 over each row."""
    K, n_blocks = _check_blocks(keys, payload, stage)
    length = n_blocks * RUN
    k, p = keys.reshape(K, length), payload.reshape(K, length)
    for j in range(stage - 1, -1, -1):
        k, p = _step(k, p, j, _desc_bits(length, stage, j, keys.device))
    return k.reshape(keys.shape), p.reshape(keys.shape)


def _pad(keys, payload):
    K, N = keys.shape
    n_pad = padded_blocks(N) * RUN
    kp = torch.full((K, n_pad), _sentinel(keys.dtype), dtype=keys.dtype, device=keys.device)
    kp[:, :N] = keys
    pp = torch.zeros((K, n_pad), dtype=payload.dtype, device=payload.device)
    pp[:, :N] = payload
    return kp, pp


def bitonic_sort_rows_reference(keys, payload):
    """The plain twin of ``bitonic_sort_rows``."""
    _check_rows(keys, payload)
    K, N = keys.shape
    kp, pp = _pad(keys, payload)
    n_blocks = kp.shape[1] // RUN
    kp, pp = sort_runs_reference(
        kp.reshape(K * n_blocks, SUB, LANES), pp.reshape(K * n_blocks, SUB, LANES)
    )
    kp, pp = kp.reshape(K, n_blocks, SUB, LANES), pp.reshape(K, n_blocks, SUB, LANES)
    for stage in range(RUN_LOG + 1, (n_blocks * RUN).bit_length()):
        kp, pp = merge_stage_reference(kp, pp, stage)
    return kp.reshape(K, -1)[:, :N], pp.reshape(K, -1)[:, :N]


# ---------------------------------------------------------------------
# Shape checks and routing
# ---------------------------------------------------------------------


def _check_pair(keys, payload):
    if keys.shape != payload.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and payload {tuple(payload.shape)} differ.")
    if keys.device != payload.device:
        raise ValueError(f"keys lie on {keys.device} and payload on {payload.device}.")


def _check_runs(keys, payload):
    _check_pair(keys, payload)
    if keys.ndim != 3 or tuple(keys.shape[1:]) != (SUB, LANES):
        raise ValueError(f"sort_runs takes (R, {SUB}, {LANES}); got {tuple(keys.shape)}.")


def _check_blocks(keys, payload, stage):
    _check_pair(keys, payload)
    if keys.ndim != 4 or tuple(keys.shape[2:]) != (SUB, LANES):
        raise ValueError(
            f"merge_stage takes (K, n_blocks, {SUB}, {LANES}); got {tuple(keys.shape)}."
        )
    K, n_blocks = keys.shape[:2]
    if n_blocks & (n_blocks - 1) or not RUN_LOG < stage <= (n_blocks * RUN).bit_length() - 1:
        raise ValueError(
            f"merge_stage needs a power-of-two block count and 13 < stage <= "
            f"log2(n_blocks * {RUN}); got n_blocks={n_blocks}, stage={stage}."
        )
    return K, n_blocks


def _check_rows(keys, payload):
    _check_pair(keys, payload)
    if keys.ndim != 2:
        raise ValueError(f"bitonic_sort_rows takes (K, N); got {tuple(keys.shape)}.")


def _on_cpu(keys):
    """True for CPU tensors (the twin); CUDA tensors must pass the
    kernels' checks, and any other device raises."""
    if keys.device.type == "cpu":
        return True
    if keys.device.type != "cuda":
        raise RuntimeError(f"The sort kernels run on CUDA tensors; got {keys.device}.")
    return False


def _cuda_ready(keys, payload):
    """Raise unless the kernels take these CUDA tensors."""
    if torch.cuda.get_device_capability(keys.device) != (9, 0):
        raise RuntimeError(
            f"The sort kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(keys.device)} is not."
        )
    if keys.dtype not in _KEY_CODE:
        raise TypeError(
            f"The sort kernels take float32, int32, float64 or int64 keys; got {keys.dtype}."
        )
    if payload.element_size() not in _PAYLOAD_BYTES:
        raise TypeError(f"The sort kernels take 4- or 8-byte payloads; got {payload.dtype}.")


# ---------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------


def sort_runs(keys, payload):
    """Sort each 8192-element run of ``(R, 64, 128)`` keys, carrying
    ``payload``: run g ascending for even g, descending for odd g."""
    _check_runs(keys, payload)
    if _on_cpu(keys):
        return sort_runs_reference(keys, payload)
    _cuda_ready(keys, payload)
    k = keys.clone(memory_format=torch.contiguous_format)
    p = payload.clone(memory_format=torch.contiguous_format)
    _sort_tiles_(k, p, RUN_LOG + 1, RUN_LOG)
    return k, p


def merge_stage(keys, payload, stage):
    """Bitonic stage ``stage`` (steps stage-1..0) over every row of
    ``(K, n_blocks, 64, 128)`` keys, each 2^(stage-13)-block group bitonic."""
    K, n_blocks = _check_blocks(keys, payload, stage)
    if _on_cpu(keys):
        return merge_stage_reference(keys, payload, stage)
    _cuda_ready(keys, payload)
    k = keys.clone(memory_format=torch.contiguous_format)
    p = payload.clone(memory_format=torch.contiguous_format)
    _merge_stage_(k, p, K, n_blocks, stage)
    return k, p


def bitonic_sort_rows(keys, payload):
    """Sort each row of ``(K, N)`` keys ascending, carrying ``payload``.

    Returns ``(keys, payload)`` of shape ``(K, N)``.  On CUDA tensors:
    one K3 launch for stages 1..T inside each 2^T tile (T = ``_tile_log``),
    then for each stage s = T+1..log2(n_pad) the K4 passes and the K5 tail
    of ``_merge_plan``, all in place on the padded copies.
    """
    _check_rows(keys, payload)
    if _on_cpu(keys):
        return bitonic_sort_rows_reference(keys, payload)
    _cuda_ready(keys, payload)
    K, N = keys.shape
    kp, pp = _pad(keys, payload)
    n_blocks = kp.shape[1] // RUN
    tile = _tile_log(kp.element_size(), pp.element_size())
    _sort_tiles_(kp, pp, _pad_log(n_blocks), tile)
    for stage in _merge_stages(_pad_log(n_blocks), tile):
        _merge_stage_(kp, pp, K, n_blocks, stage)
    return kp[:, :N], pp[:, :N]


# ---------------------------------------------------------------------
# Launches (CUDA tensors, contiguous, checked; all in place)
# ---------------------------------------------------------------------


def _codes(k, p):
    return _KEY_CODE[k.dtype], p.element_size()


def _stream(k):
    return torch.cuda.current_stream(k.device).cuda_stream


def _check_err(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}.")


def _sort_tiles_(k, p, n_pad_log, tile_log):
    """K3: stages 1..tile_log inside every 2^tile_log tile of the
    contiguous buffers, directions by the index in rows of 2^n_pad_log."""
    global RUNS_LAUNCHES
    err = _lib().bitonic_sort_runs(
        k.data_ptr(), p.data_ptr(), *_codes(k, p), k.numel() >> tile_log, n_pad_log, tile_log,
        _stream(k),
    )
    _check_err(err, "bitonic_sort_runs")
    RUNS_LAUNCHES += 1


def _pad_log(n_blocks):
    return (n_blocks * RUN).bit_length() - 1


def _exchange_(k, p, rows, n_blocks, stage, js):
    """K4: one pass over steps ``js`` (descending, consecutive, >= 13)."""
    global EXCHANGE_LAUNCHES
    err = _lib().bitonic_block_exchange(
        k.data_ptr(), p.data_ptr(), *_codes(k, p), rows, _pad_log(n_blocks), stage, js[0],
        len(js), _stream(k),
    )
    _check_err(err, "bitonic_block_exchange")
    EXCHANGE_LAUNCHES += 1


def _tail_(k, p, rows, n_blocks, stage, js):
    """K5: steps ``js`` = tile_log-1..0 of ``stage`` inside every tile."""
    global TAIL_LAUNCHES
    err = _lib().bitonic_tail(
        k.data_ptr(), p.data_ptr(), *_codes(k, p), rows, _pad_log(n_blocks), stage, len(js),
        _stream(k),
    )
    _check_err(err, "bitonic_tail")
    TAIL_LAUNCHES += 1


def _merge_stage_(k, p, rows, n_blocks, stage):
    *passes, tail = _merge_plan(stage, _tile_log(k.element_size(), p.element_size()))
    for js in passes:
        _exchange_(k, p, rows, n_blocks, stage, js)
    _tail_(k, p, rows, n_blocks, stage, tail)


def _lib():
    from probabilit_tpu_torch import _build

    lib = _build.load("bitonic_sort")
    common = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64]
    # n_pad_log, then tile_log (K3); stage, j_top, steps (K4); stage, tile_log (K5)
    ints = [ctypes.c_int] * 4
    lib.bitonic_sort_runs.argtypes = common + ints[:2] + [ctypes.c_void_p]
    lib.bitonic_block_exchange.argtypes = common + ints + [ctypes.c_void_p]
    lib.bitonic_tail.argtypes = common + ints[:3] + [ctypes.c_void_p]
    for fn in (lib.bitonic_sort_runs, lib.bitonic_block_exchange, lib.bitonic_tail):
        fn.restype = ctypes.c_int
    return lib
