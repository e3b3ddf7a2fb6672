"""K2's tensor-core algorithm, transcribed (``ops/corr_tiles.py``), on the CPU.

``corr_tiles.stats`` computes the statistics kernel's sums as its warps
do: the tiles, the lanes' Philox calls, the swizzled shared-memory
chunks, the TF32 split, the mma fragments and their float32 sums, the
float64 flush and the block's order.  It is held to the plain twin
(``cuda_exec.corr_stats_reference``) and, through the recolour solve, to
the JAX package's Iman-Conover recolouring.  Tolerances, each with what
was measured at writing:

* every sum within ``STATS_TOL * n`` of the twin (1e-5 * n, as the card's
  kernel is held; measured at most 6e-8 * n), each diagonal sum
  sum z_k^2 within 1e-6 relative (measured at most 9e-8);
* the recolour transform solved from the transcription's sums, applied to
  the scores, against ``ImanConover._recolor_scores``: 1e-4 of max |y|,
  as ``test_twin_recolor_transform_matches_reference_recolor_scores``;
* with scores of 1 every sum is n exactly (float32 sums of small integers
  are exact), and every (column, sample) is stored once.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from probabilit_tpu.models import benchmarks as jax_benchmarks
from probabilit_tpu.ops import correlation as jax_correlation

from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.ops import corr_tiles, special
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
STATS_TOL = 1e-5
DIAG_REL_TOL = 1e-6
REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def on_the_cpu():
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


def _diagonal(k):
    iu = torch.triu_indices(k, k)
    return k + torch.nonzero(iu[0] == iu[1]).flatten()


@pytest.mark.parametrize("k, n, start", [(1, 5003, 3), (3, 20001, 5), (10, 30003, 1),
                                         (15, 9999, 2), (16, 20005, 7)])
def test_transcription_matches_the_twin(k, n, start):
    columns = [3 * j + 1 for j in range(k)]
    got, seen = corr_tiles.stats((7, 8), n, columns, start=start)
    ref = cuda_exec.corr_stats_reference((7, 8), n, columns, start=start)
    assert got.dtype == torch.float64 and got.shape == ref.shape
    assert (got - ref).abs().max().item() <= STATS_TOL * n
    diag = _diagonal(k)
    assert ((got[diag] - ref[diag]).abs() / ref[diag]).max().item() <= DIAG_REL_TOL
    assert torch.equal(seen["scored"], torch.ones_like(seen["scored"]))


@pytest.mark.parametrize("k, n, start", [(1, 1, 3), (2, 6, 1), (7, 3001, 2), (8, 4099, 0),
                                         (9, 1030, 5), (13, 2000, 6), (16, 777, 1)])
def test_every_sample_is_counted_once(k, n, start):
    """Scores of 1 make every sum the count of samples, exactly."""
    got, seen = corr_tiles.stats((1, 2), n, list(range(k)), start=start, blocks=1,
                                 score=torch.ones_like)
    assert torch.equal(got, torch.full_like(got, float(n)))
    assert torch.equal(seen["scored"], torch.ones_like(seen["scored"]))


@pytest.mark.parametrize("k", range(1, 17))
def test_calls_cover_the_tile_once_without_bank_conflicts(k):
    column, group, lane, live = corr_tiles.calls(k)
    S = corr_tiles.samples_per_tile(k)
    G = S // 4
    assert column.numel() % 32 == 0 and torch.equal(lane, torch.arange(column.numel()) % 32)
    pairs = set(zip(column[live].tolist(), group[live].tolist()))
    assert len(pairs) == int(live.sum()) == k * G  # each (column, group) once
    # A quarter-warp's 16-byte stores (its lanes' calls c: one row, eight
    # chunks) and each 8 x 4 matrix ldmatrix reads (eight rows, one chunk)
    # hit eight distinct bank groups: chunk a of row r lies at a ^ (r & 7).
    def bank(r, a):
        return (r * S // 4 + (a ^ (r & 7))) % 8

    for c in range(column.numel() // 32):
        for quarter in range(4):
            q = slice(32 * c + 8 * quarter, 32 * c + 8 * quarter + 8)
            banks = [bank(r, a) for r, a, o in
                     zip(column[q].tolist(), group[q].tolist(), live[q].tolist()) if o]
            assert len(banks) == len(set(banks))
    for chunk in range(G):
        for first_row in (0, 8):
            banks = [bank(first_row + r, chunk) for r in range(8)]
            assert len(banks) == len(set(banks))


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one = 1.0 + 2.0**-10  # the TF32 neighbour of 1 above it
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-11 - 2.0**-23,
                      1.5 * 2.0**-130, 0.0, -0.0, 3.0e38], dtype=torch.float32)
    got = corr_tiles.tf32_rna(x)
    assert got[:3].tolist() == [one, -one, 1.0]
    assert torch.equal(got[3:6].view(torch.int32) & 0x1FFF, torch.zeros(3, dtype=torch.int32))
    assert got[5].view(torch.int32).item() == x[5].view(torch.int32).item()  # -0 stays -0
    # Random finite floats: the nearest value with 10 mantissa bits, a tie away from 0.
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32) * 1e3)
    r = corr_tiles.tf32_rna(v).double()
    assert torch.equal(r.float().view(torch.int32) & 0x1FFF, torch.zeros_like(v, dtype=torch.int32))
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(v.double())[1] - 11)
    err = (r - v.double()).abs()
    assert bool((err <= ulp / 2).all())
    ties = err == ulp / 2
    assert bool((r[ties].abs() > v.double()[ties].abs()).all())


def test_unsplit_tf32_leaves_the_diagonal_further_from_the_twin():
    """One TF32 product (hi.hi) against the split's three, on a pinned draw."""
    k, n = 10, 40_000
    columns = [2 * j for j in range(k)]
    ref = cuda_exec.corr_stats_reference((11, 12), n, columns)
    diag = _diagonal(k)
    split = (corr_tiles.stats((11, 12), n, columns)[0] - ref)[diag].abs().max().item()
    single = (corr_tiles.stats((11, 12), n, columns, split=False)[0] - ref)[diag].abs().max().item()
    assert split <= DIAG_REL_TOL * n < single
    assert single > 20 * split


def test_recolour_from_the_transcription_matches_reference_recolor_scores():
    jax_sink = jax_benchmarks.mixed_correlated_50()
    sink = interop.from_reference(jax_sink)[jax_sink._id]
    plan = tcompile.get_plan(sink)
    words = cuda_exec.seed_words(11)
    columns = [plan.col_of[v._id] for v in plan.corr_vars]
    n, K = 20_003, len(columns)
    sums, _ = corr_tiles.stats(words, n, columns)
    ab = cuda_exec.solve_recolor(sums.numpy(), n, plan.corr_matrix)
    z = special.ndtri_fast(cuda_exec.philox_uniforms(words, n, K, columns=columns)).T
    y = ab[: K * K].reshape(K, K) @ z.double().numpy() + ab[K * K:, None]
    ref = np.asarray(jax_correlation.ImanConover().set_target(plan.corr_matrix)
                     ._recolor_scores(jnp.asarray(z.numpy())))
    assert np.abs(y - ref).max() <= REL_TOL * np.abs(ref).max()


def test_the_kernel_source_matches_the_transcription():
    source = (ROOT / "probabilit_tpu_torch" / "csrc" / "corr_stats.cu").read_text()
    assert f"kFlushSamples = {corr_tiles.FLUSH_SAMPLES};" in source
    assert f"kThreads = {32 * corr_tiles.WARPS};" in source
    found = re.search(r"kSamples = K <= (\d+) \? (\d+) : \(K <= (\d+) \? (\d+) : (\d+)\);", source)
    small, s_small, middle, s_middle, s_large = (int(v) for v in found.groups())
    for k in range(1, 17):
        expected = s_small if k <= small else (s_middle if k <= middle else s_large)
        assert corr_tiles.samples_per_tile(k) == expected
    assert "m16n8k8.row.col.f32.tf32.tf32.f32" in source and "ldmatrix" in source
    assert "__any_sync" in source and "atomicAdd" not in source
