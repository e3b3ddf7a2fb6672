"""K2's algorithm in PyTorch: what ``csrc/corr_stats.cu`` computes per warp.

The statistics kernel sums, over samples ``start .. start + n - 1``, the
normal scores z_k of K correlated columns and their products z_j z_k.
Each warp of its grid takes tiles of S samples (``samples_per_tile``):
tile ``w, w + W, 2 W + w, ...`` for warp w of W.  Its 32 lanes make the
tile's K S / 4 Philox calls (call q of a tile: column ``q // G``, group
``q % G``, G = S / 4; lane ``q % 32``) and store each call's four
scores, split into TF32 halves hi = ``tf32_rna(z)`` and
lo = ``tf32_rna(z - hi)``, as a 16-byte chunk of a shared-memory row
(chunk a of row r at a ^ ``swizzle_key``).  The products of a tile run
while the warp scores the next one: each ``mma.m16n8k8`` k-step reads its
fragments with ldmatrix, depths 0-3 from chunk 2 s of a set's range and
depths 4-7 from chunk 2 s + 1 (``shape``).  Up to K = 8 the product's 16
rows are the hi and the lo halves of eight rows (the K columns, a row of
ones at K where it fits, in 8 / R sets of R rows over their own
samples) and its 8 columns those rows' hi halves: one product gives
hi.hi (rows 0-7) and lo.hi (rows 8-15).  Above K = 8 the rows and
columns are the K columns padded to 16: hi.hi and hi.lo of two column
tiles.  K = 4, 8 and 16 sum z_k from the B fragments in float32
instead of a row of ones.  Every ``FLUSH_SAMPLES`` samples (and at the
end) the float32 sums go into float64, and the block adds its warps'
sums in warp order: z_j z_k is hi.hi + lo.hi + its transpose.  Samples
outside the range score 0.

``stats`` transcribes this on CPU tensors: the mapping of calls to
lanes and of chunks to ldmatrix registers and fragments (through the
swizzled tile), the masks, the TF32 rounding on the int32 view (round
to nearest, ties away from zero, 10 mantissa bits), the three products,
each k-step's eight products summed and rounded to float32 before they
join the float32 accumulator (the tensor core's own order of addition
within a step is not modelled), the float64 flush and the block's
order.  It also counts how often each (column, sample) was stored and
how many warp votes took the Giles tail.  The tests hold it to the plain
twin (``cuda_exec.corr_stats_reference``) and, through the recolour
solve, to the JAX package's Iman-Conover recolouring.  Nothing on the
sampling path calls this module.
"""

from __future__ import annotations

import torch

from probabilit_tpu_torch.ops import philox as _philox
from probabilit_tpu_torch.ops import special as _special

__all__ = ["FLUSH_SAMPLES", "WARPS", "samples_per_tile", "shape", "calls", "tf32_rna", "stats"]

WARPS = 8  # a block of 256 threads
FLUSH_SAMPLES = 256  # samples a float32 accumulator carries at most
_TAIL_W = 5.0  # the Giles tail polynomial's range: w >= 5


def samples_per_tile(k):
    """S: the samples a warp scores at once for k columns."""
    return 128 if k <= 6 else (64 if k <= 14 else 32)


def shape(k):
    """The product's layout for k columns: ``stacked`` (k <= 8: rows 0-7
    hold the hi halves and rows 8-15 the lo halves of R-row sets),
    ``rows`` R, ``sets`` (8 / R stacked, else 1), ``ones_row`` (a row of
    ones gives the z sums; k = 4, 8 and 16 add B's z instead), ``steps``
    (k-steps a tile)."""
    stacked = k <= 8
    ones_row = k not in (4, 8, 16)
    needed = k + ones_row
    rows = 2 if needed <= 2 else (4 if needed <= 4 else 8)
    sets = 8 // rows if stacked else 1
    return {"stacked": stacked, "rows": rows, "sets": sets, "ones_row": ones_row,
            "steps": samples_per_tile(k) // (8 * sets)}


def calls(k):
    """``(column, group, lane, live)`` of a tile's Philox calls, int64
    tensors of 32 * ceil(k S / 128) entries, call c of a lane at
    ``32 c + lane``: every lane makes the same number of calls, a call
    past the k S / 4 the tile needs is not live."""
    groups = samples_per_tile(k) // 4
    per_lane = -(-k * groups // 32)
    q = torch.arange(32 * per_lane, dtype=torch.int64)
    live = q < k * groups
    return torch.where(live, q // groups, 0), q % groups, q % 32, live


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on float32 ``x``: the magnitude rounded to 10
    mantissa bits, ties away from zero (finite inputs)."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def swizzle_key(k, row, group):
    """The key of ``row``'s chunk ``group`` (tensors or ints): stored at
    group ^ key.  Up to k = 8 the key is the row's place in the product
    (R set + row), else row & 7."""
    lay = shape(k)
    if lay["stacked"]:
        return lay["rows"] * (group // (samples_per_tile(k) // 4 // lay["sets"])) + row
    return row & 7


def _tile_scores(seed_words, columns, g0, first, end, score):
    """The tiles starting at groups ``g0`` (a (T,) int64 tensor), as the
    warps store them: (T, K, G, 4) float32, group a's four scores of
    column k at ``[:, k, a ^ swizzle_key(k, k, a)]``, 0 outside
    ``[first, end)``.  Also the warp votes that took the tail, and the
    (column, sample) pairs the live calls scored."""
    k = len(columns)
    column, a, _, live = calls(k)
    groups = samples_per_tile(k) // 4
    g = g0[:, None] + a[None, :]  # (T, calls)
    col = torch.tensor(columns, dtype=torch.int64)[column].expand_as(g)
    words = torch.stack(_philox.philox4x32_10((g & 0xFFFFFFFF, g >> 32, col, 0), seed_words),
                        dim=-1)
    u = _philox.bits_to_open_unit(words)  # (T, calls, 4)
    x = 2.0 * u - 1.0
    w = torch.clamp(-torch.log(torch.clamp((1.0 - x) * (1.0 + x), min=1e-37)), max=16.64)
    # One vote per call and word: does a live lane of the warp need the tail?
    need = (w >= _TAIL_W) & live[None, :, None]
    votes = int(need.reshape(need.shape[0], -1, 32, 4).any(dim=2).sum())
    sample = 4 * g[..., None] + torch.arange(4)
    inside = (sample >= first) & (sample < end) & live[None, :, None]
    z = torch.where(inside, score(u), torch.zeros((), dtype=torch.float32))
    tile = torch.zeros((g0.numel(), k, groups, 4), dtype=torch.float32)
    rows, groups_live = column[live], a[live]
    tile[:, rows, groups_live ^ swizzle_key(k, rows, groups_live)] = z[:, live]
    every = column[None, :, None].expand_as(sample)
    return tile, votes, every[inside], sample[inside]


def stats(seed_words, n, columns, start=0, blocks=2, split=True, score=None):
    """The kernel's float64 ``(P,)`` sums over samples
    ``start .. start + n - 1`` (z_k, then z_j z_k for j <= k row-major),
    computed as a grid of ``blocks`` blocks computes them, and a dict of
    what the run counted: ``scored`` (how often each (column, sample) was
    stored, (K, n) int64), ``votes`` (warp votes that took the tail),
    ``calls`` (Philox calls a lane made, summed over lanes).

    ``split=False`` multiplies unsplit TF32 scores (hi.hi alone), the
    single product the kernel does not take; ``score`` replaces
    ``ndtri_fast`` as the function of the uniforms.
    """
    k = len(columns)
    if not 1 <= k <= 16 or n <= 0 or start < 0:
        raise ValueError("stats takes 1..16 columns, n > 0 and start >= 0.")
    score = _special.ndtri_fast if score is None else score
    lay = shape(k)
    S = samples_per_tile(k)
    G = S // 4
    set_groups = G // lay["sets"]
    first, end = start, start + n
    g_first = first >> 2
    tiles = -(-(((end - 1) >> 2) + 1 - g_first) // G)
    W = blocks * WARPS
    flush_every = FLUSH_SAMPLES // S
    lane = torch.arange(32)
    gid, t, m = lane >> 2, lane & 3, lane >> 3

    def product_rows(hi, lo):
        """(W, 16, G, 4) hi and lo sources of the product's rows 0-15 as
        stored (swizzled), and each row's (set, stored row or -1)."""
        src = {False: torch.zeros((W, 16, G, 4)), True: torch.zeros((W, 16, G, 4))}
        where = []
        for prow in range(16):
            if lay["stacked"]:
                sset, r = (prow & 7) // lay["rows"], (prow & 7) % lay["rows"]
            else:
                sset, r = 0, prow
            if r < k:
                src[False][:, prow], src[True][:, prow] = hi[:, r], lo[:, r]
            elif r == k and lay["ones_row"]:
                src[False][:, prow] = 1.0
            where.append((sset, r if r < k else -1))
        return src, where

    def ldsm(src, where, roles, step):
        """ldmatrix: register i of lane 4 gid + t is float t of row gid of
        matrix i; ``roles[i](row)`` gives matrix i's (product row, half,
        lo) for its row 0-7.  (W, 32, len(roles))."""
        regs = []
        for role in roles:
            prows, phys, los = [], [], []
            for row in range(8):
                prow, half, use_lo = role(row)
                sset, r = where[prow]
                logical = sset * set_groups + 2 * step + half
                phys.append(logical ^ swizzle_key(k, r, logical) if r >= 0 else logical)
                prows.append(prow)
                los.append(use_lo)
            if len(set(los)) != 1:
                raise AssertionError("a matrix reads one half")
            got = src[los[0]][:, torch.tensor(prows)[:, None], torch.tensor(phys)[:, None],
                              torch.arange(4)[None, :]]  # (W, 8 rows, 4 words)
            regs.append(got.reshape(W, 32))
        return torch.stack(regs, dim=-1)

    def frag_a(regs):
        """The 16 x 8 A operand from its fragment registers."""
        a = torch.zeros((W, 16, 8), dtype=torch.float32)
        a[:, gid, t], a[:, gid + 8, t] = regs[..., 0], regs[..., 1]
        a[:, gid, t + 4], a[:, gid + 8, t + 4] = regs[..., 2], regs[..., 3]
        return a

    def frag_b(b0, b1):
        """The 8 x 8 B operand from b0, b1 (depths t, t + 4 of column gid)."""
        b = torch.zeros((W, 8, 8), dtype=torch.float32)
        b[:, t, gid], b[:, t + 4, gid] = b0, b1
        return b

    def mma(acc, a, b):
        """acc += a b: the step's eight products summed, then rounded."""
        acc += torch.bmm(a.double(), b.double()).to(torch.float32)

    acc = torch.zeros((W, 16, 16), dtype=torch.float32)  # stacked: hi.hi | lo.hi; else hi.hi
    acc_hl = torch.zeros((W, 16, 16), dtype=torch.float32)  # above k = 8: hi.lo
    zsum = torch.zeros((W, 16, 4), dtype=torch.float32)  # k = 8, 16: B's z a column, a lane t
    e = torch.zeros((W, 16, 16), dtype=torch.float64)
    ez = torch.zeros((W, 16, 4), dtype=torch.float64)
    twice = torch.full((16,), 2.0, dtype=torch.float32)
    if lay["ones_row"] and not lay["stacked"]:
        twice[k] = 1.0
    scored = torch.zeros((k, n), dtype=torch.int64)
    votes = 0
    n_calls = 0

    def flush():
        if lay["stacked"]:
            e.add_(acc.double())
        else:
            e.add_((twice[None, :, None].double() * acc_hl.double() + acc.double())
                   .to(torch.float32).double())
        ez.add_(zsum.double())
        acc.zero_()
        acc_hl.zero_()
        zsum.zero_()

    def products(hi, lo):
        """One pass's tiles through the tensor cores, k-step by k-step."""
        src, where = product_rows(hi, lo)
        for step in range(lay["steps"]):
            if lay["stacked"]:
                a_regs = ldsm(src, where, [lambda r: (r, 0, False), lambda r: (r, 0, True),
                                           lambda r: (r, 1, False), lambda r: (r, 1, True)], step)
                # B (hi rows 0-7 at depths t, t + 4) is A's registers 0 and 2.
                b0, b1 = a_regs[..., 0], a_regs[..., 2]
                mma(acc[:, :, 0:8], frag_a(a_regs), frag_b(b0, b1))
                if not lay["ones_row"]:  # k = 4, 8: B's column gid, hi and lo
                    zsum[:, gid, t] += (b0 + a_regs[..., 1])
                    zsum[:, gid, t] += (b1 + a_regs[..., 3])
            else:
                a_regs = ldsm(src, where, [lambda r: (r, 0, False), lambda r: (r + 8, 0, False),
                                       lambda r: (r, 1, False), lambda r: (r + 8, 1, False)], step)
                roles_b = [lambda r: (r, 0, None), lambda r: (r, 1, None),
                           lambda r: (r + 8, 0, None), lambda r: (r + 8, 1, None)]
                b_hi = ldsm(src, where, [lambda r, f=f: f(r)[:2] + (False,) for f in roles_b], step)
                b_lo = ldsm(src, where, [lambda r, f=f: f(r)[:2] + (True,) for f in roles_b], step)
                a_hi = frag_a(a_regs)
                mma(acc[:, :, 0:8], a_hi, frag_b(b_hi[..., 0], b_hi[..., 1]))
                mma(acc_hl[:, :, 0:8], a_hi, frag_b(b_lo[..., 0], b_lo[..., 1]))
                mma(acc[:, :, 8:16], a_hi, frag_b(b_hi[..., 2], b_hi[..., 3]))
                mma(acc_hl[:, :, 8:16], a_hi, frag_b(b_lo[..., 2], b_lo[..., 3]))
                if not lay["ones_row"]:  # k = 16: B's columns gid and gid + 8
                    zsum[:, gid, t] += (b_hi[..., 0] + b_lo[..., 0])
                    zsum[:, gid, t] += (b_hi[..., 1] + b_lo[..., 1])
                    zsum[:, gid + 8, t] += (b_hi[..., 2] + b_lo[..., 2])
                    zsum[:, gid + 8, t] += (b_hi[..., 3] + b_lo[..., 3])

    empty = torch.zeros((W, k, G, 4), dtype=torch.float32)
    previous = (empty, empty)
    for p in range(-(-tiles // W)):
        tile_ids = torch.arange(W, dtype=torch.int64) + p * W
        active = tile_ids < tiles  # a warp past the last tile stores nothing
        g0 = g_first + tile_ids * G
        tile, v, rows, sample = _tile_scores(seed_words, columns, g0[active], first, end, score)
        votes += v
        n_calls += int(active.sum()) * int(calls(k)[0].numel())
        scored.index_put_((rows, sample - first), torch.ones_like(rows), accumulate=True)
        tile = torch.cat([tile, torch.zeros((W - tile.shape[0], *tile.shape[1:]))])
        hi = tf32_rna(tile)
        lo = tf32_rna(tile - hi) if split else torch.zeros_like(hi)
        # Each pass multiplies the tiles of the pass before (zeros before the
        # first), then flushes every flush_every passes.
        products(*previous)
        previous = (hi, lo)
        if (p + 1) % flush_every == 0:
            flush()
    products(*previous)
    flush()

    # The block reduction: warps in order within a block, then the blocks.
    P = k + k * (k + 1) // 2
    per_warp = torch.zeros((W, P), dtype=torch.float64)
    pairs = [(k, i) for i in range(k)] + [(i, j) for i in range(k) for j in range(i, k)]
    for p, (i, j) in enumerate(pairs):
        if p < k and not lay["ones_row"]:  # each set's row of column j, each lane t
            for sset in range(lay["sets"]):
                row = lay["rows"] * sset + j
                for q in range(4):
                    per_warp[:, p] += ez[:, row, q]
        elif lay["stacked"]:
            for sset in range(lay["sets"]):
                x, y = lay["rows"] * sset + i, lay["rows"] * sset + j
                per_warp[:, p] += e[:, x, y] + e[:, 8 + x, y] + e[:, 8 + y, x]
        elif p < k:
            per_warp[:, p] = e[:, k, j]
        elif i == j:
            per_warp[:, p] = e[:, i, i]
        else:
            per_warp[:, p] = 0.5 * (e[:, i, j] + e[:, j, i])
    sums = torch.zeros(P, dtype=torch.float64)
    for b in range(blocks):
        block = torch.zeros(P, dtype=torch.float64)
        for w in range(WARPS):
            block += per_warp[b * WARPS + w]
        sums += block
    return sums, {"scored": scored, "votes": votes, "calls": n_calls}
