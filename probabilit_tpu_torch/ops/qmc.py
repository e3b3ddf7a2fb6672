"""Quasi-Monte-Carlo generators (Sobol, Halton, Latin hypercube) and
antithetic uniforms, in PyTorch.

Port of ``probabilit_tpu/ops/qmc.py:39-520``.  Every generator is
index-addressable: point ``i`` of dimension ``j`` is a pure function of
``(offset + i, j)`` and the generator's randomisation, so block ``b`` of a
streamed run (``offset = b * block``) equals rows ``[offset, offset + n)``
of one long sequence exactly.

* Sobol: a digital (t,s)-sequence in base 2 with direction numbers from
  primitive polynomials over GF(2) and seeded odd initial values, searched
  on the host by ``csrc/sobol.cpp`` (built at first use, ``_build.py``;
  ``_direction_numbers_py`` is its plain twin), scrambled by a hash-based
  Owen scramble per dimension.
* Halton: radical inverses in the first d primes with a Cranley-Patterson
  shift.
* Latin hypercube: a keyed cycle-walking Feistel permutation of the strata
  per dimension, jittered by a keyed hash of the index.
* Antithetic: rows ``2k`` and ``2k + 1`` are ``u`` and ``1 - u``.

Each generator takes its randomisation as an argument: the Owen seeds,
the shift, the Feistel round keys or the Philox key.  ``generate`` draws
them from an integer seed (``randomisation``); the JAX package draws them
from its jax keys, which the port cannot reproduce, so its points differ
by design while the tests pass in the JAX package's own values and compare
points bitwise.

Integer words are int32 tensors holding uint32 bit patterns, whose sums
and products wrap as uint32's do (see ``ops/hashing.py``; antithetic's
Philox words are int64, as in ``ops/philox.py``).  Sobol is generated
one column at a time, through byte tables of the direction numbers over
just the bytes that ``offset + n`` can set; bit reversal goes through a
16-bit table.  Both give the reference's words exactly.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.ops import philox as _philox
from probabilit_tpu_torch.ops.hashing import keyed_mix32 as _mix32
from probabilit_tpu_torch.ops.hashing import shr, signed

__all__ = [
    "generate",
    "generate_sharded",
    "randomisation",
    "sobol",
    "halton",
    "latin_hypercube",
    "uniform",
    "antithetic",
    "clamp_open_unit",
    "clamp_open_unit_wide",
]

_MAX_BITS = 32
_FEISTEL_ROUNDS = 4
_MASK32 = 0xFFFFFFFF


# =====================================================================
# Direction numbers (host, once per dimension count)
# =====================================================================


def _primitive_polynomials(count):
    """First ``count`` primitive polynomials over GF(2), ascending degree,
    as ``(degree, bitmask)`` with the leading and trailing 1 bits, e.g.
    x^3 + x + 1 -> (3, 0b1011)."""

    def polymulmod(a, b, mod, deg):
        result = 0
        while b:
            if b & 1:
                result ^= a
            b >>= 1
            a <<= 1
            if a >> deg & 1:
                a ^= mod
        return result

    def x_pow_mod(e, mod, deg):
        result, base = 1, 2
        while e:
            if e & 1:
                result = polymulmod(result, base, mod, deg)
            base = polymulmod(base, base, mod, deg)
            e >>= 1
        return result

    def prime_factors(n):
        factors, p = set(), 2
        while p * p <= n:
            while n % p == 0:
                factors.add(p)
                n //= p
            p += 1
        if n > 1:
            factors.add(n)
        return factors

    found = []
    degree = 1
    while len(found) < count:
        order = (1 << degree) - 1
        factors = prime_factors(order)
        for poly in range(1 << degree, 1 << (degree + 1)):
            if not poly & 1:
                continue
            # Primitive iff ord(x) = 2^degree - 1 in GF(2)[x]/(poly).
            if x_pow_mod(order, poly, degree) != 1:
                continue
            if any(x_pow_mod(order // q, poly, degree) == 1 for q in factors):
                continue
            found.append((degree, poly))
            if len(found) == count:
                break
        degree += 1
    return found


def _splitmix64(x):
    """Language-independent counter hash (as ``csrc/sobol.cpp``)."""
    mask = (1 << 64) - 1
    x = (x + 0x9E3779B97F4A7C15) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    return x ^ (x >> 31)


def _direction_numbers_py(d):
    """(d, 32) uint32 direction numbers: the plain twin of ``csrc/sobol.cpp``.

    Dimension 0 is the van der Corput sequence; dimension j >= 1 uses the
    recurrence of the j-th primitive polynomial with odd initial values
    m_i < 2^i from a splitmix64 counter hash.
    """
    V = np.zeros((d, _MAX_BITS), dtype=np.uint64)
    for k in range(_MAX_BITS):
        V[0, k] = 1 << (_MAX_BITS - 1 - k)
    if d > 1:
        for j, (s, poly) in enumerate(_primitive_polynomials(d - 1), start=1):
            a = [(poly >> (s - i)) & 1 for i in range(1, s)]
            m = [1] + [
                int((_splitmix64(j * 64 + i) % (1 << (i - 1))) * 2 + 1)
                for i in range(2, s + 1)
            ]
            m = m[:s]
            for k in range(s, _MAX_BITS):
                new = m[k - s] ^ (m[k - s] << s)
                for i in range(1, s):
                    if a[i - 1]:
                        new ^= m[k - i] << i
                m.append(new & 0xFFFFFFFF)
            for k in range(_MAX_BITS):
                V[j, k] = (m[k] << (_MAX_BITS - 1 - k)) & 0xFFFFFFFF
    return V.astype(np.uint32)


def _native_directions(d):
    """(d, 32) uint32 direction numbers from ``csrc/sobol.cpp``, built with
    the host compiler at first use.  A failed build raises."""
    from probabilit_tpu_torch import _build

    lib = _build.load_host("sobol")
    fn = lib.probnative_sobol_directions
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint32)]
    fn.restype = ctypes.c_int
    out = np.zeros((d, _MAX_BITS), dtype=np.uint32)
    status = fn(int(d), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if status != 0:
        raise RuntimeError(f"csrc/sobol.cpp failed for d={d} (status {status}).")
    return out


@functools.lru_cache(maxsize=8)
def _direction_numbers_np(d):
    """(d, 32) uint32 direction numbers of a d-dimensional Sobol sequence."""
    return _native_directions(d)


@functools.lru_cache(maxsize=8)
def _byte_tables_np(d, nbytes):
    """(d, nbytes, 256) int32 words: entry [j, b, v] is the XOR of the
    direction numbers of column j whose bits 8b..8b+7 are set in v."""
    V = _direction_numbers_np(d)
    v = np.arange(256, dtype=np.uint32)
    T = np.zeros((d, nbytes, 256), np.uint32)
    for b in range(nbytes):
        for t in range(8):
            T[:, b, :] ^= ((v >> t) & 1)[None, :] * V[:, 8 * b + t][:, None]
    return T.view(np.int32)


@functools.lru_cache(maxsize=1)
def _rev16_np():
    v = np.arange(1 << 16, dtype=np.int32)
    r = np.zeros_like(v)
    for b in range(16):
        r |= ((v >> b) & 1) << (15 - b)
    return r


_DEVICE_TABLES = {}


def _on_device(name, array, device):
    key = (name, str(device))
    table = _DEVICE_TABLES.get(key)
    if table is None:
        if len(_DEVICE_TABLES) > 32:
            _DEVICE_TABLES.pop(next(iter(_DEVICE_TABLES)))
        table = _DEVICE_TABLES[key] = torch.from_numpy(array).to(device)
    return table


# =====================================================================
# Bit manipulation
# =====================================================================


def _reverse_bits32(x):
    """Bit reversal of 32-bit words, through a 16-bit table."""
    rev = _on_device("rev16", _rev16_np(), x.device)
    return (rev[x & 0xFFFF] << 16) | rev[shr(x, 16)]


def _owen_scramble(bits, seeds):
    """Hash-based nested-uniform (Owen) scrambling of radical-inverse bits
    (Laine-Karras style, on the bit-reversed words); ``seeds`` is one word
    per column and broadcasts over the sample axis."""
    x = _reverse_bits32(bits) + signed(seeds)
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ (x * signed(c))
    return _reverse_bits32(x)


def _bits_to_unit(bits, dtype):
    """32-bit words to uniforms in (0, 1): all 32 bits in float64, the top
    24 (a logical shift) in float32, then the open-interval clamp."""
    if dtype == torch.float64:
        return clamp_open_unit(_unsigned(bits).to(torch.float64) * 2.0**-32)
    return clamp_open_unit(shr(bits, 8).to(torch.float32) * 2.0**-24)


def clamp_open_unit(q):
    """Clamp quantiles into the OPEN interval (0, 1).

    A float32 uniform on [0, 1) hits exactly 0 about once per 2^24 draws,
    which an unbounded inverse CDF maps to -inf.  The clamp moves each
    endpoint by one step of the generator's grid: 2^-24 in float32,
    2^-53 in float64.
    """
    tiny = 2.0**-24 if q.dtype == torch.float32 else 2.0**-53
    return torch.clamp(q, tiny, 1.0 - tiny)


def clamp_open_unit_wide(q):
    """Clamp to (0, 1) at the float's normal-range floor, not the
    generator's grid: quantiles computed by a graph (a copula marginal, a
    tilt) are legitimately far below 2^-24, and the wide ppfs
    (``ops.ppf.call_wide``) resolve them down to ~1e-37 in float32.  The
    upper side is the largest float below 1."""
    if q.dtype == torch.float32:
        return torch.clamp(q, 1e-37, 1.0 - 2.0**-24)
    return torch.clamp(q, 1e-300, 1.0 - 2.0**-53)


# =====================================================================
# Generators
# =====================================================================


def _resolve(dtype, device):
    dtype = config.float_dtype() if dtype is None else dtype
    device = config.device() if device is None else torch.device(device)
    return dtype, device


def _wrap_offset_uint32(offset):
    """The offset as a 32-bit counter (index arithmetic is modulo 2^32)."""
    return int(offset) % (1 << 32)


def _words(n, offset, device):
    """Indices ``offset + i`` modulo 2^32, as int32 words."""
    idx = (torch.arange(n, dtype=torch.int64, device=device) + offset) & _MASK32
    return idx.to(torch.int32)


def _unsigned(words):
    """int32 words as their uint32 values, in int64."""
    return words.to(torch.int64) & _MASK32


def _below(words, limit):
    """``words < limit`` for uint32 words and an integer limit in (0, 2^32)."""
    if limit == 1 << 31:
        return words >= 0
    if limit < 1 << 31:
        return (words >= 0) & (words < limit)
    return (words >= 0) | (words < signed(limit))


def sobol(seeds, n, d, dtype=None, scramble=True, offset=0, device=None):
    """``n`` points from index ``offset`` of a d-dimensional Sobol sequence,
    Owen-scrambled by ``seeds`` (one 32-bit word per dimension) unless
    ``scramble=False``.  Indices are modulo 2^32."""
    dtype, device = _resolve(dtype, device)
    offset = _wrap_offset_uint32(offset)
    out = torch.empty((n, d), dtype=dtype, device=device)
    if n == 0 or d == 0:
        return out
    # Only the bits that indices up to offset + n - 1 can set: the gray
    # code of an index below 2^k is below 2^k, and higher bits add nothing.
    top = offset + n - 1
    nbits = _MAX_BITS if top >= 1 << 32 else top.bit_length()
    nbytes = (nbits + 7) // 8
    idx = _words(n, offset, device)
    gray = idx ^ shr(idx, 1)
    digits = [(gray >> (8 * b)) & 0xFF for b in range(nbytes)]
    del idx, gray
    tables = _on_device(f"sobol{d}x{nbytes}", _byte_tables_np(d, nbytes), device)
    if scramble:
        seeds = np.asarray(seeds, dtype=np.int64).reshape(-1) & _MASK32
    for j in range(d):
        acc = torch.zeros((n,), dtype=torch.int32, device=device)
        for b, digit in enumerate(digits):
            acc = acc ^ tables[j, b][digit]
        if scramble:
            acc = _owen_scramble(acc, int(seeds[j]))
        out[:, j] = _bits_to_unit(acc, dtype)
    return out


@functools.lru_cache(maxsize=8)
def _first_primes(d):
    primes, candidate = [], 2
    while len(primes) < d:
        if all(candidate % p for p in primes):
            primes.append(candidate)
        candidate += 1
    return np.array(primes, dtype=np.int64)


def _radical_inverse(idx, base, digits, compute):
    """``sum_k digit_k(idx) * f_k`` over ``digits`` base-``base`` digits,
    ``f_k = base^-(k+1)`` accumulated as Python floats, the digits by
    floor division and modulo (int32 semantics for negative indices).

    In float32 the sum follows XLA's CPU code for the JAX package's loop:
    the first two products are added with the first one fused, then each
    digit joins by a fused multiply-add.  A fused ``a * b + c`` is computed
    here in float64 (the product exact) and rounded once more.  In
    float64 the products and sums are rounded apart.
    """
    i = idx
    f = 1.0 / base
    terms = []
    for _ in range(digits):
        terms.append((torch.remainder(i, base), f))
        i = torch.div(i, base, rounding_mode="floor")
        f = f / base
    if compute == torch.float64:
        acc = torch.zeros(idx.shape, dtype=compute, device=idx.device)
        for digit, f in terms:
            acc = acc + digit.to(compute) * f
        return acc

    def fused(digit, f, acc):
        return (digit.double() * float(np.float32(f)) + acc.double()).float()

    digit, f = terms[0]
    acc = digit.to(torch.float32) * float(np.float32(f))
    if len(terms) > 1:
        d1, f1 = terms[1]
        acc = fused(digit, f, d1.to(torch.float32) * float(np.float32(f1)))
    for digit, f in terms[2:]:
        acc = fused(digit, f, acc)
    return acc


def halton(shift, n, d, dtype=None, scramble=True, offset=0, device=None):
    """``n`` points from index ``offset`` of a d-dimensional Halton
    sequence, rotated by ``shift`` (one uniform per dimension) unless
    ``scramble=False``.

    Indices are int32 in float32 mode (offsets below 2^31) and int64 in
    float64 mode, as in the JAX package.  In float32 each digit's
    ``acc + digit * f`` is computed in float64 and rounded once, as XLA's
    fused multiply-add does on the CPU.
    """
    dtype, device = _resolve(dtype, device)
    wide = dtype == torch.float64
    bits = 64 if wide else 32
    if int(offset) >= 2 ** (bits - 1):
        raise ValueError(
            f"Halton streams are int{bits}-indexed: offset must be "
            f"< 2^{bits - 1}, got {int(offset)}."
        )
    primes = _first_primes(d)
    compute = torch.float64 if wide else torch.float32
    idx = torch.arange(n, dtype=torch.int64, device=device) + int(offset)
    top = int(offset) + n - 1
    if not wide and top >= 1 << 31:
        idx = ((idx + (1 << 31)) & _MASK32) - (1 << 31)  # int32 wraps
    out = torch.empty((n, d), dtype=dtype, device=device)
    if scramble:
        shift = np.asarray(shift, dtype=np.float64 if wide else np.float32).reshape(-1)
    for j in range(d):
        base = int(primes[j])
        digits = int(np.ceil(np.log(2**31) / np.log(base)))
        if wide or top < 1 << 31:
            # Digits past the largest index's add exactly 0.
            needed, power = 0, 1
            while power <= top:
                power *= base
                needed += 1
            digits = min(digits, needed)
        acc = _radical_inverse(idx, base, digits, compute)
        if scramble:
            acc = torch.fmod(acc + float(shift[j]), 1.0)
        out[:, j] = clamp_open_unit(acc.to(dtype))
    return out


def _feistel_permutation(idx, round_keys, total):
    """Keyed bijection of [0, total): a cycle-walking balanced Feistel
    network over [0, 2^m), m the smallest even width with 2^m >= total.

    ``idx``: int32 words; ``round_keys``: at least ``_FEISTEL_ROUNDS``
    words.  Lanes that land out of the domain walk the network again;
    only those lanes are walked, by index, one host read per walk.  A lane
    that STARTS out of the domain (a padding row past the end of a final
    block, which every caller discards) may sit on a cycle inside
    [total, 2^m) and is frozen at stratum 0 instead.
    """
    if total <= 1:
        return torch.zeros_like(idx)
    if total > 1 << 32:
        raise ValueError(f"LHS strata are uint32-indexed: total must be <= 2^32, got {total}.")
    m = max(2, int(np.ceil(np.log2(total))))
    m += m & 1
    h = m // 2
    mask_h = (1 << h) - 1
    keys = [int(k) & _MASK32 for k in round_keys]

    def feistel(v):
        left = shr(v, h) & mask_h
        right = v & mask_h
        for r in range(_FEISTEL_ROUNDS):
            left, right = right, left ^ (_mix32(right, keys[r]) & mask_h)
        return (left << h) | right

    out = feistel(idx)
    if total == 1 << 32:
        return out  # the network is a bijection of the whole word
    in_dom = _below(idx, total)
    lanes = torch.nonzero(in_dom & ~_below(out, total)).squeeze(1)
    while lanes.numel():
        walked = feistel(out[lanes])
        out[lanes] = walked
        lanes = lanes[~_below(walked, total)]
    return torch.where(in_dom, out, torch.zeros_like(out))


def latin_hypercube(round_keys, n, d, dtype=None, offset=0, total=None, device=None):
    """Latin hypercube rows ``[offset, offset + n)`` of a ``total``-point
    stratification (default ``n``): the stratum of row i in dimension j is
    a keyed Feistel permutation of i under ``round_keys[j, :4]``, the
    jitter inside it ``keyed_mix32(i, round_keys[j, 4])``'s top 24 bits."""
    dtype, device = _resolve(dtype, device)
    total = n if total is None else int(total)
    if d == 0:
        return torch.zeros((n, 0), dtype=dtype, device=device)
    offset = _wrap_offset_uint32(offset)
    keys = np.asarray(round_keys, dtype=np.int64).reshape(d, _FEISTEL_ROUNDS + 1) & _MASK32
    idx = _words(n, offset, device)
    inv_total = torch.tensor(1.0 / total, dtype=dtype, device=device)
    out = torch.empty((n, d), dtype=dtype, device=device)
    for j in range(d):
        strata = _feistel_permutation(idx, keys[j, :_FEISTEL_ROUNDS], total)
        if total > 1 << 31:
            strata = _unsigned(strata)
        jitter = shr(_mix32(idx, int(keys[j, _FEISTEL_ROUNDS])), 8).to(dtype) * 2.0**-24
        out[:, j] = (strata.to(dtype) + jitter) * inv_total
    return clamp_open_unit(out)


def uniform(seed, n, d, dtype=None, device=None):
    """Pseudo-random quantiles (the ``method=None`` path) in (0, 1): a
    ``torch.Generator`` seeded with ``seed``."""
    dtype, device = _resolve(dtype, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return clamp_open_unit(torch.rand((n, d), generator=gen, dtype=dtype, device=device))


def antithetic(key, n, d, dtype=None, offset=0, device=None):
    """Antithetic pseudo-random quantiles: row ``2k`` is a uniform vector
    ``u`` and row ``2k + 1`` its reflection ``1 - u``.

    The base uniforms of pair ``p`` are Philox4x32-10 under ``key`` (two
    words) at counter ``(p, g, 0, 0)``: in float32 column ``c`` is word
    ``c % 4`` of group ``g = c // 4`` (its top 24 bits), in float64 words
    ``2 (c % 2)`` and ``2 (c % 2) + 1`` of group ``c // 2`` (53 bits).  So
    row i is a pure function of ``(key, offset + i)``, and a pair split
    by a block boundary stays consistent.
    """
    dtype, device = _resolve(dtype, device)
    if d == 0:
        return torch.zeros((n, 0), dtype=dtype, device=device)
    offset = _wrap_offset_uint32(offset)
    k0, k1 = (int(k) & _MASK32 for k in np.asarray(key, dtype=np.int64).reshape(-1)[:2])
    pair_mask = (1 << 31) - 1
    gidx = _unsigned(_words(n, offset, device))
    pair0 = offset >> 1
    n_pairs = ((offset + n - 1) >> 1) - pair0 + 1
    rel = ((gidx >> 1) - pair0) & pair_mask
    reflect = (gidx & 1).bool()
    del gidx
    pairs = (torch.arange(n_pairs, dtype=torch.int64, device=device) + pair0) & pair_mask
    zero = torch.zeros_like(pairs)
    per_call = 2 if dtype == torch.float64 else 4
    out = torch.empty((n, d), dtype=dtype, device=device)
    for g in range(-(-d // per_call)):
        words = _philox.philox4x32_10((pairs, zero + g, zero, zero), (k0, k1))
        for w in range(min(per_call, d - g * per_call)):
            if per_call == 4:
                u = (words[w] >> 8).to(torch.float32) * 2.0**-24
            else:
                hi, lo = words[2 * w] >> 5, words[2 * w + 1] >> 6
                u = (hi * (1 << 26) + lo).to(torch.float64) * 2.0**-53
            u = u[rel]
            out[:, g * per_call + w] = torch.where(reflect, 1.0 - u, u)
    return clamp_open_unit(out)


_METHODS = {
    "lhs": latin_hypercube,
    "halton": halton,
    "sobol": sobol,
    "antithetic": antithetic,
}

_SPAWN = {"sobol": 1, "halton": 2, "lhs": 3, "antithetic": 4}


def randomisation(method, seed, d, dtype=None):
    """The randomisation ``generate`` gives a method under an integer
    ``seed`` (numpy ``SeedSequence`` words, one stream per method): Sobol's
    (d,) Owen seeds in [0, 2^31), Halton's (d,) shift on the dtype's grid,
    the (d, 5) Feistel round keys and jitter keys of LHS, or antithetic's
    two-word Philox key."""
    name = method.lower().strip()
    dtype = config.float_dtype() if dtype is None else dtype
    count = {"sobol": d, "halton": 2 * d, "lhs": d * (_FEISTEL_ROUNDS + 1), "antithetic": 2}[name]
    seq = np.random.SeedSequence(int(seed) % 2**64, spawn_key=(_SPAWN[name],))
    words = seq.generate_state(max(count, 1), np.uint32).astype(np.int64)[:count]
    if name == "sobol":
        return words & 0x7FFFFFFF
    if name == "halton":
        if dtype == torch.float64:
            return ((words[:d] >> 5) * (1 << 26) + (words[d:] >> 6)) * 2.0**-53
        return ((words[:d] >> 8) * 2.0**-24).astype(np.float32)
    if name == "lhs":
        return words.reshape(d, _FEISTEL_ROUNDS + 1)
    return words


def generate(method, seed, n, d, dtype=None, offset=0, total=None, device=None):
    """Quantile matrix (n, d) for a named method (None, "lhs", "halton",
    "sobol" or "antithetic") under an integer ``seed``, on ``device``
    (default ``config.device()``).

    ``offset`` starts the index-addressable sequence at a later point:
    block ``b`` of a streamed run passes ``offset=b*block_size``, and the
    concatenated blocks equal one single-shot sequence exactly.  ``total``
    (LHS only) is the stratum count of the whole sample the block belongs
    to; it defaults to ``n``.
    """
    if method is None:
        if offset != 0:
            raise ValueError("offset requires an index-addressable QMC method.")
        return uniform(seed, n, d, dtype, device)
    name = method.lower().strip()
    if name not in _METHODS:
        raise KeyError(f"Unknown sampling method: {method!r}")
    dtype, device = _resolve(dtype, device)
    if d == 0:
        return torch.zeros((n, 0), dtype=dtype, device=device)
    r = randomisation(name, seed, d, dtype)
    if name == "lhs":
        return latin_hypercube(r, n, d, dtype=dtype, offset=offset, total=total, device=device)
    return _METHODS[name](r, n, d, dtype=dtype, offset=offset, device=device)


def generate_sharded(method, seed, n, d, dtype=None, device=None, offset=0, total=None):
    """``generate`` with the sample axis split over the active mesh.

    Without a mesh, ``generate`` on ``device``.  Under one, the row blocks
    of ``parallel/mesh.split_rows``, each on its shard's device: shard s
    generates its own rows ``[start_s, stop_s)`` (``offset + start_s``
    onwards, LHS stratified over ``total``, default ``n``), so the full
    matrix is never built on one device and, points being pure functions
    of their index, the blocks equal slices of one call bitwise.
    ``method=None`` draws from a ``torch.Generator``, which cannot be
    addressed by index: it is generated on ``mesh.devices[0]`` and split.
    """
    from probabilit_tpu_torch.parallel import mesh as _mesh

    mesh = _mesh.current_mesh()
    if mesh is None:
        return generate(method, seed, n, d, dtype, offset=offset, total=total, device=device)
    if method is None:
        return _mesh.split_rows(generate(None, seed, n, d, dtype, device=mesh.devices[0]), mesh)
    total = n if total is None else total
    return tuple(
        generate(method, seed, hi - lo, d, dtype, offset=offset + lo, total=total, device=dev)
        for (lo, hi), dev in zip(_mesh.row_bounds(n, mesh.size), mesh.devices)
    )
