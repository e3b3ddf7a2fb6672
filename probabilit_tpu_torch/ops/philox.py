"""Philox4x32-10 counter-based random bits, in plain PyTorch.

The plain twin of the generator inside ``csrc/sampling_math.cuh``, which
stands in for the TPU kernel's hardware PRNG (``pltpu.prng_seed`` /
``prng_random_bits`` in ``probabilit_tpu/engine/pallas_exec.py``).  The
TPU's bits cannot be reproduced; these are Salmon et al.'s Philox4x32
with 10 rounds (Random123), so the kernel's stream can be recomputed here
word for word.

Words are held in int64 tensors with values in [0, 2^32).  A 32x32-bit
product needs 64 unsigned bits, which overflows int64 (0xD2511F53 *
(2^32 - 1) > 2^63), so one factor is split into 16-bit halves.
"""

from __future__ import annotations

import torch

__all__ = ["philox4x32_10", "bits_to_open_unit"]

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m, x):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``m`` and ``x``."""
    p_lo = m * (x & 0xFFFF)  # < 2^48
    p_hi = m * (x >> 16)  # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 of ``counter`` (4 words) under ``key`` (2 words).

    Each word is an int64 tensor (or Python int) in [0, 2^32); the words
    broadcast against each other.  Returns the 4 output words.
    """
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (int(k) & _MASK32 for k in key)
    for r in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def bits_to_open_unit(bits):
    """Map 32 random bits to a float32 uniform on [2^-24, 1 - 2^-24].

    As ``pallas_exec._bits_to_open_unit``: the top 23 bits fill the
    mantissa of 1.0f, giving [1, 2); subtract 1 and clamp.
    """
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = mantissa.view(torch.float32) - 1.0
    tiny = 2.0**-24
    return torch.clamp(u, tiny, 1.0 - tiny)
