"""Integer avalanche mixers (the murmur3 finalizer family).

Port of ``probabilit_tpu/ops/hashing.py``.  The JAX package computes on
uint32; ``torch.uint32`` lacks shifts, products and XOR on CUDA in some
releases, so here a 32-bit word is an int32 tensor holding its bit
pattern.  Sums and products wrap modulo 2^32 as uint32's do, and a
logical right shift is the arithmetic one masked to the bits that remain
(``shr``).  Constants at or above 2^31 enter as their signed twins
(``signed``).

``fmix32`` is exactly the murmur3 32-bit finalizer (full avalanche: every
input bit flips each output bit with probability ~1/2).
"""

from __future__ import annotations

__all__ = ["fmix32", "keyed_mix32", "shr", "signed", "GOLDEN32"]

GOLDEN32 = 0x9E3779B9  # 2^32 / golden ratio; odd, so * is a bijection


def signed(c):
    """The int32 with the bit pattern of the 32-bit word ``c``."""
    c = int(c) & 0xFFFFFFFF
    return c - (1 << 32) if c >= 1 << 31 else c


def shr(x, k):
    """Logical right shift of int32 words by ``k`` (0 < k < 32)."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def fmix32(h):
    """murmur3 finalizer of int32 words."""
    h = h ^ shr(h, 16)
    h = h * signed(0x85EBCA6B)
    h = h ^ shr(h, 13)
    h = h * signed(0xC2B2AE35)
    return h ^ shr(h, 16)


def keyed_mix32(x, k):
    """Keyed avalanche: ``fmix32((x + k) * GOLDEN32)`` modulo 2^32.

    The odd multiplier is a bijection of Z/2^32, so distinct (x + k)
    values never collide before the finalizer.
    """
    return fmix32((x + signed(k)) * signed(GOLDEN32))
