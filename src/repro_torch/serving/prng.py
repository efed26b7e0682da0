"""The part of JAX's threefry PRNG that the serving engine draws with.

The JAX package samples with ``jax.random`` (default threefry2x32 keys,
``jax_threefry_partitionable`` on, ``jax_high_dynamic_range_gumbel``
off). This module gives the same bits, so a seeded request draws the
same tokens in both packages wherever their logits agree:

  * a key is a pair of uint32 words ``(seed >> 32, seed & 0xFFFFFFFF)``
    (``PRNGKey``);
  * ``threefry2x32`` is the 20-round Threefry-2x32 block cipher: the
    rotations (13, 15, 26, 6) and (17, 29, 16, 24) alternate every four
    rounds, the third key word is ``k1 ^ k2 ^ 0x1BD11BDA`` and a key is
    injected after every four rounds, with the injection count added to
    the second word;
  * ``fold_in(key, d)`` enciphers the counter pair (0, d); ``split(key)``
    enciphers (0, 0) and (0, 1) (the first pair is the carried key, the
    second the key to draw with); the random bits of an array of n words
    are ``b0 ^ b1`` of the pairs (0, i), i = 0..n-1;
  * a uniform in [tiny, 1) takes 23 mantissa bits with the exponent of
    1, minus 1; a Gumbel is ``-log(-log(u))``.

Key arithmetic runs on the host in Python ints (a split is ~130 32-bit
operations, too few to pay for a tensor call each). The Gumbel pass runs
as torch int64 arithmetic masked to 32 bits (torch has no full uint32
arithmetic) on the device of the logits it perturbs, one row per key.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

Key = Tuple[int, int]

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
#: the smallest normal float32, the lower end of the Gumbel's uniform
TINY = float(torch.finfo(torch.float32).tiny)


def threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """Threefry-2x32 (20 rounds) of the counter pair (x0, x1) under
    ``key``, in Python ints."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``."""
    return (seed >> 32) & MASK, seed & MASK


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, data & MASK)


def split(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key)``: (the carried key, the key to draw
    with)."""
    return threefry2x32(key, 0, 0), threefry2x32(key, 0, 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def random_bits(keys: Sequence[Key], n: int, device) -> torch.Tensor:
    """``jax.random.bits(key, (1, n))`` for each of ``keys``: a (len(keys),
    n) int64 tensor of uint32 values on ``device``, row b from keys[b]
    over the counters 0..n-1."""
    k = torch.tensor(keys, dtype=torch.int64, device=device).reshape(-1, 2)
    ks = (k[:, :1], k[:, 1:], k[:, :1] ^ k[:, 1:] ^ PARITY)
    x0 = ks[0]
    x1 = (torch.arange(n, dtype=torch.int64, device=device) + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & MASK
    return x0 ^ x1


def uniform(keys: Sequence[Key], n: int, device) -> torch.Tensor:
    """``jax.random.uniform(key, (1, n), minval=tiny, maxval=1)`` for
    each of ``keys``, float32: the 23 high bits as a mantissa of [1, 2),
    minus 1, then ``max(tiny, f * (1 - tiny) + tiny)``, which in float32
    is ``max(tiny, f)`` (f is 0 or at least 2**-23)."""
    bits = (random_bits(keys, n, device) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return f.clamp_min(TINY)


def gumbel(keys: Sequence[Key], n: int, device) -> torch.Tensor:
    """``jax.random.gumbel(key, (1, n))`` for each of ``keys``: a
    (len(keys), n) float32 tensor on ``device``."""
    return -torch.log(-torch.log(uniform(keys, n, device)))
