"""Counter-based RNG streams, bit-exact with ``jax.random`` (port of
``kmc_tpu/rng.py``).

A key is an int64 tensor [..., 2] holding the two uint32 words of a JAX
Threefry-2x32 key (``jax.random.key_data``).  The functions reproduce
``jax.random`` with ``jax_threefry_partitionable=True`` (the default from
JAX 0.5): ``fold_in``, ``split``, ``bits`` and float32 ``uniform`` give the
same bits as JAX for the same key, so the port and the JAX package draw the
same numbers and their stochastic stages can be compared step by step.

Torch has no shift for uint32 on the CPU, so the words travel in int64 and
every result is masked to 32 bits; the same code runs on both devices.
Leading key axes broadcast: a key of shape [R, 2] and a draw of shape
``shape`` give [R, *shape].
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Stable stream identifiers (append-only; same values as kmc_tpu.rng).
STREAM_INIT = 0
STREAM_MOVE = 1
STREAM_REACT_TRANS = 2
STREAM_REACT_MONO_CIS = 3
STREAM_REACT_CIS = 4
STREAM_DISS_TRANS = 5
STREAM_DISS_MONO_CIS = 6
STREAM_DISS_CIS = 7
STREAM_ALIGN = 8
STREAM_LATTICE = 9

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (jax._src.prng._threefry2x32_lowering)
    on int64 tensors holding uint32 values; all four broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key_from_seed(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` as int64[2].  With
    JAX's 64-bit mode off (the JAX package's setting) the seed is taken
    modulo 2^32 and the high word is 0."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` is an int or an integer tensor that
    broadcasts against the key's leading axes."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), device=key.device)
    data = data.to(torch.int64) & _MASK
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def _counters(key, shape):
    """Key words shaped to broadcast against a flat iota over ``shape``."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    pad = (1,) * len(shape)
    k0 = key[..., 0].reshape(*key.shape[:-1], *pad)
    k1 = key[..., 1].reshape(*key.shape[:-1], *pad)
    return k0, k1, torch.zeros_like(lo), lo


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: [..., 2] -> [..., num, 2]."""
    b1, b2 = threefry2x32(*_counters(key, (num,)))
    return torch.stack([b1, b2], dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 in [0, 2^32)."""
    b1, b2 = threefry2x32(*_counters(key, tuple(shape)))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32, [0, 1)."""
    fbits = (bits(key, shape) >> 9) | 0x3F800000
    return fbits.to(torch.int32).view(torch.float32) - 1.0


def permutation(key: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jax.random.permutation(key, x)`` for a 1-D ``x``: JAX's
    ``_shuffle``, ceil(3 ln n / ln(2^32 - 1)) rounds, each a ``split``, then
    32-bit ``bits`` as sort keys and a stable sort of ``x`` by them."""
    n = x.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key).unbind(-2)
        order = torch.sort(bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def base_key(seed: int, device=None):
    return key_from_seed(seed, device)


def replica_key(key, replica):
    """Independent per-replica stream (fold_in of the base key)."""
    return fold_in(key, replica)


def step_key(key, step):
    """Per-timestep subkey."""
    return fold_in(key, step)


def stream_key(skey, stream: int):
    """Per-(step, subsystem) subkey."""
    return fold_in(skey, stream)


def _threshold_words(p: float):
    """(hi, lo) words of p * 2^64, in float32 as kmc_tpu.rng computes them."""
    f = np.float32
    t = f(p) * f(4294967296.0)
    th = np.floor(t)
    tl = np.floor((t - th) * f(4294967296.0))
    return (int(np.clip(th, f(0.0), f(4294967040.0))),
            int(np.clip(tl, f(0.0), f(4294967040.0))))


def _threshold_tensors(p: torch.Tensor):
    """The same words for a float32 tensor of probabilities, on its device.
    Each step is exact in float32 (scalings by 2^32, a floor, the
    difference of a number and its floor), so the words equal
    ``_threshold_words`` of each element; 4294967040 is the largest
    float32 below 2^32."""
    t = p.to(torch.float32) * 4294967296.0
    th = torch.floor(t)
    tl = torch.floor((t - th) * 4294967296.0)
    return (torch.clamp(th, 0.0, 4294967040.0).to(torch.int64),
            torch.clamp(tl, 0.0, 4294967040.0).to(torch.int64))


def tiny_bernoulli(key: torch.Tensor, p, shape) -> torch.Tensor:
    """Bernoulli(p) resolving p down to ~5e-20, required for the reference's
    dissociation probabilities (~1e-12): two 32-bit draws form a 64-bit
    uniform that fires iff (hi, lo) < p * 2^64.  A float32 ``uniform < p``
    fires at its 2^-23 quantization regardless of p (the round-2 bond_cis
    bias, PARITY.md) and must never replace this.

    ``p`` is a float, or a float32 tensor that broadcasts against the key's
    leading axes (0-d, or one value per key, [R] for a key of [R, 2])."""
    kh, kl = split(key).unbind(-2)
    hi = bits(kh, shape)
    lo = bits(kl, shape)
    if torch.is_tensor(p):
        th, tl = _threshold_tensors(p.reshape(*p.shape, *(1,) * len(shape)))
    else:
        th, tl = _threshold_words(p)
    return (hi < th) | ((hi == th) & (lo < tl))
