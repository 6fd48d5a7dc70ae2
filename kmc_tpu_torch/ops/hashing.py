"""Stateless per-cell counter-based uniforms (port of
``kmc_tpu/ops/hashing.py``), bit-exact with the JAX package.

The lattice engine draws one uniform per (cell, step, substream) from an
integer hash of (global cell index, step, stream salt): two
multiply-xor-shift avalanche rounds.  The draw depends only on the cell's
global coordinates, so a tile, a halo copy or another device computes the
same value; the CUDA kernel K3 (``csrc/lattice.cu``) computes the same
hash in uint32 arithmetic.

Torch has no uint32 shifts on the CPU, so the words travel in int64 and
are masked to 32 bits after every add, multiply and shift, as ``rng.py``
does.  A product of two 32-bit words can reach 2^64; ``_mul32`` splits the
multiplier into 16-bit halves so no product leaves int64.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_M1 = 0x2C1B3C6D
_M2 = 0x297A2D39
_STEP_P = 0x9E3779B1   # golden-ratio prime
_SALT_P = 0x85EBCA77


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 words x < 2^32 and a constant c < 2^32."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _word(x, device=None):
    """An int, or an integer tensor, as int64 words modulo 2^32 (an int32
    value is taken as its two's-complement bits, as JAX's uint32 cast)."""
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK


def _avalanche(x):
    x = x ^ (x >> 15)
    x = _mul32(x, _M1)
    x = x ^ (x >> 12)
    x = _mul32(x, _M2)
    x = x ^ (x >> 15)
    return x


def hash_u32(counter, step, salt):
    """uint32 hash of (counter, step, salt) as int64 in [0, 2^32); all
    arguments broadcast, and each is an int or an integer tensor."""
    dev = counter.device if torch.is_tensor(counter) else None
    counter, step, salt = (_word(v, dev) for v in (counter, step, salt))
    x = (counter + _mul32(step, _STEP_P) + _mul32(salt, _SALT_P)) & _MASK
    x = _avalanche(x)
    # second round keyed differently to decorrelate consecutive counters
    return _avalanche(x ^ ((step + salt) & _MASK))


def cell_uniform(shape, step, salt, row0=0, col0=0, full_height=None,
                 full_width=None, device=None):
    """Uniforms in [0, 1) for an (h, w) block of a conceptually global grid.

    row0/col0 are the global coordinates of the block's [0, 0] cell and may
    be negative (halo rows); coordinates wrap modulo the full grid (floor
    mod, as ``jnp.mod``).  ``device`` defaults to ``step``'s."""
    h, w = shape
    fh = full_height if full_height is not None else h
    fw = full_width if full_width is not None else w
    if device is None and torch.is_tensor(step):
        device = step.device
    i64 = torch.int64
    gy = torch.remainder(torch.arange(h, dtype=i64, device=device) + row0, fh)
    gx = torch.remainder(torch.arange(w, dtype=i64, device=device) + col0, fw)
    counter = (gy[:, None] * fw + gx[None, :]) & _MASK
    return _bits_to_uniform(hash_u32(counter, step, salt))


def _bits_to_uniform(bits):
    """uint32 bits -> uniform [0, 1) from the top 24 bits, exactly as the
    JAX package forms it: (bits >> 8) as int32, to float32, times 2^-24."""
    return (bits >> 8).to(torch.int32).to(torch.float32) * (2.0 ** -24)


def scalar_uniforms(n: int, step, salt):
    """n scalar uniforms for per-step global draws (direction, parity)."""
    dev = step.device if torch.is_tensor(step) else None
    c = (torch.arange(n, dtype=torch.int64, device=dev) + 0xDEADBEEF) & _MASK
    return _bits_to_uniform(hash_u32(c, step, salt))
