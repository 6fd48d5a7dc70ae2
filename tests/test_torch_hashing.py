"""The port's counter hash (kmc_tpu_torch/ops/hashing.py) and its
``rng.permutation`` held against kmc_tpu's, bitwise.

``hash_u32``, ``cell_uniform`` (with offsets, negative halo offsets and a
full-grid size) and ``scalar_uniforms`` for seeds 0, 7, 2^31 - 1 and -5
and steps 0, 1 and 2^31 - 1, with the salt formed as the lattice step
forms it (seed * 16 + stream, in int32, wrapping); ``permutation`` as
``jax.random.permutation`` computes it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmc_tpu import rng as jrng
from kmc_tpu.ops import hashing as jh
from kmc_tpu_torch import rng as trng
from kmc_tpu_torch.ops import hashing as th

SEEDS = (0, 7, 2**31 - 1, -5)
STEPS = (0, 1, 2**31 - 1)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_cache_small_torch():
    """Keep this module's JAX compiles out of the persistent cache (and so
    out of the tree), and keep torch to two threads per test worker."""
    from jax._src import compilation_cache

    was = jax.config.jax_enable_compilation_cache
    threads = torch.get_num_threads()
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


def _salts(seed, stream):
    """(JAX salt as the lattice step forms it: int32 seed * 16 + stream,
    wrapping; the port's: a Python int, taken mod 2^32 by the hash)."""
    j = (jnp.asarray(seed, jnp.int32) * jnp.int32(16)) + jnp.int32(stream)
    return j, seed * 16 + stream


def _bits(x):
    return np.asarray(x).view(np.uint32) if np.asarray(x).dtype == np.float32 \
        else np.asarray(x).astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("step", STEPS)
def test_hash_u32_matches(seed, step):
    counter = np.arange(0, 2**32 - 1, 2**32 // 4099, dtype=np.uint32)
    for stream in range(5):
        js, ts = _salts(seed, stream)
        want = jh.hash_u32(jnp.asarray(counter), jnp.int32(step), js)
        got = th.hash_u32(torch.from_numpy(counter.astype(np.int64)),
                          torch.tensor(step, dtype=torch.int32), ts)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("step", STEPS)
def test_cell_uniform_matches(seed, step):
    for stream in (1, 2, 3, 4):
        js, ts = _salts(seed, stream)
        jstep = jnp.int32(step)
        tstep = torch.tensor(step, dtype=torch.int32)
        # whole grid, an interior block, and a halo block with negative
        # offsets on a larger global grid
        for shape, r0, c0, fh, fw in (((24, 40), 0, 0, None, None),
                                      ((16, 16), 8, 24, 64, 64),
                                      ((12, 20), -4, -4, 64, 96),
                                      ((8, 8), 60, -7, 64, 64)):
            want = jh.cell_uniform(shape, jstep, js, r0, c0, fh, fw)
            got = th.cell_uniform(shape, tstep, ts, r0, c0, fh, fw)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("step", STEPS)
def test_scalar_uniforms_matches(seed, step):
    for stream in (0, 3):
        js, ts = _salts(seed, stream)
        want = jh.scalar_uniforms(16, jnp.int32(step), js)
        got = th.scalar_uniforms(16, torch.tensor(step, dtype=torch.int32), ts)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_offset_consistency():
    """A block at a global offset reproduces the full grid's values, and
    negative (halo) offsets wrap periodically (tests/test_hashing.py)."""
    step = torch.tensor(5, dtype=torch.int32)
    full = th.cell_uniform((64, 64), step, 7)
    block = th.cell_uniform((16, 16), step, 7, row0=8, col0=24,
                            full_height=64, full_width=64)
    assert torch.equal(block, full[8:24, 24:40])
    halo = th.cell_uniform((4, 4), step, 7, row0=-2, col0=-2,
                           full_height=64, full_width=64)
    assert torch.equal(halo[2:, 2:], full[:2, :2])
    assert torch.equal(halo[:2, :2], full[-2:, -2:])


@pytest.mark.parametrize("n,k", [(1, 1), (5, 2), (32 * 32, 100),
                                 (64 * 64, 2500)])
@pytest.mark.parametrize("seed", [0, 13])
def test_permutation_matches(n, k, seed):
    """One round below n ~ 1,600, two above (3 ln n / ln(2^32 - 1))."""
    jk = jrng.stream_key(jrng.step_key(jrng.base_key(seed), 0),
                         jrng.STREAM_LATTICE)
    tk = trng.stream_key(trng.step_key(trng.base_key(seed), 0),
                         trng.STREAM_LATTICE)
    flat = jnp.zeros((n,), bool).at[:k].set(True)
    tflat = torch.zeros(n, dtype=torch.bool)
    tflat[:k] = True
    np.testing.assert_array_equal(trng.permutation(tk, tflat).numpy(),
                                  np.asarray(jax.random.permutation(jk, flat)))
    np.testing.assert_array_equal(
        trng.permutation(tk, torch.arange(n)).numpy(),
        np.asarray(jax.random.permutation(jk, jnp.arange(n))))
