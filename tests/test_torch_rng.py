"""Port parity: kmc_tpu_torch.rng reproduces jax.random's Threefry bits
exactly (jax_threefry_partitionable=True), so the port and the JAX package
draw the same numbers from the same keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmc_tpu.rng as jrng
from kmc_tpu_torch import rng as trng


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


def _words(jkey):
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 7, 123456789, -1, 2**40 + 5])
def test_key_from_seed(seed):
    np.testing.assert_array_equal(trng.key_from_seed(seed).numpy(),
                                  _words(jrng.base_key(seed)))


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_fold_in_chain(seed):
    """base -> replica -> step -> stream, batched over replicas and steps."""
    jb, tb = jrng.base_key(seed), trng.base_key(seed)
    reps = torch.arange(5)
    steps = torch.tensor([1, 2, 17, 40000, 2**31 - 1])
    t = trng.stream_key(trng.step_key(trng.replica_key(tb, reps), steps),
                        trng.STREAM_ALIGN)
    for r in range(5):
        j = jrng.stream_key(jrng.step_key(jrng.replica_key(jb, r),
                                          int(steps[r])), jrng.STREAM_ALIGN)
        np.testing.assert_array_equal(t[r].numpy(), _words(j))


@pytest.mark.parametrize("num", [2, 3, 4, 64])
def test_split(num):
    j = jax.random.fold_in(jrng.base_key(5), 11)
    t = trng.fold_in(trng.base_key(5), 11)
    np.testing.assert_array_equal(trng.split(t, num).numpy(),
                                  _words(jax.random.split(j, num)))


@pytest.mark.parametrize("shape", [(1,), (7,), (24, 24), (24, 8, 3), (64, 3)])
def test_bits_and_uniform(shape):
    j = jax.random.fold_in(jrng.base_key(1), 2)
    t = trng.fold_in(trng.base_key(1), 2)
    np.testing.assert_array_equal(
        trng.bits(t, shape).numpy(),
        np.asarray(jax.random.bits(j, shape, jnp.uint32)).astype(np.int64))
    u = trng.uniform(t, shape)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(),
                                  np.asarray(jax.random.uniform(j, shape)))


def test_uniform_batched_keys():
    """A [R, 2] key batch draws what each replica's key draws alone."""
    tk = trng.replica_key(trng.base_key(4), torch.arange(6))
    u = trng.uniform(tk, (10, 7)).numpy()
    for r in range(6):
        jk = jrng.replica_key(jrng.base_key(4), r)
        np.testing.assert_array_equal(u[r],
                                      np.asarray(jax.random.uniform(jk, (10, 7))))


@pytest.mark.parametrize("p", [3.48e-12, 1.12e-12, 0.3])
def test_tiny_bernoulli(p):
    j = jax.random.fold_in(jrng.base_key(8), 3)
    t = trng.fold_in(trng.base_key(8), 3)
    got = trng.tiny_bernoulli(t, p, (4096,)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jrng.tiny_bernoulli(j, p, (4096,))))


def test_tiny_bernoulli_threshold_words():
    """(hi, lo) words of p * 2^64 resolve p far below float32's 2^-23."""
    hi, lo = trng._threshold_words(3.48e-12)
    assert hi == 0 and abs(lo / 2.0**64 - 3.48e-12) < 1e-18
