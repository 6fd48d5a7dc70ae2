"""The port's single-trajectory step driver (kmc_tpu_torch.engine.step)
held against kmc_tpu.engine.step.

* ``init_state(cfg, seed)`` against kmc_tpu's: keys, topology and flags
  bitwise, poses within 1e-4 A, as tests/test_torch_ensemble.py holds
  init_ensemble.  Poses are not bitwise: XLA's CPU backend fuses the
  candidate placement u * L - L / 2 into one multiply-add (one rounding,
  the port rounds twice) and the orientations go through two libraries'
  cos/sin; the largest difference is a few float32 ulps (6.1e-5 A at
  small_cfg).
* A teacher-forced trajectory of 30 steps from a bonded, dense start: at
  each step the JAX state is carried into the port, both take one step,
  and topology, flags, keys and observables are compared bitwise, poses
  within 1e-4 A (angles and quaternions within 1e-4).  Off a TPU,
  kmc_tpu's step_fn runs the unfused idealize (kmc_tpu/engine/step.py),
  while the port's step runs K2's plain version (the fused core); the two
  agree within the JAX suite's fused-vs-unfused tolerance of 1e-4 A.
* ``run`` with a tail that is not a multiple of out_every calls its hook
  as kmc_tpu's run does, with the same observables.
"""

import jax
import numpy as np
import pytest
import torch

from kmc_tpu.engine.step import make_step_fn as j_make_step_fn
from kmc_tpu.engine.step import run as j_run
from kmc_tpu.state import init_state as j_init_state
import kmc_tpu_torch
from kmc_tpu_torch import convert
from kmc_tpu_torch.engine.step import make_masked_chunk_fn
from kmc_tpu_torch.ops import align as k2

from test_torch_clusters import jax_fields, port_cfg
from test_torch_ensemble import (assert_obs_match, assert_states_match,
                                 bonded_start, dense_cfg)


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


def single(fields):
    """A single-trajectory JAX state's numpy fields with a replica axis."""
    return {k: v[None] for k, v in fields.items()}


@pytest.mark.parametrize("seed", [0, 7])
def test_init_state_matches(small_cfg, seed):
    want = single(jax_fields(j_init_state(small_cfg, seed)))
    got = kmc_tpu_torch.init_state(port_cfg(small_cfg), seed, device="cpu")
    assert got.step.shape == (1,)
    assert_states_match(got, want, f"seed {seed}")


def test_step_trajectory_teacher_forced():
    cfg = dense_cfg()
    tcfg = port_cfg(cfg)
    js = bonded_start(cfg, 1)
    step = j_make_step_fn(cfg)
    before = k2.align_core_single.launches
    dirty_seen = bonds = 0
    for i in range(30):
        fields = jax_fields(js)
        dirty_seen += int(fields["dirty"])
        ts = convert.from_numpy(fields, batched=False)
        js, jobs = step(js)
        ts, tobs = kmc_tpu_torch.step_fn(ts, tcfg, device="cpu")
        want = single(jax_fields(js))
        assert_states_match(ts, want, f"step {i}")
        assert_obs_match(tobs, type(jobs)(*(np.asarray(x)[None]
                                             for x in jobs)), f"step {i}")
        bonds = max(bonds, int(jobs.bond_num))
    # the window formed bonds (the start has three) and ran the align core
    # on dirty states
    assert bonds >= 4 and dirty_seen >= 2
    # the CPU route runs the plain version and launches no kernel
    assert k2.align_core_single.launches == before


def test_step_fn_takes_one_replica():
    cfg = port_cfg(dense_cfg())
    st = kmc_tpu_torch.init_ensemble(cfg, 2, seed=0, device="cpu")
    with pytest.raises(ValueError, match="batched=True"):
        kmc_tpu_torch.step_fn(st, cfg, device="cpu")
    st1 = kmc_tpu_torch.init_state(cfg, 0, device="cpu")
    with pytest.raises((RuntimeError, ValueError)):
        kmc_tpu_torch.step_fn(st1, cfg)                 # defaults to cuda


def test_run_driver_tail_matches(small_cfg):
    """kmc_tpu's tests/test_step.py::test_run_driver_tail_masked_chunk on
    the port: 50 steps at out_every = 20 call the hook at 200, 400 and
    500 ns with kmc_tpu's observables."""
    cfg = small_cfg.replace(out_every=20)
    tcfg = port_cfg(cfg)
    want, got = [], []
    js = j_run(j_init_state(cfg, 3), cfg, n_steps=50,
               on_output=lambda s, o: want.append(o))
    ts = kmc_tpu_torch.run(kmc_tpu_torch.init_state(tcfg, 3, device="cpu"),
                           tcfg, n_steps=50,
                           on_output=lambda s, o: got.append(o),
                           device="cpu")
    assert [float(o.time_ns[0]) for o in got] == [200.0, 400.0, 500.0]
    for g, w in zip(got, want):
        assert_obs_match(g, type(w)(*(np.asarray(x)[None] for x in w)),
                         f"t={float(w.time_ns)}")
    assert int(ts.step[0]) == 51 == int(js.step)
    np.testing.assert_array_equal(ts.a_trans[0].numpy(),
                                  np.asarray(js.a_trans))
    np.testing.assert_allclose(ts.a_xy[0].numpy(), np.asarray(js.a_xy),
                               atol=1e-4)


def test_masked_chunk_zero_steps_gives_zero_observables():
    cfg = port_cfg(dense_cfg())
    st = kmc_tpu_torch.init_state(cfg, 0, device="cpu")
    out, obs = make_masked_chunk_fn(cfg, device="cpu")(st, 0)
    assert out is st
    assert all(float(x.abs().sum()) == 0 for x in obs)
