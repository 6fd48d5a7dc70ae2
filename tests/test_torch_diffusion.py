"""Port parity: the diffusion round of kmc_tpu_torch against kmc_tpu under
identical keys, on bonded small states: mobility classes and the
accept/reject of every molecule bitwise, poses within 1e-5 A (and 1e-5
rad / quaternion units): JAX runs eagerly here, and the two libraries'
float32 cos/sin/sqrt differ only in the last bit."""

import jax
import numpy as np
import pytest
import torch

from kmc_tpu import rng as jrng
from kmc_tpu.engine.clusters import cluster_labels as j_labels
from kmc_tpu.engine.diffusion import (collide_matrix as j_collide,
                                      diffuse as j_diffuse,
                                      mobility as j_mobility)
from kmc_tpu.state import positions as j_positions
from kmc_tpu_torch import rng as trng
from kmc_tpu_torch.engine.clusters import cluster_labels as t_labels
from kmc_tpu_torch.engine.diffusion import (collide_matrix as t_collide,
                                            diffuse as t_diffuse,
                                            mobility as t_mobility)
from kmc_tpu_torch.state import positions as t_positions

from test_torch_clusters import bonded_batch, jax_fields, port_cfg


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


def assert_pose_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_mobility_and_collisions_bitwise(small_cfg):
    cfg = small_cfg
    states, ts = bonded_batch(cfg)
    tcfg = port_cfg(cfg)
    info = t_labels(ts, tcfg)
    d, rot, free_b = t_mobility(info, tcfg)
    p = t_positions(ts, tcfg)
    hit = t_collide(p, p, tcfg)
    for r, st in enumerate(states):
        ji = j_labels(st, cfg)
        jd, jrot, jfree = j_mobility(ji, cfg)
        np.testing.assert_array_equal(d[r].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(rot[r].numpy(), np.asarray(jrot))
        np.testing.assert_array_equal(free_b[r].numpy(), np.asarray(jfree))
        jp = j_positions(st, cfg)
        np.testing.assert_array_equal(hit[r].numpy(),
                                      np.asarray(j_collide(jp, jp, cfg)))


@pytest.mark.parametrize("step", [1, 5, 77])
@pytest.mark.parametrize("rule", ["sweep", "sweep_exact", "symmetric",
                                  "sweep_sin_theta", "symmetric_sin_theta"])
def test_diffuse_matches(small_cfg, step, rule):
    """The ``*_sin_theta`` rules also draw the free ligands' 3D direction
    with cos(theta) uniform (``sin_weighted_theta=True``)."""
    cfg = small_cfg.replace(
        sweep_collisions=not rule.startswith("symmetric"),
        sweep_exact_cleanup=rule == "sweep_exact",
        sin_weighted_theta=rule.endswith("sin_theta"))
    tcfg = port_cfg(cfg)
    states, ts = bonded_batch(cfg)
    skey = trng.stream_key(trng.step_key(ts.key, step), trng.STREAM_MOVE)
    out = t_diffuse(ts, t_labels(ts, tcfg), skey, tcfg)
    for r, st in enumerate(states):
        jkey = jrng.stream_key(jrng.step_key(st.key, step), jrng.STREAM_MOVE)
        want = jax_fields(j_diffuse(st, j_labels(st, cfg), jkey, cfg))
        # accept/reject per molecule: which poses changed
        for f in ("a_xy", "a_psi", "b_center", "b_quat"):
            moved_j = np.asarray(want[f] != jax_fields(st)[f])
            moved_t = (getattr(out, f)[r] != getattr(ts, f)[r]).numpy()
            if moved_j.ndim > 1:
                moved_j, moved_t = moved_j.any(-1), moved_t.any(-1)
            np.testing.assert_array_equal(moved_t, moved_j, f)
            assert_pose_close(getattr(out, f)[r].numpy(), want[f])


def test_reflection_and_wrap(small_cfg):
    """Free ligands pushed through the z walls and molecules across the
    periodic x/y edges come back the same way in both packages."""
    cfg = small_cfg
    tcfg = port_cfg(cfg)
    states, _ = bonded_batch(cfg)
    edge = []
    for st in states:
        b = st.b_center
        b = b.at[:, 2].set(jax.numpy.where(jax.numpy.arange(cfg.n_b) % 2 == 0,
                                           0.5, cfg.cell_range_z - 0.5))
        a = st.a_xy.at[:, 0].add(cfg.cell_range_x / 2 - 1.0)
        edge.append(st._replace(b_center=b, a_xy=a))
    from test_torch_clusters import stack_fields
    from kmc_tpu_torch import convert

    ts = convert.from_numpy(stack_fields(edge))
    skey = trng.stream_key(trng.step_key(ts.key, 3), trng.STREAM_MOVE)
    out = t_diffuse(ts, t_labels(ts, tcfg), skey, tcfg)
    for r, st in enumerate(edge):
        jkey = jrng.stream_key(jrng.step_key(st.key, 3), jrng.STREAM_MOVE)
        want = jax_fields(j_diffuse(st, j_labels(st, cfg), jkey, cfg))
        for f in ("a_xy", "a_psi", "b_center", "b_quat"):
            assert_pose_close(getattr(out, f)[r].numpy(), want[f])
