"""Port parity: SimConfig, templates, geometry helpers and derived
coordinates of kmc_tpu_torch against kmc_tpu on the same inputs.

Inputs come from a numpy seed and go to both packages.  JAX runs eagerly,
as the JAX package's own geometry tests call it: eager XLA and PyTorch
evaluate these expressions in the same order without FMA contraction, so
pure arithmetic agrees bitwise; where cos/sin/atan2/sqrt enter, the two
libraries' float32 implementations differ in the last bit, and the
tolerance is 1 ulp of the array's largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmc_tpu.config as jcfg
import kmc_tpu.geometry as jg
import kmc_tpu.models.tnfr as jtnfr
import kmc_tpu.state as jstate
import kmc_tpu_torch.config as tcfg
import kmc_tpu_torch.geometry as tg
import kmc_tpu_torch.models.tnfr as ttnfr
import kmc_tpu_torch.state as tstate
from kmc_tpu_torch import convert


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


def assert_within_ulp(got, want, ulps=1.0):
    """|got - want| <= ulps * spacing(max |want|) elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = ulps * np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_simconfig_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.SimConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.SimConfig)]
    assert tf == jf
    j, t = jcfg.SimConfig(), tcfg.SimConfig()
    for prop in ("n", "plane_z", "p_trans_ass", "p_trans_diss",
                 "p_mono_cis_ass", "p_mono_cis_diss", "p_cis_ass",
                 "p_cis_diss", "trimer_arm"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.replace(n_a=7).n_a == 7
    assert tcfg.SimConfig.from_dict(j.to_dict()) == t


@pytest.mark.parametrize("cfg", [tcfg.SimConfig(),
                                 tcfg.SimConfig(rb_a_radius=17.0,
                                                rb_b_radius=25.0,
                                                bond_dist_cutoff=12.0)])
def test_templates_and_offsets_match(cfg):
    jc = jcfg.SimConfig(**cfg.to_dict())
    np.testing.assert_array_equal(ttnfr.receptor_template(cfg).numpy(),
                                  np.asarray(jtnfr.receptor_template(jc)))
    np.testing.assert_array_equal(ttnfr.ligand_template(cfg).numpy(),
                                  np.asarray(jtnfr.ligand_template(jc)))
    assert ttnfr.trans_offsets(cfg) == jtnfr.trans_offsets(jc)
    assert ttnfr.cis_offsets(cfg) == jtnfr.cis_offsets(jc)
    assert ttnfr.b_center_offset(cfg) == jtnfr.b_center_offset(jc)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _unit_quats(seed, n):
    q = _rand(seed, (n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", ["quat_mul", "quat_rotate", "quat_to_mat",
                                  "quat_normalize", "mat3_apply"])
def test_quaternion_arithmetic(name):
    args = {
        "quat_mul": (_unit_quats(0, 64), _unit_quats(1, 64)),
        "quat_rotate": (_unit_quats(2, 64), _rand(3, (64, 3), 300.0)),
        "quat_to_mat": (_unit_quats(4, 64),),
        "quat_normalize": (_rand(5, (64, 4)),),
        "mat3_apply": (_rand(6, (64, 3, 3)), _rand(7, (64, 3), 300.0)),
    }[name]
    want = np.asarray(getattr(jg, name)(*map(jnp.asarray, args)))
    got = getattr(tg, name)(*map(torch.from_numpy, args)).numpy()
    if name == "quat_normalize":
        # the norm's sqrt differs by an ulp between the libraries, and the
        # division carries it: 2 ulps
        assert_within_ulp(got, want, ulps=2.0)
    else:                           # pure + - *: bitwise
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["quat_axis_z", "quat_axis_x"])
def test_axis_quaternions(name):
    ang = np.random.default_rng(8).uniform(-np.pi, np.pi, 64).astype(np.float32)
    want = np.asarray(getattr(jg, name)(jnp.asarray(ang)))
    got = getattr(tg, name)(torch.from_numpy(ang)).numpy()
    assert_within_ulp(got, want)


def test_quat_from_euler():
    e = np.random.default_rng(9).uniform(-np.pi, np.pi, (3, 64)).astype(np.float32)
    want = np.asarray(jg.quat_from_euler(*map(jnp.asarray, e)))
    got = tg.quat_from_euler(*map(torch.from_numpy, e)).numpy()
    assert_within_ulp(got, want, ulps=2.0)   # three cos/sin pairs compose


def test_euler_matrix_and_rot_z():
    e = np.random.default_rng(15).uniform(-np.pi, np.pi, (3, 64)).astype(
        np.float32)
    want = np.asarray(jg.euler_matrix(*map(jnp.asarray, e)))
    got = tg.euler_matrix(*map(torch.from_numpy, e)).numpy()
    assert_within_ulp(got, want, ulps=2.0)   # three cos/sin pairs compose
    # numbers broadcast against tensors, as jnp.broadcast_arrays does
    want = np.asarray(jg.euler_matrix(0.3, jnp.asarray(e[1]), 0.0))
    got = tg.euler_matrix(0.3, torch.from_numpy(e[1]), 0.0).numpy()
    assert_within_ulp(got, want, ulps=2.0)
    assert_within_ulp(tg.rot_z(torch.from_numpy(e[2])).numpy(),
                      np.asarray(jg.rot_z(jnp.asarray(e[2]))))


def test_apply_rotation_and_rot2d():
    rot, pts, ctr = (_rand(16, (64, 3, 3)), _rand(17, (64, 16, 3), 300.0),
                     _rand(18, (64, 3), 300.0))
    want = np.asarray(jg.apply_rotation(*map(jnp.asarray, (rot, pts, ctr))))
    got = tg.apply_rotation(*map(torch.from_numpy, (rot, pts, ctr))).numpy()
    # XLA's CPU dot fuses the three products into multiply-adds; the port
    # rounds each product: 2 ulps
    assert_within_ulp(got, want, ulps=2.0)
    ang = np.random.default_rng(19).uniform(-np.pi, np.pi, 64).astype(
        np.float32)
    xy = _rand(20, (64, 5, 2), 300.0)
    want = np.asarray(jg.rot2d_apply(jnp.asarray(ang), jnp.asarray(xy)))
    got = tg.rot2d_apply(torch.from_numpy(ang), torch.from_numpy(xy)).numpy()
    assert_within_ulp(got, want)


def test_build_receptors_and_ligands():
    cfg = tcfg.SimConfig()
    jc = jcfg.SimConfig()
    g = np.random.default_rng(21)
    xy = g.uniform(-1000, 1000, (4, 16, 2)).astype(np.float32)
    c3 = g.uniform(-1000, 1000, (4, 16, 3)).astype(np.float32)
    th, ph, ps = g.uniform(-np.pi, np.pi, (3, 4, 16)).astype(np.float32)
    want = np.asarray(jtnfr.build_receptors(jnp.asarray(xy),
                                            jnp.asarray(ps), jc))
    got = ttnfr.build_receptors(torch.from_numpy(xy), torch.from_numpy(ps),
                                cfg).numpy()
    assert got.shape == (4, 16, 4, 4, 3)
    assert_within_ulp(got, want)
    want = np.asarray(jtnfr.build_ligands(*map(jnp.asarray,
                                                (c3, th, ph, ps)), jc))
    got = ttnfr.build_ligands(*map(torch.from_numpy, (c3, th, ph, ps)),
                              cfg).numpy()
    assert got.shape == (4, 16, 4, 4, 3)
    assert_within_ulp(got, want)


def test_align_angle_2d():
    a, b = _rand(10, (256, 2)), _rand(11, (256, 2))
    b[:4] = 0.0                                  # dot == 0 branch
    want = np.asarray(jg.align_angle_2d(jnp.asarray(a), jnp.asarray(b)))
    got = tg.align_angle_2d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert_within_ulp(got, want)


@pytest.mark.parametrize("thresh", [10.0, 45.0, 90.0, 170.0])
def test_angle_gates_and_angle(thresh):
    u, v = _rand(12, (512, 3)), _rand(13, (512, 3))
    ju, jv, tu, tv = jnp.asarray(u), jnp.asarray(v), *map(torch.from_numpy,
                                                          (u, v))
    np.testing.assert_array_equal(
        tg.angle_gate_above_deg(tu, tv, thresh).numpy(),
        np.asarray(jg.angle_gate_above_deg(ju, jv, thresh)))
    np.testing.assert_array_equal(
        tg.angle_gate_below_deg(tu, tv, thresh).numpy(),
        np.asarray(jg.angle_gate_below_deg(ju, jv, thresh)))
    # degrees in [0, 180]: 1 ulp of 180
    assert_within_ulp(tg.angle_between_deg(tu, tv).numpy(),
                      np.asarray(jg.angle_between_deg(ju, jv)))


def test_wrap_shift_and_reflect_z():
    z = np.random.default_rng(14).uniform(-2500, 2500, 512).astype(np.float32)
    np.testing.assert_array_equal(
        tg.wrap_shift(torch.from_numpy(z), 1000.0).numpy(),
        np.asarray(jg.wrap_shift(jnp.asarray(z), 1000.0)))
    np.testing.assert_array_equal(
        tg.reflect_z(torch.from_numpy(z), 1000.0).numpy(),
        np.asarray(jg.reflect_z(jnp.asarray(z), 1000.0)))


def _random_state_np(cfg, seed, r=3):
    """Random poses and a random (mutual) topology, as numpy fields."""
    g = np.random.default_rng(seed)
    na, nb = cfg.n_a, cfg.n_b
    q = g.standard_normal((r, nb, 4)).astype(np.float32)
    a_trans = np.full((r, na), -1, np.int32)
    a_site = np.full((r, na), -1, np.int32)
    a_cis = np.full((r, na), -1, np.int32)
    b_partner = np.full((r, nb, 3), -1, np.int32)
    for k in range(r):
        perm = g.permutation(na)
        for i, a in enumerate(perm[: nb]):              # one trans bond per B
            b, s = i, int(g.integers(1, 4))
            a_trans[k, a], a_site[k, a] = na + b, s
            b_partner[k, b, s - 1] = a
        for a1, a2 in perm[nb: nb + 6].reshape(3, 2):   # three cis pairs
            a_cis[k, a1], a_cis[k, a2] = a2, a1
    return dict(
        a_xy=g.uniform(-1000, 1000, (r, na, 2)).astype(np.float32),
        a_psi=g.uniform(-np.pi, np.pi, (r, na)).astype(np.float32),
        b_center=g.uniform(0, 600, (r, nb, 3)).astype(np.float32),
        b_quat=q / np.linalg.norm(q, axis=-1, keepdims=True),
        a_trans=a_trans, a_site=a_site, a_cis=a_cis, b_partner=b_partner,
        b_laid=g.random((r, nb)) < 0.5,
        max_complex=np.zeros(r, np.int32), step=np.ones(r, np.int32),
        key=np.zeros((r, 2), np.uint32), dirty=np.ones(r, bool))


def _jax_state(fields, k):
    d = {f: jnp.asarray(v[k]) for f, v in fields.items() if f != "key"}
    d["key"] = jax.random.wrap_key_data(jnp.asarray(fields["key"][k]))
    return jstate.SimState(**d)


@pytest.mark.parametrize("seed", [0, 1])
def test_positions_and_neighbors(small_cfg, seed):
    cfg = tcfg.SimConfig(**small_cfg.to_dict())
    fields = _random_state_np(cfg, seed)
    ts = convert.from_numpy(fields)
    pos = tstate.positions(ts, cfg).numpy()
    nbr = tstate.neighbors(ts, cfg).numpy()
    for k in range(pos.shape[0]):
        js = _jax_state(fields, k)
        assert_within_ulp(pos[k], np.asarray(jstate.positions(js, small_cfg)))
        np.testing.assert_array_equal(
            nbr[k], np.asarray(jstate.neighbors(js, small_cfg)))


def test_convert_round_trip(small_cfg):
    fields = _random_state_np(small_cfg, 2)
    fields["key"] = np.arange(6, dtype=np.uint32).reshape(3, 2) * 977
    back = convert.to_numpy(convert.from_numpy(fields))
    for name, x in fields.items():
        np.testing.assert_array_equal(back[name], x)
        assert back[name].dtype == x.dtype, name
