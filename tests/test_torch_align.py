"""Port parity for the idealize stage and its kernels K1 and K2.

* The plain version of K1 (kmc_tpu_torch.ops.align_batched) against the
  JAX package's Pallas kernel (align_core_batched, interpret mode, as
  tests/test_pallas_align.py runs it) on the same inputs, B = 10 replicas
  (which exercises the Pallas kernel's padding to its 8-replica block):
  positions within 1e-4 A, directions and quaternions within 1e-5, snap
  and b_laid codes exact.
* idealize_fused and idealize of the port against kmc_tpu's on the same
  states and keys, with the same tolerances.

* The plain version of K2 (kmc_tpu_torch.ops.align) against the JAX
  package's single-replica Pallas kernel (interpret mode) on K2's own
  operands, and the port's single-trajectory ``align_core`` against
  kmc_tpu's ``align_core(..., interpret=True)``, on the fixtures of
  tests/test_pallas_align.py (loose trans, unlaid, merged complex, cis
  pair) and the bonded chain at the origin: the same tolerances.

* A torch model of the CUDA kernels' level schedule (align_core.cuh: one
  pass per depth level, parents from the previous round, both halves from
  the pass's starting poses, early exit) against K1's plain version, to
  the bit, with the passes each input needs.

The CUDA kernels are held against their plain versions on the card by
tests/test_torch_kernels.py.

The bonded fixtures sit near the origin, as the JAX suite's do.  The
tolerances are absolute, and a snapped chain far from the origin carries
float32 cancellation in its (site - bead) directions: for the long chain
rooted at (330, 120) A instead of the origin, kmc_tpu's own fused and
unfused idealize already differ by 2.4e-4 A.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmc_tpu import rng as jrng
from kmc_tpu.engine.align import (_choose_roots as j_choose_roots,
                                  idealize as j_idealize,
                                  idealize_fused as j_idealize_fused)
from kmc_tpu.engine.clusters import cluster_labels as j_labels
from kmc_tpu.models.tnfr import ligand_template
from kmc_tpu.ops.pallas_align import _core_for
from kmc_tpu.ops.pallas_align import align_core as j_align_core
from kmc_tpu.ops.pallas_align_batched import align_core_batched as j_core
from kmc_tpu_torch import convert
from kmc_tpu_torch import rng as trng
from kmc_tpu_torch.engine.align import idealize as t_idealize
from kmc_tpu_torch.engine.align import idealize_fused as t_idealize_fused
from kmc_tpu_torch.engine.clusters import cluster_labels as t_labels
from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.io.checkpoint import load_reference_cpt
from kmc_tpu_torch.ops import align as k2
from kmc_tpu_torch.ops import align_batched, build
from kmc_tpu_torch.testing import align_core_inputs, bonded_state

from test_torch_clusters import (BONDED_FIXTURES, jax_fields, long_chain,
                                 loose_cis, loose_trans, merged_complex,
                                 port_cfg, stack_fields, unlaid_ligand)


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


POS_TOL, ANG_TOL = 1e-4, 1e-5     # the JAX suite's fused-vs-XLA tolerances
STEP = 7


def _ten_states(cfg):
    """Ten bonded fixtures: the shared six and four reseeded variants."""
    return ([b(cfg) for b in BONDED_FIXTURES]
            + [loose_trans(cfg, 7), unlaid_ligand(cfg, 8), loose_cis(cfg, 9),
               merged_complex(cfg, 10)])


def core_inputs(cfg, states):
    """K1's inputs for each state, as numpy: roots from kmc_tpu's root
    choice with the align stream of step STEP, act = cluster size > 1."""
    rows = []
    for st in states:
        info = j_labels(st, cfg)
        skey = jrng.stream_key(jrng.step_key(st.key, STEP), jrng.STREAM_ALIGN)
        root = np.asarray(j_choose_roots(st, info, skey, cfg)).astype(np.int32)
        f = jax_fields(st)
        psi = f["a_psi"].astype(np.float32)
        rows.append((f["a_xy"], np.stack([np.cos(psi), np.sin(psi)], -1),
                     f["b_center"], f["b_quat"], f["a_trans"], f["a_site"],
                     f["a_cis"], f["b_partner"], f["b_laid"].astype(np.int32),
                     root, (np.asarray(info.size) > 1).astype(np.int32)))
    return [np.ascontiguousarray(np.stack(col)) for col in zip(*rows)]


def assert_core_close(got, want):
    names = ("a_xy", "a_dir", "snap", "b_center", "b_quat", "b_laid")
    tols = (POS_TOL, ANG_TOL, None, POS_TOL, ANG_TOL, None)
    for name, g, w, tol in zip(names, got, want, tols):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        if tol is None:
            np.testing.assert_array_equal(g, w, name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


def test_plain_core_matches_pallas_kernel(small_cfg):
    cfg = small_cfg
    states = _ten_states(cfg)
    args = core_inputs(cfg, states)
    want = j_core(*map(jnp.asarray, args), None, cfg, interpret=True)
    got = align_batched.align_core_batched_plain(*map(torch.from_numpy, args),
                                                 port_cfg(cfg))
    assert_core_close(got, want)
    # the fixtures reach every branch: trans and cis seats, re-seats,
    # lay-downs and unreached chain tails
    snap, b_laid = got[2].numpy(), got[5].numpy()
    assert (snap == 1).any() and (snap == 2).any() and (b_laid >= 2).any()


def test_wrapper_uses_plain_version_on_cpu(small_cfg):
    args = [torch.from_numpy(a) for a in core_inputs(small_cfg,
                                                     [merged_complex(small_cfg)])]
    before = align_batched.align_core_batched.launches
    got = align_batched.align_core_batched(*args, port_cfg(small_cfg))
    want = align_batched.align_core_batched_plain(*args, port_cfg(small_cfg))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert align_batched.align_core_batched.launches == before


def test_wrapper_rejects_bad_inputs(small_cfg):
    cfg = port_cfg(small_cfg)
    args = [torch.from_numpy(a) for a in core_inputs(small_cfg,
                                                     [loose_cis(small_cfg)])]
    align_batched._check_inputs(args, cfg)
    bad_dtype = list(args)
    bad_dtype[4] = args[4].to(torch.int64)
    with pytest.raises(TypeError):
        align_batched._check_inputs(bad_dtype, cfg)
    bad_shape = list(args)
    bad_shape[9] = args[9][:, :-1]
    with pytest.raises(ValueError):
        align_batched._check_inputs(bad_shape, cfg)
    strided = list(args)
    strided[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        align_batched._check_inputs(strided, cfg)
    with pytest.raises(ValueError):
        align_batched.align_core_batched(*[a.to("meta") for a in args], cfg)


def _state_batch(cfg):
    states = [loose_trans(cfg), unlaid_ligand(cfg), loose_cis(cfg),
              merged_complex(cfg), long_chain(cfg)]
    return states, convert.from_numpy(stack_fields(states))


def _assert_state_close(got, want):
    np.testing.assert_allclose(got.a_xy.numpy(), want["a_xy"], atol=POS_TOL)
    np.testing.assert_allclose(got.a_psi.numpy(), want["a_psi"], atol=ANG_TOL)
    np.testing.assert_allclose(got.b_center.numpy(), want["b_center"],
                               atol=POS_TOL)
    np.testing.assert_allclose(got.b_quat.numpy(), want["b_quat"],
                               atol=ANG_TOL)
    np.testing.assert_array_equal(got.b_laid.numpy(), want["b_laid"])
    np.testing.assert_array_equal(got.dirty.numpy(), want["dirty"])


@pytest.mark.parametrize("fused", [True, False])
def test_idealize_matches(small_cfg, fused):
    """Port idealize_fused / idealize against kmc_tpu's on the same states
    and keys, collision revert and dirty flag included."""
    cfg = small_cfg
    tcfg = port_cfg(cfg)
    states, ts = _state_batch(cfg)
    skey = trng.stream_key(trng.step_key(ts.key, STEP), trng.STREAM_ALIGN)
    t_fn = t_idealize_fused if fused else t_idealize
    out = t_fn(ts, t_labels(ts, tcfg), skey, tcfg)
    for r, st in enumerate(states):
        jkey = jrng.stream_key(jrng.step_key(st.key, STEP), jrng.STREAM_ALIGN)
        info = j_labels(st, cfg)
        if fused:
            js = j_idealize_fused(st, info, jkey, cfg, interpret=True)
        else:
            js = j_idealize(st, info, jkey, cfg)
        _assert_state_close(type(out)(*(x[r:r + 1] for x in out)),
                            {k: v[None] for k, v in jax_fields(js).items()})


def test_ptxas_summary_parses_report():
    report = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_120align_batched_kernelE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 564 bytes cmem[0]\n")
    lines = build.ptxas_summary(report)
    assert lines == ["_ZN12_GLOBAL__N_120align_batched_kernelE: "
                     "Used 40 registers, 564 bytes cmem[0]"]


def test_source_hash_covers_sources():
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()
    assert any(p.endswith("align_batched.cu") for p in build._sources())
    # one library per kernel source; the shared header is hashed too
    assert build.kernel_names() == ["align", "align_batched", "lattice"]
    assert any(p.endswith("align_core.cuh") for p in build._sources())


# ---------------------------------------------------------------------------
# K2, the single-replica core (kmc_tpu_torch/ops/align.py)

K2_FIXTURES = (loose_trans, unlaid_ligand, merged_complex, loose_cis,
               long_chain)


def _k2_operands(cfg, st):
    """K2's twelve operands for one JAX state, as numpy, with roots from
    kmc_tpu's root choice (align stream of step STEP)."""
    (a_xy, a_dir, b_center, b_quat, a_trans, a_site, a_cis, b_partner,
     b_laid, root, act) = (x[0] for x in core_inputs(cfg, [st]))
    col = [np.ascontiguousarray(x[:, None]) for x in
           (a_trans, a_site, a_cis, b_laid, root, act)]
    return [a_xy, a_dir, b_center, b_quat, *col[:3], b_partner, *col[3:],
            np.array(ligand_template(cfg))]


@pytest.mark.parametrize("fixture", K2_FIXTURES,
                         ids=[f.__name__ for f in K2_FIXTURES])
def test_single_core_plain_matches_pallas_kernel(small_cfg, fixture):
    """K2's plain version against kmc_tpu's single-replica Pallas kernel
    (interpret mode) on K2's own operands: 1e-4 A / 1e-5, codes exact."""
    cfg = small_cfg
    ops = _k2_operands(cfg, fixture(cfg))
    core = _core_for(cfg, True)
    j_args = [jnp.asarray(x[:, 0]) if x.ndim == 2 and x.shape[1] == 1
              else jnp.asarray(x) for x in ops]
    want = core(*j_args)
    got = k2.align_core_single_plain(*map(torch.from_numpy, ops),
                                     port_cfg(cfg))
    assert got[2].shape == (cfg.n_a, 1) and got[5].shape == (cfg.n_b, 1)
    assert_core_close([g.squeeze(-1) if i in (2, 5) else g
                       for i, g in enumerate(got)], want)


@pytest.mark.parametrize("fixture", K2_FIXTURES,
                         ids=[f.__name__ for f in K2_FIXTURES])
def test_single_align_core_matches(small_cfg, fixture):
    """The port's single-trajectory ``align_core`` (CPU: K2's plain
    version) against kmc_tpu's ``align_core(..., interpret=True)``."""
    cfg = small_cfg
    st = fixture(cfg)
    info = j_labels(st, cfg)
    skey = jrng.stream_key(jrng.step_key(st.key, STEP), jrng.STREAM_ALIGN)
    root = j_choose_roots(st, info, skey, cfg)
    act = info.size > 1
    want = j_align_core(st, root, act, cfg, interpret=True)
    ts = convert.from_numpy(jax_fields(st), batched=False)
    got = k2.align_core(ts, torch.from_numpy(np.array(root))[None],
                        torch.from_numpy(np.array(act))[None],
                        port_cfg(cfg))
    tols = (POS_TOL, ANG_TOL, POS_TOL, ANG_TOL, None, None)
    for name, g, w, tol in zip(("a_xy", "a_psi", "b_center", "b_quat",
                                "b_laid", "unreached"), got, want, tols):
        g, w = g[0].numpy(), np.asarray(w)
        if tol is None:
            np.testing.assert_array_equal(g, w, name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


def test_single_plain_equals_batched_plain(small_cfg):
    """K2's plain version is K1's plain version on a batch of one, the
    template taken from its input."""
    cfg = small_cfg
    ops = [torch.from_numpy(x) for x in _k2_operands(cfg, long_chain(cfg))]
    got = k2.align_core_single_plain(*ops, port_cfg(cfg))
    cols = (4, 5, 6, 8, 9, 10)
    want = align_batched.align_core_batched_plain(
        *(x[:, 0][None] if i in cols else x[None]
          for i, x in enumerate(ops[:-1])), port_cfg(cfg))
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w[0].shape), w[0])
    # a scaled template moves the seats: the input is read, not ignored
    moved = k2.align_core_single_plain(*ops[:-1], ops[-1] * 1.5,
                                       port_cfg(cfg))
    assert not torch.equal(moved[0], got[0])


def test_single_wrapper_cpu_route_and_checks(small_cfg):
    cfg = port_cfg(small_cfg)
    ops = [torch.from_numpy(x)
           for x in _k2_operands(small_cfg, merged_complex(small_cfg))]
    before = k2.align_core_single.launches
    got = k2.align_core_single(*ops, cfg)
    want = k2.align_core_single_plain(*ops, cfg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert k2.align_core_single.launches == before
    k2._check_inputs(ops, cfg)
    bad = list(ops)
    bad[4] = ops[4][:, 0].contiguous()                   # [na] not [na, 1]
    with pytest.raises(ValueError):
        k2._check_inputs(bad, cfg)
    bad = list(ops)
    bad[11] = ops[11].double()
    with pytest.raises(TypeError):
        k2._check_inputs(bad, cfg)
    with pytest.raises(ValueError):
        k2.align_core_single(*[x.to("meta") for x in ops], cfg)
    st = convert.from_numpy(stack_fields([merged_complex(small_cfg)] * 2))
    with pytest.raises(ValueError, match="one replica"):
        k2.align_core(st, st.b_laid.new_zeros((2, cfg.n)),
                      st.b_laid.new_zeros((2, cfg.n)), cfg)


# ---------------------------------------------------------------------------
# The kernels' level schedule (kmc_tpu_torch/csrc/align_core.cuh)

REF_CPT = os.path.join(os.path.dirname(__file__), "data", "ref_position.cpt")


def level_schedule(a_xy, a_dir, b_center, b_quat, a_trans, a_site, a_cis,
                   b_partner, b_laid, is_root, act, cfg):
    """align_core.cuh's schedule in tensor ops: the root lay-down first,
    then one pass per depth level d that takes BFS round d, chooses a newly
    reached molecule's parent from the round-(d-1) depths, and seats the
    level-d receptors and ligands from the poses as they stood at the start
    of the pass; a replica stops after the first pass that changes no
    depth.  Returns K1's outputs and the passes each replica ran."""
    ab = align_batched
    na, nb, inf = cfg.n_a, cfg.n_b, ab._INF
    k = ab._constants(cfg)

    def g(x, idx):
        return torch.gather(x, 1, idx)

    a_x, a_y = a_xy[..., 0], a_xy[..., 1]
    a_dx, a_dy = a_dir[..., 0], a_dir[..., 1]
    b_cx, b_cy, b_cz = b_center.unbind(-1)
    b_qw, b_qx, b_qy, b_qz = b_quat.unbind(-1)
    bp = b_partner.unbind(-1)
    ir_a, ir_b = is_root[:, :na] == 1, is_root[:, na:] == 1
    act_a, act_b = act[:, :na] == 1, act[:, na:] == 1
    i_ab = torch.clamp(a_trans - na, 0, nb - 1).long()
    i_ac = torch.clamp(a_cis, 0, na - 1).long()
    i_bp = [torch.clamp(x, 0, na - 1).long() for x in bp]
    v_trans, v_cis, v_bp = a_trans >= 0, a_cis >= 0, [x >= 0 for x in bp]

    # load phase: root-ligand lay-down
    root_b = ir_b & act_b & (b_laid == 0)
    tx, ty, tz = k["bead1"]
    bdx, bdy = ab._rot_xy(b_qw, b_qx, b_qy, b_qz, tx, ty, tz)
    qw0, qz0 = ab._quat_z_cs(tx * bdx + ty * bdy, tx * bdy - ty * bdx)
    zero = torch.zeros_like(b_qw)
    b_qw = torch.where(root_b, qw0, b_qw)
    b_qx = torch.where(root_b, zero, b_qx)
    b_qy = torch.where(root_b, zero, b_qy)
    b_qz = torch.where(root_b, qz0, b_qz)
    b_cz = torch.where(root_b, k["plane_z"], b_cz)
    b_laid_new = torch.where(root_b, 1, b_laid)
    sj = torch.clamp(a_site, 1, 3)
    svx, svy, svz = (ab._pick3(sj, k["site"], c) for c in range(3))
    bvx, bvy, bvz = (ab._pick3(sj, k["bead"], c) for c in range(3))

    depth_a = torch.where(ir_a, 0.0, inf)
    depth_b = torch.where(ir_b, 0.0, inf)
    a_snap = torch.zeros_like(a_trans)
    live = torch.ones(a_xy.shape[0], dtype=torch.bool)
    passes = torch.zeros(a_xy.shape[0], dtype=torch.int64)
    for d in range(1, cfg.align_depth + 1):
        passes += live
        # BFS round d and the parents, both from the round-(d-1) depths
        pd_t = torch.where(v_trans, g(depth_b, i_ab), inf)
        pd_c = torch.where(v_cis, g(depth_a, i_ac), inf)
        pd_b = [torch.where(v_bp[c], g(depth_a, i_bp[c]), inf)
                for c in range(3)]
        nda = torch.minimum(depth_a, torch.minimum(
            torch.where(v_trans, pd_t + 1.0, inf),
            torch.where(v_cis, pd_c + 1.0, inf)))
        ndb = depth_b
        for c in range(3):
            ndb = torch.minimum(ndb, torch.where(v_bp[c], pd_b[c] + 1.0, inf))
        new_a = (nda != depth_a) & live[:, None]
        new_b = (ndb != depth_b) & live[:, None]
        from_trans = pd_t == d - 1.0
        from_cis = ~from_trans & (pd_c == d - 1.0)
        sel0 = pd_b[0] == d - 1.0
        sel1 = ~sel0 & (pd_b[1] == d - 1.0)
        sel2 = ~sel0 & ~sel1 & (pd_b[2] == d - 1.0)
        parent_b = torch.where(sel0, bp[0], torch.where(
            sel1, bp[1], torch.where(sel2, bp[2], -1)))
        i_ba = torch.clamp(parent_b, 0, na - 1).long()

        # level-d receptors from the pass's starting poses
        sel_t = new_a & act_a & from_trans
        sel_c = new_a & act_a & from_cis
        qpw, qpx, qpy, qpz = (g(x, i_ab) for x in (b_qw, b_qx, b_qy, b_qz))
        cpx, cpy = g(b_cx, i_ab), g(b_cy, i_ab)
        sx, sy = ab._rot_xy(qpw, qpx, qpy, qpz, svx, svy, svz)
        bx, by = ab._rot_xy(qpw, qpx, qpy, qpz, bvx, bvy, bvz)
        bsx, bsy = cpx + sx, cpy + sy
        utx = bsx - (cpx + bx)
        uty = bsy - (cpy + by)
        un = torch.clamp(torch.sqrt(utx * utx + uty * uty), min=1e-9)
        utx, uty = utx / un, uty / un
        uxp, uyp = g(a_dx, i_ac), g(a_dy, i_ac)
        xc_x = g(a_x, i_ac) - k["ra"] * uxp - k["c_off0"] * uxp
        xc_y = g(a_y, i_ac) - k["ra"] * uyp - k["c_off0"] * uyp
        # level-d ligands from the same starting poses
        sel_b = new_b & act_b & (parent_b >= 0)
        ux2, uy2 = g(a_dx, i_ba), g(a_dy, i_ba)
        cx2 = g(a_x, i_ba) + k["ra_seat"] * ux2
        cy2 = g(a_y, i_ba) + k["ra_seat"] * uy2
        pj = torch.clamp(g(a_site, i_ba), 1, 3)
        ghx, ghy = ab._pick3(pj, k["bead"], 0), ab._pick3(pj, k["bead"], 1)
        qwb, qzb = ab._quat_z_cs(ghx * (-ux2) + ghy * (-uy2),
                                 ghx * (-uy2) - ghy * (-ux2))

        # the pass's writes: level-d cells only
        a_x = torch.where(sel_t, bsx + k["t_off0"] * utx,
                          torch.where(sel_c, xc_x, a_x))
        a_y = torch.where(sel_t, bsy + k["t_off0"] * uty,
                          torch.where(sel_c, xc_y, a_y))
        a_dx = torch.where(sel_t, -utx, torch.where(sel_c, -uxp, a_dx))
        a_dy = torch.where(sel_t, -uty, torch.where(sel_c, -uyp, a_dy))
        a_snap = torch.where(sel_t | sel_c, 1, a_snap)
        b_cx = torch.where(sel_b, cx2, b_cx)
        b_cy = torch.where(sel_b, cy2, b_cy)
        b_cz = torch.where(sel_b, k["plane_z"], b_cz)
        b_qw = torch.where(sel_b, qwb, b_qw)
        b_qx = torch.where(sel_b, zero, b_qx)
        b_qy = torch.where(sel_b, zero, b_qy)
        b_qz = torch.where(sel_b, qzb, b_qz)
        b_laid_new = torch.where(sel_b, 1, b_laid_new)
        depth_a = torch.where(live[:, None], nda, depth_a)
        depth_b = torch.where(live[:, None], ndb, depth_b)
        live = new_a.any(1) | new_b.any(1)      # the barrier's OR
        if not live.any():
            break

    a_snap = torch.where(act_a & ~ir_a & (depth_a >= inf), 2, a_snap)
    b_laid_new = torch.where(act_b & ~ir_b & (depth_b >= inf),
                             b_laid_new + 2, b_laid_new)
    return (torch.stack([a_x, a_y], -1), torch.stack([a_dx, a_dy], -1),
            a_snap.to(torch.int32), torch.stack([b_cx, b_cy, b_cz], -1),
            torch.stack([b_qw, b_qx, b_qy, b_qz], -1),
            b_laid_new.to(torch.int32)), passes


def _no_cis(st):
    return st._replace(a_cis=torch.full_like(st.a_cis, -1))


def _no_bonds(st):
    none = torch.full_like
    return st._replace(a_trans=none(st.a_trans, -1),
                       a_site=none(st.a_site, -1), a_cis=none(st.a_cis, -1),
                       b_partner=none(st.b_partner, -1))


# (case, align_depth, state maker, passes): the mature reference state
# with three root draws, bonded states at four depths, a trans-only
# topology (receptor-ligand-receptor only: 2 passes) and no bonds (1 pass)
LEVEL_CASES = [
    *[(f"ref_cpt_seed{s}", 8, lambda c, s=s: load_reference_cpt(
        REF_CPT, c, seed=s, device="cpu"), n)
      for s, n in ((0, 8), (1, 8), (2, 6))],
    *[(f"bonded_depth{d}", d, lambda c: bonded_state(
        c, 1, seed=1, device="cpu"), n)
      for d, n in ((1, 1), (3, 3), (8, 8), (12, 12))],
    ("trans_only", 8, lambda c: _no_cis(bonded_state(c, 1, seed=3,
                                                     device="cpu")), 2),
    ("no_bonds", 8, lambda c: _no_bonds(bonded_state(c, 1, seed=3,
                                                     device="cpu")), 1),
]


@pytest.mark.parametrize("case,depth,make,passes", LEVEL_CASES,
                         ids=[c[0] for c in LEVEL_CASES])
def test_level_schedule_equals_plain(case, depth, make, passes):
    """The kernels' one-pass-per-level schedule, early exit included, is
    K1's plain version to the bit at SimConfig(): the invariant the CUDA
    core's single barrier a pass rests on."""
    cfg = SimConfig(align_depth=depth)
    args = align_core_inputs(make(cfg), cfg)
    got, ran = level_schedule(*args, cfg)
    want = align_batched.align_core_batched_plain(*args, cfg)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert ran.tolist() == [passes]
    assert (got[2] == 1).any() or case == "no_bonds"
