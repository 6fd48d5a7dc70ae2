"""The replica-batched idealize core, kernel K1 (port of
``kmc_tpu/ops/pallas_align_batched.py`` and of ``align_core`` in
``kmc_tpu/ops/pallas_align.py``).

``align_core_batched`` takes B replicas' poses and topology and returns the
snapped poses: BFS depth by ``align_depth`` rounds of min-propagation,
parent = first neighbour column at depth - 1, root-ligand lay-down, and
``align_depth`` snap sweeps (A<-B trans seat, A<-A cis seat, B<-A re-seat).
On a CUDA tensor it launches the hand-written kernel
``kmc_tpu_torch/csrc/align_batched.cu`` (one thread block per replica,
one pass per depth level, stopping at the deepest level present; the
results are this module's plain version to the bit) and raises if the
launch fails; on a CPU tensor it runs
``align_core_batched_plain``, the same arithmetic in plain tensor ops.
There is no fallback from the card to the plain version.

The arithmetic is the TPU kernel's: receptor azimuths travel as direction
vectors (cos psi, sin psi) and z-quaternions come from half-angle
identities, so the core needs no transcendental; ``align_core`` converts
psi to a direction on the way in and back with one atan2 on the way out.

Shapes (B replicas, na receptors, nb ligands, n = na + nb):
  in:  a_xy f32[B, na, 2], a_dir f32[B, na, 2], b_center f32[B, nb, 3],
       b_quat f32[B, nb, 4], a_trans/a_site/a_cis i32[B, na],
       b_partner i32[B, nb, 3], b_laid i32[B, nb] (0/1),
       is_root i32[B, n] (0/1), act i32[B, n] (0/1)
  out: a_xy, a_dir, snap i32[B, na] (0 no, 1 snapped, 2 unreached),
       b_center, b_quat, b_laid i32[B, nb] (bit 0 laid, bit 1 unreached)
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.models.tnfr import (b_center_offset, cis_offsets,
                                       ligand_template_np, trans_offsets)

_INF = 30000.0
MAX_MOLECULES = 1024        # one thread per molecule in a block


# --------------------------------------------------------------------------
# Constants, rounded to float32 as the TPU kernel rounds them.

def _f32(x) -> float:
    return float(np.float32(x))


def _constants(cfg: SimConfig, tmpl=None) -> dict:
    """Scalars of ``cfg`` and the template vectors the core reads, from
    ``tmpl`` (f32[4, 4, 3], as K2 takes it) or the configuration's."""
    tmpl = ligand_template_np(cfg) if tmpl is None else np.asarray(tmpl)
    return dict(
        ra=_f32(cfg.rb_a_radius),
        t_off0=_f32(trans_offsets(cfg)[0]),
        c_off0=_f32(cis_offsets(cfg)[0]),
        ra_seat=_f32(cfg.rb_a_radius + b_center_offset(cfg)),
        plane_z=_f32(cfg.plane_z),
        bead1=[float(v) for v in tmpl[1, 0]],
        site=[[float(v) for v in tmpl[j, 1]] for j in (1, 2, 3)],
        bead=[[float(v) for v in tmpl[j, 0]] for j in (1, 2, 3)],
    )


# --------------------------------------------------------------------------
# Plain version.

def _quat_z_cs(dot, det):
    """(w, z) of the z-axis quaternion for atan2(det, dot), half-angle form."""
    r = torch.clamp(torch.sqrt(dot * dot + det * det), min=1e-12)
    c = dot / r
    ch = torch.sqrt(torch.clamp((1.0 + c) * 0.5, min=0.0))
    sh = torch.sqrt(torch.clamp((1.0 - c) * 0.5, min=0.0))
    return ch, torch.where(det < 0, -sh, sh)


def _rot_xy(qw, qx, qy, qz, vx, vy, vz):
    """x, y of (vx, vy, vz) rotated by quaternions (geometry.quat_rotate)."""
    tx = qy * vz - qz * vy
    ty = qz * vx - qx * vz
    tz = qx * vy - qy * vx
    ox = vx + 2.0 * (qw * tx + qy * tz - qz * ty)
    oy = vy + 2.0 * (qw * ty + qz * tx - qx * tz)
    return ox, oy


def _pick3(idx, table, k):
    """table[idx - 1][k] for idx in {1, 2, 3} (python-float tables)."""
    out = torch.where(idx == 2, table[1][k], table[0][k])
    return torch.where(idx == 3, table[2][k], out)


def align_core_batched_plain(a_xy, a_dir, b_center, b_quat, a_trans, a_site,
                             a_cis, b_partner, b_laid, is_root, act,
                             cfg: SimConfig, tmpl=None):
    """K1 in plain tensor ops: the reference the kernel is held against.
    ``tmpl`` (f32[4, 4, 3]) replaces the configuration's ligand template."""
    na, nb = cfg.n_a, cfg.n_b
    k = _constants(cfg, tmpl)
    ra = k["ra"]

    def g(x, idx):
        return torch.gather(x, 1, idx)

    a_x, a_y = a_xy[..., 0], a_xy[..., 1]
    a_dx, a_dy = a_dir[..., 0], a_dir[..., 1]
    b_cx, b_cy, b_cz = b_center.unbind(-1)
    b_qw, b_qx, b_qy, b_qz = b_quat.unbind(-1)
    bp = b_partner.unbind(-1)
    ir_a, ir_b = is_root[:, :na] == 1, is_root[:, na:] == 1
    act_a, act_b = act[:, :na] == 1, act[:, na:] == 1

    i_ab = torch.clamp(a_trans - na, 0, nb - 1).long()    # A -> its trans B
    i_ac = torch.clamp(a_cis, 0, na - 1).long()           # A -> its cis A
    i_bp = [torch.clamp(x, 0, na - 1).long() for x in bp]  # B -> partner As
    v_trans, v_cis = a_trans >= 0, a_cis >= 0
    v_bp = [x >= 0 for x in bp]

    # ---- BFS depth via min-propagation ----
    depth_a = torch.where(ir_a, 0.0, _INF)
    depth_b = torch.where(ir_b, 0.0, _INF)
    for _ in range(cfg.align_depth):
        ga_t = torch.where(v_trans, g(depth_b, i_ab) + 1.0, _INF)
        ga_c = torch.where(v_cis, g(depth_a, i_ac) + 1.0, _INF)
        nda = torch.minimum(depth_a, torch.minimum(ga_t, ga_c))
        ndb = depth_b
        for c in range(3):
            ndb = torch.minimum(
                ndb, torch.where(v_bp[c], g(depth_a, i_bp[c]) + 1.0, _INF))
        depth_a, depth_b = nda, ndb

    # ---- parent = first neighbour column at depth - 1 ----
    pd_t = torch.where(v_trans, g(depth_b, i_ab), _INF)
    pd_c = torch.where(v_cis, g(depth_a, i_ac), _INF)
    from_trans = pd_t == depth_a - 1.0
    from_cis = ~from_trans & (pd_c == depth_a - 1.0)
    pd_b = [torch.where(v_bp[c], g(depth_a, i_bp[c]), _INF) for c in range(3)]
    sel0 = pd_b[0] == depth_b - 1.0
    sel1 = ~sel0 & (pd_b[1] == depth_b - 1.0)
    sel2 = ~sel0 & ~sel1 & (pd_b[2] == depth_b - 1.0)
    parent_b = torch.where(sel0, bp[0], torch.where(
        sel1, bp[1], torch.where(sel2, bp[2], -1)))
    i_ba = torch.clamp(parent_b, 0, na - 1).long()        # B -> parent A
    has_pb = parent_b >= 0

    # ---- root ligand lay-down in place ----
    root_b = ir_b & act_b & (b_laid == 0)
    tx, ty, tz = k["bead1"]
    bdx, bdy = _rot_xy(b_qw, b_qx, b_qy, b_qz, tx, ty, tz)
    qw0, qz0 = _quat_z_cs(tx * bdx + ty * bdy, tx * bdy - ty * bdx)
    zero = torch.zeros_like(b_qw)
    b_qw = torch.where(root_b, qw0, b_qw)
    b_qx = torch.where(root_b, zero, b_qx)
    b_qy = torch.where(root_b, zero, b_qy)
    b_qz = torch.where(root_b, qz0, b_qz)
    b_cz = torch.where(root_b, k["plane_z"], b_cz)
    b_laid_new = torch.where(root_b, 1, b_laid)

    # ---- template vectors of the bound bead (a_site in 1..3) ----
    sj = torch.clamp(a_site, 1, 3)
    svx, svy, svz = (_pick3(sj, k["site"], c) for c in range(3))
    bvx, bvy, bvz = (_pick3(sj, k["bead"], c) for c in range(3))
    pj = torch.clamp(g(a_site, i_ba), 1, 3)   # bead the parent receptor binds
    ghx, ghy = _pick3(pj, k["bead"], 0), _pick3(pj, k["bead"], 1)

    a_snap = torch.zeros_like(a_trans)
    for d in range(1, cfg.align_depth + 1):
        # --- A children ---
        at_d = act_a & (depth_a == float(d))
        sel_t = at_d & from_trans
        sel_c = at_d & from_cis
        # A <- B trans seat
        qpw, qpx, qpy, qpz = (g(x, i_ab) for x in (b_qw, b_qx, b_qy, b_qz))
        cpx, cpy = g(b_cx, i_ab), g(b_cy, i_ab)
        sx, sy = _rot_xy(qpw, qpx, qpy, qpz, svx, svy, svz)
        bx, by = _rot_xy(qpw, qpx, qpy, qpz, bvx, bvy, bvz)
        bsx, bsy = cpx + sx, cpy + sy
        utx = bsx - (cpx + bx)
        uty = bsy - (cpy + by)
        un = torch.clamp(torch.sqrt(utx * utx + uty * uty), min=1e-9)
        utx, uty = utx / un, uty / un
        xt_x, xt_y = bsx + k["t_off0"] * utx, bsy + k["t_off0"] * uty
        # A <- A cis seat
        uxp, uyp = g(a_dx, i_ac), g(a_dy, i_ac)
        xc_x = g(a_x, i_ac) - ra * uxp - k["c_off0"] * uxp
        xc_y = g(a_y, i_ac) - ra * uyp - k["c_off0"] * uyp
        a_x = torch.where(sel_t, xt_x, torch.where(sel_c, xc_x, a_x))
        a_y = torch.where(sel_t, xt_y, torch.where(sel_c, xc_y, a_y))
        a_dx = torch.where(sel_t, -utx, torch.where(sel_c, -uxp, a_dx))
        a_dy = torch.where(sel_t, -uty, torch.where(sel_c, -uyp, a_dy))
        a_snap = torch.where(sel_t | sel_c, 1, a_snap)

        # --- B children (parent is always an A; reads this round's A) ---
        sel_b = act_b & (depth_b == float(d)) & has_pb
        ux2, uy2 = g(a_dx, i_ba), g(a_dy, i_ba)
        cx2 = g(a_x, i_ba) + k["ra_seat"] * ux2
        cy2 = g(a_y, i_ba) + k["ra_seat"] * uy2
        qwb, qzb = _quat_z_cs(ghx * (-ux2) + ghy * (-uy2),
                              ghx * (-uy2) - ghy * (-ux2))
        b_cx = torch.where(sel_b, cx2, b_cx)
        b_cy = torch.where(sel_b, cy2, b_cy)
        b_cz = torch.where(sel_b, k["plane_z"], b_cz)
        b_qw = torch.where(sel_b, qwb, b_qw)
        b_qx = torch.where(sel_b, zero, b_qx)
        b_qy = torch.where(sel_b, zero, b_qy)
        b_qz = torch.where(sel_b, qzb, b_qz)
        b_laid_new = torch.where(sel_b, 1, b_laid_new)

    # ---- unreached markers (chain deeper than align_depth) ----
    a_snap = torch.where(act_a & ~ir_a & (depth_a >= _INF), 2, a_snap)
    b_laid_new = torch.where(act_b & ~ir_b & (depth_b >= _INF),
                             b_laid_new + 2, b_laid_new)
    return (torch.stack([a_x, a_y], -1), torch.stack([a_dx, a_dy], -1),
            a_snap.to(torch.int32), torch.stack([b_cx, b_cy, b_cz], -1),
            torch.stack([b_qw, b_qx, b_qy, b_qz], -1),
            b_laid_new.to(torch.int32))


# --------------------------------------------------------------------------
# The kernel's wrapper.

class _Params(ctypes.Structure):
    """Mirror of ``struct AlignParams`` in csrc/align_core.cuh."""
    _fields_ = [("na", ctypes.c_int), ("nb", ctypes.c_int),
                ("depth", ctypes.c_int), ("ra", ctypes.c_float),
                ("t_off0", ctypes.c_float), ("c_off0", ctypes.c_float),
                ("ra_seat", ctypes.c_float), ("plane_z", ctypes.c_float),
                ("bead1", ctypes.c_float * 3),
                ("site", (ctypes.c_float * 3) * 3),
                ("bead", (ctypes.c_float * 3) * 3)]


@functools.lru_cache(maxsize=16)
def _params(cfg: SimConfig) -> _Params:
    k = _constants(cfg)
    p = _Params(na=cfg.n_a, nb=cfg.n_b, depth=cfg.align_depth, ra=k["ra"],
                t_off0=k["t_off0"], c_off0=k["c_off0"],
                ra_seat=k["ra_seat"], plane_z=k["plane_z"])
    p.bead1[:] = k["bead1"]
    for j in range(3):
        p.site[j][:] = k["site"][j]
        p.bead[j][:] = k["bead"][j]
    return p


def _bind(lib):
    fn = lib.kmc_align_batched
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.POINTER(_Params), ctypes.c_int]
                       + [ctypes.c_void_p] * 18)
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(args, cfg: SimConfig):
    na, nb, n = cfg.n_a, cfg.n_b, cfg.n
    names = ("a_xy", "a_dir", "b_center", "b_quat", "a_trans", "a_site",
             "a_cis", "b_partner", "b_laid", "is_root", "act")
    shapes = ((na, 2), (na, 2), (nb, 3), (nb, 4), (na,), (na,), (na,),
              (nb, 3), (nb,), (n,), (n,))
    dtypes = (torch.float32,) * 4 + (torch.int32,) * 7
    batch, device = args[0].shape[0], args[0].device
    if n > MAX_MOLECULES:
        raise ValueError(f"align kernel takes at most {MAX_MOLECULES} "
                         f"molecules per replica, got {n}")
    for name, x, shape, dtype in zip(names, args, shapes, dtypes):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, a_xy on {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != (batch, *shape):
            raise ValueError(f"{name} must have shape {(batch, *shape)}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def align_core_batched(a_xy, a_dir, b_center, b_quat, a_trans, a_site, a_cis,
                       b_partner, b_laid, is_root, act, cfg: SimConfig):
    """K1: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors.  Each kernel launch adds one to ``align_core_batched.launches``
    and its batch size to ``align_core_batched.replicas``."""
    args = (a_xy, a_dir, b_center, b_quat, a_trans, a_site, a_cis, b_partner,
            b_laid, is_root, act)
    if a_xy.device.type == "cpu":
        return align_core_batched_plain(*args, cfg)
    if a_xy.device.type != "cuda":
        raise ValueError(f"no align kernel for device {a_xy.device}")
    _check_inputs(args, cfg)
    from kmc_tpu_torch.ops import build

    fn = _bind(build.library("align_batched"))
    batch, na, nb = a_xy.shape[0], cfg.n_a, cfg.n_b
    outs = (torch.empty_like(a_xy), torch.empty_like(a_dir),
            torch.empty((batch, na), dtype=torch.int32, device=a_xy.device),
            torch.empty_like(b_center), torch.empty_like(b_quat),
            torch.empty((batch, nb), dtype=torch.int32, device=a_xy.device))
    params = _params(cfg)
    stream = torch.cuda.current_stream(a_xy.device).cuda_stream
    with torch.cuda.device(a_xy.device):
        err = fn(ctypes.byref(params), batch,
                 *(x.data_ptr() for x in args),
                 *(o.data_ptr() for o in outs), stream)
    if err != 0:
        raise RuntimeError(f"align kernel launch failed: CUDA error {err}")
    align_core_batched.launches += 1
    align_core_batched.replicas += batch
    return outs


align_core_batched.launches = 0     # kernel launches
align_core_batched.replicas = 0     # replicas those launches aligned


def align_core(state, is_root, act, cfg: SimConfig):
    """The fused idealize core for every replica of ``state``.

    Returns (a_xy, a_psi, b_center, b_quat, b_laid, unreached): un-snapped
    receptors keep their azimuth bitwise; ``unreached`` (bool[R]) flags a
    replica with an active molecule beyond align_depth this pass."""
    i32 = torch.int32
    a_dir = torch.stack([torch.cos(state.a_psi), torch.sin(state.a_psi)], -1)
    a_xy, a_dir, snap, b_center, b_quat, b_laid = align_core_batched(
        state.a_xy.contiguous(), a_dir, state.b_center.contiguous(),
        state.b_quat.contiguous(), state.a_trans.to(i32).contiguous(),
        state.a_site.to(i32).contiguous(), state.a_cis.to(i32).contiguous(),
        state.b_partner.to(i32).contiguous(), state.b_laid.to(i32),
        is_root.to(i32), act.to(i32), cfg)
    a_psi = torch.where(snap == 1, torch.atan2(a_dir[..., 1], a_dir[..., 0]),
                        state.a_psi)
    unreached = (snap == 2).any(dim=1) | (b_laid >= 2).any(dim=1)
    return a_xy, a_psi, b_center, b_quat, (b_laid & 1) > 0, unreached
