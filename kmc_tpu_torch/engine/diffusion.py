"""Diffusion round over all clusters (port of
``kmc_tpu/engine/diffusion.py``).

Every cluster (connected component, singletons included) draws one rigid
translation + rotation from its mobility class; all proposals apply in
parallel; collisions are resolved by the sweep emulation (random cluster
priorities, 3 refinement rounds, 3 unrolled cleanup rounds) and rejected
clusters revert as a unit.  Collision model (reference radii): A-A rod
axis distance < 2 R_A, A-B bead centers < R_A + R_B, B-B beads < 2 R_B.
Ligands leaving [0, L_z] are reflected with the quaternion z-mirror, and
clusters wrap in x, y by their mean reference point (main.cpp:597-605,
925-931).  All tensors carry a leading replica axis R.
"""

from __future__ import annotations

import math

import torch

from kmc_tpu_torch import rng
from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.engine.clusters import ClusterInfo
from kmc_tpu_torch.geometry import (mat3_apply, quat_from_euler, quat_mul,
                                    quat_to_mat)
from kmc_tpu_torch.ops.segment import onehot, seg_max, seg_sum
from kmc_tpu_torch.state import SimState, positions


def _per_molecule(x, label):
    """x[r, label[r, i]] for per-label rows x [R, n(, k)]."""
    idx = label.long()
    if x.dim() == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)


def mobility(info: ClusterInfo, cfg: SimConfig):
    """Per-molecule (D_trans, D_rot, is_free_ligand) of its cluster:
    free ligand (RB_B), free receptor (RB_A), lone cis pair (cis),
    1-ligand complex (bond), >=2-ligand complex frozen (main.cpp:984-985)."""
    has_b = info.n_b > 0
    free_b = has_b & (info.size == 1)
    one_lig = (info.n_b == 1) & (info.size > 1)
    frozen = info.n_b >= 2
    free_a = ~has_b & (info.size == 1)
    cis_pair = ~has_b & (info.size >= 2)

    def pick(b, bond, a, cis):
        # python floats round to float32 in torch.where, as the JAX
        # package's float32 RuntimeParams do
        v = torch.where(free_b, b, 0.0)
        v = torch.where(one_lig, bond, v)
        v = torch.where(free_a, a, v)
        v = torch.where(cis_pair, cis, v)
        return torch.where(frozen, 0.0, v)

    d = pick(cfg.rb_b_d, cfg.bond_d, cfg.rb_a_d, cfg.cis_d)
    rot = pick(cfg.rb_b_rot_d, cfg.bond_rot_d, cfg.rb_a_rot_d, cfg.cis_rot_d)
    return d, rot, free_b


def _d2(x, y):
    """x [R, m, kx, 3], y [R, mm, ky, 3] -> squared distances
    [R, m, mm, kx, ky]."""
    dx = x[:, :, None, :, None, 0] - y[:, None, :, None, :, 0]
    dy = x[:, :, None, :, None, 1] - y[:, None, :, None, :, 1]
    dz = x[:, :, None, :, None, 2] - y[:, None, :, None, :, 2]
    return dx * dx + dy * dy + dz * dz


def collide_matrix(p, q, cfg: SimConfig):
    """bool[R, n, n]: molecule i at placement p overlaps molecule j at
    placement q (p, q: f32[R, n, 4, 4, 3]) under the reference radii."""
    na = cfg.n_a
    ra, rb = cfg.rb_a_radius, cfg.rb_b_radius
    pa, qa = p[:, :na, 0, 0, :], q[:, :na, 0, 0, :]
    pab, qab = p[:, :na, :, 0, :], q[:, :na, :, 0, :]
    pbb, qbb = p[:, na:, 1:, 0, :], q[:, na:, 1:, 0, :]
    da = pa[:, :, None] - qa[:, None, :]
    aa = (da * da).sum(-1) < (2 * ra) ** 2
    ab = (_d2(pab, qbb) < (ra + rb) ** 2).flatten(3).any(-1)
    ba = (_d2(pbb, qab) < (ra + rb) ** 2).flatten(3).any(-1)
    bb = (_d2(pbb, qbb) < (2 * rb) ** 2).flatten(3).any(-1)
    return torch.cat([torch.cat([aa, ab], dim=2),
                      torch.cat([ba, bb], dim=2)], dim=1)


def cluster_reject(p, q, label, cfg: SimConfig):
    """bool[R, n] per-LABEL flag: the cluster overlaps another cluster, with
    every molecule i at p against every molecule j at q."""
    hit = collide_matrix(p, q, cfg)
    cross = label[:, :, None] != label[:, None, :]
    return seg_max((hit & cross).any(dim=2), label, cfg.n)


def diffuse(state: SimState, info: ClusterInfo, skey, cfg: SimConfig):
    """One synchronous diffusion round over all clusters of all replicas.
    ``skey`` is the per-replica move key, i64[R, 2]."""
    n, na = cfg.n, cfg.n_a
    dt = cfg.time_step
    lx, ly, lz = cfg.cell_range_x, cfg.cell_range_y, cfg.cell_range_z
    label = info.label
    dev = label.device
    f32 = torch.float32

    d, rot_d, free_b = mobility(info, cfg)
    moving = (d > 0) | (rot_d > 0)

    # ---- per-cluster draws (rows indexed by cluster label) ----
    n_draw = 7 if cfg.sweep_collisions else 6
    u = rng.uniform(skey, (n, n_draw))                     # [R, n, 7]
    uc = _per_molecule(u, label)
    u_amp = uc[..., 0]
    phai = uc[..., 1] * 2.0 * math.pi
    if cfg.sin_weighted_theta:
        theta_dir = torch.arccos(1.0 - 2.0 * uc[..., 2])
    else:
        theta_dir = uc[..., 2] * math.pi         # reference quirk (main.cpp:910)

    # displacement magnitude 2*sqrt(D dt/6)*U (main.cpp:585, 693, 909, 990)
    amp = 2.0 * torch.sqrt(d * dt / 6.0) * u_amp
    sin_t = torch.where(free_b, torch.sin(theta_dir), 1.0)
    cos_t = torch.where(free_b, torch.cos(theta_dir), 0.0)
    tvec = torch.stack([amp * sin_t * torch.cos(phai),
                        amp * sin_t * torch.sin(phai), amp * cos_t], dim=-1)

    a_xy = state.a_xy + tvec[:, :na, :2]
    b_center = state.b_center + tvec[:, na:]
    b_quat = state.b_quat

    # ---- ligand z reflection (free ligands only; main.cpp:925-931) ----
    zc = b_center[..., 2]
    refl = free_b[:, na:] & ((zc > lz) | (zc < 0.0))
    z_shift = lz * torch.round(zc / lz)
    b_center = torch.cat(
        [b_center[..., :2], torch.where(refl, -zc + 2.0 * z_shift, zc)[..., None]],
        dim=-1)
    mirror = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=f32, device=dev)
    b_quat = torch.where(refl[..., None], b_quat * mirror, b_quat)

    # ---- xy periodic wrap by cluster mean reference point ----
    refpt = torch.cat([a_xy, b_center[..., :2]], dim=1)             # [R, n, 2]
    size_per_label = seg_max(info.size, label, n)
    denom = torch.clamp(size_per_label, min=1)[..., None]
    mean = seg_sum(refpt, label, n) / denom
    shift = torch.stack([lx * torch.round(mean[..., 0] / lx),
                         ly * torch.round(mean[..., 1] / ly)], dim=-1)
    shift_m = _per_molecule(shift, label)
    a_xy = a_xy - shift_m[:, :na]
    b_center = torch.cat([b_center[..., :2] - shift_m[:, na:],
                          b_center[..., 2:]], dim=-1)

    # ---- cluster rotation about COM (main.cpp:609-635, 724-766, 1087-1128) ----
    rot_scale = torch.sqrt(rot_d * dt)
    psai = (2.0 * uc[..., 3] - 1.0) * rot_scale
    theta = (2.0 * uc[..., 4] - 1.0) * rot_scale * free_b
    phi = (2.0 * uc[..., 5] - 1.0) * rot_scale * free_b

    a_z = torch.full_like(a_xy[..., :1], 3.0 * cfg.rb_a_radius)
    centers = torch.cat([torch.cat([a_xy, a_z], dim=-1), b_center], dim=1)
    com = seg_sum(centers, label, n) / denom
    q_delta = quat_from_euler(theta, phi, psai)
    rot = quat_to_mat(q_delta)
    com_m = _per_molecule(com, label)
    new_centers = mat3_apply(rot, centers - com_m) + com_m
    a_psi = state.a_psi + psai[:, :na]
    prop = state._replace(a_xy=new_centers[:, :na, :2], a_psi=a_psi,
                          b_center=new_centers[:, na:],
                          b_quat=quat_mul(q_delta[:, na:], b_quat))

    # ---- collision resolution (C15) ----
    p = positions(prop, cfg)
    c = positions(state, cfg)
    if cfg.sweep_collisions:
        hit_nn = collide_matrix(p, p, cfg)
        hit_no = collide_matrix(p, c, cfg)
        ohl = onehot(label, n)                                    # [R, n, n]
        offdiag = ~torch.eye(n, dtype=torch.bool, device=dev)

        def to_labels(hit):
            h = ohl.transpose(1, 2) @ hit.to(f32) @ ohl
            return (h > 0) & offdiag                  # cross-cluster pairs

        h_nn = to_labels(hit_nn)                                  # [R, L, L]
        h_no = to_labels(hit_no)
        h_on = h_no.transpose(1, 2)
        pri_l = u[..., 6]                             # per-cluster sweep order
        earlier = pri_l[:, None, :] < pri_l[:, :, None]   # b moves before a
        moved_l = seg_max(moving, label, n)

        def sweep_round(acc_l):
            accm = acc_l & moved_l
            bad = torch.where(earlier & accm[:, None, :], h_nn, h_no)
            return ~bad.any(dim=2)

        acc = sweep_round(torch.ones_like(moved_l))
        acc = sweep_round(acc)
        acc = sweep_round(acc)

        def cleanup(acc_l):
            am = acc_l & moved_l
            ai, aj = am[:, :, None], am[:, None, :]
            pair = torch.where(ai & aj, h_nn,
                               torch.where(ai, h_no, aj & h_on))
            bad_l = pair.any(dim=2) & acc_l & moved_l
            return acc_l & ~bad_l, bad_l.any()

        if cfg.sweep_exact_cleanup:
            while True:
                acc, any_bad = cleanup(acc)
                if not bool(any_bad):
                    break
        else:
            for _ in range(3):
                acc, _ = cleanup(acc)
        rej = ~acc
    else:
        rej = (cluster_reject(p, p, label, cfg)
               | cluster_reject(p, c, label, cfg))
    ok = ~torch.gather(rej, 1, label.long()) & moving               # [R, n]

    return state._replace(
        a_xy=torch.where(ok[:, :na, None], prop.a_xy, state.a_xy),
        a_psi=torch.where(ok[:, :na], prop.a_psi, state.a_psi),
        b_center=torch.where(ok[:, na:, None], prop.b_center, state.b_center),
        b_quat=torch.where(ok[:, na:, None], prop.b_quat, state.b_quat),
    )
