"""Bond-geometry idealization (port of ``kmc_tpu/engine/align.py``).

After bonds form at loose gate geometry, molecules are snapped onto exact
bond frames by constraint projection along a BFS tree: pick a root per
cluster (a random laid ligand, else the min-index receptor), compute BFS
depth and parent by bounded min-propagation, sweep depths
1..align_depth snapping each molecule onto its parent (A<-B trans seat,
A<-A cis seat, B<-A re-seat with lay-down), then revert wholesale every
changed cluster that now overlaps another (main.cpp:1138-1860).

``idealize_fused`` runs the depth + sweep core as one kernel
(ops/align_batched.py, K1 on the card); ``idealize`` is the unfused tensor
form.  They agree within 1e-4 A / 1e-5 rad.  All tensors carry a leading
replica axis R.
"""

from __future__ import annotations

import torch

from kmc_tpu_torch import rng
from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.engine.clusters import ClusterInfo
from kmc_tpu_torch.engine.diffusion import cluster_reject
from kmc_tpu_torch.geometry import align_angle_2d, quat_axis_z, quat_rotate
from kmc_tpu_torch.models.tnfr import (b_center_offset, cis_offsets,
                                       ligand_template, trans_offsets)
from kmc_tpu_torch.ops.segment import seg_max, seg_min
from kmc_tpu_torch.state import SimState, neighbors, positions

_INF = 30000


def _gather(x, idx):
    """x[r, idx[r, ...]] for x [R, m(, k)] and integer idx [R, ...]."""
    flat = idx.reshape(idx.shape[0], -1).long()
    if x.dim() == 2:
        return torch.gather(x, 1, flat).reshape(idx.shape)
    k = x.shape[-1]
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, k))
    return out.reshape(*idx.shape, k)


def _depth_and_parent(state: SimState, is_root, cfg: SimConfig):
    nbr = neighbors(state, cfg)                           # [R, n, 3]
    depth = torch.where(is_root, 0, _INF).to(torch.int32)
    clipped = torch.clamp(nbr, min=0)
    valid = nbr >= 0
    for _ in range(cfg.align_depth):
        nd = torch.where(valid, _gather(depth, clipped) + 1, _INF)
        depth = torch.minimum(depth, nd.amin(dim=2))
    # parent = first neighbor column whose depth is ours - 1
    nd = torch.where(valid, _gather(depth, clipped), _INF)
    is_par = nd == (depth[..., None] - 1)
    col = is_par.to(torch.uint8).argmax(dim=2, keepdim=True)
    parent = torch.where(is_par.any(dim=2),
                         torch.gather(nbr, 2, col)[..., 0], -1)
    return depth, parent


def _choose_roots(state: SimState, info: ClusterInfo, skey, cfg: SimConfig):
    """Random laid-ligand root per B-cluster; min-index root otherwise."""
    n, na = cfg.n, cfg.n_a
    dev = info.label.device
    idx = torch.arange(n, device=dev)
    is_b = idx >= na
    laid_full = torch.cat([torch.zeros_like(state.b_laid[:, :1]).expand(-1, na),
                           state.b_laid], dim=1)
    u = rng.uniform(skey, (n,))
    # prefer laid ligands, then unlaid ligands; receptors never root B-clusters
    prio = u + torch.where(laid_full, 0.0, 10.0) + torch.where(is_b, 0.0, 1e6)
    prio = prio + idx * 1e-7                              # deterministic tiebreak
    best = seg_min(prio, info.label, n)
    best = torch.where(torch.isfinite(best), best, 3e9)
    best_m = torch.gather(best, 1, info.label.long())
    root_b = ((prio - best_m).abs() < 1e-9) & is_b & (info.n_b > 0)
    root_a = (idx == info.label) & (info.n_b == 0)
    return root_b | root_a


def _collision_revert(state: SimState, prop: SimState, info: ClusterInfo,
                      cfg: SimConfig, extra_dirty) -> SimState:
    """Whole-cluster revert of changed clusters that now overlap
    (main.cpp:1759-1860); a revert-free pass leaves the replica clean
    unless a chain ran beyond align_depth (``extra_dirty``)."""
    n, na = cfg.n, cfg.n_a
    tol = 1e-3
    moved_a = (((prop.a_xy - state.a_xy).abs().amax(dim=2) > tol)
               | ((prop.a_psi - state.a_psi).abs() > 1e-4))
    moved_b = (((prop.b_center - state.b_center).abs().amax(dim=2) > tol)
               | ((prop.b_quat - state.b_quat).abs().amax(dim=2) > 1e-4))
    changed = seg_max(torch.cat([moved_a, moved_b], dim=1), info.label, n)

    p_new = positions(prop, cfg)
    rej = cluster_reject(p_new, p_new, info.label, cfg) & changed
    keep = ~torch.gather(rej, 1, info.label.long())
    ka, kb = keep[:, :na], keep[:, na:]
    return state._replace(
        a_xy=torch.where(ka[..., None], prop.a_xy, state.a_xy),
        a_psi=torch.where(ka, prop.a_psi, state.a_psi),
        b_center=torch.where(kb[..., None], prop.b_center, state.b_center),
        b_quat=torch.where(kb[..., None], prop.b_quat, state.b_quat),
        b_laid=torch.where(kb, prop.b_laid, state.b_laid),
        dirty=rej.any(dim=1) | extra_dirty,
    )


def idealize_fused(state: SimState, info: ClusterInfo, skey,
                   cfg: SimConfig) -> SimState:
    """idealize with the depth + sweep core as one fused kernel
    (ops/align_batched.py); root choice and the collision revert stay in
    tensor code."""
    from kmc_tpu_torch.ops.align_batched import align_core

    is_root = _choose_roots(state, info, skey, cfg)
    a_xy, a_psi, b_center, b_quat, b_laid, unreached = align_core(
        state, is_root, info.size > 1, cfg)
    prop = state._replace(a_xy=a_xy, a_psi=a_psi, b_center=b_center,
                          b_quat=b_quat, b_laid=b_laid)
    return _collision_revert(state, prop, info, cfg, unreached)


def idealize(state: SimState, info: ClusterInfo, skey,
             cfg: SimConfig) -> SimState:
    """The unfused idealize: the same constraint projection in plain tensor
    ops, with receptor azimuths as angles (cos/sin/atan2)."""
    na, nb = cfg.n_a, cfg.n_b
    dev = info.label.device
    ra = cfg.rb_a_radius
    tmpl = ligand_template(cfg, dev)                     # [4, 4, 3]
    t_off = trans_offsets(cfg)
    c_off = cis_offsets(cfg)
    seat_r = b_center_offset(cfg)
    plane_z = cfg.plane_z

    is_root = _choose_roots(state, info, skey, cfg)
    depth, parent = _depth_and_parent(state, is_root, cfg)
    act = info.size > 1
    # chain deeper than align_depth: unreached this pass -> stay dirty
    unreached = (act & ~is_root & (depth >= _INF)).any(dim=1)

    # ---- root ligand lay-down in place (main.cpp:1138-1193) ----
    root_b = is_root[:, na:] & act[:, na:] & ~state.b_laid
    bead1_dir = quat_rotate(state.b_quat, tmpl[1, 0])[..., :2]
    alpha0 = align_angle_2d(tmpl[1, 0, :2].expand_as(bead1_dir), bead1_dir)
    b_quat = torch.where(root_b[..., None], quat_axis_z(alpha0), state.b_quat)
    b_center = torch.cat(
        [state.b_center[..., :2],
         torch.where(root_b, plane_z, state.b_center[..., 2])[..., None]],
        dim=-1)
    b_laid = state.b_laid | root_b
    a_xy, a_psi = state.a_xy, state.a_psi

    par = parent[:, :na]
    par_is_b = par >= na
    pb = torch.clamp(par - na, 0, nb - 1)
    site_bead = torch.clamp(state.a_site, 1, 3).long()
    site_v, bead_v = tmpl[site_bead, 1], tmpl[site_bead, 0]   # [R, na, 3]
    pa = torch.clamp(par, 0, na - 1)
    parb = parent[:, na:]
    pa2 = torch.clamp(parb, 0, na - 1)
    jbead = torch.clamp(_gather(state.a_site, pa2), 1, 3).long()
    ghost = tmpl[jbead, 0, :2]                                # [R, nb, 2]

    for d in range(1, cfg.align_depth + 1):
        # --- A children ---
        sel_a = act[:, :na] & (depth[:, :na] == d) & (par >= 0)
        # A <- B trans seat (main.cpp:1313-1325)
        qp = _gather(b_quat, pb)
        ctr = _gather(b_center, pb)
        bsite = ctr + quat_rotate(qp, site_v)
        bbead = ctr + quat_rotate(qp, bead_v)
        u_t = bsite[..., :2] - bbead[..., :2]
        u_t = u_t / torch.clamp(torch.linalg.vector_norm(u_t, dim=-1,
                                                         keepdim=True), min=1e-9)
        xy_trans = bsite[..., :2] + t_off[0] * u_t
        psi_trans = torch.atan2(-u_t[..., 1], -u_t[..., 0])   # +x faces the B
        # A <- A cis seat (main.cpp:1389-1401)
        psi_p = _gather(a_psi, pa)
        ux = torch.stack([torch.cos(psi_p), torch.sin(psi_p)], dim=-1)
        cis_site = _gather(a_xy, pa) - ra * ux                # parent's -x site
        u_c = -ux
        xy_cis = cis_site + c_off[0] * u_c
        psi_cis = torch.atan2(u_c[..., 1], u_c[..., 0])       # +x faces parent

        new_xy = torch.where(par_is_b[..., None], xy_trans, xy_cis)
        new_psi = torch.where(par_is_b, psi_trans, psi_cis)
        a_xy = torch.where(sel_a[..., None], new_xy, a_xy)
        a_psi = torch.where(sel_a, new_psi, a_psi)

        # --- B children (parent is always an A; main.cpp:1438-1501) ---
        sel_b = act[:, na:] & (depth[:, na:] == d) & (parb >= 0)
        psi2 = _gather(a_psi, pa2)
        ux2 = torch.stack([torch.cos(psi2), torch.sin(psi2)], dim=-1)
        asite = _gather(a_xy, pa2) + ra * ux2                 # parent's trans site
        ctr_xy = asite + seat_r * ux2
        alpha = align_angle_2d(ghost, -ux2)                   # bead faces parent
        b_center = torch.where(
            sel_b[..., None],
            torch.cat([ctr_xy, torch.full_like(ctr_xy[..., :1], plane_z)], -1),
            b_center)
        b_quat = torch.where(sel_b[..., None], quat_axis_z(alpha), b_quat)
        b_laid = b_laid | sel_b

    prop = state._replace(a_xy=a_xy, a_psi=a_psi, b_center=b_center,
                          b_quat=b_quat, b_laid=b_laid)
    return _collision_revert(state, prop, info, cfg, unreached)
