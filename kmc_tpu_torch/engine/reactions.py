"""The six reaction channels (port of ``kmc_tpu/engine/reactions.py``).

Each channel is a dense gated tensor (eligibility x geometric gates x
Bernoulli draws); write conflicts resolve by mutual-argmax matching on
random priorities; channels apply in reference order, so later channels
see earlier channels' topology writes (main.cpp:1874-2141).  The three
dissociations draw with ``rng.tiny_bernoulli``.  ``torch.argmax`` returns
the first maximum, as ``jnp.argmax`` does, so the matchings pick the same
partners.  All tensors carry a leading replica axis R.
"""

from __future__ import annotations

import numpy as np
import torch

from kmc_tpu_torch import rng
from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.geometry import angle_gate_above_deg, angle_gate_below_deg
from kmc_tpu_torch.state import SimState, positions

_NEG_INF = float("-inf")


def _p32(p: float) -> float:
    """A probability rounded to float32, as the JAX package carries it."""
    return float(np.float32(p))


def _first_true(m, dim):
    """Index of the first True along ``dim`` (argmax of a bool tensor)."""
    return m.to(torch.uint8).argmax(dim=dim)


def _mutual_match_bipartite(cand, score, rounds):
    """Resolve cand[R, i, s] to a matching in which each row and column
    commits at most once.  Returns bool[R, i, s]."""
    committed = torch.zeros_like(cand)
    avail_r = torch.ones_like(cand[:, :, 0])
    avail_c = torch.ones_like(cand[:, 0, :])
    for _ in range(rounds):
        c = cand & avail_r[:, :, None] & avail_c[:, None, :]
        s = torch.where(c, score, _NEG_INF)
        best_c = s == s.amax(dim=2, keepdim=True)        # row's favorite
        best_r = s == s.amax(dim=1, keepdim=True)        # column's favorite
        m = c & best_c & best_r
        committed |= m
        avail_r = avail_r & ~m.any(dim=2)
        avail_c = avail_c & ~m.any(dim=1)
    return committed


def _mutual_match_symmetric(cand, score, rounds):
    """Resolve a symmetric cand[R, i, j] (i != j) to disjoint pairs; score
    is symmetric.  Returns bool[R, i, j]."""
    committed = torch.zeros_like(cand)
    avail = torch.ones_like(cand[:, :, 0])
    for _ in range(rounds):
        c = cand & avail[:, :, None] & avail[:, None, :]
        s = torch.where(c, score, _NEG_INF)
        best = s == s.amax(dim=2, keepdim=True)
        m = c & best & best.transpose(1, 2)
        committed |= m
        avail = avail & ~m.any(dim=2)
    return committed


def _cis_geometry(p, cfg: SimConfig):
    """Distance + orientation gates of both cis channels (main.cpp:1960-1981)."""
    na = cfg.n_a
    cis_site = p[:, :na, 2, 2, :]
    center2 = p[:, :na, 2, 0, :]
    diff = cis_site[:, None, :, :] - cis_site[:, :, None, :]
    dist2 = (diff * diff).sum(-1)
    v = center2 - cis_site
    ang = angle_gate_above_deg(v[:, :, None, :], v[:, None, :, :],
                               180.0 - cfg.cis_thetaot_cutoff)
    geom = (dist2 < cfg.cis_dist_cutoff ** 2) & ang
    return geom & ~torch.eye(na, dtype=torch.bool, device=p.device)


def _cis_channel(a_cis, geom, elig_extra, prob, key, cfg: SimConfig):
    """One cis association channel; each unordered pair is tested twice
    (the reference scans ordered pairs, main.cpp:1952-1953)."""
    na = cfg.n_a
    free_cis = a_cis < 0
    elig = geom & free_cis[:, :, None] & free_cis[:, None, :] & elig_extra
    u = rng.uniform(key, (na, na))
    ut = u.transpose(1, 2)
    prob = _p32(prob)
    cand = elig & elig.transpose(1, 2) & ((u < prob) | (ut < prob))
    # tie-break priority from the same uniforms; u >= 0, so fmod is the
    # floored remainder jnp's % computes
    score = torch.fmod(u * 7919.0, 1.0)
    score = torch.minimum(score, score.transpose(1, 2))
    m = _mutual_match_symmetric(cand, score, cfg.match_rounds)
    partner = torch.where(m.any(dim=2), _first_true(m, 2).to(torch.int32), -1)
    return torch.where(partner >= 0, partner, a_cis)


def react(state: SimState, skey, cfg: SimConfig) -> SimState:
    """Apply the six reaction channels; ``skey`` is the per-replica step
    key, i64[R, 2]."""
    na, nb = cfg.n_a, cfg.n_b
    p = positions(state, cfg)
    i32 = torch.int32
    a_trans, a_site, a_cis = state.a_trans, state.a_site, state.a_cis
    b_partner = state.b_partner

    # ================= trans association (C16) =================
    k1, k2 = rng.split(rng.stream_key(skey, rng.STREAM_REACT_TRANS)).unbind(-2)
    a_tsite = p[:, :na, 2, 1, :]              # A trans site
    a_c2 = p[:, :na, 2, 0, :]                 # A bead-2 center
    a_orient = p[:, :na, 2, 3, :]             # A +z marker
    b_sites = p[:, na:, 1:, 1, :]             # [R, nb, 3, 3]
    b_beads = p[:, na:, 1:, 0, :]
    b_ctr = p[:, na:, 0, 0, :]
    b_up = p[:, na:, 0, 1, :]

    diff = b_sites[:, None] - a_tsite[:, :, None, None, :]
    dist2 = (diff * diff).sum(-1)                              # [R, na, nb, 3]
    v_a = a_c2 - a_tsite
    v_b = b_beads - b_sites
    g_ot = angle_gate_above_deg(v_a[:, :, None, None, :], v_b[:, None],
                                180.0 - cfg.bond_thetaot_cutoff)
    w_a = a_c2 - a_orient
    w_b = b_ctr - b_up
    g_pd = angle_gate_below_deg(w_a[:, :, None, :], w_b[:, None],
                                cfg.bond_thetapd_cutoff)       # [R, na, nb]
    gate = (dist2 < cfg.bond_dist_cutoff ** 2) & g_ot & g_pd[..., None]
    elig = gate & (a_trans < 0)[:, :, None, None] & (b_partner < 0)[:, None]
    fire = rng.uniform(k1, (na, nb, 3)) < _p32(cfg.p_trans_ass)
    r = elig.shape[0]
    cand = (elig & fire).reshape(r, na, nb * 3)
    score = rng.uniform(k2, (na, nb * 3))
    m = _mutual_match_bipartite(cand, score, cfg.match_rounds)

    hit_a = m.any(dim=2)
    flat = _first_true(m, 2).to(i32)
    a_trans = torch.where(hit_a, na + flat // 3, a_trans)
    a_site = torch.where(hit_a, flat % 3 + 1, a_site)
    m3 = m.reshape(r, na, nb, 3)
    b_partner = torch.where(m3.any(dim=1), _first_true(m3, 1).to(i32),
                            b_partner)

    # ================= cis associations (C17) =================
    geom = _cis_geometry(p, cfg)
    trans_free = a_trans < 0
    both_free = trans_free[:, :, None] & trans_free[:, None, :]
    a_cis = _cis_channel(a_cis, geom, both_free, cfg.p_mono_cis_ass,
                         rng.stream_key(skey, rng.STREAM_REACT_MONO_CIS), cfg)
    a_cis = _cis_channel(a_cis, geom, ~both_free, cfg.p_cis_ass,
                         rng.stream_key(skey, rng.STREAM_REACT_CIS), cfg)

    # ================= trans dissociation (C18) =================
    # ~1e-12 probabilities: the 64-bit-resolution Bernoulli (rng.py)
    unbind = (a_trans >= 0) & rng.tiny_bernoulli(
        rng.stream_key(skey, rng.STREAM_DISS_TRANS), _p32(cfg.p_trans_diss),
        (na,))
    bidx = torch.clamp(a_trans - na, 0, nb - 1).long()
    sidx = torch.clamp(a_site - 1, 0, 2).long()
    clear = torch.zeros((r, nb * 3), dtype=i32, device=p.device)
    clear.scatter_add_(1, bidx * 3 + sidx, unbind.to(i32))
    b_partner = torch.where(clear.reshape(r, nb, 3) > 0, -1, b_partner)
    a_trans = torch.where(unbind, -1, a_trans)
    a_site = torch.where(unbind, -1, a_site)

    # ================= cis dissociations =================
    trans_free = a_trans < 0
    has_cis = a_cis >= 0
    partner = torch.clamp(a_cis, 0, na - 1).long()
    both_free = trans_free & torch.gather(trans_free, 1, partner)

    def cis_unbind(stream, prob, member_mask):
        fire = has_cis & member_mask & rng.tiny_bernoulli(
            rng.stream_key(skey, stream), _p32(prob), (na,))
        return fire | torch.gather(fire, 1, partner)       # either member

    brk = cis_unbind(rng.STREAM_DISS_MONO_CIS, cfg.p_mono_cis_diss, both_free)
    brk = brk | cis_unbind(rng.STREAM_DISS_CIS, cfg.p_cis_diss,
                           has_cis & ~both_free)
    a_cis = torch.where(brk, -1, a_cis)

    # any topology change means geometry needs (re-)idealization next step
    changed = ((a_trans != state.a_trans).any(dim=1)
               | (a_cis != state.a_cis).any(dim=1)
               | (b_partner != state.b_partner).flatten(1).any(dim=1))
    return state._replace(a_trans=a_trans, a_site=a_site, a_cis=a_cis,
                          b_partner=b_partner, dirty=state.dirty | changed)
