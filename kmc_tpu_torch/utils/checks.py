"""Invariant checks (port of ``kmc_tpu/utils/checks.py``).

The engine's hazard class is write conflicts in parallel event
application, so these checks verify a state after a step (in tests, or
under a debug flag):

* topology mutuality: a_trans/b_partner and a_cis cross-link consistently
  (the reference writes both sides by hand, main.cpp:1926-1928,
  1994-1995);
* hard-sphere exclusion: no overlaps at the reference collision radii
  between clusters (the reference allows transient intra-complex
  proximity during alignment but reverts inter-complex overlap);
* counter consistency: bond_num == rl + cis + mono_cis (main.cpp:1931-1938).

Each check returns bool[R], one flag per replica; ``assert_invariants``
raises on the host.
"""

from __future__ import annotations

import torch

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.engine.clusters import cluster_labels
from kmc_tpu_torch.engine.diffusion import collide_matrix
from kmc_tpu_torch.engine.observables import bond_counters
from kmc_tpu_torch.state import SimState, positions


def topology_mutual(state: SimState, cfg: SimConfig):
    na, nb = cfg.n_a, cfg.n_b
    ai = torch.arange(na, device=state.a_trans.device)

    # trans: a_trans[i] = b, a_site[i] = s  <=>  b_partner[b - na, s - 1] = i
    has = state.a_trans >= 0
    b = torch.clamp(state.a_trans - na, 0, nb - 1).long()
    s = torch.clamp(state.a_site - 1, 0, 2).long()
    flat = state.b_partner.reshape(state.b_partner.shape[0], -1)
    back = torch.gather(flat, 1, b * 3 + s)
    ok_t = torch.where(has, back == ai, True).all(dim=1)
    ok_t &= (has == (state.a_site >= 0)).all(dim=1)

    # every b_partner entry points back
    slot = torch.arange(nb * 3, device=flat.device)
    pa = torch.clamp(flat, 0, na - 1).long()
    fwd = ((torch.gather(state.a_trans, 1, pa) == na + slot // 3)
           & (torch.gather(state.a_site, 1, pa) == slot % 3 + 1))
    ok_b = torch.where(flat >= 0, fwd, True).all(dim=1)

    # cis: symmetric, no self-link
    has_c = state.a_cis >= 0
    pc = torch.clamp(state.a_cis, 0, na - 1).long()
    ok_c = torch.where(has_c, (torch.gather(state.a_cis, 1, pc) == ai)
                       & (pc != ai), True).all(dim=1)
    return ok_t & ok_b & ok_c


def no_cross_cluster_overlap(state: SimState, cfg: SimConfig):
    p = positions(state, cfg)
    info = cluster_labels(state, cfg)
    hit = collide_matrix(p, p, cfg)
    cross = info.label[:, :, None] != info.label[:, None, :]
    return ~(hit & cross).flatten(1).any(dim=1)


def counters_consistent(state: SimState, cfg: SimConfig):
    rl, mono, cis, total = bond_counters(state, cfg)
    return total == rl + mono + cis


def assert_invariants(state: SimState, cfg: SimConfig, where: str = ""):
    """Raise AssertionError naming the first invariant a replica breaks."""
    for name, check in (("topology not mutual", topology_mutual),
                        ("overlap", no_cross_cluster_overlap),
                        ("counters", counters_consistent)):
        ok = check(state, cfg)
        if not bool(ok.all()):
            bad = torch.nonzero(~ok)[:, 0].tolist()
            raise AssertionError(f"{name} {where} (replicas {bad})")
