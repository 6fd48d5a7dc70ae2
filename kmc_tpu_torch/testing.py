"""Inputs for checking the port's kernels against their plain versions:
replica states with random bonded topologies, made from a seed, and K1's
inputs formed from them exactly as the main path forms them."""

from __future__ import annotations

import numpy as np
import torch

from kmc_tpu_torch import rng
from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.engine.align import _choose_roots
from kmc_tpu_torch.engine.clusters import cluster_labels
from kmc_tpu_torch.parallel.ensemble import init_ensemble
from kmc_tpu_torch.state import SimState


def bonded_state(cfg: SimConfig, n_rep: int, seed: int, device) -> SimState:
    """Cold-start poses with a random mutual topology: each ligand binds up
    to three receptors (while free receptors last) and random receptor
    pairs are cis-bonded, so complexes span several ligands and some chains
    run deeper than align_depth.  Half the ligands are marked laid."""
    st = init_ensemble(cfg, n_rep, seed=seed, device=device)
    g = np.random.default_rng(seed)
    na, nb = cfg.n_a, cfg.n_b
    a_trans = np.full((n_rep, na), -1, np.int32)
    a_site = np.full((n_rep, na), -1, np.int32)
    a_cis = np.full((n_rep, na), -1, np.int32)
    b_partner = np.full((n_rep, nb, 3), -1, np.int32)
    for r in range(n_rep):
        free = list(g.permutation(na))
        for b in range(nb):
            for s in range(int(g.integers(0, 4))):
                if not free:
                    break
                a = free.pop()
                a_trans[r, a], a_site[r, a] = na + b, s + 1
                b_partner[r, b, s] = a
        pairs = g.permutation(na)[: 2 * int(g.integers(1, na // 2 + 1))]
        for a1, a2 in pairs.reshape(-1, 2):
            a_cis[r, a1], a_cis[r, a2] = a2, a1

    def dev(x):
        return torch.from_numpy(x).to(device)

    return st._replace(a_trans=dev(a_trans), a_site=dev(a_site),
                       a_cis=dev(a_cis), b_partner=dev(b_partner),
                       b_laid=dev(g.random((n_rep, nb)) < 0.5))


def align_core_inputs(st: SimState, cfg: SimConfig) -> list[torch.Tensor]:
    """K1's eleven inputs for every replica of ``st``: roots from the align
    stream of each replica's current step, act = cluster size > 1
    (engine/align.idealize_fused, ops/align_batched.align_core)."""
    i32 = torch.int32
    info = cluster_labels(st, cfg)
    skey = rng.stream_key(rng.step_key(st.key, st.step), rng.STREAM_ALIGN)
    root = _choose_roots(st, info, skey, cfg)
    a_dir = torch.stack([torch.cos(st.a_psi), torch.sin(st.a_psi)], -1)
    return [st.a_xy.contiguous(), a_dir, st.b_center.contiguous(),
            st.b_quat.contiguous(), st.a_trans.contiguous(),
            st.a_site.contiguous(), st.a_cis.contiguous(),
            st.b_partner.contiguous(), st.b_laid.to(i32),
            root.to(i32), (info.size > 1).to(i32)]
