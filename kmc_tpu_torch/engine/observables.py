"""Observables of one step (port of ``kmc_tpu/engine/observables.py``).

The reference's bond counters (main.cpp:135-136) are pure functions of the
topology: rl = trans bonds, mono_cis = cis bonds with both receptors
trans-free, cis = the other cis bonds, bond_num = their sum.  Cluster size
is the mean size of ligand-seeded clusters larger than 1 (main.cpp:976-977,
2200-2202).  Every field is per replica, [R].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.engine.clusters import ClusterInfo
from kmc_tpu_torch.state import SimState


class Observables(NamedTuple):
    """One row of the reference ``bond.dat`` time series (main.cpp:2251)."""

    time_ns: torch.Tensor       # f32[R]
    bond_rl: torch.Tensor       # i32[R]
    bond_mono_cis: torch.Tensor
    bond_cis: torch.Tensor
    bond_num: torch.Tensor
    cluster_size: torch.Tensor  # f32[R]
    max_complex: torch.Tensor   # i32[R]


def bond_counters(state: SimState, cfg: SimConfig):
    i32 = torch.int32
    rl = (state.a_trans >= 0).sum(dim=1, dtype=i32)
    has_cis = state.a_cis >= 0
    partner = torch.clamp(state.a_cis, 0, cfg.n_a - 1).long()
    trans_free = state.a_trans < 0
    tf_partner = torch.gather(trans_free, 1, partner)
    mono = (has_cis & trans_free & tf_partner).sum(dim=1, dtype=i32) // 2
    cis = has_cis.sum(dim=1, dtype=i32) // 2 - mono
    return rl, mono, cis, rl + mono + cis


def cluster_stats(info: ClusterInfo, cfg: SimConfig):
    """(cluster_size, max_b_cluster) from ligand-seeded clusters."""
    seeded = info.is_root & (info.n_b > 0)
    big = seeded & (info.size > 1)
    tot = torch.where(big, info.size, 0).sum(dim=1, dtype=torch.int32)
    num = big.sum(dim=1, dtype=torch.int32)
    cluster_size = torch.where(num > 0, tot / torch.clamp(num, min=1), 0.0)
    max_b = torch.where(seeded, info.size, 0).amax(dim=1).to(torch.int32)
    return cluster_size.to(torch.float32), max_b


def observe(state: SimState, info: ClusterInfo, cfg: SimConfig) -> Observables:
    """Counters from the committed topology, cluster stats from the step's
    start-of-step labels (the reference's bond.dat semantics)."""
    rl, mono, cis, total = bond_counters(state, cfg)
    cluster_size, _ = cluster_stats(info, cfg)
    return Observables(
        time_ns=(state.step.to(torch.float32) - 1.0) * cfg.time_step,
        bond_rl=rl, bond_mono_cis=mono, bond_cis=cis, bond_num=total,
        cluster_size=cluster_size, max_complex=state.max_complex)
