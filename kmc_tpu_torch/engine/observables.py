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


MAX_HIST_SIZE = 16


def _bincount_rows(idx, length: int):
    """Per-replica bincount: i32[R, length] counts of idx [R, m], whose
    values lie in 0..length-1."""
    out = torch.zeros((idx.shape[0], length), dtype=torch.int32,
                      device=idx.device)
    return out.scatter_add_(1, idx.long(), torch.ones_like(idx,
                                                           dtype=torch.int32))


def cluster_histogram(info: ClusterInfo, cfg: SimConfig):
    """Histogram of ligand-seeded cluster sizes, i32[R, MAX_HIST_SIZE + 1]:
    slot s = number of clusters of size s (s >= MAX_HIST_SIZE binned into
    the last slot; slot 0 unused)."""
    seeded = info.is_root & (info.n_b > 0)
    sizes = torch.where(seeded, torch.clamp(info.size, 0, MAX_HIST_SIZE), 0)
    hist = _bincount_rows(sizes, MAX_HIST_SIZE + 1)
    hist[:, 0] = 0
    return hist


def seeded_receptor_histogram(info: ClusterInfo, cfg: SimConfig):
    """Histogram over the number of receptors in each ligand-seeded cluster,
    i32[R, MAX_HIST_SIZE + 1]: slot r = clusters with r receptor members
    (r >= MAX_HIST_SIZE in the last slot; slot 0 = pure-ligand clusters),
    the statistic of the reference's cluster.log (main.cpp:2291-2305)."""
    seeded = info.is_root & (info.n_b > 0)
    idx = torch.where(seeded, torch.clamp(info.n_a, 0, MAX_HIST_SIZE) + 1, 0)
    return _bincount_rows(idx, MAX_HIST_SIZE + 2)[:, 1:]


def receptor_oligomer_histogram(info: ClusterInfo, cfg: SimConfig):
    """Histogram over the number of receptors per cluster (any cluster with
    a receptor, free receptors as size 1), i32[R, MAX_HIST_SIZE + 1]."""
    rooted = info.is_root & (info.n_a > 0)
    sizes = torch.where(rooted, torch.clamp(info.n_a, 0, MAX_HIST_SIZE), 0)
    hist = _bincount_rows(sizes, MAX_HIST_SIZE + 1)
    hist[:, 0] = 0
    return hist


def observe(state: SimState, info: ClusterInfo, cfg: SimConfig) -> Observables:
    """Counters from the committed topology, cluster stats from the step's
    start-of-step labels (the reference's bond.dat semantics)."""
    rl, mono, cis, total = bond_counters(state, cfg)
    cluster_size, _ = cluster_stats(info, cfg)
    return Observables(
        time_ns=(state.step.to(torch.float32) - 1.0) * cfg.time_step,
        bond_rl=rl, bond_mono_cis=mono, bond_cis=cis, bond_num=total,
        cluster_size=cluster_size, max_complex=state.max_complex)
