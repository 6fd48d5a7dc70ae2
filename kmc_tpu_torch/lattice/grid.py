"""Lattice state (port of ``kmc_tpu/lattice/grid.py``; BASELINE configs
2/5).

A 2D periodic occupancy grid: cell value k = oligomer of size k (0 empty).
The oligomer size is the species, so the cluster-size distribution is a
plain histogram of the grid.  ``disp`` carries each particle's accumulated
displacement (for MSD validation); it rides along with hops and is
absorbed on merges.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kmc_tpu_torch import rng as _rng
from kmc_tpu_torch.config import LatticeConfig
from kmc_tpu_torch.state import resolve_device

MAX_SPECIES = 8   # largest oligomer; association above this is gated off


class LatticeState(NamedTuple):
    grid: torch.Tensor   # int32[H, W] oligomer size per cell (0 = empty)
    disp: torch.Tensor   # int32[H, W, 2] accumulated (dy, dx) of the occupant
    step: torch.Tensor   # i32[] steps applied
    seed: torch.Tensor   # i32[] stream seed for the per-cell counter hash
    time: torch.Tensor   # f32[] simulated time in step units (+1 a step)


def init_lattice(cfg: LatticeConfig, seed: int = 0,
                 n_particles: int | None = None,
                 device=None) -> LatticeState:
    """Random monomer fill at cfg.density (or exactly n_particles), drawn
    as the JAX package draws it.  Runs on the card unless ``device="cpu"``;
    raises without a card."""
    dev = resolve_device(device)
    key = _rng.base_key(seed, dev)
    kfill = _rng.stream_key(_rng.step_key(key, 0), _rng.STREAM_LATTICE)
    h, w = cfg.height, cfg.width
    if n_particles is None:
        occupied = _rng.uniform(kfill, (h, w)) < float(np.float32(cfg.density))
    else:
        flat = torch.zeros((h * w,), dtype=torch.bool, device=dev)
        flat[:n_particles] = True
        occupied = _rng.permutation(kfill, flat).reshape(h, w)
    return LatticeState(
        grid=occupied.to(torch.int32),
        disp=torch.zeros((h, w, 2), dtype=torch.int32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        seed=torch.tensor(seed, dtype=torch.int32, device=dev),
        time=torch.zeros((), dtype=torch.float32, device=dev),
    )


def species_histogram(state: LatticeState) -> torch.Tensor:
    """Count of cells per species 0..MAX_SPECIES (0 = empty cells)."""
    counts = torch.bincount(state.grid.reshape(-1).to(torch.int64),
                            minlength=MAX_SPECIES + 1)
    return counts[:MAX_SPECIES + 1]


def particle_count(state: LatticeState) -> torch.Tensor:
    """Total monomer-equivalents (conserved by hop/merge/split)."""
    return state.grid.sum(dtype=torch.int32)


def msd(state: LatticeState) -> torch.Tensor:
    """Mean squared displacement over occupied cells (lattice units^2), in
    float32 as the JAX package computes it.  The squared displacements are
    integers, so the float32 sum is exact, and equal to JAX's whatever the
    summation order, while it stays below 2^24."""
    occ = state.grid > 0
    d2 = (state.disp.to(torch.float32) ** 2).sum(-1)
    total = torch.where(occ, d2, 0.0).sum()
    return total / torch.clamp(occ.sum(dtype=torch.int32), min=1)
