"""Lattice diffusion-reaction step (port of ``kmc_tpu/lattice/step.py``).

This is the plain PyTorch version of kernel K3 (``ops/lattice.py``,
``csrc/lattice.cu``): the CPU runs it, and the tests and ``chip_smoke.py``
hold the kernel to it bit for bit.

Per timestep:
  1. hop: a global axis is drawn per step, then every particle attempts a
     hop with probability hop_prob / k (oligomer size k) choosing its own
     +/- sign along the axis.  Two sub-passes (all + movers, then all -
     movers) keep targets unique; the displacement rides along.
  2. reactions: one global direction d and a parity mask along d's axis
     (each cell in at most one source-target pair): merge (a)+(b) -> (a+b)
     with ass_prob when a+b fits; split (k) -> (k-1)+(1) into an empty
     d-neighbor with diss_prob.

One step references neighbors through 4 chained sub-passes, so a tiled or
sharded step needs width-4 ghost zones.  All randomness comes from the
stateless per-cell counter hash (``ops/hashing.py``) keyed by (global cell
coordinates, step, seed, stream).

The directions are drawn on the device; the shifts here are ``torch.roll``
by Python ints, so each step reads them back to the host once.  The plain
version runs on the CPU; on the card the kernel draws them itself.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from kmc_tpu_torch.config import LatticeConfig
from kmc_tpu_torch.lattice.grid import MAX_SPECIES, LatticeState
from kmc_tpu_torch.ops.hashing import cell_uniform, scalar_uniforms

# stream salts: salt = seed * 16 + stream
SALT_CTRL = 0     # per-step direction/parity draws
SALT_HOP = 1
SALT_MERGE = 2
SALT_SPLIT = 3
SALT_SIGN = 4     # per-particle hop sign

# direction -> (dy, dx)
_DIRS = ((0, 1), (1, 0), (0, -1), (-1, 0))


def _f32(p: float) -> float:
    """p rounded to float32, as JAX compares a float32 array with a Python
    float; a float32 value compares the same in float32 and float64."""
    return float(np.float32(p))


def _shift(x, dy: int, dx: int):
    """x shifted so entry [i,j] becomes the value at [i+dy, j+dx] (periodic)."""
    return torch.roll(x, shifts=(-dy, -dx), dims=(0, 1))


def _shift_back(x, dy: int, dx: int):
    return torch.roll(x, shifts=(dy, dx), dims=(0, 1))


def _parity_mask_global(h, w, row0, col0, axis_is_y: bool, offset: int,
                        device=None):
    """Parity of the *global* coordinate along the pairing axis, identical
    in halo copies across shard boundaries (grid dims must be even)."""
    if axis_is_y:
        coord = torch.arange(h, device=device)[:, None] + row0
        coord = coord.expand(h, w)
    else:
        coord = torch.arange(w, device=device)[None, :] + col0
        coord = coord.expand(h, w)
    return torch.remainder(coord, 2) == offset


def _hop_pass(grid, disp, moved, want, d):
    """One signed sub-pass: cells in ``want`` (attempting, sign matches,
    not already moved this step) hop to their d-neighbor if it is empty.
    For a fixed d every target has a unique source: conflict-free."""
    dy, dx = d
    nb = _shift(grid, dy, dx)
    move = (grid > 0) & want & ~moved & (nb == 0)
    moved_grid = torch.where(move, 0, grid)
    incoming = _shift_back(torch.where(move, grid, 0), dy, dx)
    new_grid = moved_grid + incoming

    dvec = torch.tensor([dy, dx], dtype=torch.int32, device=grid.device)
    moved_disp = torch.where(move[..., None], 0, disp)
    inc_disp = _shift_back(torch.where(move[..., None], disp + dvec, 0),
                           dy, dx)
    new_disp = torch.where(incoming[..., None] > 0, inc_disp, moved_disp)
    new_moved = (moved & ~move) | (incoming > 0)
    return new_grid, new_disp, new_moved


def _hop_substep(grid, disp, u_att, u_sgn, axis_idx: int):
    """Signed two-pass hop along the step's global axis: every particle
    attempts with its own probability and chooses its own +/- direction."""
    attempt = (grid > 0) & (u_att * torch.clamp(grid, min=1) < 1.0)
    sgn_pos = u_sgn < 0.5
    d_pos = (axis_idx, 1 - axis_idx)      # axis 0: (0,+-1); axis 1: (+-1,0)
    d_neg = (-d_pos[0], -d_pos[1])
    moved = torch.zeros_like(grid, dtype=torch.bool)
    grid, disp, moved = _hop_pass(grid, disp, moved, attempt & sgn_pos, d_pos)
    grid, disp, moved = _hop_pass(grid, disp, moved, attempt & ~sgn_pos,
                                  d_neg)
    return grid, disp


def _react_substep(grid, disp, u_m, u_s, d, parity, cfg: LatticeConfig):
    dy, dx = d
    nb = _shift(grid, dy, dx)

    # ---- merge: source (parity on) absorbs its d-neighbor ----
    merge = ((grid > 0) & (nb > 0) & (grid + nb <= MAX_SPECIES) & parity
             & (u_m < _f32(cfg.ass_prob)))
    absorbed = _shift_back(merge, dy, dx)
    grid1 = torch.where(merge, grid + nb, grid)
    grid1 = torch.where(absorbed, 0, grid1)
    disp1 = torch.where(absorbed[..., None], 0, disp)

    # ---- split: source (parity on, k>=2) ejects a monomer into an empty
    #      d-neighbor (mutually exclusive with merge: neighbor was occupied)
    nb1 = _shift(grid1, dy, dx)
    split = (grid1 >= 2) & (nb1 == 0) & parity & (u_s < _f32(cfg.diss_prob))
    receives = _shift_back(split, dy, dx)
    grid2 = torch.where(split, grid1 - 1, grid1) + receives.to(grid1.dtype)
    # ejected monomer starts with the parent's displacement
    parent_disp = _shift_back(disp1, dy, dx)
    disp2 = torch.where(receives[..., None], parent_disp, disp1)
    return grid2, disp2


def step_controls(state: LatticeState):
    """Per-step global draws: hop/react directions and parity offsets."""
    return _controls(state.step, state.seed)


def _controls(step, seed):
    ctrl = scalar_uniforms(4, step, seed.to(torch.int64) * 16 + SALT_CTRL)
    dir_idx = (ctrl[:2] * 4).to(torch.int32)
    par_off = (ctrl[2:] * 2).to(torch.int32)
    return dir_idx, par_off


def step_variant(state: LatticeState) -> tuple[int, int]:
    """The step's (hop axis, reaction direction), one of the 8 variants
    the kernel branches on."""
    dir_idx, _ = step_controls(state)
    hop, rct = dir_idx.tolist()
    return hop % 2, rct


def lattice_step_arrays(grid, disp, step, seed, cfg: LatticeConfig,
                        row0: int = 0, col0: int = 0):
    """One step of (grid, disp) at (step, seed): the plain version of K3.
    row0/col0 offset the cell-hash coordinates (a block's global origin)."""
    h, w = grid.shape
    fh, fw = cfg.height, cfg.width
    dir_idx, par_off = _controls(step, seed)
    hop_dir, rct_dir = dir_idx.tolist()
    par_rct = _parity_mask_global(h, w, row0, col0, rct_dir % 2 == 1,
                                  int(par_off[1]), grid.device)
    salt = seed.to(torch.int64) * 16

    def uniform(stream):
        return cell_uniform((h, w), step, salt + stream, row0, col0, fh, fw)

    # pre-scale: hop prob for species k is hop_prob / k -> u*k < hop_prob.
    # XLA folds the JAX package's division by the constant f32(hop_prob)
    # into a product with its float32 reciprocal; so does this.
    inv_hop = torch.tensor(np.float32(1.0) / np.float32(cfg.hop_prob),
                           dtype=torch.float32, device=grid.device)
    grid, disp = _hop_substep(grid, disp, uniform(SALT_HOP) * inv_hop,
                              uniform(SALT_SIGN), hop_dir % 2)
    return _react_substep(grid, disp, uniform(SALT_MERGE),
                          uniform(SALT_SPLIT), _DIRS[rct_dir], par_rct, cfg)


def lattice_step(state: LatticeState, cfg: LatticeConfig,
                 row0: int = 0, col0: int = 0) -> LatticeState:
    """One step.  row0/col0 offset the cell-hash coordinates: 0 for a full
    grid, a block's global origin when called on a local block."""
    grid, disp = lattice_step_arrays(state.grid, state.disp, state.step,
                                     state.seed, cfg, row0, col0)
    return state._replace(grid=grid, disp=disp, step=state.step + 1,
                          time=state.time + 1.0)


def make_lattice_step(cfg: LatticeConfig):
    return functools.partial(lattice_step, cfg=cfg)


def make_lattice_chunk(cfg: LatticeConfig, chunk: int):
    """``chunk`` steps of the plain version per call."""

    def f(state: LatticeState) -> LatticeState:
        for _ in range(chunk):
            state = lattice_step(state, cfg)
        return state

    return f


def make_sharded_lattice_step(cfg: LatticeConfig, mesh,
                              chunk: Optional[int] = None):
    """``chunk`` (or one) steps of this rank's block of a grid cut over a
    ``grid_mesh`` (``parallel/halo.py``), through ``lattice_block_call``:
    K3 on the card, the plain version on the CPU.  The JAX package lets
    XLA partition ``jnp.roll`` on a sharded array; torch has no
    partitioner, so this is the explicit halo form: the block is padded
    once, each step refreshes only the ghost strips and runs K3 on the
    padded block at its global origin, and the interior is cropped once
    (``halo.halo_chunk``)."""
    from kmc_tpu_torch.ops.lattice import lattice_block_call
    from kmc_tpu_torch.parallel.halo import halo_chunk

    return halo_chunk(cfg, mesh, lattice_block_call, chunk or 1)
