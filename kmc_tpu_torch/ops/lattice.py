"""One whole lattice timestep as one kernel, K3 (port of
``kmc_tpu/ops/pallas_lattice.py``: ``_kernel``, ``pallas_lattice_step``,
``make_pallas_lattice_step``, ``make_pallas_lattice_chunk``).

``lattice_block_call`` advances a block (grid int32[h, w], disp
int32[h, w, 2]) by one step at the step and seed held in int32 scalar
tensors.  On a CUDA tensor it launches the hand-written kernel
``kmc_tpu_torch/csrc/lattice.cu`` once and raises if the launch fails; on a
CPU tensor it runs the plain version, ``lattice/step.py``'s
``lattice_step_arrays`` (what ``lattice_step`` runs).  There is no fallback
from the card to the plain version.

The kernel draws the step's directions on the device, so a step costs no
read-back to the host.  The TPU's ``tiled_block_call`` and
``padded_block_call`` cut the grid into VMEM-sized tiles; on the card the
kernel tiles the grid itself (32 x 32 tiles with width-4 ghosts in shared
memory), so neither is ported as such.  Like ``padded_block_call``, the
kernel takes the block's global origin (row0, col0) for its hashes and
parity, with the block wrapping periodically onto itself.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from kmc_tpu_torch.config import LatticeConfig
from kmc_tpu_torch.lattice.grid import LatticeState
from kmc_tpu_torch.lattice.step import lattice_step_arrays


def _bind(lib):
    fn = lib.kmc_lattice_step
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(grid, disp, step, seed):
    dev = grid.device
    for name, x in (("grid", grid), ("disp", disp), ("step", step),
                    ("seed", seed)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, grid on {dev}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if grid.dim() != 2:
        raise ValueError(f"grid must be [h, w], got {tuple(grid.shape)}")
    h, w = grid.shape
    if tuple(disp.shape) != (h, w, 2):
        raise ValueError(f"disp must have shape {(h, w, 2)}, got "
                         f"{tuple(disp.shape)}")
    if h % 2 or w % 2 or h == 0 or w == 0:
        raise ValueError(f"the lattice needs even, nonzero dimensions (the "
                         f"parity mask pairs cells), got {h} x {w}")
    if step.dim() != 0 or seed.dim() != 0:
        raise ValueError("step and seed must be 0-dim tensors")


def lattice_block_call(grid, disp, step, seed, cfg: LatticeConfig,
                       row0: int = 0, col0: int = 0):
    """K3: (grid, disp) one step later.  The plain version for CPU
    tensors, the CUDA kernel for CUDA tensors; each kernel launch adds one
    to ``lattice_block_call.launches``."""
    if grid.device.type == "cpu":
        return lattice_step_arrays(grid, disp, step, seed, cfg, row0, col0)
    if grid.device.type != "cuda":
        raise ValueError(f"no lattice kernel for device {grid.device}")
    _check_inputs(grid, disp, step, seed)
    from kmc_tpu_torch.ops import build

    fn = _bind(build.library("lattice"))
    h, w = grid.shape
    out_grid, out_disp = torch.empty_like(grid), torch.empty_like(disp)
    f32 = np.float32
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    with torch.cuda.device(grid.device):
        err = fn(grid.data_ptr(), disp.data_ptr(), step.data_ptr(),
                 seed.data_ptr(), out_grid.data_ptr(), out_disp.data_ptr(),
                 h, w, row0, col0, cfg.height, cfg.width,
                 float(f32(1.0) / f32(cfg.hop_prob)), float(f32(cfg.ass_prob)),
                 float(f32(cfg.diss_prob)), stream)
    if err != 0:
        raise RuntimeError(f"lattice kernel launch failed: CUDA error {err}")
    lattice_block_call.launches += 1
    return out_grid, out_disp


lattice_block_call.launches = 0


def pallas_lattice_step(state: LatticeState,
                        cfg: LatticeConfig) -> LatticeState:
    """One fused-kernel step, trajectory-identical to lattice_step."""
    grid, disp = lattice_block_call(state.grid, state.disp, state.step,
                                    state.seed, cfg)
    return state._replace(grid=grid, disp=disp, step=state.step + 1,
                          time=state.time + 1.0)


def make_pallas_lattice_step(cfg: LatticeConfig):
    return functools.partial(pallas_lattice_step, cfg=cfg)


def make_pallas_lattice_chunk(cfg: LatticeConfig, chunk: int):
    """``chunk`` kernel steps per call, one launch each."""

    def f(state: LatticeState) -> LatticeState:
        for _ in range(chunk):
            state = pallas_lattice_step(state, cfg)
        return state

    return f
