"""Simulation state of a replica ensemble (port of ``kmc_tpu/state.py``).

The state stores poses, not coordinates: a receptor is (x, y, azimuth) and
a ligand is (center, unit quaternion); bead and site coordinates are
derived from the canonical templates (``positions``).  Every field carries
an explicit leading replica axis R.

Index conventions (0-based): molecules 0..n_a-1 are receptors (A),
n_a..n-1 are ligands (B).  Topology (reference protein_status / res_nei,
main.cpp:115-118):

* ``a_trans``: int32[R, n_a], bound B molecule index or -1
* ``a_site``:  int32[R, n_a], bound B bead (1..3) or -1
* ``a_cis``:   int32[R, n_a], cis partner A index or -1
* ``b_partner``: int32[R, n_b, 3], A bound at bead (1+k)'s site, or -1
* ``b_laid``: bool[R, n_b], ligand lies in the membrane plane

``key`` is int64[R, 2]: the two uint32 words of each replica's Threefry
key, exactly ``jax.random.key_data`` of the JAX package's key (rng.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.geometry import quat_rotate
from kmc_tpu_torch.models.tnfr import ligand_template, receptor_template


class SimState(NamedTuple):
    a_xy: torch.Tensor         # f32[R, n_a, 2] rod axis position
    a_psi: torch.Tensor        # f32[R, n_a]    rod azimuth
    b_center: torch.Tensor     # f32[R, n_b, 3] trimer virtual center
    b_quat: torch.Tensor       # f32[R, n_b, 4] orientation (w, x, y, z)
    a_trans: torch.Tensor      # i32[R, n_a]
    a_site: torch.Tensor       # i32[R, n_a]
    a_cis: torch.Tensor        # i32[R, n_a]
    b_partner: torch.Tensor    # i32[R, n_b, 3]
    b_laid: torch.Tensor       # bool[R, n_b]
    max_complex: torch.Tensor  # i32[R] running max B-seeded cluster size
    step: torch.Tensor         # i32[R] current MC step (1-based)
    key: torch.Tensor          # i64[R, 2] Threefry key words
    dirty: torch.Tensor        # bool[R] geometry may be un-idealized (set by
    #   react on a topology change and by align on a revert; cleared by a
    #   revert-free idealize) -- the lazy ensemble step aligns dirty
    #   replicas first


def empty_state(cfg: SimConfig, key: torch.Tensor) -> SimState:
    """All-default state for replica keys ``key`` (i64[R, 2])."""
    r, dev = key.shape[0], key.device
    f32, i32 = torch.float32, torch.int32
    b_quat = torch.zeros((r, cfg.n_b, 4), dtype=f32, device=dev)
    b_quat[..., 0] = 1.0
    return SimState(
        a_xy=torch.zeros((r, cfg.n_a, 2), dtype=f32, device=dev),
        a_psi=torch.zeros((r, cfg.n_a), dtype=f32, device=dev),
        b_center=torch.zeros((r, cfg.n_b, 3), dtype=f32, device=dev),
        b_quat=b_quat,
        a_trans=torch.full((r, cfg.n_a), -1, dtype=i32, device=dev),
        a_site=torch.full((r, cfg.n_a), -1, dtype=i32, device=dev),
        a_cis=torch.full((r, cfg.n_a), -1, dtype=i32, device=dev),
        b_partner=torch.full((r, cfg.n_b, 3), -1, dtype=i32, device=dev),
        b_laid=torch.zeros((r, cfg.n_b), dtype=torch.bool, device=dev),
        max_complex=torch.zeros((r,), dtype=i32, device=dev),
        step=torch.ones((r,), dtype=i32, device=dev),
        key=key,
        dirty=torch.ones((r,), dtype=torch.bool, device=dev),
    )


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, "cuda" by default; raises when CUDA is
    asked for (or defaulted to) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kmc_tpu_torch runs on a CUDA device by default "
                           "and none is available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def check_state_device(state: SimState, device) -> None:
    """Raise unless ``state`` lives on ``device`` (resolved as above)."""
    dev = resolve_device(device)
    have = state.a_xy.device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"state lives on {have}, the step was asked to run "
                         f"on {dev}")


def init_state(cfg: SimConfig, seed: int = 0, device=None) -> SimState:
    """Cold start of a single trajectory (one replica): random
    non-overlapping placement from the base key of ``seed``, the JAX
    package's ``init_state(cfg, seed)``."""
    from kmc_tpu_torch.engine.init import random_init

    return random_init(cfg, seed, resolve_device(device))


def take_replicas(state: SimState, idx: torch.Tensor) -> SimState:
    """The replicas ``idx`` of every field."""
    return SimState(*(x[idx] for x in state))


# ---------------------------------------------------------------------------
# Derived coordinates.

def a_positions(a_xy, a_psi, cfg: SimConfig, cos_sin=None):
    """Receptor bead/point coordinates, f32[..., n_a, 4, 4, 3].
    ``cos_sin`` gives (cos psi, sin psi) computed elsewhere."""
    tmpl = receptor_template(cfg, a_xy.device).reshape(16, 3)
    c, s = cos_sin if cos_sin is not None else (torch.cos(a_psi),
                                                torch.sin(a_psi))
    c, s = c[..., None], s[..., None]
    x, y = tmpl[:, 0], tmpl[:, 1]
    rx = x * c - y * s + a_xy[..., 0:1]
    ry = x * s + y * c + a_xy[..., 1:2]
    rz = tmpl[:, 2].expand(rx.shape)
    return torch.stack([rx, ry, rz], dim=-1).reshape(*a_psi.shape, 4, 4, 3)


def b_positions(b_center, b_quat, cfg: SimConfig):
    """Ligand bead/point coordinates, f32[..., n_b, 4, 4, 3]."""
    tmpl = ligand_template(cfg, b_center.device).reshape(16, 3)
    pts = quat_rotate(b_quat[..., None, :], tmpl) + b_center[..., None, :]
    return pts.reshape(*b_center.shape[:-1], 4, 4, 3)


def positions(state: SimState, cfg: SimConfig):
    """All coordinates, f32[R, n, 4, 4, 3] (A block then B block)."""
    return torch.cat(
        [a_positions(state.a_xy, state.a_psi, cfg),
         b_positions(state.b_center, state.b_quat, cfg)],
        dim=-4,
    )


def neighbors(state: SimState, cfg: SimConfig):
    """Bond-graph neighbor lists, int32[R, n, 3], -1 padded.  For A:
    column 0 = trans partner, column 1 = cis partner; for B the three
    per-bead site partners (main.cpp:543-551)."""
    a = torch.stack([state.a_trans, state.a_cis,
                     torch.full_like(state.a_trans, -1)], dim=-1)
    return torch.cat([a, state.b_partner], dim=-2)
