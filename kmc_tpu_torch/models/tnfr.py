"""TNF receptor / ligand rigid-body model geometry (port of
``kmc_tpu/models/tnfr.py``).

The templates are pure constants of the configuration; they are built once
as numpy float32 arrays (the same values the JAX package builds) and handed
out as tensors on the caller's device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.geometry import apply_rotation, euler_matrix, rot_z


@functools.lru_cache(maxsize=None)
def _receptor_np(ra: float) -> np.ndarray:
    beads = []
    for j in range(4):
        z = 2.0 * ra * j
        beads.append([[0.0, 0.0, z], [ra, 0.0, z], [-ra, 0.0, z],
                      [0.0, 0.0, z + ra]])
    return np.asarray(beads, np.float32)


@functools.lru_cache(maxsize=None)
def _ligand_np(rb: float, arm: float) -> np.ndarray:
    s3 = math.sqrt(3.0)
    zero = [0.0, 0.0, 0.0]
    pts = [
        [[0.0, 0.0, 0.0], [0.0, 0.0, rb], zero, zero],
        [[0.0, arm, 0.0], [0.0, arm + rb, 0.0], zero, zero],
        [[-rb, -arm / 2.0, 0.0],
         [-rb * (s3 / 2.0 + 1.0), -arm / 2.0 - rb / 2.0, 0.0], zero, zero],
        [[rb, -arm / 2.0, 0.0],
         [rb * (s3 / 2.0 + 1.0), -arm / 2.0 - rb / 2.0, 0.0], zero, zero],
    ]
    return np.asarray(pts, np.float32)


def receptor_template_np(cfg: SimConfig) -> np.ndarray:
    """Canonical receptor at origin: f32[4, 4, 3] (bead, point, xyz).

    Bead j center at z = 2*R*j; +x/-x sites at x = +-R; +z marker at
    center + R*z  (main.cpp:298-315 with 0-based beads/points)."""
    return _receptor_np(cfg.rb_a_radius)


def ligand_template_np(cfg: SimConfig) -> np.ndarray:
    """Canonical ligand trimer at origin: f32[4, 4, 3]; unused points zero.

    Bead 0 = virtual center (point 1 = up-site at +z*R); beads 1..3 at the
    vertices of an equilateral triangle, arm 2R/sqrt(3), with outward sites
    R beyond each bead center (main.cpp:386-412)."""
    return _ligand_np(cfg.rb_b_radius, cfg.trimer_arm)


def receptor_template(cfg: SimConfig, device=None) -> torch.Tensor:
    return torch.from_numpy(receptor_template_np(cfg)).to(device)


def ligand_template(cfg: SimConfig, device=None) -> torch.Tensor:
    return torch.from_numpy(ligand_template_np(cfg)).to(device)


def build_receptors(center_xy, psai, cfg: SimConfig) -> torch.Tensor:
    """Receptor bodies (..., 4, 4, 3) at center_xy (..., 2) with azimuth
    psai (...,): the template rotated about the rod's z axis, then moved
    to (x, y, 0) (main.cpp:328-350)."""
    flat = receptor_template(cfg, psai.device).reshape(16, 3)
    rotated = apply_rotation(rot_z(psai), flat.expand(*psai.shape, 16, 3),
                             psai.new_zeros(*psai.shape, 3))
    body = rotated.reshape(*psai.shape, 4, 4, 3)
    center = torch.cat([center_xy, center_xy.new_zeros(
        *center_xy.shape[:-1], 1)], dim=-1)
    return body + center[..., None, None, :]


def build_ligands(center, theta, phi, psai, cfg: SimConfig) -> torch.Tensor:
    """Ligand bodies (..., 4, 4, 3) at center (..., 3) with Euler angles
    (...,): the template rotated in 3D about the virtual center
    (main.cpp:421-446)."""
    flat = ligand_template(cfg, psai.device).reshape(16, 3)
    rotated = apply_rotation(euler_matrix(theta, phi, psai),
                             flat.expand(*psai.shape, 16, 3),
                             psai.new_zeros(*psai.shape, 3))
    return rotated.reshape(*psai.shape, 4, 4, 3) + center[..., None, None, :]


# Ideal bond frames (engine/align.py), from the reference's snap formulas:
#   trans: main.cpp:1313-1325, cis: main.cpp:786-798, 1389-1401,
#   B re-seat distance: main.cpp:1491-1494.

def trans_offsets(cfg: SimConfig):
    """Multipliers m such that an ideally trans-bonded A has point p at
    B_site + m[p] * u, u = (B_site - B_bead_center)/R_B (points 0..3)."""
    b2 = cfg.bond_dist_cutoff / 2.0
    ra = cfg.rb_a_radius
    return (b2 + ra, b2, b2 + 2.0 * ra, b2 + ra)


def cis_offsets(cfg: SimConfig):
    """Multipliers m such that an ideally cis-bonded partner A2 has point p
    at A1_cis_site + m[p] * u, u = (A1_cis_site - A1_center)/R_A."""
    c2 = cfg.cis_dist_cutoff / 2.0
    ra = cfg.rb_a_radius
    return (c2 + ra, c2 + 2.0 * ra, c2, c2 + ra)


def b_center_offset(cfg: SimConfig):
    """Distance from an A's trans site to the re-seated B virtual center
    along u = (A_site - A_center)/R_A  (main.cpp:1491)."""
    return cfg.bond_dist_cutoff / 2.0 + cfg.trimer_arm + cfg.rb_b_radius
