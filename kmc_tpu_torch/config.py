"""Configuration of the particle engine (``SimConfig``).

A copy of ``kmc_tpu.config.SimConfig``: same field names, defaults and
derived properties, so a configuration means the same thing in both
packages (tests/test_torch_config_geometry.py holds the two equal).  The
port keeps its own copy because importing anything from ``kmc_tpu`` pulls
in JAX.  Fields that name TPU knobs (``fused_align``) keep their meaning:
``fused_align=True`` runs the idealize core as the fused kernel
(ops/align_batched.py), ``False`` as the unfused tensor code.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """All physics + runtime constants of the particle engine.

    Defaults reproduce the reference workload (main.cpp:39-99): 150 membrane
    receptors (protein A) + 50 ligand trimers (protein B) in a
    5773 x 5773 x 1000 Angstrom box, dt = 10 ns.
    """

    # ---- run control (main.cpp:39-40) ----
    simu_step: int = 20_000_000
    time_step: float = 10.0            # ns
    out_every: int = 5000              # checkpoint/time-series cadence (main.cpp:2206)

    # ---- box (main.cpp:43-45); periodic in x,y, z-reflecting for ligands ----
    cell_range_x: float = 5773.0
    cell_range_y: float = 5773.0
    cell_range_z: float = 1000.0

    # ---- molecule counts (main.cpp:47-69) ----
    n_a: int = 150                     # receptors (protein A)
    n_b: int = 50                      # ligand trimers (protein B)

    # ---- geometry (main.cpp:71-78) ----
    rb_a_radius: float = 20.0          # receptor bead radius (Angstrom)
    rb_b_radius: float = 30.0          # ligand bead radius

    # ---- diffusion coefficients (main.cpp:73-89) ----
    rb_a_d: float = 1.0                # A^2/ns, free receptor translation
    rb_a_rot_d: float = 0.0174         # rad^2/ns, free receptor rotation
    rb_b_d: float = 7.2614             # free ligand translation
    rb_b_rot_d: float = 0.0061209      # free ligand rotation
    cis_d: float = 0.5                 # lone cis receptor pair translation
    cis_rot_d: float = 0.005
    bond_d: float = 0.5                # 1-ligand complex translation (main.cpp:88,984)
    bond_rot_d: float = 0.005

    # ---- reaction rates, per ns (main.cpp:80-91) ----
    ass_rate: float = 0.04             # trans (receptor-ligand) association
    diss_rate: float = 3.48e-13        # trans dissociation
    mono_cis_ass_rate: float = 4.7e-5  # cis association, both receptors free
    mono_cis_diss_rate: float = 1.12e-13
    cis_ass_rate: float = 9.6e-4       # cis association, >=1 receptor bound
    cis_diss_rate: float = 1.12e-13

    # ---- geometric gates (main.cpp:93-99) ----
    bond_dist_cutoff: float = 18.0     # trans site-site distance gate
    bond_thetapd_cutoff: float = 45.0  # |theta_pd| gate, degrees (main.cpp:1915)
    bond_thetaot_cutoff: float = 90.0  # |theta_ot - 180| gate
    cis_dist_cutoff: float = 15.0
    cis_thetaot_cutoff: float = 10.0

    # ---- engine knobs (new; no reference equivalent) ----
    label_closure_iters: int = 8       # adjacency-matrix squarings for cluster
    #   labels: coverage = 2^iters hops >= n guarantees exact components
    align_depth: int = 8               # max BFS depth idealized per step
    #   (snap chains longer than this finish over subsequent steps; the
    #   mobility freeze keeps real complexes well inside this bound)
    match_rounds: int = 2              # mutual-argmax rounds in reaction matching
    fused_align: bool = True           # run the idealize core as one fused
    #   kernel (ops/align_batched.py); False = the unfused tensor path.  The
    #   two agree within 1e-4 A (tests/test_torch_align.py).
    sin_weighted_theta: bool = False   # reference quirk #3: ligand 3D direction
    #   uses theta = U*pi (pole-oversampled, main.cpp:910). False replicates the
    #   reference; True samples cos(theta) uniformly (physically isotropic).
    sweep_collisions: bool = True      # collision resolution emulates the
    #   reference's Gauss-Seidel sweep (main.cpp:577-1872) via random cluster
    #   priorities: later movers see earlier movers' NEW placements, earlier
    #   movers see later movers' OLD placements, + a monotone cleanup loop.
    #   False = the symmetric rule (reject on overlap with ANY placement, old
    #   or new, of any other cluster).
    sweep_exact_cleanup: bool = False  # True: run the cleanup loop to its
    #   fixpoint (exact no-overlap invariant).  False (default): 3 unrolled
    #   cleanup rounds; a deeper revert chain can leave a transient overlap
    #   that the collision rule then self-heals.

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        """Total molecules (A then B)."""
        return self.n_a + self.n_b

    @property
    def plane_z(self) -> float:
        """z of the receptor interaction bead (bead index 2; reference bead 3
        at z = (3*2-2)*RB_A_radius, main.cpp:301) — the ligand lay-down plane."""
        return 4.0 * self.rb_a_radius

    @property
    def p_trans_ass(self) -> float:
        return self.ass_rate * self.time_step

    @property
    def p_trans_diss(self) -> float:
        return self.diss_rate * self.time_step

    @property
    def p_mono_cis_ass(self) -> float:
        return self.mono_cis_ass_rate * self.time_step

    @property
    def p_mono_cis_diss(self) -> float:
        return self.mono_cis_diss_rate * self.time_step

    @property
    def p_cis_ass(self) -> float:
        return self.cis_ass_rate * self.time_step

    @property
    def p_cis_diss(self) -> float:
        return self.cis_diss_rate * self.time_step

    @property
    def trimer_arm(self) -> float:
        """Distance from ligand virtual center to each bead center
        (main.cpp:395: RB_B_radius * 2/sqrt(3))."""
        return self.rb_b_radius * 2.0 / math.sqrt(3.0)

    # ------------------------------------------------------------------
    def replace(self, **kw: Any) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @classmethod
    def from_json(cls, path: str) -> "SimConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


# Reference-default singleton.
DEFAULT = SimConfig()
