"""Reference-physics -> lattice-engine parameter mapping (port of
``kmc_tpu/lattice/mapping.py``; BASELINE configs 2/3), in pure Python.

The reference moves a free receptor by ``2*sqrt(D*dt/6)*U(0,1)`` at a
uniform angle each step (main.cpp:585-595), so its per-step mean-squared
displacement is (4*D*dt/6) * E[U^2] = 2*D*dt/9.  A lattice walker with hop
probability p at spacing a accumulates p * a^2 per step; matching gives

    hop_prob = 2 * D * dt / (9 * a^2)

An adjacent pair merges at ass_prob/4 per pair-step on the lattice while a
reference A-A pair (scanned twice per step) reacts at ~2*rate*dt, giving
ass_prob = 8 * rate_ass * dt; a k>=2 cell splits at diss_prob/2 per step
against rate*dt, giving diss_prob = 2 * rate_diss * dt.
"""

from __future__ import annotations

from kmc_tpu_torch.config import LatticeConfig, SimConfig


def reference_lattice_config(
    cfg: SimConfig | None = None,
    spacing: float = 20.0,
    species: str = "receptor",
    reaction: str = "mono_cis",
    height: int = 512,
    width: int = 512,
    density: float | None = None,
    rate_scale: float = 1.0,
) -> LatticeConfig:
    """LatticeConfig with hop/ass/diss probabilities derived from the
    reference parameter set.

    spacing: lattice constant in Angstrom (default = the receptor bead
    radius, main.cpp:72, so one cell ~ one molecule footprint).
    species: 'receptor' (D=1 A^2/ns) or 'ligand' (D=7.2614) sets the hop.
    reaction: 'mono_cis' | 'cis' | 'trans' selects the rate pair.
    rate_scale: multiply both reaction rates (ratio preserved).
    """
    cfg = cfg or SimConfig()
    d = {"receptor": cfg.rb_a_d, "ligand": cfg.rb_b_d}[species]
    rates = {
        "mono_cis": (cfg.mono_cis_ass_rate, cfg.mono_cis_diss_rate),
        "cis": (cfg.cis_ass_rate, cfg.cis_diss_rate),
        "trans": (cfg.ass_rate, cfg.diss_rate),
    }[reaction]
    dt = cfg.time_step
    hop = 2.0 * d * dt / (9.0 * spacing**2)
    ass = min(8.0 * rates[0] * dt * rate_scale, 1.0)
    diss = min(2.0 * rates[1] * dt * rate_scale, 1.0)
    if density is None:
        # reference receptor surface density: N_A / box area, one molecule
        # per cell footprint a^2
        density = cfg.n_a * spacing**2 / (cfg.cell_range_x * cfg.cell_range_y)
    return LatticeConfig(
        height=height, width=width, hop_prob=hop, ass_prob=ass,
        diss_prob=diss, density=density,
    )


def msd_per_step_A2(cfg: SimConfig, species: str = "receptor") -> float:
    """The reference's analytic per-step MSD in A^2 (2*D*dt/9)."""
    d = {"receptor": cfg.rb_a_d, "ligand": cfg.rb_b_d}[species]
    return 2.0 * d * cfg.time_step / 9.0
