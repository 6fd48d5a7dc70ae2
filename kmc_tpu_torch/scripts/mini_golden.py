"""The mini configuration of the JAX package's ``scripts/mini_golden.py``:
the reference's area density (150 receptors in 5,773^2 A -> 40 in
2,981^2 A) and z extent, 12 ligands, and the cis association rates scaled
by ``boost``.  The flux diagnostics (``receptors_probe.py``,
``chan_flux.py``) run at this configuration.

Only the configuration is ported.  The rest of the JAX file patches,
compiles and runs the C++ reference (main.cpp) for its band test, and
that source is not in this repository.
"""

from __future__ import annotations

NA, NB = 40, 12
BOX_XY, BOX_Z = 2981.0, 1000.0


def our_config(boost: float):
    """``SimConfig`` at the mini size with the mono-cis and cis association
    rates ``boost`` times the reference's (main.cpp:39-99)."""
    from kmc_tpu_torch.config import SimConfig

    return SimConfig(
        n_a=NA, n_b=NB,
        cell_range_x=BOX_XY, cell_range_y=BOX_XY, cell_range_z=BOX_Z,
        mono_cis_ass_rate=0.000047 * boost,
        cis_ass_rate=0.00096 * boost,
        out_every=1000,
    )
