"""kmc_tpu_torch -- the PyTorch + CUDA port of kmc_tpu.

A kinetic Monte Carlo simulator of TNF-receptor / ligand oligomerization
(fixed-timestep diffusion-reaction of rigid bodies), run as a single
trajectory or a replica ensemble on NVIDIA GPUs.  The package mirrors
``kmc_tpu``'s layout (``engine/diffusion.py`` <-> ``kmc_tpu/engine/
diffusion.py``), imports torch and never JAX, and runs the idealize core
as hand-written CUDA kernels: K2 (``csrc/align.cu``) for the single
trajectory, K1 (``csrc/align_batched.cu``) for ensembles.  The lattice
engine (``lattice/``) runs its whole step as the hand-written kernel K3
(``csrc/lattice.cu``) on the card; its rejection-free mode
(``lattice/rejection_free.py``) runs in plain PyTorch.  ``RuntimeParams``
(``engine/params.py``) runs a parameter sweep across the replicas of one
batched step.  The multi-device paths (``parallel/mesh.py``,
``distributed.py``, ``halo.py``) run one process a card on
``torch.distributed``: a sharded replica ensemble, and a lattice cut over
a rank grid with K3 on each halo-padded block.  Its tests hold it against
``kmc_tpu`` on the same inputs.
The command line is ``python -m kmc_tpu_torch.cli``.
"""

from kmc_tpu_torch.config import LatticeConfig, SimConfig
from kmc_tpu_torch.engine.params import RuntimeParams
from kmc_tpu_torch.engine.step import make_step_fn, run, step_fn
from kmc_tpu_torch.lattice.grid import LatticeState, init_lattice
from kmc_tpu_torch.lattice.step import make_lattice_step
from kmc_tpu_torch.parallel.ensemble import (init_ensemble,
                                             lazy_ensemble_step,
                                             make_ensemble_chunk,
                                             make_lazy_ensemble_chunk)
from kmc_tpu_torch.state import SimState, init_state

__all__ = ["LatticeConfig", "LatticeState", "RuntimeParams", "SimConfig",
           "SimState", "init_ensemble", "init_lattice", "init_state",
           "lazy_ensemble_step", "make_ensemble_chunk",
           "make_lattice_step", "make_lazy_ensemble_chunk", "make_step_fn",
           "run", "step_fn"]
