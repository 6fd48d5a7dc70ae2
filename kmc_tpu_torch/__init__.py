"""kmc_tpu_torch -- the PyTorch + CUDA port of kmc_tpu.

A kinetic Monte Carlo simulator of TNF-receptor / ligand oligomerization
(fixed-timestep diffusion-reaction of rigid bodies), run as a replica
ensemble on one NVIDIA GPU.  The package mirrors ``kmc_tpu``'s layout
(``engine/diffusion.py`` <-> ``kmc_tpu/engine/diffusion.py``), imports
torch and never JAX, and runs the idealize core as a hand-written CUDA
kernel (``csrc/align_batched.cu``).  Its tests hold it against ``kmc_tpu``
on the same inputs.
"""

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.parallel.ensemble import (init_ensemble,
                                             lazy_ensemble_step,
                                             make_lazy_ensemble_chunk)
from kmc_tpu_torch.state import SimState

__all__ = ["SimConfig", "SimState", "init_ensemble", "lazy_ensemble_step",
           "make_lazy_ensemble_chunk"]
