"""kmc_tpu_torch -- the PyTorch + CUDA port of kmc_tpu.

A kinetic Monte Carlo simulator of TNF-receptor / ligand oligomerization
(fixed-timestep diffusion-reaction of rigid bodies), run as a single
trajectory or a replica ensemble on one NVIDIA GPU.  The package mirrors
``kmc_tpu``'s layout (``engine/diffusion.py`` <-> ``kmc_tpu/engine/
diffusion.py``), imports torch and never JAX, and runs the idealize core
as hand-written CUDA kernels: K2 (``csrc/align.cu``) for the single
trajectory, K1 (``csrc/align_batched.cu``) for ensembles.  Its tests hold
it against ``kmc_tpu`` on the same inputs.  The command line is
``python -m kmc_tpu_torch.cli``.
"""

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.engine.step import make_step_fn, run, step_fn
from kmc_tpu_torch.parallel.ensemble import (init_ensemble,
                                             lazy_ensemble_step,
                                             make_ensemble_chunk,
                                             make_lazy_ensemble_chunk)
from kmc_tpu_torch.state import SimState, init_state

__all__ = ["SimConfig", "SimState", "init_ensemble", "init_state",
           "lazy_ensemble_step", "make_ensemble_chunk",
           "make_lazy_ensemble_chunk", "make_step_fn", "run", "step_fn"]
