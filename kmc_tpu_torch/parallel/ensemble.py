"""Replica ensembles and the lazy (event-driven) ensemble step (port of
``kmc_tpu/parallel/ensemble.py``).

Every stage runs on all replicas at once through the explicit leading
replica axis.  The lazy step runs the idealize stage only on the
``k_align`` dirtiest replicas: idealize is a geometric no-op on a clean
replica, and a replica is dirty only in the step after a topology change
or an align revert.  Overflow replicas (more than k dirty) are aligned on
later steps, rotation-prioritised so none starves.

The entry points run on the card unless the caller passes
``device="cpu"``; without a card they raise rather than run on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from kmc_tpu_torch import rng
from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.engine.align import idealize, idealize_fused
from kmc_tpu_torch.engine.clusters import cluster_labels, take_info
from kmc_tpu_torch.engine.diffusion import diffuse
from kmc_tpu_torch.engine.init import random_init_from_key
from kmc_tpu_torch.engine.observables import (Observables, cluster_stats,
                                              observe)
from kmc_tpu_torch.engine.reactions import react
from kmc_tpu_torch.state import SimState, take_replicas

_ALIGNED_FIELDS = ("a_xy", "a_psi", "b_center", "b_quat", "b_laid", "dirty")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, "cuda" by default; raises when CUDA is
    asked for (or defaulted to) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kmc_tpu_torch runs on a CUDA device by default "
                           "and none is available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def _check_state_device(state: SimState, device) -> None:
    dev = resolve_device(device)
    have = state.a_xy.device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"state lives on {have}, the step was asked to run "
                         f"on {dev}")


def init_ensemble(cfg: SimConfig, n_replicas: int, seed: int = 0,
                  device=None) -> SimState:
    """Batched cold start: replica r starts from fold_in(key(seed), r), the
    JAX package's placement for the same seed."""
    dev = resolve_device(device)
    base = rng.base_key(seed, dev)
    keys = rng.replica_key(base, torch.arange(n_replicas, device=dev))
    return random_init_from_key(cfg, keys)


def default_k_align(n_replicas: int) -> int:
    return max(n_replicas // 8, 32)


def lazy_ensemble_step(state: SimState, cfg: SimConfig, k_align: int,
                       device=None) -> tuple[SimState, Observables]:
    """One ensemble step aligning only the ``k_align`` dirtiest replicas."""
    _check_state_device(state, device)
    n_rep = state.step.shape[0]
    k_align = min(k_align, n_rep)

    skey = rng.step_key(state.key, state.step)
    info = cluster_labels(state, cfg)
    _, max_b = cluster_stats(info, cfg)
    max_c = torch.maximum(state.max_complex, max_b)
    s1 = diffuse(state, info, rng.stream_key(skey, rng.STREAM_MOVE), cfg)

    # ---- gather the K dirtiest replicas (rotation tiebreak, no starvation)
    ar = torch.arange(n_rep, dtype=torch.int32, device=state.step.device)
    rot = torch.remainder(ar + state.step[0] * 7919, n_rep)
    prio = torch.where(s1.dirty, 0, n_rep * 2) + rot
    idx = torch.argsort(prio, stable=True)[:k_align]

    # diffusion moves poses only, so the start-of-step clusters still hold
    align = idealize_fused if cfg.fused_align else idealize
    sub = align(take_replicas(s1, idx), take_info(info, idx),
                rng.stream_key(skey[idx], rng.STREAM_ALIGN), cfg)
    fields = {}
    for name in _ALIGNED_FIELDS:
        full = getattr(s1, name).clone()
        full[idx] = getattr(sub, name)
        fields[name] = full
    s2 = s1._replace(**fields)

    s3 = react(s2, skey, cfg)
    s3 = s3._replace(step=state.step + 1, max_complex=max_c)
    return s3, observe(s3, info, cfg)


def make_lazy_ensemble_chunk(cfg: SimConfig, chunk: Optional[int] = None,
                             k_align: Optional[int] = None, device=None
                             ) -> Callable[[SimState],
                                           tuple[SimState, Observables]]:
    """A function advancing a state ``chunk`` lazy steps and returning
    (state, observables of the last step).  k_align defaults to
    max(replicas // 8, 32)."""
    dev = resolve_device(device)
    chunk = chunk or cfg.out_every

    def run(state: SimState):
        k = k_align or default_k_align(state.step.shape[0])
        obs = None
        for _ in range(chunk):
            state, obs = lazy_ensemble_step(state, cfg, k, dev)
        return state, obs

    return run
