"""Replica ensembles: the eager ensemble step and the lazy (event-driven)
ensemble step (port of ``kmc_tpu/parallel/ensemble.py``).

Every stage runs on all replicas at once through the explicit leading
replica axis.  The eager step is ``engine/step.step_fn`` on all replicas,
with the idealize core as K1 at B = R.  The lazy step runs the idealize
stage only on the ``k_align`` dirtiest replicas: idealize is a geometric
no-op on a clean replica, and a replica is dirty only in the step after a
topology change or an align revert.  Overflow replicas (more than k
dirty) are aligned on later steps, rotation-prioritised so none starves.

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
from kmc_tpu_torch.engine.observables import (Observables, cluster_histogram,
                                              cluster_stats, observe,
                                              seeded_receptor_histogram)
from kmc_tpu_torch.engine.reactions import react
from kmc_tpu_torch.engine.step import step_fn
from kmc_tpu_torch.state import (SimState, check_state_device,
                                  resolve_device, take_replicas)

_ALIGNED_FIELDS = ("a_xy", "a_psi", "b_center", "b_quat", "b_laid", "dirty")


def init_ensemble(cfg: SimConfig, n_replicas: int, seed: int = 0,
                  device=None) -> SimState:
    """Batched cold start: replica r starts from fold_in(key(seed), r), the
    JAX package's placement for the same seed."""
    return init_replicas(cfg, range(n_replicas), seed, device)


def init_replicas(cfg: SimConfig, replicas: range, seed: int = 0,
                  device=None) -> SimState:
    """The replicas ``replicas`` of init_ensemble(cfg, n, seed), built
    directly: each replica's start depends only on its own key, so a
    rank builds its block without the others."""
    dev = resolve_device(device)
    base = rng.base_key(seed, dev)
    keys = rng.replica_key(base, torch.arange(replicas.start, replicas.stop,
                                              device=dev))
    return random_init_from_key(cfg, keys)


def broadcast_ensemble(state: SimState, n_replicas: int,
                       seed: int = 0) -> SimState:
    """A single-trajectory state -> an ensemble of ``n_replicas`` copies of
    that configuration with independent Threefry streams, replica r keyed
    fold_in(key(seed), r): the anchor-continuation start (a reference
    checkpoint continued as an ensemble)."""
    if state.step.shape[0] != 1:
        raise ValueError("broadcast_ensemble takes a single trajectory, got "
                         f"{state.step.shape[0]} replicas")
    dev = state.step.device
    keys = rng.replica_key(rng.base_key(seed, dev),
                           torch.arange(n_replicas, device=dev))
    bat = SimState(*(x.expand(n_replicas, *x.shape[1:]).clone()
                     for x in state))
    return bat._replace(key=keys)


def make_ensemble_step(cfg: SimConfig, device=None
                       ) -> Callable[[SimState], tuple[SimState, Observables]]:
    """The eager ensemble step: state -> (state, per-replica observables)."""
    dev = resolve_device(device)
    return lambda state: step_fn(state, cfg, dev, batched=True)


def make_ensemble_chunk(cfg: SimConfig, chunk: Optional[int] = None,
                        device=None):
    """``chunk`` eager ensemble steps (default cfg.out_every) returning the
    final step's observables."""
    dev = resolve_device(device)
    chunk = chunk or cfg.out_every

    def run(state: SimState):
        obs = None
        for _ in range(chunk):
            state, obs = step_fn(state, cfg, dev, batched=True)
        return state, obs

    return run


def _final_hists(state: SimState, cfg: SimConfig):
    info = cluster_labels(state, cfg)
    return (cluster_histogram(info, cfg),
            seeded_receptor_histogram(info, cfg))


def make_ensemble_chunk_hist(cfg: SimConfig, chunk: Optional[int] = None,
                             device=None):
    """The eager chunk returning (state, (obs, hist, ahist)): ``hist`` the
    per-replica ligand-seeded cluster-size histogram and ``ahist`` the
    receptors-per-seeded-cluster histogram at the final step, the form of
    the reference's cluster.log frames (main.cpp:2291-2305) that the
    statistical validator compares."""
    run = make_ensemble_chunk(cfg, chunk, device)

    def f(state: SimState):
        state, obs = run(state)
        return state, (obs, *_final_hists(state, cfg))

    return f


def merge_observables(obs: Observables) -> Observables:
    """Ensemble mean of each observable, float32."""
    return Observables(*(x.to(torch.float32).mean(dim=0) for x in obs))


def default_k_align(n_replicas: int) -> int:
    return max(n_replicas // 8, 32)


def lazy_ensemble_step(state: SimState, cfg: SimConfig, k_align: int,
                       device=None) -> tuple[SimState, Observables]:
    """One ensemble step aligning only the ``k_align`` dirtiest replicas."""
    check_state_device(state, device)
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


def make_lazy_ensemble_chunk_hist(cfg: SimConfig, chunk: Optional[int] = None,
                                  k_align: Optional[int] = None, device=None):
    """The lazy chunk returning (state, (obs, hist, ahist)) as
    ``make_ensemble_chunk_hist`` does."""
    run = make_lazy_ensemble_chunk(cfg, chunk, k_align, device)

    def f(state: SimState):
        state, obs = run(state)
        return state, (obs, *_final_hists(state, cfg))

    return f
