"""Step driver (port of ``kmc_tpu/engine/step.py``).

One MC timestep, mirroring the reference loop (main.cpp:461-2308):

  cluster detection -> diffusion sweep -> geometry idealization ->
  reaction sweep -> commit -> observables

``step_fn`` advances a single trajectory (a state of one replica) and runs
the fused idealize core as K2 (ops/align.py); the ensemble paths
(parallel/ensemble.py) call it with ``batched=True`` and run K1 on all
replicas.  ``run`` advances ``out_every`` steps between calls of its
output hook, the analogue of the reference's every-5000-steps I/O
(main.cpp:2206).

``rp`` (engine/params.py ``RuntimeParams``) replaces the config's
diffusion constants and reaction probabilities, with a value per replica
in a parameter sweep (``sweep``): one batched step runs different physics
in each replica.  ``step_fn_diag`` also returns the per-replica reaction
flux counts (``react(diag=True)``) and the diffusion's residual overlap.

The entry points run on the card unless the caller passes
``device="cpu"``; without a card they raise rather than run on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from kmc_tpu_torch import rng
from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.engine.align import idealize, idealize_fused
from kmc_tpu_torch.engine.clusters import cluster_labels
from kmc_tpu_torch.engine.diffusion import diffuse
from kmc_tpu_torch.engine.observables import (Observables, cluster_stats,
                                              observe)
from kmc_tpu_torch.engine.params import RuntimeParams
from kmc_tpu_torch.engine.reactions import react
from kmc_tpu_torch.state import SimState, check_state_device, resolve_device


def _step(state: SimState, cfg: SimConfig, device, batched: bool,
          rp: Optional[RuntimeParams], diag: bool):
    check_state_device(state, device)
    if not batched and state.step.shape[0] != 1:
        raise ValueError("step_fn advances one trajectory; got "
                         f"{state.step.shape[0]} replicas (pass "
                         "batched=True for an ensemble)")
    skey = rng.step_key(state.key, state.step)
    info = cluster_labels(state, cfg)
    _, max_b = cluster_stats(info, cfg)
    max_c = torch.maximum(state.max_complex, max_b)

    st = diffuse(state, info, rng.stream_key(skey, rng.STREAM_MOVE), cfg,
                 rp, diag=diag)
    if diag:
        st, residual = st
    akey = rng.stream_key(skey, rng.STREAM_ALIGN)
    if cfg.fused_align:
        st = idealize_fused(st, info, akey, cfg, batched=batched)
    else:
        st = idealize(st, info, akey, cfg)
    st = react(st, skey, cfg, rp, diag=diag)
    if diag:
        st, dg = st
        dg["residual_overlap"] = residual.to(torch.int32)
    st = st._replace(step=state.step + 1, max_complex=max_c)
    if diag:
        return st, observe(st, info, cfg), dg
    return st, observe(st, info, cfg)


def step_fn(state: SimState, cfg: SimConfig, device=None,
            batched: bool = False, rp: Optional[RuntimeParams] = None
            ) -> tuple[SimState, Observables]:
    """One MC timestep: SimState -> (SimState, Observables).

    ``batched=False`` (the single trajectory) takes a state of one replica
    and runs the idealize core as K2; ``batched=True`` takes any number of
    replicas and runs K1 on all of them.  ``cfg.fused_align=False`` runs
    the unfused idealize instead of either kernel.  ``rp`` overrides the
    physics parameters: leaves 0-d, or [R] for a sweep over replicas."""
    return _step(state, cfg, device, batched, rp, diag=False)


def step_fn_diag(state: SimState, cfg: SimConfig, device=None,
                 batched: bool = False,
                 rp: Optional[RuntimeParams] = None):
    """``step_fn`` returning (state, obs, diag) with per-channel reaction
    flux diagnostics: eligible candidates and accepted events per channel
    (``react(diag=True)``) and ``residual_overlap`` (``diffuse(diag=
    True)``), each int32 [R].  The JAX package's scripts/chan_flux.py uses
    them to bisect kinetics deviations channel by channel."""
    return _step(state, cfg, device, batched, rp, diag=True)


def make_step_fn(cfg: SimConfig, device=None) -> Callable:
    """Single-step function ``f(state, rp=None)`` of a trajectory for the
    given config."""
    dev = resolve_device(device)
    return lambda state, rp=None: step_fn(state, cfg, dev, rp=rp)


def make_chunk_fn(cfg: SimConfig, chunk: Optional[int] = None, device=None):
    """``chunk``-step advance (default cfg.out_every) returning the final
    step's observables."""
    dev = resolve_device(device)
    chunk = chunk or cfg.out_every

    def chunk_fn(state: SimState):
        obs = None
        for _ in range(chunk):
            state, obs = step_fn(state, cfg, dev)
        return state, obs

    return chunk_fn


def _zero_obs(state: SimState) -> Observables:
    zf = torch.zeros_like(state.step, dtype=torch.float32)
    zi = torch.zeros_like(state.step)
    return Observables(zf, zi, zi, zi, zi, zf, zi)


def make_masked_chunk_fn(cfg: SimConfig, device=None):
    """The run's tail: ``f(state, todo)`` executes only the first ``todo``
    of ``out_every`` steps and returns the observables of step
    ``todo - 1`` (zeros when ``todo`` is 0), as the JAX package's
    fixed-shape masked chunk does."""
    dev = resolve_device(device)

    def f(state: SimState, todo: int):
        obs = _zero_obs(state)
        for _ in range(min(int(todo), cfg.out_every)):
            state, obs = step_fn(state, cfg, dev)
        return state, obs

    return f


def run(state: SimState, cfg: SimConfig, n_steps: Optional[int] = None,
        on_output: Optional[Callable[[SimState, Observables], None]] = None,
        device=None) -> SimState:
    """Advance ``n_steps`` (default cfg.simu_step), invoking ``on_output``
    with (state, observables) every ``cfg.out_every`` steps and after a
    shorter tail -- the hook the I/O layer (io/writers.py) plugs into."""
    n_steps = n_steps if n_steps is not None else cfg.simu_step
    chunk_fn = make_chunk_fn(cfg, device=device)
    masked_fn = make_masked_chunk_fn(cfg, device=device)

    done = 0
    while done < n_steps:
        todo = min(cfg.out_every, n_steps - done)
        if todo == cfg.out_every:
            state, obs = chunk_fn(state)
        else:
            state, obs = masked_fn(state, todo)
        done += todo
        if on_output is not None:
            on_output(state, obs)
    return state
