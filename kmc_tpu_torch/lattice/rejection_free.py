"""Rejection-free (BKL/Gillespie) event selection for the lattice engine
(port of ``kmc_tpu/lattice/rejection_free.py``).

The fixed-timestep lattice step tests every channel against rate * dt
each step, and almost every draw is a rejection.  This mode builds the
dense per-site rate tensor, selects the ONE firing event by Gumbel-max
(argmax of log-rate + Gumbel noise, the reparameterisation of categorical
sampling) and advances continuous time by Exp(1) / total rate: no step
is wasted, and in sparse or low-rate regimes one event leaps what the
fixed-dt engine spends thousands of steps rejecting.

Rates are in per-step units matched to lattice/step.py's per-direction
probabilities, so both modes share one time axis (``state.time``) and
one equilibrium:

  hop(cell -> empty d-neighbor):   hop_prob / (4k)   [axis 1/2 x sign 1/2]
  merge(cell absorbs d-neighbor):  ass_prob / 8      [direction 1/4 x parity 1/2]
  split(cell ejects monomer to d): diss_prob / 8     [direction 1/4 x parity 1/2]

All randomness is the stateless counter hash (ops/hashing.py) keyed by
the event counter (``state.step`` counts events in this mode, batches in
the batch form), with the JAX package's salts, so both packages draw the
same uniforms.  Scores, selections and updates stay on the device: an
event or a batch issues its kernels without reading anything back, and
only ``run_until`` reads the time, once a chunk.

Against the JAX package: the selections and updates are the same
functions of the scores, bit for bit (``_select``, ``_apply``; ``top_k``'s
order is rebuilt from a stable sort).  The scores are not: float32
``log`` differs by an ulp between XLA's CPU backend, torch on the CPU and
the card for some arguments, so two trajectories can part where the two
best scores lie within an ulp or two of each other, and the time, a
float32 sum of the rates, agrees to a few ulps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kmc_tpu_torch.config import LatticeConfig
from kmc_tpu_torch.lattice.grid import MAX_SPECIES, LatticeState
from kmc_tpu_torch.ops.hashing import cell_uniform, scalar_uniforms

# direction -> (dy, dx), as lattice/step.py's _DIRS
_DIR_TUPLES = ((0, 1), (1, 0), (0, -1), (-1, 0))

# Stream salts live in the same seed*16+stream space as lattice/step.py's
# 0..4; Gumbel channels take 8..15 and the waiting-time draw takes 5, so
# consecutive replica seeds (seed*16 apart) can never alias a neighbor's
# stream (all salts are distinct mod 16).
SALT_RF_GUMBEL = 8    # per-(cell, channel) Gumbel draws: 8..15
SALT_RF_TIME = 5      # per-event exponential waiting-time draw

_TINY = 1e-12         # float32(1e-12) where it meets a float32 tensor

@functools.cache
def _dirs(device) -> torch.Tensor:
    """The four directions as an int64 [4, 2] device constant, built once
    per device."""
    return torch.tensor(_DIR_TUPLES, dtype=torch.int64, device=device)


def event_rates(grid: torch.Tensor, cfg: LatticeConfig) -> torch.Tensor:
    """Dense per-site rate tensor f32[8, H, W]: channels 0..3 = move/merge
    toward _DIRS[c], channels 4..7 = monomer ejection toward _DIRS[c-4].
    A move channel's rate is hop_prob/(4k) when the neighbor is empty and
    ass_prob/8 when occupied and the merged size fits (else 0)."""
    k = grid
    occ = k > 0
    # float32 constants as the JAX package forms them; a Python float
    # meets a float32 tensor in float32.  The division is a tensor's:
    # ``float / tensor`` is a product with the reciprocal in torch, an ulp
    # off the quotient for some k
    f32 = np.float32
    kf = torch.clamp(k, min=1).to(torch.float32)
    hop = torch.full_like(kf, float(f32(0.25) * f32(cfg.hop_prob))) / kf
    mrg = float(f32(cfg.ass_prob / 8.0))
    spl = float(f32(cfg.diss_prob / 8.0))

    # neighbor toward direction c: nb[i, j] = k[i + dy, j + dx] (periodic)
    nbs = [torch.roll(k, shifts=(-dy, -dx), dims=(0, 1))
           for dy, dx in _DIR_TUPLES]
    nb = torch.stack(nbs)                                   # [4, H, W]
    can_hop = occ & (nb == 0)
    can_mrg = occ & (nb > 0) & (k + nb <= MAX_SPECIES)
    move = torch.where(can_hop, hop, torch.where(can_mrg, mrg, 0.0))
    split = torch.where((k >= 2) & (nb == 0), spl, 0.0)
    return torch.cat([move, split])


def _gumbel_field(shape, step, salt):
    """Gumbel(0, 1) noise -log(-log(u)) of the cell hash over an (h, w)
    grid; ``salt`` may be a tensor broadcasting against it ([C, 1, 1]
    draws C channels, the same bits as C calls)."""
    u = cell_uniform(shape, step, salt)
    return -torch.log(-torch.log(torch.clamp(u, min=_TINY)))


def _scores(state: LatticeState, rates: torch.Tensor) -> torch.Tensor:
    """Gumbel-max scores f32[8, H, W]: log-rate plus the channel's Gumbel
    noise, -inf where the rate is zero."""
    h, w = state.grid.shape
    chans = torch.arange(8, dtype=torch.int64, device=rates.device)
    salt = (state.seed.to(torch.int64) * 16 + SALT_RF_GUMBEL
            + chans[:, None, None])
    scores = (torch.log(torch.clamp(rates, min=_TINY))
              + _gumbel_field((h, w), state.step, salt))
    return torch.where(rates > 0, scores, float("-inf"))


def _top_k(scores: torch.Tensor, k_events: int):
    """(values, flat indices) of the ``k_events`` largest scores in
    ``jax.lax.top_k``'s order: descending, equal scores by ascending flat
    index (a stable sort keeps equal keys in index order)."""
    vals, idx = torch.sort(scores.reshape(-1), descending=True, stable=True)
    return vals[:k_events], idx[:k_events]


def _select(scores: torch.Tensor, k_events: int | None = None,
            exclusion: int = 3, thinning: str = "parallel"):
    """The events to apply: (flat [K] int64 indices into [8, H, W], keep
    [K] bool).

    ``k_events=None`` is the serial rule: the one Gumbel-max winner (the
    first maximum, as ``jnp.argmax``), kept iff some rate is nonzero.
    Otherwise the batch rule of ``rf_batch_step``: the top ``k_events``
    scores, thinned so that both cells of every kept event lie at
    Chebyshev distance >= ``exclusion`` (periodic) from every higher-scored
    kept candidate's cells."""
    _, h, w = scores.shape
    flat_scores = scores.reshape(-1)
    if k_events is None:
        flat = torch.argmax(flat_scores).reshape(1)
        return flat, torch.isfinite(flat_scores[flat])
    if thinning not in ("parallel", "greedy"):
        raise ValueError(f"thinning must be 'parallel' or 'greedy', got "
                         f"{thinning!r}")
    top, flat = _top_k(scores, k_events)
    live = torch.isfinite(top)                              # real candidates
    c, y, x, ty, tx = _cells(flat, h, w)

    def chebdist(ay, ax, by, bx):
        dy = (ay[:, None] - by[None, :]).abs()
        dx = (ax[:, None] - bx[None, :]).abs()
        dy = torch.minimum(dy, h - dy)
        dx = torch.minimum(dx, w - dx)
        return torch.maximum(dy, dx)

    dmin = torch.minimum(
        torch.minimum(chebdist(y, x, y, x), chebdist(y, x, ty, tx)),
        torch.minimum(chebdist(ty, tx, y, x), chebdist(ty, tx, ty, tx)))
    conflict = dmin < exclusion                             # [K, K]
    ii = torch.arange(k_events, device=scores.device)
    earlier = ii[None, :] < ii[:, None]                     # j < i
    if thinning == "parallel":
        # one-shot rule: drop i iff ANY higher-scored live candidate
        # conflicts (the order is by score, so j < i scores higher)
        blocked = (conflict & live[None, :] & earlier).any(dim=1)
        return flat, live & ~blocked
    # greedy independent set in score order: keep i iff it conflicts with
    # no KEPT j < i
    keep = torch.zeros_like(live)
    hit = conflict & earlier
    for i in range(k_events):
        keep[i] = live[i] & ~(hit[i] & keep).any()
    return flat, keep


def _cells(flat: torch.Tensor, h: int, w: int):
    """(channel, y, x, target y, target x) of flat indices into [8, H, W]."""
    c = flat // (h * w)
    y = (flat % (h * w)) // w
    x = flat % w
    d = _dirs(flat.device)[c % 4]                           # [K, 2]
    return c, y, x, torch.remainder(y + d[:, 0], h), torch.remainder(
        x + d[:, 1], w)


def _apply(state: LatticeState, flat: torch.Tensor, keep: torch.Tensor,
           total: torch.Tensor) -> LatticeState:
    """Apply the kept events ``flat`` ([K] flat indices into [8, H, W]) to
    ``state``; time += the sum of the kept events' Exp(1) draws over the
    frozen ``total`` rate; step += 1.

    Source cell: a hop empties it, a merge absorbs the neighbor INTO it
    (the fixed-dt step's source-keeps convention), a split loses 1; the
    target takes the hopping particle (its displacement rides along),
    is emptied (the absorbed history is dropped) or receives the ejected
    monomer (which inherits the parent's displacement).  Kept events touch
    disjoint cells, so the updates are commutative adds of deltas; events
    not kept add zeros."""
    h, w = state.grid.shape
    c, y, x, ty, tx = _cells(flat, h, w)
    grid, disp = state.grid, state.disp
    k1 = grid[y, x]
    k2 = grid[ty, tx]
    is_split = c >= 4
    is_merge = ~is_split & (k2 > 0)
    src_val = torch.where(is_split, k1 - 1, torch.where(is_merge, k1 + k2, 0))
    tgt_val = torch.where(is_split, 1, torch.where(is_merge, 0, k1))
    ki = keep.to(grid.dtype)
    grid = grid.clone()
    grid.index_put_((y, x), (src_val - k1) * ki, accumulate=True)
    grid.index_put_((ty, tx), (tgt_val - k2) * ki, accumulate=True)

    d = _dirs(flat.device)[c % 4].to(disp.dtype)            # [K, 2]
    sdisp = disp[y, x]                                      # [K, 2]
    tdisp = disp[ty, tx]
    new_sdisp = torch.where((is_split | is_merge)[:, None], sdisp, 0)
    new_tdisp = torch.where(is_split[:, None], sdisp,
                            torch.where(is_merge[:, None], 0, sdisp + d))
    kd = keep[:, None].to(disp.dtype)
    disp = disp.clone()
    disp.index_put_((y, x), (new_sdisp - sdisp) * kd, accumulate=True)
    disp.index_put_((ty, tx), (new_tdisp - tdisp) * kd, accumulate=True)

    # waiting time: the kept events' Exp(1) draws over the frozen total
    salt = state.seed.to(torch.int64) * 16 + SALT_RF_TIME
    u_t = scalar_uniforms(flat.shape[0], state.step, salt)
    exp1 = -torch.log(torch.clamp(u_t, min=_TINY))
    dt = torch.where(keep, exp1, 0.0).sum() / torch.clamp(total, min=_TINY)
    dt = torch.where(keep.any(), dt, 0.0)
    return state._replace(grid=grid, disp=disp, step=state.step + 1,
                          time=state.time + dt)


def rf_step(state: LatticeState, cfg: LatticeConfig) -> LatticeState:
    """Apply ONE event: the Gumbel-max winner over the full rate tensor,
    then its move/merge/split, then time += Exp(1)/total_rate.  A state
    with zero total rate (fully jammed) is returned with only the step
    advanced."""
    rates = event_rates(state.grid, cfg)                    # [8, H, W]
    flat, keep = _select(_scores(state, rates))
    return _apply(state, flat, keep, rates.sum())


def make_rf_step(cfg: LatticeConfig):
    return lambda state: rf_step(state, cfg)


def rf_batch_step(state: LatticeState, cfg: LatticeConfig,
                  k_events: int = 64, exclusion: int = 3,
                  thinning: str = "parallel") -> LatticeState:
    """Apply up to ``k_events`` spatially separated events in ONE pass --
    the throughput form of rejection-free selection (the serial rf_step
    does O(HW) work per single event).

    Selection: the top-K Gumbel-max winners over the frozen rate tensor,
    then a thinning that keeps an event only if both its cells are at
    Chebyshev distance >= ``exclusion`` (periodic) from every
    higher-scored kept candidate's cells.  Rates depend on
    4-neighbourhoods, so with exclusion >= 3 the kept events commute and
    each was selected from a rate field unperturbed by the others; the
    approximation against serial BKL is temporal (all waiting times are
    drawn against the same frozen total rate).

    ``thinning``: "greedy" keeps i iff it conflicts with no KEPT j < i (a
    ``k_events``-iteration loop of tiny ops); "parallel" keeps i iff it
    conflicts with no live CANDIDATE j < i (one vectorised mask; a subset
    of greedy's events).  ``state.step`` counts batches here."""
    rates = event_rates(state.grid, cfg)
    flat, keep = _select(_scores(state, rates), k_events, exclusion,
                         thinning)
    return _apply(state, flat, keep, rates.sum())


def make_rf_batch_chunk(cfg: LatticeConfig, n_batches: int,
                        k_events: int = 64, exclusion: int = 3,
                        thinning: str = "parallel"):
    """``n_batches``-batch advance; returns (state, dts) where ``dts[i]``
    is batch i's waiting time (zero iff that batch applied no events).

    Time accumulates from ZERO within the chunk and is added to the start
    time once, so a long-run float32 time axis does not stall once a
    batch dt drops below ulp(time)."""

    def f(state: LatticeState):
        t0 = state.time
        st = state._replace(time=torch.zeros_like(state.time))
        dts = []
        for _ in range(n_batches):
            st2 = rf_batch_step(st, cfg, k_events, exclusion, thinning)
            dts.append(st2.time - st.time)
            st = st2
        return st._replace(time=t0 + st.time), torch.stack(dts)

    return f


def _make_rf_chunk_dt(cfg: LatticeConfig, n_events: int):
    """``n_events``-event advance returning (state, chunk_dt).

    Per-event dts accumulate from ZERO within the chunk and are added to
    the start time once (compensated summation), so a long-run float32
    time accumulator does not stall when a single dt drops below
    ulp(time)."""

    def f(state: LatticeState):
        t0 = state.time
        st = state._replace(time=torch.zeros_like(state.time))
        for _ in range(n_events):
            st = rf_step(st, cfg)
        return st._replace(time=t0 + st.time), st.time

    return f


def make_rf_chunk(cfg: LatticeConfig, n_events: int):
    """``n_events``-event advance."""
    f = _make_rf_chunk_dt(cfg, n_events)
    return lambda state: f(state)[0]


def run_until(state: LatticeState, cfg: LatticeConfig, t_end: float,
              chunk: int = 256) -> LatticeState:
    """Advance events until state.time >= t_end (a host loop over chunks;
    the final chunk may overshoot by O(chunk/total_rate)).

    Jamming is detected from the chunk's accumulated waiting time: rf_step
    adds dt > 0 for every applied event and exactly 0 when the total rate
    is zero, so chunk_dt == 0 iff NO event fired in the whole chunk."""
    f = _make_rf_chunk_dt(cfg, chunk)
    while float(state.time) < t_end:
        state, dt = f(state)
        if float(dt) == 0.0:                              # zero events: jammed
            break
    return state
