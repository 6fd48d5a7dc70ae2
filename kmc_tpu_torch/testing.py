"""Inputs for checking the port's kernels against their plain versions:
replica states with random bonded topologies, made from a seed, and the
inputs of K1 and K2 formed from them exactly as the main paths form
them; and the ulp-tie rule under which two rejection-free trajectories
may part."""

from __future__ import annotations

import numpy as np
import torch

from kmc_tpu_torch import rng
from kmc_tpu_torch.config import LatticeConfig, SimConfig
from kmc_tpu_torch.engine.align import _choose_roots
from kmc_tpu_torch.engine.clusters import cluster_labels
from kmc_tpu_torch.lattice.grid import LatticeState
from kmc_tpu_torch.lattice.rejection_free import _scores, event_rates
from kmc_tpu_torch.models.tnfr import ligand_template
from kmc_tpu_torch.parallel.ensemble import init_ensemble
from kmc_tpu_torch.state import SimState


def bonded_state(cfg: SimConfig, n_rep: int, seed: int, device) -> SimState:
    """Cold-start poses with a random mutual topology: each ligand binds up
    to three receptors (while free receptors last) and random receptor
    pairs are cis-bonded, so complexes span several ligands and some chains
    run deeper than align_depth.  Half the ligands are marked laid."""
    st = init_ensemble(cfg, n_rep, seed=seed, device=device)
    g = np.random.default_rng(seed)
    na, nb = cfg.n_a, cfg.n_b
    a_trans = np.full((n_rep, na), -1, np.int32)
    a_site = np.full((n_rep, na), -1, np.int32)
    a_cis = np.full((n_rep, na), -1, np.int32)
    b_partner = np.full((n_rep, nb, 3), -1, np.int32)
    for r in range(n_rep):
        free = list(g.permutation(na))
        for b in range(nb):
            for s in range(int(g.integers(0, 4))):
                if not free:
                    break
                a = free.pop()
                a_trans[r, a], a_site[r, a] = na + b, s + 1
                b_partner[r, b, s] = a
        pairs = g.permutation(na)[: 2 * int(g.integers(1, na // 2 + 1))]
        for a1, a2 in pairs.reshape(-1, 2):
            a_cis[r, a1], a_cis[r, a2] = a2, a1

    def dev(x):
        return torch.from_numpy(x).to(device)

    return st._replace(a_trans=dev(a_trans), a_site=dev(a_site),
                       a_cis=dev(a_cis), b_partner=dev(b_partner),
                       b_laid=dev(g.random((n_rep, nb)) < 0.5))


def align_core_inputs(st: SimState, cfg: SimConfig) -> list[torch.Tensor]:
    """K1's eleven inputs for every replica of ``st``: roots from the align
    stream of each replica's current step, act = cluster size > 1
    (engine/align.idealize_fused, ops/align_batched.align_core)."""
    i32 = torch.int32
    info = cluster_labels(st, cfg)
    skey = rng.stream_key(rng.step_key(st.key, st.step), rng.STREAM_ALIGN)
    root = _choose_roots(st, info, skey, cfg)
    a_dir = torch.stack([torch.cos(st.a_psi), torch.sin(st.a_psi)], -1)
    return [st.a_xy.contiguous(), a_dir, st.b_center.contiguous(),
            st.b_quat.contiguous(), st.a_trans.contiguous(),
            st.a_site.contiguous(), st.a_cis.contiguous(),
            st.b_partner.contiguous(), st.b_laid.to(i32),
            root.to(i32), (info.size > 1).to(i32)]


def align_core_single_inputs(st: SimState,
                             cfg: SimConfig) -> list[torch.Tensor]:
    """K2's twelve inputs for the one replica of ``st``: K1's inputs as
    [n, 1] columns and the ligand template (ops/align.align_core)."""
    if st.step.shape[0] != 1:
        raise ValueError(f"K2 takes one replica, got {st.step.shape[0]}")
    (a_xy, a_dir, b_center, b_quat, a_trans, a_site, a_cis, b_partner,
     b_laid, root, act) = (x[0] for x in align_core_inputs(st, cfg))
    a_trans, a_site, a_cis, b_laid, root, act = (
        x[:, None].contiguous() for x in (a_trans, a_site, a_cis, b_laid,
                                          root, act))
    return [a_xy.contiguous(), a_dir.contiguous(), b_center.contiguous(),
            b_quat.contiguous(), a_trans, a_site, a_cis,
            b_partner.contiguous(), b_laid, root, act,
            ligand_template(cfg, st.a_xy.device).contiguous()]


def rf_tie(state: LatticeState, cfg: LatticeConfig,
           k_events: int | None = None, ulps: int = 2) -> bool:
    """Whether the rejection-free selection from ``state`` sits on an ulp
    tie: two scores adjacent in the descending order of the best
    ``k_events`` + 1 (the best two for the serial step) lie within
    ``ulps`` ulps of each other.  float32 ``log`` differs by an ulp
    between libraries, so two correct trajectories may part only from
    such a state."""
    scores = _scores(state, event_rates(state.grid, cfg)).reshape(-1)
    top = torch.sort(scores, descending=True).values[:(k_events or 1) + 1]
    top = top[torch.isfinite(top)]
    a = top[:-1].abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    gap = top[:-1].double() - top[1:].double()
    return bool((gap <= ulps * ulp.double()).any())


def rf_against_cpu(step, state: LatticeState, cfg: LatticeConfig, n: int,
                   k_events: int | None = None, time_rtol: float = 1e-5):
    """Advance ``state`` (on the card) and a CPU copy ``n`` times with
    ``step`` (``rf_step`` or a batch step), comparing after every call:
    grid, disp and step equal, time within ``time_rtol`` relative.

    Returns (calls compared, the call at which the two parted on an ulp
    tie or None, the worst relative time difference).  At a parting both
    sides' scores are recomputed from the common state; it is admitted
    only at an ulp tie of the CPU's (``rf_tie``), and the comparison stops
    there.  Any other difference raises AssertionError."""
    from kmc_tpu_torch import convert

    cpu = convert.lattice_from_numpy(convert.lattice_to_numpy(state))
    worst = 0.0
    for i in range(n):
        common, common_dev = cpu, state
        state, cpu = step(state), step(cpu)
        if not all(torch.equal(getattr(state, f).cpu(), getattr(cpu, f))
                   for f in ("grid", "disp", "step")):
            ties = (rf_tie(common, cfg, k_events),
                    rf_tie(common_dev, cfg, k_events))
            if ties[0]:
                return i, i, worst
            raise AssertionError(f"rejection-free call {i}: the card and "
                                 "the CPU parted without an ulp tie (tie "
                                 f"in the CPU's, the card's scores: {ties})")
        t_dev, t_cpu = float(state.time), float(cpu.time)
        rel = abs(t_dev - t_cpu) / max(abs(t_cpu), 1e-30)
        worst = max(worst, rel)
        if rel > time_rtol:
            raise AssertionError(f"rejection-free call {i}: time {t_dev} "
                                 f"on the card, {t_cpu} on the CPU")
    return n, None, worst
