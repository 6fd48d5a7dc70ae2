"""Cold-start random placement (port of ``kmc_tpu/engine/init.py``).

Molecules are inserted in the reference's sequential order
(main.cpp:281-351 receptors, 354-447 ligands), each insertion drawing
``K_CANDIDATES`` positions at once and keeping the first that overlaps
nothing placed before it.  The loop over insertions is a Python loop; each
insertion is batched over [R, K_CANDIDATES].  Keys and draws equal the JAX
package's, so the same seed places the same molecules.
"""

from __future__ import annotations

import math

import torch

from kmc_tpu_torch import rng
from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.geometry import quat_from_euler
from kmc_tpu_torch.state import SimState, empty_state

K_CANDIDATES = 64


def _insert_loop(key, n_insert, propose, accept):
    """Sequential inserter: propose(subkey) -> [R, K, d] candidates,
    accept(cand, placed [R, i, d]) -> bool[R, K].  Returns [R, n_insert, d]."""
    placed = []
    for i in range(n_insert):
        key, sub = rng.split(key).unbind(-2)
        cand = propose(sub)
        prior = (torch.stack(placed, dim=1) if placed
                 else cand[:, :0])                     # [R, i, d]
        ok = accept(cand, prior)
        first = ok.to(torch.uint8).argmax(dim=1)       # first valid candidate
        placed.append(cand[torch.arange(cand.shape[0]), first])
    return torch.stack(placed, dim=1)


def _sq_dist(x, y):
    """x [R, K, d], y [R, m, d] -> squared distances [R, K, m]."""
    diff = x[:, :, None, :] - y[:, None, :, :]
    return (diff * diff).sum(-1)


def random_init_from_key(cfg: SimConfig, base: torch.Tensor) -> SimState:
    """Cold start of every replica from its base key (i64[R, 2])."""
    dev = base.device
    f32 = torch.float32
    key = rng.stream_key(rng.step_key(base, 0), rng.STREAM_INIT)
    ka, kb, kra, krb = rng.split(key, 4).unbind(-2)

    lx, ly, lz = cfg.cell_range_x, cfg.cell_range_y, cfg.cell_range_z
    ra, rb = cfg.rb_a_radius, cfg.rb_b_radius

    # ---- receptors: xy plane, pairwise center distance > 2*R_A ----
    scale_a = torch.tensor([lx, ly], dtype=f32, device=dev)
    off_a = torch.tensor([lx / 2, ly / 2], dtype=f32, device=dev)

    def propose_a(k):
        return rng.uniform(k, (K_CANDIDATES, 2)) * scale_a - off_a

    def accept_a(cand, placed):
        return ~(_sq_dist(cand, placed) <= (2 * ra) ** 2).any(dim=2)

    a_centers = _insert_loop(ka, cfg.n_a, propose_a, accept_a)

    # ---- ligands: 3D box, clear of all A beads (3D distance,
    #      main.cpp:362-372) and of earlier B centers (main.cpp:375-383) ----
    bead_z = 2.0 * ra * torch.arange(4, dtype=f32, device=dev)
    r = base.shape[0]
    a_beads = torch.cat(
        [a_centers[:, :, None, :].expand(r, cfg.n_a, 4, 2),
         bead_z[None, None, :, None].expand(r, cfg.n_a, 4, 1)],
        dim=-1).reshape(r, cfg.n_a * 4, 3)
    cut_ab = ra + cfg.trimer_arm + rb                       # main.cpp:368
    cut_bb = 2.0 * cfg.trimer_arm + 2.0 * rb                # main.cpp:380
    scale_b = torch.tensor([lx, ly, lz], dtype=f32, device=dev)
    off_b = torch.tensor([lx / 2, ly / 2, 0.0], dtype=f32, device=dev)

    def propose_b(k):
        return rng.uniform(k, (K_CANDIDATES, 3)) * scale_b - off_b

    def accept_b(cand, placed):
        bad_a = (_sq_dist(cand, a_beads) <= cut_ab ** 2).any(dim=2)
        bad_b = (_sq_dist(cand, placed) <= cut_bb ** 2).any(dim=2)
        return ~(bad_a | bad_b)

    b_centers = _insert_loop(kb, cfg.n_b, propose_b, accept_b)

    # ---- random orientations (main.cpp:328-330, 421-424) ----
    psai_a = (2.0 * rng.uniform(kra, (cfg.n_a,)) - 1.0) * math.pi
    eul_b = (2.0 * rng.uniform(krb, (3, cfg.n_b)) - 1.0) * math.pi
    st = empty_state(cfg, base)
    return st._replace(
        a_xy=a_centers, a_psi=psai_a, b_center=b_centers,
        b_quat=quat_from_euler(eul_b[:, 0], eul_b[:, 1], eul_b[:, 2]))
