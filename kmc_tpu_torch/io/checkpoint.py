"""Checkpoint / resume (port of ``kmc_tpu/io/checkpoint.py``).

Two formats:

* **native** -- an atomic .npz of every state field, the RNG key as
  ``key_data`` uint32[..., 2] (``jax.random.key_data``'s layout), written
  to a temporary file and renamed.  The layout is the JAX package's, so
  each package reads the other's checkpoints.  A single trajectory is
  stored without the replica axis (as the JAX package stores it), an
  ensemble with it.  Bitwise-exact resume.
* **reference text** (``position.cpt``) -- the fixed-point layout of
  main.cpp:2206-2244 / reader :226-270.  %.3f coordinates make this resume
  inexact by <= 5e-4 A, the reference's own bound.  Reading rebuilds poses
  from coordinates: receptor azimuth from its +x site, ligand quaternion
  refit from its bead axes.

Coordinates for the text formats come from ``host_positions``: the state's
poses on the host in float32, with the C library's ``cosf``/``sinf`` --
the functions XLA's CPU backend calls for float32 cos/sin -- so one state
gives the same files in both packages.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import os
import tempfile

import numpy as np
import torch

from kmc_tpu_torch import convert, rng
from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.engine.observables import bond_counters
from kmc_tpu_torch.models.tnfr import ligand_template_np
from kmc_tpu_torch.state import (SimState, a_positions, b_positions,
                                 empty_state, resolve_device)


# ---------------------------------------------------------------------------
# host-side coordinates of one replica

@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for fn in (lib.cosf, lib.sinf):
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float]
    return lib


def host_positions(state: SimState, cfg: SimConfig) -> np.ndarray:
    """Coordinates of replica 0 of ``state``, f32[n, 4, 4, 3] on the host
    (A block then B block), for the output files."""
    m = _libm()
    psi = state.a_psi[0].detach().cpu()
    cos = torch.tensor([m.cosf(v) for v in psi.tolist()], dtype=torch.float32)
    sin = torch.tensor([m.sinf(v) for v in psi.tolist()], dtype=torch.float32)
    a = a_positions(state.a_xy[0].detach().cpu(), psi, cfg, (cos, sin))
    b = b_positions(state.b_center[0].detach().cpu(),
                    state.b_quat[0].detach().cpu(), cfg)
    return torch.cat([a, b], dim=0).numpy()


def _write_atomic(path: str, mode: str, write) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


# ---------------------------------------------------------------------------
# native atomic checkpoint

def save_native(path: str, state: SimState, batched: bool = False) -> None:
    """Write ``state``: a single trajectory (one replica, stored without the
    replica axis) unless ``batched``."""
    if not batched and state.step.shape[0] != 1:
        raise ValueError(f"a single trajectory has one replica, got "
                         f"{state.step.shape[0]}; pass batched=True")
    arrays = convert.to_numpy(state, batched=batched)
    arrays["key_data"] = arrays.pop("key")
    _write_atomic(path, "wb", lambda f: np.savez(f, **arrays))


def load_native(path: str, device=None) -> SimState:
    """Read a native checkpoint of either package onto ``device`` (the card
    unless the caller asks for the CPU).  A single trajectory comes back as
    one replica."""
    dev = resolve_device(device)
    with np.load(path) as z:
        fields = {f: z[f] for f in SimState._fields if f != "key" and f in z}
        fields["key"] = z["key_data"]
    batched = fields["step"].ndim == 1
    # checkpoints written before the dirty flag: force one idealize pass
    fields.setdefault("dirty", np.ones(fields["step"].shape, bool))
    return convert.from_numpy(fields, batched=batched, device=dev)


# ---------------------------------------------------------------------------
# reference-compatible text checkpoint

def save_reference_cpt(path: str, state: SimState, cfg: SimConfig) -> None:
    """position.cpt of replica 0 of ``state``."""
    p = host_positions(state, cfg)
    na, nb = cfg.n_a, cfg.n_b
    a_trans = state.a_trans[0].cpu().numpy()
    a_site = state.a_site[0].cpu().numpy()
    a_cis = state.a_cis[0].cpu().numpy()
    b_partner = state.b_partner[0].cpu().numpy()
    rl, mono, cis, total = (int(x[0]) for x in bond_counters(
        SimState(*(x[:1].cpu() for x in state)), cfg))

    lines = []
    for i in range(na):
        for j in range(4):
            for k in range(4):
                x, y, z = p[i, j, k]
                lines.append(f"{x:>10.3f}{y:>10.3f}{z:>10.3f}")
        status2 = 1 if a_trans[i] >= 0 else 0
        status3 = 1 if a_cis[i] >= 0 else 0
        nei2 = int(a_trans[i]) + 1 if a_trans[i] >= 0 else 0
        nei4 = int(a_site[i]) + 1 if a_site[i] >= 0 else 0  # ref bead 2..4
        nei3 = int(a_cis[i]) + 1 if a_cis[i] >= 0 else 0
        lines.append(f"{status2:>8}{status3:>8}{nei2:>8}{nei4:>8}{nei3:>8}")
    for b in range(nb):
        i = na + b
        for j in range(4):
            for k in range(2):
                x, y, z = p[i, j, k]
                lines.append(f"{x:>10.3f}{y:>10.3f}{z:>10.3f}")
            if j == 0:
                lines.append(f"{0:>8}{0:>8}")
            else:
                bound = b_partner[b, j - 1] >= 0
                lines.append(
                    f"{1 if bound else 0:>8}"
                    f"{int(b_partner[b, j - 1]) + 1 if bound else 0:>8}")
    lines += [str(total), str(rl), str(cis), str(mono),
              str(int(state.max_complex[0])), str(int(state.step[0]) - 1)]
    _write_atomic(path, "w", lambda f: f.write("\n".join(lines) + "\n"))


def _quat_from_mat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), numerically safe."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def load_reference_cpt(path: str, cfg: SimConfig, seed: int = 0,
                       device=None) -> SimState:
    """A single-trajectory state (one replica) from a position.cpt, keyed
    with the base key of ``seed``."""
    dev = resolve_device(device)
    with open(path) as f:
        toks = f.read().split()
    it = iter(toks)

    def nxt_f():
        return float(next(it))

    def nxt_i():
        return int(next(it))

    na, nb = cfg.n_a, cfg.n_b
    a_xy = np.zeros((na, 2), np.float32)
    a_psi = np.zeros((na,), np.float32)
    a_trans = np.full((na,), -1, np.int32)
    a_site = np.full((na,), -1, np.int32)
    a_cis = np.full((na,), -1, np.int32)
    for i in range(na):
        coords = np.array(
            [[nxt_f(), nxt_f(), nxt_f()] for _ in range(16)]).reshape(4, 4, 3)
        a_xy[i] = coords[0, 0, :2]
        d = coords[2, 1, :2] - coords[2, 0, :2]      # +x site direction
        a_psi[i] = np.arctan2(d[1], d[0])
        status2, status3, nei2, nei4, nei3 = (nxt_i() for _ in range(5))
        if status2:
            a_trans[i] = nei2 - 1
            a_site[i] = nei4 - 1
        if status3:
            a_cis[i] = nei3 - 1

    b_center = np.zeros((nb, 3), np.float32)
    b_quat = np.zeros((nb, 4), np.float32)
    b_laid = np.zeros((nb,), bool)
    b_partner = np.full((nb, 3), -1, np.int32)
    b_mirrored = np.zeros((nb,), bool)
    arm = cfg.trimer_arm
    rb = cfg.rb_b_radius
    tmpl_b = ligand_template_np(cfg)
    for b in range(nb):
        coords = np.zeros((4, 2, 3))
        stats = []
        for j in range(4):
            for k in range(2):
                coords[j, k] = [nxt_f(), nxt_f(), nxt_f()]
            stats.append((nxt_i(), nxt_i()))
        center = coords[0, 0]
        b_center[b] = center
        yv = (coords[1, 0] - center) / arm           # template bead1 = +y
        zv = (coords[0, 1] - center) / rb            # up-site = +z
        xv = np.cross(yv, zv)
        m = np.stack([xv, yv, zv], axis=1)           # columns = image axes
        # A ligand laid while facing down comes out of the reference's
        # lay-down rebuild (main.cpp:1145-1190) mirrored against the
        # template; a mirror through the template x = 0 plane equals
        # relabelling beads 3 <-> 4, so relabel and carry the partner slots
        # (the same physical state with a proper rotation).  The frame
        # above rests on bead 1 and the up-site only, so a mirror shows as
        # beads 3 and 4 sitting at each other's expected positions.
        e2 = center + m @ tmpl_b[2, 0]
        e3 = center + m @ tmpl_b[3, 0]
        if (np.sum((coords[2, 0] - e2) ** 2)
                > np.sum((coords[2, 0] - e3) ** 2)):
            b_mirrored[b] = True
            coords[[2, 3]] = coords[[3, 2]]
            stats[2], stats[3] = stats[3], stats[2]
        # orthonormalize against %.3f rounding (proper rotation enforced)
        u, _, vt = np.linalg.svd(m)
        sgn = np.sign(np.linalg.det(u @ vt))
        m = u @ np.diag([1.0, 1.0, sgn]) @ vt
        b_quat[b] = _quat_from_mat(m)
        b_laid[b] = (
            abs(coords[0, 1, 2] - (center[2] + rb)) < 1e-2
            and np.all(np.abs(coords[1:, 0, 2] - center[2]) < 1e-2))
        for j in range(1, 4):
            status, nei = stats[j]
            if status:
                b_partner[b, j - 1] = nei - 1

    # the beads-3 <-> 4 relabel of a mirrored ligand renames its partner
    # slots, so receptors trans-bound to it follow: a_site 2 <-> 3
    for i in range(na):
        if a_trans[i] >= 0 and b_mirrored[a_trans[i] - na]:
            if a_site[i] == 2:
                a_site[i] = 3
            elif a_site[i] == 3:
                a_site[i] = 2

    total, rl, cis, mono, max_complex, step = (nxt_i() for _ in range(6))
    st = empty_state(cfg, rng.base_key(seed, dev)[None])

    def t(x):
        return torch.from_numpy(x).to(dev)[None]

    return st._replace(
        a_xy=t(a_xy), a_psi=t(a_psi), b_center=t(b_center), b_quat=t(b_quat),
        a_trans=t(a_trans), a_site=t(a_site), a_cis=t(a_cis),
        b_partner=t(b_partner), b_laid=t(b_laid),
        max_complex=torch.tensor([max_complex], dtype=torch.int32,
                                 device=dev),
        step=torch.tensor([step + 1], dtype=torch.int32,   # main.cpp:267
                          device=dev))
