"""Output writers (port of ``kmc_tpu/io/writers.py``).

Byte-compatible with the reference's flat files, and with the JAX
package's writers on the same state:

* ``parameter.log`` -- run-parameter header           (main.cpp:179-205)
* ``bond.dat``      -- 7-column kinetics time series  (main.cpp:2247-2253)
* ``test.gro``      -- GROMACS-style trajectory       (main.cpp:2258-2287)
* ``cluster.log``   -- per-cluster member lists       (main.cpp:2291-2305)
* ``hist.dat``      -- cluster-size distributions (kmc_tpu's addition)

Writers run on the host.  A state comes to the host once per output
interval (cfg.out_every steps); the step loop never touches the
filesystem.  A single-trajectory state has one replica; the writers take
replica 0.
"""

from __future__ import annotations

import os
from typing import Iterable, List

import numpy as np

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.engine.clusters import cluster_labels
from kmc_tpu_torch.engine.observables import (Observables, cluster_histogram,
                                              receptor_oligomer_histogram)
from kmc_tpu_torch.io.checkpoint import host_positions, save_reference_cpt
from kmc_tpu_torch.state import SimState, take_replicas


def write_parameter_log(path: str, cfg: SimConfig) -> None:
    """Reference parameter header (appending, like main.cpp:179)."""

    def row(name, *vals):
        return f"{name:>25}" + "".join(f"{v:>15g}" if isinstance(v, float)
                                       else f"{v:>15}" for v in vals) + "\n"

    with open(path, "a") as f:
        f.write(
            f"{'box size: x y z':>25}{cfg.cell_range_x:>15g}"
            f"{cfg.cell_range_y:>7g}{cfg.cell_range_z:>7g}\n\n")
        f.write(row("protein_A_tot_num", cfg.n_a))
        f.write(row("RB_A_tot_num", cfg.n_a * 4))
        f.write(row("protein_B_tot_num", cfg.n_b))
        f.write(row("RB_B_tot_num", cfg.n_b * 4) + "\n")
        f.write(row("RB_A_D", cfg.rb_a_d))
        f.write(row("RB_A_rot_D", cfg.rb_a_rot_d))
        f.write(row("RB_B_D", cfg.rb_b_d))
        f.write(row("RB_B_rot_D", cfg.rb_b_rot_d) + "\n")
        f.write(f"{'R-L interaction:':>25}\n")
        f.write(row("bond_D", cfg.bond_d))
        f.write(row("bond_rot_D", cfg.bond_rot_d))
        f.write(row("Ass_Rate", cfg.ass_rate))
        f.write(row("Diss_Rate", cfg.diss_rate) + "\n")
        f.write(f"{'Cis interaction:':>25}\n")
        f.write(row("cis_D", cfg.cis_d))
        f.write(row("cis_rot_D", cfg.cis_rot_d))
        f.write(row("mono_cis_Ass_Rate", cfg.mono_cis_ass_rate))
        f.write(row("mono_cis_Diss_Rate", cfg.mono_cis_diss_rate) + "\n")
        f.write(row("cis_Ass_Rate", cfg.cis_ass_rate))
        f.write(row("cis_Diss_Rate", cfg.cis_diss_rate) + "\n")


def append_bond_dat(path: str, obs: Observables) -> None:
    """One bond.dat row from replica 0's observables: t(ns), rl, mono_cis,
    cis, bond, cluster_size, max_complex (main.cpp:2251)."""
    o = [x.reshape(-1)[0].item() for x in obs]
    with open(path, "a") as f:
        f.write(f"{o[0]:>15.3f}{o[1]:>5}{o[2]:>5}{o[3]:>10}{o[4]:>10}"
                f"{o[5]:>10.3f}{o[6]:>10}\n")


def _time_ns(state: SimState, cfg: SimConfig) -> float:
    return (int(state.step[0]) - 1) * cfg.time_step


def append_gro_frame(path: str, state: SimState, cfg: SimConfig) -> None:
    """GROMACS-style frame: receptor bead centers as ALA/CA, ligand beads
    1..3 as LEU/CA, coordinates in nm (main.cpp:2258-2287)."""
    p = host_positions(state, cfg)
    na = cfg.n_a
    lines: List[str] = [f"Hello Gro!, t={_time_ns(state, cfg):.3f}",
                        str(cfg.n_a * 4 + cfg.n_b * 3)]
    for i in range(na):
        for j in range(4):
            x, y, z = p[i, j, 0] / 10.0
            lines.append(
                f"{i + 1:>5}ALA{'CA':>7}{i + 1:>5}{x:>8.3f}{y:>8.3f}{z:>8.3f}")
    for i in range(cfg.n_b):
        for j in range(1, 4):
            x, y, z = p[na + i, j, 0] / 10.0
            lines.append(
                f"{na + i + 1:>5}LEU{'CA':>7}{na + i + 1:>5}"
                f"{x:>8.3f}{y:>8.3f}{z:>8.3f}")
    lines.append(
        f"{cfg.cell_range_x / 10:>8.3f}{cfg.cell_range_y / 10:>12.3f}"
        f"{cfg.cell_range_z / 10:>12.3f}")
    with open(path, "a") as f:
        f.write("\n".join(lines) + "\n")


def append_hist(path: str, state: SimState, cfg: SimConfig) -> None:
    """Cluster-size distribution row: t, then ligand-seeded cluster counts
    by size 1..MAX_HIST_SIZE, then receptor-oligomer counts."""
    info = cluster_labels(take_replicas(state, [0]), cfg)
    h1 = cluster_histogram(info, cfg)[0, 1:].tolist()
    h2 = receptor_oligomer_histogram(info, cfg)[0, 1:].tolist()
    with open(path, "a") as f:
        f.write(f"{_time_ns(state, cfg):.3f} "
                + " ".join(str(x) for x in h1) + " | "
                + " ".join(str(x) for x in h2) + "\n")


def bfs_clusters(state: SimState, cfg: SimConfig) -> List[List[int]]:
    """The reference's ligand-seeded BFS (main.cpp:505-562) on replica 0:
    one row per ligand, listing 1-based member indices in BFS visit order
    (empty for ligands already visited)."""
    na, n = cfg.n_a, cfg.n
    a_trans = state.a_trans[0].cpu().numpy()
    a_cis = state.a_cis[0].cpu().numpy()
    b_partner = state.b_partner[0].cpu().numpy()

    def nbrs(i: int) -> Iterable[int]:
        if i < na:
            if a_trans[i] >= 0:
                yield int(a_trans[i])
            if a_cis[i] >= 0:
                yield int(a_cis[i])
        else:
            for k in range(3):
                if b_partner[i - na, k] >= 0:
                    yield int(b_partner[i - na, k])

    visited = np.zeros(n, bool)
    rows: List[List[int]] = []
    for seed in range(na, n):
        row: List[int] = []
        if not visited[seed]:
            visited[seed] = True
            queue = [seed]
            while queue:
                cur = queue.pop(0)
                row.append(cur + 1)            # reference is 1-based
                for nb in nbrs(cur):
                    if not visited[nb]:
                        visited[nb] = True
                        queue.append(nb)
        rows.append(row)
    return rows


def append_cluster_log(path: str, state: SimState, cfg: SimConfig) -> None:
    rows = bfs_clusters(state, cfg)
    with open(path, "a") as f:
        f.write(f"Hello Cluster!, t={_time_ns(state, cfg):.3f}\n")
        for row in rows:
            f.write("".join(f"{m}  " for m in row) + "\n")


class OutputSet:
    """All periodic writers of a single trajectory behind one callback for
    ``engine.step.run``.

    With ``use_native`` (default: when available), test.gro frames are
    formatted by the C++ codec and written by its background thread
    (io/native.py); otherwise by ``append_gro_frame``."""

    def __init__(self, out_dir: str, cfg: SimConfig, fresh: bool = True,
                 use_native: bool | None = None):
        self.cfg = cfg
        os.makedirs(out_dir, exist_ok=True)
        self.bond = os.path.join(out_dir, "bond.dat")
        self.gro = os.path.join(out_dir, "test.gro")
        self.cluster = os.path.join(out_dir, "cluster.log")
        self.cpt = os.path.join(out_dir, "position.cpt")
        self.hist = os.path.join(out_dir, "hist.dat")
        if fresh:
            for f in (self.bond, self.gro, self.cluster, self.hist):
                open(f, "w").close()
            # only on a fresh run: a resumed run would append a second header
            write_parameter_log(os.path.join(out_dir, "parameter.log"), cfg)

        self._gro_writer = None
        if use_native is not False:
            from kmc_tpu_torch.io import native

            if native.available():
                self._native = native
                self._gro_writer = native.AsyncWriter(self.gro)
            elif use_native:
                raise RuntimeError("native kmcio unavailable")

    def __call__(self, state: SimState, obs: Observables) -> None:
        state = SimState(*(x[:1].cpu() for x in state))   # one host copy
        append_bond_dat(self.bond, obs)
        if self._gro_writer is not None:
            cfg = self.cfg
            frame = self._native.format_gro(
                host_positions(state, cfg), cfg.n_a, cfg.n_b,
                _time_ns(state, cfg),
                (cfg.cell_range_x, cfg.cell_range_y, cfg.cell_range_z))
            self._gro_writer.append(frame)
        else:
            append_gro_frame(self.gro, state, self.cfg)
        append_cluster_log(self.cluster, state, self.cfg)
        append_hist(self.hist, state, self.cfg)
        save_reference_cpt(self.cpt, state, self.cfg)

    def close(self) -> None:
        if self._gro_writer is not None:
            self._gro_writer.close()
            self._gro_writer = None


class EnsembleOutputSet:
    """Writers for a replica ensemble: merged kinetics with error bars to
    ``bond_ens.dat`` (time, then mean/std/min/max per counter), plus the
    full reference-format file set for replica 0."""

    COLS = ("bond_rl", "bond_mono_cis", "bond_cis", "bond_num",
            "cluster_size", "max_complex")

    def __init__(self, out_dir: str, cfg: SimConfig, fresh: bool = True):
        self.cfg = cfg
        os.makedirs(out_dir, exist_ok=True)
        self.ens = os.path.join(out_dir, "bond_ens.dat")
        if fresh:
            with open(self.ens, "w") as f:
                f.write("# t_ns " + " ".join(
                    f"{c}_mean {c}_std {c}_min {c}_max" for c in self.COLS)
                        + "\n")
        self.rep0 = OutputSet(out_dir, cfg, fresh=fresh)

    def __call__(self, state: SimState, obs: Observables) -> None:
        obs = Observables(*(x.cpu() for x in obs))
        row = [f"{float(obs.time_ns[0]):.3f}"]
        for c in self.COLS:
            v = getattr(obs, c).numpy().astype(np.float64)
            row += [f"{v.mean():.4f}", f"{v.std():.4f}",
                    f"{v.min():.3f}", f"{v.max():.3f}"]
        with open(self.ens, "a") as f:
            f.write(" ".join(row) + "\n")
        self.rep0(state, Observables(*(x[:1] for x in obs)))

    def close(self) -> None:
        self.rep0.close()
