"""Lattice engine I/O (port of ``kmc_tpu/lattice/io.py``): the time series
and checkpoints, byte for byte and key for key as the JAX package writes
them, so each package reads the other's files.

``lattice.dat`` row: step, particle count, MSD, species histogram
1..MAX_SPECIES, simulated time, the lattice analogue of bond.dat.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from kmc_tpu_torch.config import LatticeConfig
from kmc_tpu_torch.lattice.grid import (LatticeState, msd, particle_count,
                                        species_histogram)
from kmc_tpu_torch.state import resolve_device


def append_lattice_dat(path: str, state: LatticeState) -> None:
    hist = species_histogram(state).cpu().numpy()[1:]
    with open(path, "a") as f:
        f.write(
            f"{int(state.step)} {int(particle_count(state))} "
            f"{float(msd(state)):.4f} "
            + " ".join(str(int(x)) for x in hist)
            + f" {float(state.time):.4f}\n"
        )


def save_lattice(path: str, state: LatticeState) -> None:
    """npz with the JAX package's keys and dtypes, written atomically."""
    arrays = {f: v.detach().cpu().numpy()
              for f, v in state._asdict().items()}
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_lattice(path: str, device=None) -> LatticeState:
    """A checkpoint of either package, on ``device`` (the card unless
    ``"cpu"``).  One written before the time field resumes the time axis
    from the step counter."""
    dev = resolve_device(device)
    z = np.load(path)
    fields = {f: torch.from_numpy(np.asarray(z[f])).to(dev)
              for f in LatticeState._fields if f in z}
    fields.setdefault("time", fields["step"].to(torch.float32))
    return LatticeState(**fields)


class LatticeOutputSet:
    def __init__(self, out_dir: str, cfg: LatticeConfig, fresh: bool = True):
        self.cfg = cfg
        os.makedirs(out_dir, exist_ok=True)
        self.dat = os.path.join(out_dir, "lattice.dat")
        self.ckpt = os.path.join(out_dir, "lattice_checkpoint.npz")
        if fresh:
            open(self.dat, "w").close()

    def __call__(self, state: LatticeState) -> None:
        append_lattice_dat(self.dat, state)
        save_lattice(self.ckpt, state)
