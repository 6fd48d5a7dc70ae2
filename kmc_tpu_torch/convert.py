"""Carry a simulation state between the JAX package and the port.

The JAX package's ``SimState`` travels as a dict of numpy arrays, with the
key given as ``jax.random.key_data(key)`` (uint32[..., 2]); this module
turns it into the port's ``SimState`` (leading replica axis, int64 key
words) and back.  It imports neither package's JAX code: the caller
produces and consumes the numpy dict, so the port stays free of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from kmc_tpu_torch.state import SimState

_FLOAT = ("a_xy", "a_psi", "b_center", "b_quat")
_INT = ("a_trans", "a_site", "a_cis", "b_partner", "max_complex", "step")
_BOOL = ("b_laid", "dirty")


def from_numpy(fields: dict, batched: bool = True, device="cpu") -> SimState:
    """Port state from a dict of numpy arrays (the JAX SimState's fields).
    With ``batched=False`` the arrays are one replica's and gain a replica
    axis of length 1."""
    out = {}
    for name in SimState._fields:
        x = np.asarray(fields[name])
        if not batched:
            x = x[None]
        if name in _FLOAT:
            x = x.astype(np.float32)
        elif name in _INT:
            x = x.astype(np.int32)
        elif name in _BOOL:
            x = x.astype(bool)
        else:                                   # key words, uint32 -> int64
            x = x.astype(np.int64)
        out[name] = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return SimState(**out)


def to_numpy(state: SimState, batched: bool = True) -> dict:
    """Dict of numpy arrays with the JAX SimState's dtypes (key words as
    uint32, ready for ``jax.random.wrap_key_data``)."""
    out = {}
    for name in SimState._fields:
        x = getattr(state, name).detach().cpu().numpy()
        if name == "key":
            x = x.astype(np.uint32)
        if not batched:
            x = x[0]
        out[name] = x
    return out
