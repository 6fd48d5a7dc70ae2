"""Runtime physics parameters (port of ``kmc_tpu/engine/params.py``).

``SimConfig`` fields are fixed when a step is built.  ``RuntimeParams``
carries the *continuous* physics -- diffusion coefficients and per-step
reaction probabilities -- as float32 tensors, so one step can run a
different parameter set in each replica of an ensemble: a parameter
sweep in one batched step (SURVEY.md §2).  Each leaf is 0-d (the same
value for every replica) or [R] (one value per replica).

Shapes, counts and cutoffs stay in ``SimConfig`` (they set tensor sizes
and gate geometry).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.state import resolve_device


class RuntimeParams(NamedTuple):
    rb_a_d: torch.Tensor
    rb_a_rot_d: torch.Tensor
    rb_b_d: torch.Tensor
    rb_b_rot_d: torch.Tensor
    cis_d: torch.Tensor
    cis_rot_d: torch.Tensor
    bond_d: torch.Tensor
    bond_rot_d: torch.Tensor
    p_trans_ass: torch.Tensor
    p_trans_diss: torch.Tensor
    p_mono_cis_ass: torch.Tensor
    p_mono_cis_diss: torch.Tensor
    p_cis_ass: torch.Tensor
    p_cis_diss: torch.Tensor


def from_config(cfg: SimConfig, device=None) -> RuntimeParams:
    """The config's values as 0-d float32 tensors, on the card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    vals = torch.tensor([getattr(cfg, f) for f in RuntimeParams._fields],
                        dtype=torch.float32, device=dev)
    return RuntimeParams(*vals.unbind())


def sweep(cfg: SimConfig, n: int, device=None, **overrides) -> RuntimeParams:
    """Batched params: base values broadcast to [n], with per-replica
    values for any overridden field, e.g. ``sweep(cfg, 8,
    p_trans_ass=grid)``."""
    dev = resolve_device(device)
    out = {}
    for name, base in zip(RuntimeParams._fields, from_config(cfg, dev)):
        if name in overrides:
            v = torch.as_tensor(overrides[name], dtype=torch.float32,
                                device=dev)
            if v.shape != (n,):
                raise ValueError(f"sweep: {name} has shape "
                                 f"{tuple(v.shape)}, want ({n},)")
            out[name] = v
        else:
            out[name] = base.expand(n).clone()
    return RuntimeParams(**out)


def per_replica(v, ndim: int):
    """A parameter shaped to broadcast against a [R, ...] tensor of
    ``ndim`` dims: a [R] tensor becomes [R, 1, ...]; a 0-d tensor or a
    float is returned as it is."""
    if torch.is_tensor(v) and v.dim() == 1:
        return v.reshape(-1, *(1,) * (ndim - 1))
    return v
