"""Connected components of the bond graph (port of
``kmc_tpu/engine/clusters.py``).

The adjacency matrix with self-loops is squared ``label_closure_iters``
times (boolean transitive closure: k squarings cover components of
diameter 2^k); label = min reachable molecule index, size = row sum, #A and
#B = partial row sums.  The squarings are float32 batched matrix products
of 0/1 entries: every count is an integer of at most n, exact in float32
(and in TF32), so the closure is exact on both devices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.state import SimState, neighbors


class ClusterInfo(NamedTuple):
    label: torch.Tensor    # i32[R, n] component id = min molecule index
    size: torch.Tensor     # i32[R, n] component size, per molecule
    n_a: torch.Tensor      # i32[R, n] receptors in component
    n_b: torch.Tensor      # i32[R, n] ligands in component
    is_root: torch.Tensor  # bool[R, n] molecule is its component's label


def take_info(info: ClusterInfo, idx: torch.Tensor) -> ClusterInfo:
    """The replicas ``idx`` of every field."""
    return ClusterInfo(*(x[idx] for x in info))


def reachability(state: SimState, cfg: SimConfig):
    """bool[R, n, n] transitive closure of the bond graph (with self-loops)."""
    n = cfg.n
    # exactness guard: k squarings cover components of diameter 2^k
    assert 2 ** cfg.label_closure_iters >= n, (
        f"label_closure_iters={cfg.label_closure_iters} covers diameter "
        f"{2 ** cfg.label_closure_iters} < n={n}; raise it to "
        f">= ceil(log2(n))")
    nbr = neighbors(state, cfg)                               # [R, n, 3]
    idx = torch.arange(n, dtype=nbr.dtype, device=nbr.device)
    adj = (nbr[..., None] == idx).any(dim=2)
    adj |= torch.eye(n, dtype=torch.bool, device=nbr.device)
    reach = adj.to(torch.float32)
    for _ in range(cfg.label_closure_iters):
        reach = (torch.bmm(reach, reach) > 0.5).to(torch.float32)
    return reach > 0.5


def cluster_labels(state: SimState, cfg: SimConfig) -> ClusterInfo:
    n = cfg.n
    reach = reachability(state, cfg)
    idx = torch.arange(n, dtype=torch.int32, device=reach.device)
    label = torch.where(reach, idx, n).amin(dim=2).to(torch.int32)
    size = reach.sum(dim=2, dtype=torch.int32)
    in_a = reach[..., : cfg.n_a].sum(dim=2, dtype=torch.int32)
    return ClusterInfo(label=label, size=size, n_a=in_a, n_b=size - in_a,
                       is_root=label == idx)
