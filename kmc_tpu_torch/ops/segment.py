"""Segment reductions over per-replica labels (port of
``kmc_tpu/ops/segment.py``).

Inputs carry a leading replica axis: ``x`` is [R, m] or [R, m, k] and
``labels`` is int[R, m] with values in [0, num_segments).  Min and max are
``scatter_reduce`` with an explicit fill for empty segments (the JAX
package's masked-reduction fills: +inf / dtype max for min, -inf / dtype
min / False for max).  The float sum is a one-hot matrix product, which is
deterministic on the card where ``scatter_add`` uses atomics.
"""

from __future__ import annotations

import torch


def _fill_min(dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _fill_max(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def onehot(labels, num_segments: int, dtype=torch.float32):
    """[R, m, num_segments] one-hot rows of ``labels``."""
    cols = torch.arange(num_segments, device=labels.device)
    return (labels[..., None] == cols).to(dtype)


def seg_sum(x, labels, num_segments: int):
    """Sum of float x[R, m(, k)] into segments: [R, num_segments(, k)]."""
    oh = onehot(labels, num_segments, x.dtype).transpose(1, 2)
    if x.dim() == 2:
        return torch.bmm(oh, x[..., None])[..., 0]
    return torch.bmm(oh, x)


def seg_min(x, labels, num_segments: int):
    out = torch.full((x.shape[0], num_segments), _fill_min(x.dtype),
                     dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(1, labels.long(), x, "amin")


def seg_max(x, labels, num_segments: int):
    if x.dtype == torch.bool:
        return seg_max(x.to(torch.uint8), labels, num_segments) > 0
    out = torch.full((x.shape[0], num_segments), _fill_max(x.dtype),
                     dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(1, labels.long(), x, "amax")
