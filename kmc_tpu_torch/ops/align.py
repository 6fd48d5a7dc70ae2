"""The single-replica idealize core, kernel K2 (port of
``kmc_tpu/ops/pallas_align.py``: ``_align_kernel`` and ``align_core``).

``align_core_single`` takes one replica's poses and topology in the TPU
kernel's operand layout -- integer columns [n, 1], receptor directions
(cos psi, sin psi), the ligand template f32[4, 4, 3] as an input -- and
returns the snapped poses, the snap codes [na, 1] (0 no, 1 snapped,
2 unreached) and the laid bits [nb, 1] (bit 0 laid, bit 1 unreached).  On
a CUDA tensor it launches the hand-written kernel
``kmc_tpu_torch/csrc/align.cu`` (one thread block, one thread per
molecule, one pass per depth level; the plain version's bits) and raises
if the launch fails; on a CPU tensor it runs
``align_core_single_plain``.  There is no fallback from the card to the
plain version.

The single trajectory (``engine/step.step_fn``) runs this kernel; every
batched path runs K1 (``ops/align_batched.py``), as the JAX package routes
an unbatched call to its single-replica kernel and a vmapped one to the
batched kernel.

Shapes (na receptors, nb ligands, n = na + nb):
  in:  a_xy f32[na, 2], a_dir f32[na, 2], b_center f32[nb, 3],
       b_quat f32[nb, 4], a_trans/a_site/a_cis i32[na, 1],
       b_partner i32[nb, 3], b_laid i32[nb, 1] (0/1),
       is_root i32[n, 1] (0/1), act i32[n, 1] (0/1), tmpl f32[4, 4, 3]
  out: a_xy, a_dir, a_snap i32[na, 1], b_center, b_quat, b_laid i32[nb, 1]
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.models.tnfr import ligand_template
from kmc_tpu_torch.ops.align_batched import (MAX_MOLECULES, _Params,
                                             align_core_batched_plain,
                                             _params)

_NAMES = ("a_xy", "a_dir", "b_center", "b_quat", "a_trans", "a_site",
          "a_cis", "b_partner", "b_laid", "is_root", "act", "tmpl")


def align_core_single_plain(a_xy, a_dir, b_center, b_quat, a_trans, a_site,
                            a_cis, b_partner, b_laid, is_root, act, tmpl,
                            cfg: SimConfig):
    """K2 in plain tensor ops: K1's plain version on a batch of one, with
    the template taken from ``tmpl``."""
    cols = (a_trans, a_site, a_cis, b_laid, is_root, act)
    a_trans, a_site, a_cis, b_laid, is_root, act = (x[:, 0] for x in cols)
    out = align_core_batched_plain(
        *(x[None] for x in (a_xy, a_dir, b_center, b_quat, a_trans, a_site,
                            a_cis, b_partner, b_laid, is_root, act)),
        cfg, tmpl=tmpl.detach().cpu().numpy())
    a_xy, a_dir, snap, b_center, b_quat, laid = (x[0] for x in out)
    return a_xy, a_dir, snap[:, None], b_center, b_quat, laid[:, None]


def _bind(lib):
    fn = lib.kmc_align
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.POINTER(_Params)] + [ctypes.c_void_p] * 19)
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(args, cfg: SimConfig):
    na, nb, n = cfg.n_a, cfg.n_b, cfg.n
    shapes = ((na, 2), (na, 2), (nb, 3), (nb, 4), (na, 1), (na, 1), (na, 1),
              (nb, 3), (nb, 1), (n, 1), (n, 1), (4, 4, 3))
    dtypes = (torch.float32,) * 4 + (torch.int32,) * 7 + (torch.float32,)
    device = args[0].device
    if n > MAX_MOLECULES:
        raise ValueError(f"align kernel takes at most {MAX_MOLECULES} "
                         f"molecules, got {n}")
    for name, x, shape, dtype in zip(_NAMES, args, shapes, dtypes):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, a_xy on {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def align_core_single(a_xy, a_dir, b_center, b_quat, a_trans, a_site, a_cis,
                      b_partner, b_laid, is_root, act, tmpl, cfg: SimConfig):
    """K2: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors.  Each kernel launch adds one to ``align_core_single.launches``."""
    args = (a_xy, a_dir, b_center, b_quat, a_trans, a_site, a_cis, b_partner,
            b_laid, is_root, act, tmpl)
    if a_xy.device.type == "cpu":
        return align_core_single_plain(*args, cfg)
    if a_xy.device.type != "cuda":
        raise ValueError(f"no align kernel for device {a_xy.device}")
    _check_inputs(args, cfg)
    from kmc_tpu_torch.ops import build

    fn = _bind(build.library("align"))
    dev = a_xy.device
    outs = (torch.empty_like(a_xy), torch.empty_like(a_dir),
            torch.empty((cfg.n_a, 1), dtype=torch.int32, device=dev),
            torch.empty_like(b_center), torch.empty_like(b_quat),
            torch.empty((cfg.n_b, 1), dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(_params(cfg)), tmpl.data_ptr(),
                 *(x.data_ptr() for x in args[:-1]),
                 *(o.data_ptr() for o in outs), stream)
    if err != 0:
        raise RuntimeError(f"align kernel launch failed: CUDA error {err}")
    align_core_single.launches += 1
    return outs


align_core_single.launches = 0


def align_core(state, is_root, act, cfg: SimConfig):
    """The fused idealize core for a single-trajectory state (one replica).

    Same contract as ``ops.align_batched.align_core`` at R = 1: returns
    (a_xy, a_psi, b_center, b_quat, b_laid, unreached) with the replica
    axis kept; un-snapped receptors keep their azimuth bitwise."""
    if state.a_xy.shape[0] != 1:
        raise ValueError("the single-replica align core takes one replica, "
                         f"got {state.a_xy.shape[0]}")
    i32 = torch.int32
    psi = state.a_psi[0]
    a_dir = torch.stack([torch.cos(psi), torch.sin(psi)], -1)
    a_xy, a_dir, snap, b_center, b_quat, b_laid = align_core_single(
        state.a_xy[0].contiguous(), a_dir, state.b_center[0].contiguous(),
        state.b_quat[0].contiguous(),
        state.a_trans[0].to(i32).reshape(-1, 1).contiguous(),
        state.a_site[0].to(i32).reshape(-1, 1).contiguous(),
        state.a_cis[0].to(i32).reshape(-1, 1).contiguous(),
        state.b_partner[0].to(i32).contiguous(),
        state.b_laid[0].to(i32).reshape(-1, 1),
        is_root[0].to(i32).reshape(-1, 1), act[0].to(i32).reshape(-1, 1),
        _template(cfg, state.a_xy.device), cfg)
    snap, b_laid = snap[:, 0], b_laid[:, 0]
    a_psi = torch.where(snap == 1, torch.atan2(a_dir[:, 1], a_dir[:, 0]), psi)
    unreached = (snap == 2).any() | (b_laid >= 2).any()
    return (a_xy[None], a_psi[None], b_center[None], b_quat[None],
            ((b_laid & 1) > 0)[None], unreached[None])


@functools.lru_cache(maxsize=16)
def _template(cfg: SimConfig, device) -> torch.Tensor:
    """The ligand template on ``device``, made once per configuration."""
    return ligand_template(cfg, device).contiguous()
