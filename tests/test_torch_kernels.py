"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  The module imports neither JAX nor kmc_tpu, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py

Tolerances: positions 1e-4 A, directions and quaternions 1e-5, integer
codes exact.  The kernels are built with -fmad=false, so in practice the
kernel and the plain version agree to the bit.
"""

import pytest
import torch

from kmc_tpu_torch import SimConfig, lazy_ensemble_step
from kmc_tpu_torch import convert
from kmc_tpu_torch.ops import align_batched
from kmc_tpu_torch.testing import align_core_inputs, bonded_state

POS_TOL, ANG_TOL = 1e-4, 1e-5
SMALL = SimConfig(n_a=24, n_b=8, cell_range_x=700.0, cell_range_y=700.0,
                  cell_range_z=200.0)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _assert_core_close(got, want):
    names = ("a_xy", "a_dir", "snap", "b_center", "b_quat", "b_laid")
    tols = (POS_TOL, ANG_TOL, None, POS_TOL, ANG_TOL, None)
    for name, g, w, tol in zip(names, got, want, tols):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if tol is None:
            assert torch.equal(g, w), name
        else:
            err = float((g - w).abs().max()) if g.numel() else 0.0
            assert err <= tol, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 10, 64, 512])
def test_align_kernel_matches_plain_at_reference_size(batch):
    dev = _cuda()
    cfg = SimConfig()
    args = align_core_inputs(bonded_state(cfg, batch, seed=batch,
                                          device=dev), cfg)
    before = align_batched.align_core_batched.launches
    got = align_batched.align_core_batched(*args, cfg)
    torch.cuda.synchronize()
    assert align_batched.align_core_batched.launches == before + 1
    _assert_core_close(got, align_batched.align_core_batched_plain(*args,
                                                                   cfg))
    assert (got[2] == 1).any()            # seats happened


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 8, 12])
def test_align_kernel_matches_plain_small(depth):
    """Deep and shallow sweeps; depth 1 leaves most chains unreached."""
    dev = _cuda()
    cfg = SMALL.replace(align_depth=depth)
    args = align_core_inputs(bonded_state(cfg, 16, seed=depth, device=dev),
                             cfg)
    got = align_batched.align_core_batched(*args, cfg)
    _assert_core_close(got, align_batched.align_core_batched_plain(*args,
                                                                   cfg))


@pytest.mark.gpu
def test_align_kernel_empty_batch():
    dev = _cuda()
    args = align_core_inputs(bonded_state(SMALL, 2, seed=0, device=dev),
                             SMALL)
    got = align_batched.align_core_batched(*[a[:0] for a in args], SMALL)
    assert all(g.shape[0] == 0 for g in got)


@pytest.mark.gpu
def test_align_wrapper_raises_instead_of_falling_back():
    dev = _cuda()
    args = align_core_inputs(bonded_state(SMALL, 2, seed=1, device=dev),
                             SMALL)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError):
        align_batched.align_core_batched(*bad, SMALL)
    bad = list(args)
    bad[4] = args[4].cpu()
    with pytest.raises(ValueError):
        align_batched.align_core_batched(*bad, SMALL)


@pytest.mark.gpu
def test_lazy_step_on_card_matches_cpu():
    """One lazy step on the card (through K1) from each of 5 trajectory
    states equals the CPU path (plain K1) from the same state."""
    dev = _cuda()
    st = bonded_state(SMALL, 8, seed=5, device=dev)
    for i in range(5):
        cpu_in = convert.from_numpy(convert.to_numpy(st))
        before = align_batched.align_core_batched.launches
        st, obs = lazy_ensemble_step(st, SMALL, 2, device=dev)
        assert align_batched.align_core_batched.launches == before + 1
        want, want_obs = lazy_ensemble_step(cpu_in, SMALL, 2, device="cpu")
        for f in want._fields:
            got = getattr(st, f).cpu()
            if f in ("a_xy", "a_psi", "b_center", "b_quat"):
                assert float((got - getattr(want, f)).abs().max()) <= POS_TOL
            else:
                assert torch.equal(got, getattr(want, f)), (f, i)
        for f in want_obs._fields:
            assert torch.equal(getattr(obs, f).cpu(), getattr(want_obs, f))
