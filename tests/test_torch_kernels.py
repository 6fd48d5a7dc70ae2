"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  The module imports neither JAX nor kmc_tpu, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py

Tolerances: K1 positions 1e-4 A, directions and quaternions 1e-5,
integer codes exact, on the bonded fixtures; K1 on the mature reference
state and on the trans-only and bond-free replicas, K2 and K3 (the
lattice step) to the bit.  The
kernels are built with -fmad=false and round each operation as their
plain versions do.

Two paths without a kernel of their own are also held to the CPU here:
the rejection-free lattice mode (equal after every event or batch, time
within 1e-5 relative, parting only at an ulp tie of its Gumbel scores)
and the batched step with a per-replica parameter sweep (through K1).
"""

import os

import pytest
import torch

from kmc_tpu_torch import (LatticeConfig, SimConfig, init_lattice,
                           init_state, lazy_ensemble_step, step_fn)
from kmc_tpu_torch import convert
from kmc_tpu_torch.io.checkpoint import load_reference_cpt
from kmc_tpu_torch.lattice.step import (lattice_step, lattice_step_arrays,
                                        step_variant)
from kmc_tpu_torch.ops import align as k2
from kmc_tpu_torch.ops import align_batched
from kmc_tpu_torch.ops import lattice as k3
from kmc_tpu_torch.parallel.ensemble import broadcast_ensemble
from kmc_tpu_torch.testing import (align_core_inputs,
                                   align_core_single_inputs, bonded_state)

POS_TOL, ANG_TOL = 1e-4, 1e-5
REF_CPT = os.path.join(os.path.dirname(__file__), "data", "ref_position.cpt")
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


# ---------------------------------------------------------------------------
# K2, the single-replica core


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_single_kernel_matches_plain_at_reference_size(seed):
    dev = _cuda()
    cfg = SimConfig()
    args = align_core_single_inputs(bonded_state(cfg, 1, seed=seed,
                                                 device=dev), cfg)
    before = k2.align_core_single.launches
    got = k2.align_core_single(*args, cfg)
    torch.cuda.synchronize()
    assert k2.align_core_single.launches == before + 1
    want = k2.align_core_single_plain(*args, cfg)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)
    assert (got[2] == 1).any()            # seats happened
    # K2 and K1 at batch 1 run the same body: the same bits
    k1 = align_batched.align_core_batched(
        *(a[:, 0][None] if i in (4, 5, 6, 8, 9, 10) else a[None]
          for i, a in enumerate(args[:-1])), cfg)
    for g, w in zip(got, k1):
        assert torch.equal(g.reshape(w[0].shape), w[0])


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 12])
def test_single_kernel_matches_plain_small(depth):
    dev = _cuda()
    cfg = SMALL.replace(align_depth=depth)
    args = align_core_single_inputs(bonded_state(cfg, 1, seed=depth,
                                                 device=dev), cfg)
    got = k2.align_core_single(*args, cfg)
    for g, w in zip(got, k2.align_core_single_plain(*args, cfg)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_single_wrapper_raises_instead_of_falling_back():
    dev = _cuda()
    args = align_core_single_inputs(bonded_state(SMALL, 1, seed=1,
                                                 device=dev), SMALL)
    bad = list(args)
    bad[11] = args[11].double()
    with pytest.raises(TypeError):
        k2.align_core_single(*bad, SMALL)
    bad = list(args)
    bad[4] = args[4].cpu()
    with pytest.raises(ValueError):
        k2.align_core_single(*bad, SMALL)


@pytest.mark.gpu
def test_step_fn_on_card_matches_cpu():
    """Single-trajectory steps on the card (through K2, never K1) equal the
    CPU path (K2's plain version) from the same state."""
    dev = _cuda()
    st = bonded_state(SMALL, 1, seed=6, device=dev)
    for i in range(5):
        cpu_in = convert.from_numpy(convert.to_numpy(st))
        k1_before = align_batched.align_core_batched.launches
        k2_before = k2.align_core_single.launches
        st, obs = step_fn(st, SMALL, device=dev)
        assert k2.align_core_single.launches == k2_before + 1
        assert align_batched.align_core_batched.launches == k1_before
        want, want_obs = step_fn(cpu_in, SMALL, device="cpu")
        for f in want._fields:
            got = getattr(st, f).cpu()
            if f in ("a_xy", "a_psi", "b_center", "b_quat"):
                assert float((got - getattr(want, f)).abs().max()) <= POS_TOL
            else:
                assert torch.equal(got, getattr(want, f)), (f, i)
        for f in want_obs._fields:
            assert torch.equal(getattr(obs, f).cpu(), getattr(want_obs, f))
    assert init_state(SMALL, 0).a_xy.is_cuda


# ---------------------------------------------------------------------------
# K1 and K2 on the mature reference state and on shallow topologies: the
# level schedule's early exit after 8, 2 and 1 passes


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


def _strip(st, cis_only):
    none = torch.full_like
    st = st._replace(a_cis=none(st.a_cis, -1))
    if cis_only:
        return st
    return st._replace(a_trans=none(st.a_trans, -1),
                       a_site=none(st.a_site, -1),
                       b_partner=none(st.b_partner, -1))


@pytest.mark.gpu
def test_single_kernel_matches_plain_on_reference_state():
    """K2 on a mature state of the C++ reference (144 of 200 molecules in
    complexes, chains 6-8 levels deep), to the bit."""
    dev = _cuda()
    cfg = SimConfig()
    args = align_core_single_inputs(
        load_reference_cpt(REF_CPT, cfg, seed=0, device=dev), cfg)
    got = k2.align_core_single(*args, cfg)
    _assert_bitwise(got, k2.align_core_single_plain(*args, cfg))
    assert int((got[2] == 1).sum()) > 100


@pytest.mark.gpu
def test_align_kernel_bitwise_on_reference_ensemble():
    """K1 at B = 64 on the reference state broadcast with distinct keys, so
    each replica draws its own roots, to the bit."""
    dev = _cuda()
    cfg = SimConfig()
    st = broadcast_ensemble(load_reference_cpt(REF_CPT, cfg, seed=0,
                                               device=dev), 64, seed=0)
    args = align_core_inputs(st, cfg)
    assert not torch.equal(args[9][0], args[9][1])      # roots differ
    got = align_batched.align_core_batched(*args, cfg)
    _assert_bitwise(got, align_batched.align_core_batched_plain(*args, cfg))


@pytest.mark.gpu
@pytest.mark.parametrize("bonds", ["trans_only", "none"])
def test_align_kernels_bitwise_on_shallow_topologies(bonds):
    """K1 and K2 where the block leaves after 2 passes (receptor-ligand-
    receptor only) or after 1 (no bond), to the bit."""
    dev = _cuda()
    cfg = SimConfig()
    st = _strip(bonded_state(cfg, 1, seed=3, device=dev),
                cis_only=bonds == "trans_only")
    args = align_core_inputs(st, cfg)
    got = align_batched.align_core_batched(*args, cfg)
    _assert_bitwise(got, align_batched.align_core_batched_plain(*args, cfg))
    assert bool((got[2] == 1).any()) == (bonds == "trans_only")
    args2 = align_core_single_inputs(st, cfg)
    _assert_bitwise(k2.align_core_single(*args2, cfg),
                    k2.align_core_single_plain(*args2, cfg))


# ---------------------------------------------------------------------------
# K3, the lattice step

ALL_VARIANTS = {(h, r) for h in range(2) for r in range(4)}
DENSE = dict(density=0.15, ass_prob=0.3, diss_prob=0.1)
SATURATED = dict(density=0.5, ass_prob=0.9, diss_prob=0.5)


def _assert_k3_matches_plain(cfg, dev):
    """64 steps of K3 and of lattice_step from one state, equal to the bit
    at every step, all 8 variants seen.  Returns the largest species."""
    st = init_lattice(cfg, seed=11, device=dev)
    seen, top = set(), 0
    for i in range(64):
        seen.add(step_variant(st))
        before = k3.lattice_block_call.launches
        got = k3.pallas_lattice_step(st, cfg)
        assert k3.lattice_block_call.launches == before + 1
        want = lattice_step(st, cfg)
        assert torch.equal(got.grid, want.grid), i
        assert torch.equal(got.disp, want.disp), i
        assert int(got.step) == i + 1 and float(got.time) == i + 1.0
        top = max(top, int(got.grid.max()))
        st = got
    assert seen == ALL_VARIANTS
    assert int(st.grid.sum()) == int(init_lattice(cfg, seed=11,
                                                  device=dev).grid.sum())
    return top


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 64), (48, 48), (64, 96), (512, 512)])
def test_lattice_kernel_matches_plain(shape):
    """K3 against lattice_step on the card, to the bit, every step, over
    steps that cover all 8 (hop axis, reaction direction) variants."""
    dev = _cuda()
    _assert_k3_matches_plain(
        LatticeConfig(height=shape[0], width=shape[1], **DENSE), dev)


@pytest.mark.gpu
@pytest.mark.parametrize("setting", [
    # merge and split pairs on most cells: the lazily drawn hashes are
    # read often, and species up to 8 form
    dict(height=64, width=64, **SATURATED),
    # fewer rows than one tile, a width that is no multiple of 32
    dict(height=16, width=40, density=0.01),
    # smaller than the 40 x 40 frame: the wrap tables wrap several times
    dict(height=8, width=8, **SATURATED),
], ids=["saturated_64x64", "sparse_16x40", "saturated_8x8"])
def test_lattice_kernel_matches_plain_at_edge_settings(setting):
    """K3 to the bit where its lazily drawn hashes, its wrap tables and
    its edge tiles are all exercised, all 8 variants seen."""
    dev = _cuda()
    top = _assert_k3_matches_plain(LatticeConfig(**setting), dev)
    if setting["density"] == SATURATED["density"]:
        assert top >= 4                       # merges happened


@pytest.mark.gpu
def test_lattice_kernel_offset_block_matches_plain():
    """A block at a global origin of a larger grid, hashed and paired on
    global coordinates, as a shard of a halo step would be."""
    dev = _cuda()
    cfg = LatticeConfig(height=128, width=128, **DENSE)
    st = init_lattice(cfg.replace(height=40, width=72), seed=2, device=dev)
    g, d = st.grid, st.disp
    for i in range(16):
        step = torch.tensor(i, dtype=torch.int32, device=dev)
        got = k3.lattice_block_call(g, d, step, st.seed, cfg, -8, 100)
        want = lattice_step_arrays(g, d, step, st.seed, cfg, -8, 100)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        g, d = got


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 1)])
def test_lattice_kernel_on_halo_blocks_matches_plain(shape):
    """K3 on the halo-padded blocks of a grid cut over a rank grid, each
    at its negative global origin with full != block (on 1 x 1 the block
    is larger than the grid, as on one card's shard): every padded output
    equals the plain version's, and the cropped blocks put together equal
    whole-grid K3, every step, all 8 variants seen."""
    from kmc_tpu_torch.testing import step_halo_blocks

    dev = _cuda()
    cfg = LatticeConfig(height=64, width=64, **DENSE)
    st = init_lattice(cfg, seed=12, device=dev)
    seen = set()
    for i in range(64):
        seen.add(step_variant(st))
        before = k3.lattice_block_call.launches
        grid, disp, outs = step_halo_blocks(st, cfg, shape,
                                            k3.lattice_block_call)
        assert k3.lattice_block_call.launches == before + len(outs)
        _, _, plain = step_halo_blocks(st, cfg, shape, lattice_step_arrays)
        for (g, d), (pg, pd) in zip(outs, plain):
            assert torch.equal(g, pg) and torch.equal(d, pd), i
        st = k3.pallas_lattice_step(st, cfg)
        assert torch.equal(grid, st.grid) and torch.equal(disp, st.disp), i
    assert seen == ALL_VARIANTS


@pytest.mark.gpu
def test_sharded_lattice_step_on_card_matches_whole_grid():
    """make_sharded_lattice_step on one rank (a 1 x 1 grid) launches K3
    once a step on the padded block and equals the whole-grid chunk."""
    from kmc_tpu_torch.lattice.step import make_sharded_lattice_step
    from kmc_tpu_torch.parallel.halo import gather_lattice, shard_lattice
    from kmc_tpu_torch.parallel.mesh import grid_mesh

    dev = _cuda()
    cfg = LatticeConfig(height=96, width=64, **DENSE)
    mesh = grid_mesh((1, 1), dev)
    st = init_lattice(cfg, seed=6, device=dev)
    want = k3.make_pallas_lattice_chunk(cfg, 40)(st)
    step = make_sharded_lattice_step(cfg, mesh, chunk=20)
    before = k3.lattice_block_call.launches
    got = gather_lattice(step(step(shard_lattice(st, cfg, mesh))), cfg, mesh)
    assert k3.lattice_block_call.launches == before + 40
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.gpu
def test_lattice_card_matches_cpu():
    """K3 steps on the card equal the plain version on the CPU."""
    dev = _cuda()
    cfg = LatticeConfig(height=96, width=64, **DENSE)
    st = init_lattice(cfg, seed=4, device=dev)
    cpu = convert.lattice_from_numpy(convert.lattice_to_numpy(st))
    chunk = k3.make_pallas_lattice_chunk(cfg, 10)
    before = k3.lattice_block_call.launches
    st = chunk(st)
    assert k3.lattice_block_call.launches == before + 10
    for _ in range(10):
        cpu = lattice_step(cpu, cfg)
    for f in cpu._fields:
        assert torch.equal(getattr(st, f).cpu(), getattr(cpu, f)), f


@pytest.mark.gpu
def test_lattice_wrapper_raises_instead_of_falling_back():
    dev = _cuda()
    cfg = LatticeConfig(height=16, width=16)
    st = init_lattice(cfg, seed=0, device=dev)
    args = (st.grid, st.disp, st.step, st.seed)
    for bad_shape in ((15, 16), (16, 9)):
        with pytest.raises(ValueError, match="even"):
            k3.lattice_block_call(
                torch.zeros(bad_shape, dtype=torch.int32, device=dev),
                torch.zeros((*bad_shape, 2), dtype=torch.int32, device=dev),
                st.step, st.seed, cfg)
    with pytest.raises(TypeError):
        k3.lattice_block_call(args[0].long(), *args[1:], cfg)
    with pytest.raises(ValueError):
        k3.lattice_block_call(args[0], args[1], args[2].cpu(), args[3], cfg)
    with pytest.raises(ValueError, match="contiguous"):
        k3.lattice_block_call(args[0].t(), *args[1:], cfg)
    with pytest.raises(ValueError):
        k3.lattice_block_call(args[0], args[1][:8], *args[2:], cfg)


# ---------------------------------------------------------------------------
# Paths without a kernel of their own: the rejection-free lattice mode and
# the parameter sweep, on the card against the CPU


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["serial", "parallel", "greedy"])
def test_rejection_free_card_matches_cpu(mode):
    """200 serial events (or 40 batches of k = 64) at 32^2 on the card
    against the CPU from the same start, after every call: grid, disp and
    step equal, time within 1e-5 relative; a parting is admitted only at
    an ulp tie of the two best scores (testing.rf_tie).  No kernel of K1,
    K2 or K3 launches."""
    from kmc_tpu_torch.lattice.rejection_free import rf_batch_step, rf_step
    from kmc_tpu_torch.testing import rf_against_cpu

    dev = _cuda()
    cfg = LatticeConfig(height=32, width=32, hop_prob=0.3, ass_prob=0.4,
                        diss_prob=0.2)
    st = init_lattice(cfg, seed=3, n_particles=80, device=dev)
    counts = (align_batched.align_core_batched.launches,
              k2.align_core_single.launches, k3.lattice_block_call.launches)
    if mode == "serial":
        done, tie, _ = rf_against_cpu(lambda s: rf_step(s, cfg), st, cfg, 200)
        assert tie is not None or done == 200
    else:
        done, tie, _ = rf_against_cpu(
            lambda s: rf_batch_step(s, cfg, 64, 3, mode), st, cfg, 40, 64)
        assert tie is not None or done == 40
    assert done >= 20
    assert counts == (align_batched.align_core_batched.launches,
                      k2.align_core_single.launches,
                      k3.lattice_block_call.launches)


@pytest.mark.gpu
def test_sweep_step_on_card_matches_cpu():
    """The batched step_fn with a per-replica sweep: 3 card steps (K1 once
    a step, K2 never) equal the CPU path from the same state, topology and
    keys bitwise, poses within 1e-4 A."""
    from kmc_tpu_torch.engine.params import sweep

    dev = _cuda()
    st = bonded_state(SMALL, 8, seed=5, device=dev)
    over = dict(p_trans_ass=[0.0, 0.1, 0.4, 1.0] * 2,
                p_trans_diss=[0.0, 0.5] * 4,
                rb_a_d=[0.0] * 4 + [SMALL.rb_a_d] * 4)
    rp_dev = sweep(SMALL, 8, device=dev, **over)
    rp_cpu = sweep(SMALL, 8, device="cpu", **over)
    for i in range(3):
        cpu_in = convert.from_numpy(convert.to_numpy(st))
        k1_before = align_batched.align_core_batched.launches
        k2_before = k2.align_core_single.launches
        st, _ = step_fn(st, SMALL, device=dev, batched=True, rp=rp_dev)
        assert align_batched.align_core_batched.launches == k1_before + 1
        assert k2.align_core_single.launches == k2_before
        want, _ = step_fn(cpu_in, SMALL, device="cpu", batched=True,
                          rp=rp_cpu)
        for f in want._fields:
            got = getattr(st, f).cpu()
            if f in ("a_xy", "a_psi", "b_center", "b_quat"):
                assert float((got - getattr(want, f)).abs().max()) <= POS_TOL
            else:
                assert torch.equal(got, getattr(want, f)), (f, i)


@pytest.mark.gpu
def test_validation_driver_on_card_matches_cpu(tmp_path, monkeypatch):
    """The validation driver's lazy ensemble (SMALL, 8 replicas, 2 outputs
    of 10 steps) gives the CPU's kinetics series and histograms on the
    card, and the card's state file cut after output 1 resumes on the CPU
    to the same series."""
    import types

    import numpy as np

    from kmc_tpu_torch.scripts import validate_vs_reference as vv

    dev = _cuda()
    monkeypatch.setattr(vv, "run_config", lambda: SMALL.replace(out_every=10))

    def run(device, n_out, state_file=None):
        args = types.SimpleNamespace(
            replicas=8, seed=0, sub_chunks=2, align_mode="lazy",
            init_cpt=None, write_outputs=None, state_file=state_file,
            resume_state=True, device=device)
        return vv._run_ensemble(args, n_out, with_hist=True)

    before = align_batched.align_core_batched.launches
    card = run(dev.type, 2)
    assert align_batched.align_core_batched.launches == before + 20
    cpu = run("cpu", 2)
    sf = str(tmp_path / "state.npz")
    run(dev.type, 1, sf)
    resumed = run("cpu", 2, sf)
    for other in (cpu, resumed):
        for c in vv.KIN_COLS:
            np.testing.assert_array_equal(card[0][c], other[0][c], c)
        np.testing.assert_array_equal(card[1], other[1])
        np.testing.assert_array_equal(card[2], other[2])


@pytest.mark.gpu
def test_residual_overlap_on_card_matches_cpu():
    """measure_residual_overlap's run (SMALL with the unrolled cleanup, 4
    replicas, one chunk of 10 steps) launches K1 once a step on the card
    and gives the CPU's per-chunk count and final state: integer fields
    bitwise, poses within POS_TOL."""
    from kmc_tpu_torch.scripts import measure_residual_overlap as ro

    dev = _cuda()
    cfg = SMALL.replace(sweep_exact_cleanup=False)
    launches = align_batched.align_core_batched.launches
    replicas = align_batched.align_core_batched.replicas
    card, st = ro.measure(cfg, 4, 1, 10, device=dev)
    assert align_batched.align_core_batched.launches == launches + 10
    assert align_batched.align_core_batched.replicas == replicas + 40
    cpu, want = ro.measure(cfg, 4, 1, 10, device="cpu")
    assert card == cpu
    for f in want._fields:
        got = getattr(st, f).cpu()
        if f in ("a_xy", "a_psi", "b_center", "b_quat"):
            assert float((got - getattr(want, f)).abs().max()) <= POS_TOL, f
        else:
            assert torch.equal(got, getattr(want, f)), f


@pytest.mark.gpu
def test_distributed_e2e_on_card_matches_cpu(tmp_path):
    """The worker's production loop at W = 1 (SMALL, with the fused align
    that the card runs as K1 -- the worker's own configuration runs the
    unfused align; 4 replicas, 2 outputs of 10 steps) launches K1 once a
    step on the card and writes the CPU's rows, text-identical, and the
    CPU's shard: integer leaves bitwise, poses within POS_TOL."""
    import argparse

    import numpy as np

    from kmc_tpu_torch.scripts import distributed_worker as dw

    _cuda()
    launches = align_batched.align_core_batched.launches
    for where in ("cuda", "cpu"):
        dw.run_e2e(argparse.Namespace(
            out_dir=str(tmp_path / where), replicas_per_host=4, seed=0,
            outputs=2, out_every=10, resume=False, device=where),
            SMALL)
        if where == "cuda":
            assert align_batched.align_core_batched.launches == launches + 20
    card, cpu = tmp_path / "cuda", tmp_path / "cpu"
    assert ((card / "bond_ens.dat").read_text()
            == (cpu / "bond_ens.dat").read_text())
    with np.load(card / "checkpoint.shard0.npz") as zc, \
            np.load(cpu / "checkpoint.shard0.npz") as zp:
        assert sorted(zc.files) == sorted(zp.files)
        fields = {f"leaf{i}": f for i, f in enumerate(
            ("a_xy", "a_psi", "b_center", "b_quat"))}
        for k in zp.files:
            if k in fields:
                assert np.abs(zc[k] - zp[k]).max() <= POS_TOL, fields[k]
            else:
                np.testing.assert_array_equal(zc[k], zp[k], k)


@pytest.mark.gpu
def test_bench_on_card_matches_cpu(monkeypatch):
    """bench.py's run (SMALL, 4 lazy replicas, a warm-up and one timed
    chunk of 5 steps) launches K1 once a step on the card and leaves the
    CPU's state: integer fields bitwise, poses within POS_TOL."""
    from kmc_tpu_torch.scripts import bench

    dev = _cuda()
    monkeypatch.setattr(bench, "SimConfig", lambda: SMALL)
    launches = align_batched.align_core_batched.launches
    steps, _, st = bench.measure(4, 5, 1, "lazy", dev)
    assert align_batched.align_core_batched.launches == launches + 10
    assert steps == 20
    _, _, want = bench.measure(4, 5, 1, "lazy", torch.device("cpu"))
    for f in want._fields:
        got = getattr(st, f).cpu()
        if f in ("a_xy", "a_psi", "b_center", "b_quat"):
            assert float((got - getattr(want, f)).abs().max()) <= POS_TOL, f
        else:
            assert torch.equal(got, getattr(want, f)), f


@pytest.mark.gpu
def test_weak_scaling_on_card_matches_cpu(tmp_path):
    """weak_scaling's one-rank size on the card (SMALL, 4 replicas, a
    warm-up and one timed chunk of 5 eager steps, NCCL group of one)
    leaves the block of a gloo rank on the CPU: integer leaves bitwise,
    poses within POS_TOL."""
    import numpy as np

    from kmc_tpu_torch.scripts import weak_scaling
    from kmc_tpu_torch.state import SimState

    _cuda()
    for where in ("cuda", "cpu"):
        rows = weak_scaling.run_sizes([1], 4, 5, 1, where, cfg=SMALL,
                                      work_dir=str(tmp_path / where),
                                      save_state=True)
        assert rows[0]["replicas"] == 4 and rows[0]["efficiency"] == 1.0
    poses = {f"leaf{SimState._fields.index(f)}"
             for f in ("a_xy", "a_psi", "b_center", "b_quat")}
    with np.load(tmp_path / "cuda" / "n1" / "rank0.npz") as zc, \
            np.load(tmp_path / "cpu" / "n1" / "rank0.npz") as zp:
        assert sorted(zc.files) == sorted(zp.files)
        for k in zp.files:
            if k in poses:
                assert np.abs(zc[k] - zp[k]).max() <= POS_TOL, k
            else:
                np.testing.assert_array_equal(zc[k], zp[k], k)


@pytest.mark.gpu
@pytest.mark.parametrize("script", ["receptors_probe", "chan_flux"])
def test_flux_diagnostics_on_card_matches_cpu(script):
    """The flux diagnostics' ensembles at their own configurations, with
    the fused align (K1 on the card), 4 replicas, 10 steps: the probe's
    random start at probe_config(), and chan_flux's 8 preformed complexes
    at our_config(10.0).  K1 launches once a step; the diag series and
    the integer fields of the final state equal the CPU's; positions
    within max(4 ulp of |x| an align pass, POS_TOL) (one ulp is 1.2e-4 A
    at |x| > 1024 A, and the mini box reaches 1,490 A; the preformed
    complexes take two passes a step, the probe's free receptors one),
    angles and quaternions within POS_TOL."""
    import numpy as np

    from kmc_tpu_torch.scripts import chan_flux as cf
    from kmc_tpu_torch.scripts import mini_golden as mg
    from kmc_tpu_torch.scripts import receptors_probe as rp

    dev = _cuda()
    if script == "receptors_probe":
        cfg, init, ulps = rp.probe_config(), None, 4
    else:
        cfg = mg.our_config(10.0)
        init, ulps = cf.build_preformed(cfg, 8), 8
    assert cfg.fused_align
    runs = {}
    for where in (dev, torch.device("cpu")):
        launches = align_batched.align_core_batched.launches
        state = cf.start_state(cfg, 4, 7, init, where)
        runs[where.type] = cf.diag_series(state, cfg, 2, 5, where)
        if where.type == "cuda":
            assert align_batched.align_core_batched.launches == launches + 10
    (card, st), (cpu, want) = runs["cuda"], runs["cpu"]
    for i, (c, p) in enumerate(zip(card, cpu)):
        assert sorted(c) == sorted(p)
        for k in p:
            np.testing.assert_array_equal(c[k], p[k], f"{k} output {i}")
    for f in want._fields:
        got, ref = getattr(st, f).cpu(), getattr(want, f)
        if f in ("a_xy", "b_center"):
            ulp = torch.nextafter(ref.abs(), torch.full_like(ref, 1e9)) \
                - ref.abs()
            assert bool(((got - ref).abs()
                         <= torch.clamp(ulps * ulp, min=POS_TOL)).all()), f
        elif f in ("a_psi", "b_quat"):
            assert float((got - ref).abs().max()) <= POS_TOL, f
        else:
            assert torch.equal(got, ref), f
