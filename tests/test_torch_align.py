"""Port parity for the idealize stage and its kernel K1.

* The plain version of K1 (kmc_tpu_torch.ops.align_batched) against the
  JAX package's Pallas kernel (align_core_batched, interpret mode, as
  tests/test_pallas_align.py runs it) on the same inputs, B = 10 replicas
  (which exercises the Pallas kernel's padding to its 8-replica block):
  positions within 1e-4 A, directions and quaternions within 1e-5, snap
  and b_laid codes exact.
* idealize_fused and idealize of the port against kmc_tpu's on the same
  states and keys, with the same tolerances.

The CUDA kernel is held against the plain version on the card by
tests/test_torch_kernels.py.

The bonded fixtures sit near the origin, as the JAX suite's do.  The
tolerances are absolute, and a snapped chain far from the origin carries
float32 cancellation in its (site - bead) directions: for the long chain
rooted at (330, 120) A instead of the origin, kmc_tpu's own fused and
unfused idealize already differ by 2.4e-4 A.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmc_tpu import rng as jrng
from kmc_tpu.engine.align import (_choose_roots as j_choose_roots,
                                  idealize as j_idealize,
                                  idealize_fused as j_idealize_fused)
from kmc_tpu.engine.clusters import cluster_labels as j_labels
from kmc_tpu.ops.pallas_align_batched import align_core_batched as j_core
from kmc_tpu_torch import convert
from kmc_tpu_torch import rng as trng
from kmc_tpu_torch.engine.align import idealize as t_idealize
from kmc_tpu_torch.engine.align import idealize_fused as t_idealize_fused
from kmc_tpu_torch.engine.clusters import cluster_labels as t_labels
from kmc_tpu_torch.ops import align_batched, build

from test_torch_clusters import (BONDED_FIXTURES, jax_fields, long_chain,
                                 loose_cis, loose_trans, merged_complex,
                                 port_cfg, stack_fields, unlaid_ligand)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_cache_small_torch():
    """Keep this module's JAX compiles out of the persistent cache (and so
    out of the tree), and keep torch to two threads per test worker."""
    from jax._src import compilation_cache

    was = jax.config.jax_enable_compilation_cache
    threads = torch.get_num_threads()
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


POS_TOL, ANG_TOL = 1e-4, 1e-5     # the JAX suite's fused-vs-XLA tolerances
STEP = 7


def _ten_states(cfg):
    """Ten bonded fixtures: the shared six and four reseeded variants."""
    return ([b(cfg) for b in BONDED_FIXTURES]
            + [loose_trans(cfg, 7), unlaid_ligand(cfg, 8), loose_cis(cfg, 9),
               merged_complex(cfg, 10)])


def core_inputs(cfg, states):
    """K1's inputs for each state, as numpy: roots from kmc_tpu's root
    choice with the align stream of step STEP, act = cluster size > 1."""
    rows = []
    for st in states:
        info = j_labels(st, cfg)
        skey = jrng.stream_key(jrng.step_key(st.key, STEP), jrng.STREAM_ALIGN)
        root = np.asarray(j_choose_roots(st, info, skey, cfg)).astype(np.int32)
        f = jax_fields(st)
        psi = f["a_psi"].astype(np.float32)
        rows.append((f["a_xy"], np.stack([np.cos(psi), np.sin(psi)], -1),
                     f["b_center"], f["b_quat"], f["a_trans"], f["a_site"],
                     f["a_cis"], f["b_partner"], f["b_laid"].astype(np.int32),
                     root, (np.asarray(info.size) > 1).astype(np.int32)))
    return [np.ascontiguousarray(np.stack(col)) for col in zip(*rows)]


def assert_core_close(got, want):
    names = ("a_xy", "a_dir", "snap", "b_center", "b_quat", "b_laid")
    tols = (POS_TOL, ANG_TOL, None, POS_TOL, ANG_TOL, None)
    for name, g, w, tol in zip(names, got, want, tols):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        if tol is None:
            np.testing.assert_array_equal(g, w, name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


def test_plain_core_matches_pallas_kernel(small_cfg):
    cfg = small_cfg
    states = _ten_states(cfg)
    args = core_inputs(cfg, states)
    want = j_core(*map(jnp.asarray, args), None, cfg, interpret=True)
    got = align_batched.align_core_batched_plain(*map(torch.from_numpy, args),
                                                 port_cfg(cfg))
    assert_core_close(got, want)
    # the fixtures reach every branch: trans and cis seats, re-seats,
    # lay-downs and unreached chain tails
    snap, b_laid = got[2].numpy(), got[5].numpy()
    assert (snap == 1).any() and (snap == 2).any() and (b_laid >= 2).any()


def test_wrapper_uses_plain_version_on_cpu(small_cfg):
    args = [torch.from_numpy(a) for a in core_inputs(small_cfg,
                                                     [merged_complex(small_cfg)])]
    before = align_batched.align_core_batched.launches
    got = align_batched.align_core_batched(*args, port_cfg(small_cfg))
    want = align_batched.align_core_batched_plain(*args, port_cfg(small_cfg))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert align_batched.align_core_batched.launches == before


def test_wrapper_rejects_bad_inputs(small_cfg):
    cfg = port_cfg(small_cfg)
    args = [torch.from_numpy(a) for a in core_inputs(small_cfg,
                                                     [loose_cis(small_cfg)])]
    align_batched._check_inputs(args, cfg)
    bad_dtype = list(args)
    bad_dtype[4] = args[4].to(torch.int64)
    with pytest.raises(TypeError):
        align_batched._check_inputs(bad_dtype, cfg)
    bad_shape = list(args)
    bad_shape[9] = args[9][:, :-1]
    with pytest.raises(ValueError):
        align_batched._check_inputs(bad_shape, cfg)
    strided = list(args)
    strided[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        align_batched._check_inputs(strided, cfg)
    with pytest.raises(ValueError):
        align_batched.align_core_batched(*[a.to("meta") for a in args], cfg)


def _state_batch(cfg):
    states = [loose_trans(cfg), unlaid_ligand(cfg), loose_cis(cfg),
              merged_complex(cfg), long_chain(cfg)]
    return states, convert.from_numpy(stack_fields(states))


def _assert_state_close(got, want):
    np.testing.assert_allclose(got.a_xy.numpy(), want["a_xy"], atol=POS_TOL)
    np.testing.assert_allclose(got.a_psi.numpy(), want["a_psi"], atol=ANG_TOL)
    np.testing.assert_allclose(got.b_center.numpy(), want["b_center"],
                               atol=POS_TOL)
    np.testing.assert_allclose(got.b_quat.numpy(), want["b_quat"],
                               atol=ANG_TOL)
    np.testing.assert_array_equal(got.b_laid.numpy(), want["b_laid"])
    np.testing.assert_array_equal(got.dirty.numpy(), want["dirty"])


@pytest.mark.parametrize("fused", [True, False])
def test_idealize_matches(small_cfg, fused):
    """Port idealize_fused / idealize against kmc_tpu's on the same states
    and keys, collision revert and dirty flag included."""
    cfg = small_cfg
    tcfg = port_cfg(cfg)
    states, ts = _state_batch(cfg)
    skey = trng.stream_key(trng.step_key(ts.key, STEP), trng.STREAM_ALIGN)
    t_fn = t_idealize_fused if fused else t_idealize
    out = t_fn(ts, t_labels(ts, tcfg), skey, tcfg)
    for r, st in enumerate(states):
        jkey = jrng.stream_key(jrng.step_key(st.key, STEP), jrng.STREAM_ALIGN)
        info = j_labels(st, cfg)
        if fused:
            js = j_idealize_fused(st, info, jkey, cfg, interpret=True)
        else:
            js = j_idealize(st, info, jkey, cfg)
        _assert_state_close(type(out)(*(x[r:r + 1] for x in out)),
                            {k: v[None] for k, v in jax_fields(js).items()})


def test_ptxas_summary_parses_report():
    report = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_120align_batched_kernelE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 564 bytes cmem[0]\n")
    lines = build.ptxas_summary(report)
    assert lines == ["_ZN12_GLOBAL__N_120align_batched_kernelE: "
                     "Used 40 registers, 564 bytes cmem[0]"]


def test_source_hash_covers_sources():
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()
    assert any(p.endswith("align_batched.cu") for p in build._sources())
