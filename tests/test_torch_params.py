"""The port's runtime parameters (kmc_tpu_torch/engine/params.py) and the
``rp`` / ``diag`` arguments they feed, held against kmc_tpu on the CPU.

* ``RuntimeParams``, ``from_config`` and ``sweep`` equal kmc_tpu's, field
  for field and bit for bit.
* ``step_fn`` with ``rp=from_config(cfg)`` (0-d leaves) or an
  override-free ``sweep`` ([R] leaves) gives the bits of ``rp=None``.
* A 4-replica sweep through the port's batched ``step_fn`` against
  ``jax.vmap(step_fn)`` with the same sweep, teacher-forced over 5 steps
  from bonded starts (``fused_align=False``: off a TPU kmc_tpu runs the
  unfused idealize): topology, flags and keys bitwise, poses within
  1e-4 A, as tests/test_torch_step.py holds a step.
* kmc_tpu's tests/test_params.py cases ``test_rate_sweep_changes_kinetics``
  and ``test_frozen_diffusion_sweep`` on the port.
* ``rng.tiny_bernoulli`` with a [R] tensor ``p`` gives the bits of R
  calls with floats.
* ``step_fn_diag``'s counts (residual_overlap included) equal kmc_tpu's
  ``vmap(step_fn_diag)`` over 5 teacher-forced steps, and its state is
  ``step_fn``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmc_tpu import rng as jrng
from kmc_tpu.engine import params as jparams
from kmc_tpu.engine.step import step_fn as j_step_fn
from kmc_tpu.engine.step import step_fn_diag as j_step_fn_diag
import kmc_tpu_torch
from kmc_tpu_torch import convert
from kmc_tpu_torch import rng as trng
from kmc_tpu_torch.engine import params as tparams
from kmc_tpu_torch.engine.step import step_fn_diag

from helpers import ideal_cis_pair
from test_torch_clusters import jax_fields, port_cfg
from test_torch_ensemble import (assert_states_match, bonded_start,
                                 dense_cfg, jax_batch)

N_REP = 4
SWEEP = dict(
    p_trans_ass=[0.0, 0.4, 1.0, 0.04],
    p_trans_diss=[0.0, 0.5, 1.0, 3.48e-12],
    p_mono_cis_ass=[1.0, 0.0, 0.3, 4.7e-4],
    p_cis_ass=[0.0, 1.0, 0.5, 9.6e-3],
    p_cis_diss=[0.5, 0.0, 1.0, 1.12e-12],
    rb_a_d=[0.0, 40.0, 80.0, 20.0],
    bond_rot_d=[0.0, 0.002, 0.01, 0.004],
)


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


def _as_numpy(rp):
    return {f: np.asarray(getattr(rp, f)) for f in rp._fields}


def _j_sweep(cfg, n):
    return jparams.sweep(cfg, n, **{k: jnp.asarray(v, jnp.float32)
                                    for k, v in SWEEP.items()})


def _t_sweep(cfg, n):
    return tparams.sweep(port_cfg(cfg), n, device="cpu", **SWEEP)


def assert_same_bits(a, b, where=""):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{f} {where}"


def test_runtime_params_match(small_cfg):
    tcfg = port_cfg(small_cfg)
    assert tparams.RuntimeParams._fields == jparams.RuntimeParams._fields
    assert kmc_tpu_torch.RuntimeParams is tparams.RuntimeParams
    want = _as_numpy(jparams.from_config(small_cfg))
    got = tparams.from_config(tcfg, device="cpu")
    for f, w in want.items():
        g = getattr(got, f)
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_array_equal(g.numpy(), w, f)
    want = _as_numpy(_j_sweep(small_cfg, N_REP))
    got = _t_sweep(small_cfg, N_REP)
    for f, w in want.items():
        g = getattr(got, f)
        assert g.dtype == torch.float32 and g.shape == (N_REP,)
        np.testing.assert_array_equal(g.numpy(), w, f)
    with pytest.raises(ValueError, match="p_trans_ass"):
        tparams.sweep(tcfg, N_REP, device="cpu", p_trans_ass=[0.1, 0.2])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tparams.from_config(tcfg)


@pytest.mark.parametrize("form", ["single_from_config", "batched_from_config",
                                  "batched_sweep"])
def test_default_params_match_config(form):
    """rp holding the config's own values gives the bits of rp=None, over
    8 free-running steps from a bonded dense start (trans and cis bonds
    form and break there)."""
    cfg = dense_cfg()
    tcfg = port_cfg(cfg)
    n = 1 if form.startswith("single") else N_REP
    fields = jax_fields(jax_batch([bonded_start(cfg, r) for r in range(n)]))
    st = convert.from_numpy(fields)
    rp = (tparams.from_config(tcfg, device="cpu") if "from_config" in form
          else tparams.sweep(tcfg, n, device="cpu"))
    step = kmc_tpu_torch.make_step_fn(tcfg, device="cpu")
    batched = n > 1
    a = b = st
    for i in range(8):
        if batched:
            a, oa = kmc_tpu_torch.step_fn(a, tcfg, "cpu", batched=True)
            b, ob = kmc_tpu_torch.step_fn(b, tcfg, "cpu", batched=True,
                                          rp=rp)
        else:
            a, oa = step(a)
            b, ob = step(b, rp)
        assert_same_bits(a, b, f"step {i}")
        assert_same_bits(oa, ob, f"obs step {i}")


def _cis_encounter(cfg, r):
    """bonded_start plus an unbonded ideal cis pair (receptors 5, 6) nudged
    2 A inside the 15 A gate: both cis channels have candidates."""
    st = ideal_cis_pair(bonded_start(cfg, r), 5, 6, cfg, xy=(0.0, 0.0),
                        psi=0.3 * r)
    ux = jnp.stack([jnp.cos(st.a_psi[5]), jnp.sin(st.a_psi[5])])
    return st._replace(a_xy=st.a_xy.at[6].add(2.0 * ux))


def _teacher_forced(cfg, jstep, tstep, steps, check, start=bonded_start):
    """Carry the JAX batch into the port at every step; both take one step
    and ``check(jax_out, port_out, i)`` compares them."""
    js = jax_batch([start(cfg, r) for r in range(N_REP)])
    for i in range(steps):
        ts = convert.from_numpy(jax_fields(js))
        jout = jstep(js)
        check(jout, tstep(ts), i)
        js = jout[0]


def test_sweep_step_matches_jax_vmap(small_cfg):
    cfg = small_cfg.replace(fused_align=False)
    tcfg = port_cfg(cfg)
    jrp, trp = _j_sweep(cfg, N_REP), _t_sweep(cfg, N_REP)
    jstep = jax.jit(jax.vmap(lambda s, r: j_step_fn(s, cfg, r)))
    seen = {"bonds": set()}

    def check(jout, tout, i):
        want = jax_fields(jout[0])
        assert_states_match(tout[0], want, f"step {i}")
        seen["bonds"].update(map(int, np.asarray(jout[1].bond_num)))

    _teacher_forced(cfg, lambda s: jstep(s, jrp),
                    lambda s: kmc_tpu_torch.step_fn(s, tcfg, "cpu",
                                                    batched=True, rp=trp),
                    5, check)
    assert len(seen["bonds"]) > 1          # the replicas' kinetics differ


def test_rate_sweep_changes_kinetics(small_cfg):
    """Replicas with mono-cis rate 0 never bond; rate-1 replicas do, all in
    one batched step (kmc_tpu's tests/test_params.py case)."""
    from kmc_tpu.parallel.ensemble import init_ensemble as j_init_ensemble

    cfg = small_cfg
    tcfg = port_cfg(cfg)
    one = ideal_cis_pair(jax.tree.map(lambda x: x[0],
                                      j_init_ensemble(cfg, 1, seed=0)),
                         0, 1, cfg)
    fields = jax_fields(one)
    st = kmc_tpu_torch.init_ensemble(tcfg, N_REP, seed=0, device="cpu")
    st = st._replace(**{
        f: torch.from_numpy(np.array(fields[f])).to(
            getattr(st, f).dtype).expand_as(getattr(st, f)).clone()
        for f in st._fields if f != "key"})
    # nudge A1 toward A0 so the site gap is strictly inside the 15 A gate,
    # and freeze diffusion so the move phase keeps the geometry
    ux = torch.stack([torch.cos(st.a_psi[:, 0]), torch.sin(st.a_psi[:, 0])],
                     -1)
    a_xy = st.a_xy.clone()
    a_xy[:, 1] += 2.0 * ux
    st = st._replace(a_xy=a_xy)
    zeros = [0.0] * N_REP
    rp = tparams.sweep(tcfg, N_REP, device="cpu",
                       p_mono_cis_ass=[0.0, 0.0, 1.0, 1.0], rb_a_d=zeros,
                       rb_a_rot_d=zeros, rb_b_d=zeros, rb_b_rot_d=zeros)
    st2, _ = kmc_tpu_torch.step_fn(st, tcfg, "cpu", batched=True, rp=rp)
    assert st2.a_cis[:, 0].tolist() == [-1, -1, 1, 1]


def test_frozen_diffusion_sweep(small_cfg):
    """rb_a_d = 0 replicas keep receptors still; others move."""
    cfg = port_cfg(small_cfg)
    base = kmc_tpu_torch.init_ensemble(cfg, 2, seed=1, device="cpu")
    rp = tparams.sweep(cfg, 2, device="cpu", rb_a_d=[0.0, cfg.rb_a_d],
                       rb_a_rot_d=[0.0, cfg.rb_a_rot_d])
    st2, _ = kmc_tpu_torch.step_fn(base, cfg, "cpu", batched=True, rp=rp)
    d = (st2.a_xy - base.a_xy).abs().amax(dim=(1, 2))
    assert float(d[0]) == 0.0
    assert float(d[1]) > 0.0


P_VALUES = [0.0, 1e-12, 3.7e-7, 0.5, 1.0]


def test_tiny_bernoulli_tensor_p():
    """A [R] tensor p (and a 0-d one) gives, replica by replica, the bits
    of calls with the float; the float path equals kmc_tpu's."""
    keys = trng.replica_key(trng.key_from_seed(3),
                            torch.arange(len(P_VALUES)))
    shape = (4096,)
    got = trng.tiny_bernoulli(keys, torch.tensor(P_VALUES,
                                                 dtype=torch.float32), shape)
    assert got.shape == (len(P_VALUES), *shape)
    for r, p in enumerate(P_VALUES):
        one = trng.tiny_bernoulli(keys[r], float(np.float32(p)), shape)
        assert torch.equal(got[r], one), p
        zero_d = trng.tiny_bernoulli(keys[r], torch.tensor(p), shape)
        assert torch.equal(zero_d, one), p
        jkey = jax.random.wrap_key_data(
            jnp.asarray(keys[r].numpy().astype(np.uint32)))
        want = np.asarray(jrng.tiny_bernoulli(jkey, jnp.float32(p), shape))
        np.testing.assert_array_equal(one.numpy(), want, str(p))
    assert not got[0].any() and got[4].all()
    assert 0 < int(got[3].sum()) < shape[0]


def test_step_fn_diag_matches_jax():
    cfg = dense_cfg().replace(fused_align=False)
    tcfg = port_cfg(cfg)
    jrp, trp = _j_sweep(cfg, N_REP), _t_sweep(cfg, N_REP)
    jstep = jax.jit(jax.vmap(lambda s, r: j_step_fn_diag(s, cfg, r)))
    totals = {}

    def tstep(s):
        out = step_fn_diag(s, tcfg, "cpu", batched=True, rp=trp)
        plain = kmc_tpu_torch.step_fn(s, tcfg, "cpu", batched=True, rp=trp)
        assert_same_bits(out[0], plain[0])
        assert_same_bits(out[1], plain[1])
        return out

    def check(jout, tout, i):
        assert_states_match(tout[0], jax_fields(jout[0]), f"step {i}")
        jdg, tdg = jout[2], tout[2]
        assert sorted(tdg) == sorted(jdg)
        for k, v in jdg.items():
            assert tdg[k].dtype == torch.int32 and tdg[k].shape == (N_REP,)
            np.testing.assert_array_equal(tdg[k].numpy(), np.asarray(v),
                                          f"{k} step {i}")
            totals[k] = totals.get(k, 0) + int(np.asarray(v).sum())

    _teacher_forced(cfg, lambda s: jstep(s, jrp), tstep, 5, check,
                    start=_cis_encounter)
    # the window exercised the trans, mono-cis and dissociation counts
    for k in ("elig_trans", "acc_trans", "elig_mono", "acc_mono",
              "dis_trans"):
        assert totals[k] > 0, (k, totals)
