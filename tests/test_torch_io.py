"""The port's I/O (kmc_tpu_torch.io) held against kmc_tpu.io.

* Writers: from one bridged state, bond.dat, test.gro, cluster.log,
  hist.dat, parameter.log and position.cpt are byte-identical to
  kmc_tpu's.  test.gro is compared once per formatter: the port's Python
  formatter against kmc_tpu's Python one, and the port's binding of its
  copy of the codec (kmc_tpu_torch/csrc/kmcio.cpp) against kmc_tpu's
  native/kmcio.cpp (skipped where g++ is missing, as
  tests/test_native_io.py skips).
* ``load_reference_cpt`` of the committed reference checkpoint equals
  kmc_tpu's, field by field.
* Native checkpoints (single trajectory and ensemble) written by either
  package are read by the other, and the states are equal.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from kmc_tpu.engine.step import make_step_fn as j_make_step_fn
from kmc_tpu.io import checkpoint as jck
from kmc_tpu.io import native as jnative
from kmc_tpu.io import writers as jw
from kmc_tpu.parallel.ensemble import init_ensemble as j_init_ensemble
from kmc_tpu.parallel.ensemble import make_ensemble_step as j_eager_step
from kmc_tpu.state import positions as j_positions
from kmc_tpu_torch import convert
from kmc_tpu_torch.engine.observables import Observables
from kmc_tpu_torch.io import checkpoint as tck
from kmc_tpu_torch.io import native as tnative
from kmc_tpu_torch.io import writers as tw

from test_torch_clusters import jax_fields, merged_complex, port_cfg
from test_torch_ensemble import bonded_start, dense_cfg

REF_CPT = os.path.join(os.path.dirname(__file__), "data", "ref_position.cpt")


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


@functools.lru_cache(maxsize=None)
def _step_fn(cfg):
    return j_make_step_fn(cfg)


def _stepped(cfg, start, n):
    """kmc_tpu state and observables after n steps from ``start``."""
    step = _step_fn(cfg)
    st, obs = start, None
    for _ in range(n):
        st, obs = step(st)
    return st, obs


def _bridge(js, jobs):
    ts = convert.from_numpy(jax_fields(js), batched=False)
    tobs = Observables(*(torch.from_numpy(np.array(x)[None]) for x in jobs))
    return ts, tobs


@functools.lru_cache(maxsize=None)
def _states():
    """(name, JAX config, JAX state, JAX observables): a bonded dense state
    after 12 steps, and a merged complex in small_cfg's box."""
    dense = dense_cfg()
    small = dense.replace(cell_range_x=2000.0, cell_range_y=2000.0,
                          cell_range_z=600.0)
    return [("dense", dense, *_stepped(dense, bonded_start(dense, 2), 12)),
            ("merged", small, *_stepped(small, merged_complex(small), 1))]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("which", [0, 1])
def test_writers_byte_identical(tmp_path, which):
    name, cfg, js, jobs = _states()[which]
    tcfg = port_cfg(cfg)
    ts, tobs = _bridge(js, jobs)
    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    td.mkdir()
    jw.write_parameter_log(str(jd / "parameter.log"), cfg)
    tw.write_parameter_log(str(td / "parameter.log"), tcfg)
    for _ in range(2):                  # appended rows, as a run appends
        jw.append_bond_dat(str(jd / "bond.dat"), jobs)
        tw.append_bond_dat(str(td / "bond.dat"), tobs)
        jw.append_gro_frame(str(jd / "test.gro"), js, cfg)
        tw.append_gro_frame(str(td / "test.gro"), ts, tcfg)
        jw.append_cluster_log(str(jd / "cluster.log"), js, cfg)
        tw.append_cluster_log(str(td / "cluster.log"), ts, tcfg)
        jw.append_hist(str(jd / "hist.dat"), js, cfg)
        tw.append_hist(str(td / "hist.dat"), ts, tcfg)
    jck.save_reference_cpt(str(jd / "position.cpt"), js, cfg)
    tck.save_reference_cpt(str(td / "position.cpt"), ts, tcfg)
    for f in ("parameter.log", "bond.dat", "test.gro", "cluster.log",
              "hist.dat", "position.cpt"):
        assert _read(td / f) == _read(jd / f), f"{f} ({name})"
    # the state had bonds and multi-member clusters to write
    assert int(jobs.bond_num) > 0
    assert any(len(r) > 1 for r in tw.bfs_clusters(ts, tcfg))


def test_native_gro_byte_identical(tmp_path):
    if not (jnative.available() and tnative.available()):
        pytest.skip("native toolchain unavailable")
    _, cfg, js, _ = _states()[0]
    ts = convert.from_numpy(jax_fields(js), batched=False)
    pos_j = np.asarray(j_positions(js, cfg))
    pos_t = tck.host_positions(ts, port_cfg(cfg))
    np.testing.assert_array_equal(pos_t, pos_j)
    box = (cfg.cell_range_x, cfg.cell_range_y, cfg.cell_range_z)
    t = (int(js.step) - 1) * cfg.time_step
    assert (tnative.format_gro(pos_t, cfg.n_a, cfg.n_b, t, box)
            == jnative.format_gro(pos_j, cfg.n_a, cfg.n_b, t, box))
    # the async writer persists every frame it is handed, in order
    path = str(tmp_path / "frames.gro")
    frames = [tnative.format_gro(pos_t, cfg.n_a, cfg.n_b, t + k, box)
              for k in range(3)]
    with tnative.AsyncWriter(path) as w:
        for fr in frames:
            w.append(fr)
    assert _read(path) == b"".join(frames)


@pytest.mark.parametrize("use_native", [False, True])
def test_output_set_matches(tmp_path, use_native):
    """OutputSet from the same states: every file byte-identical, with the
    Python formatter and with the native codec."""
    if use_native and not (jnative.available() and tnative.available()):
        pytest.skip("native toolchain unavailable")
    _, cfg, js, jobs = _states()[0]
    tcfg = port_cfg(cfg)
    jo = jw.OutputSet(str(tmp_path / "jax"), cfg, use_native=use_native)
    to = tw.OutputSet(str(tmp_path / "port"), tcfg, use_native=use_native)
    for k in range(2):
        js, jobs = _stepped(cfg, js, 3)
        jo(js, jobs)
        to(*_bridge(js, jobs))
    jo.close()
    to.close()
    for f in ("parameter.log", "bond.dat", "test.gro", "cluster.log",
              "hist.dat", "position.cpt"):
        assert (_read(tmp_path / "port" / f) == _read(tmp_path / "jax" / f)), f


def test_ensemble_output_set_matches(tmp_path):
    cfg = dense_cfg()
    js = j_init_ensemble(cfg, 3, seed=4)
    js, jobs = j_eager_step(cfg, donate=False)(js)
    ts = convert.from_numpy(jax_fields(js))
    tobs = Observables(*(torch.from_numpy(np.array(x)) for x in jobs))
    jo = jw.EnsembleOutputSet(str(tmp_path / "jax"), cfg)
    to = tw.EnsembleOutputSet(str(tmp_path / "port"), port_cfg(cfg))
    jo(js, jobs)
    to(ts, tobs)
    jo.close()
    to.close()
    for f in ("bond_ens.dat", "bond.dat", "test.gro", "cluster.log",
              "position.cpt"):
        assert (_read(tmp_path / "port" / f) == _read(tmp_path / "jax" / f)), f


def test_load_reference_cpt_matches(ref_cfg):
    js = jck.load_reference_cpt(REF_CPT, ref_cfg, seed=3)
    ts = tck.load_reference_cpt(REF_CPT, port_cfg(ref_cfg), seed=3,
                                device="cpu")
    want = jax_fields(js)
    for f in ts._fields:
        got = getattr(ts, f)[0].numpy()
        np.testing.assert_array_equal(got.astype(want[f].dtype), want[f], f)
    assert int(ts.a_trans.ge(0).sum()) > 0          # the file has bonds


def _assert_fields_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for f, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[f]).astype(w.dtype), w, f)


def test_native_checkpoint_read_by_both(tmp_path):
    # single trajectory: JAX writes, the port reads, and back
    cfg = dense_cfg()
    js, _ = _stepped(cfg, bonded_start(cfg, 0), 3)
    p = str(tmp_path / "j.npz")
    jck.save_native(p, js)
    ts = tck.load_native(p, device="cpu")
    assert ts.step.shape == (1,)
    _assert_fields_equal(convert.to_numpy(ts, batched=False), jax_fields(js))
    q = str(tmp_path / "t.npz")
    tck.save_native(q, ts)
    _assert_fields_equal(jax_fields(jck.load_native(q)), jax_fields(js))
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k

    # ensemble: the replica axis is kept
    je = j_init_ensemble(cfg, 3, seed=1)
    jck.save_native(p, je)
    te = tck.load_native(p, device="cpu")
    _assert_fields_equal(convert.to_numpy(te), jax_fields(je))
    tck.save_native(q, te, batched=True)
    _assert_fields_equal(jax_fields(jck.load_native(q)), jax_fields(je))
    with pytest.raises(ValueError, match="batched=True"):
        tck.save_native(q, te)


def test_load_native_defaults_to_cuda(tmp_path):
    cfg = dense_cfg()
    p = str(tmp_path / "j.npz")
    jck.save_native(p, bonded_start(cfg, 0))
    if torch.cuda.is_available():
        assert tck.load_native(p).a_xy.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tck.load_native(p)
