"""The port's rejection-free lattice mode
(kmc_tpu_torch/lattice/rejection_free.py) held against kmc_tpu's on the
CPU, on inputs made from numpy seeds.

* ``event_rates`` bitwise at 8^2 (every cell occupied), 16^2 and 32^2,
  with species up to MAX_SPECIES; kmc_tpu's hand-made rate case.
* Gumbel fields: float32 ``log`` of XLA's CPU backend and of torch differ
  by one ulp for some arguments, so the fields are held within one ulp of
  each of their two logs, |d| <= ulp(g) + 2^-23 (measured: about 23 % of
  the cells differ, never by more); the port's eight channels drawn in one
  call equal eight calls bitwise.
* Selection and update on kmc_tpu's own scores (``_select`` +
  ``_apply``): the chosen flat indices, grid, disp and step bitwise along
  a kmc_tpu trajectory, for ``rf_step`` and for ``rf_batch_step`` under
  both thinning rules (and with fewer live candidates than k, where
  -inf scores tie); time within 1e-6 relative (a float32 sum of the rates
  and one log).
* The top-k order on a hand-made vector with finite and -inf ties equals
  ``lax.top_k``'s.
* Free-running: 300 serial events at 16^2 and 30 batches at 32^2 under
  each rule, grid, disp and step bitwise after every event, time within
  1e-5 relative; the one admitted parting is at an ulp tie
  (``testing.rf_tie``: two of the best scores within 2 ulp), after which
  the comparison stops.
* The chunks' compensated time (chunk dt == 0 iff no event fired),
  ``run_until`` stopping on a jammed grid, kmc_tpu's conservation and
  separation tests on the port, and ``--lattice-rf`` through both CLIs at
  32^2 (200 events and a resume of 100).

The long equilibrium runs (``test_equilibrium_matches_fixed_dt``,
``test_batched_equilibrium_matches_serial``) stay in kmc_tpu's
tests/test_rejection_free.py: the modes' statistics are the JAX
package's, and the port reproduces its trajectories.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmc_tpu import cli as jcli
from kmc_tpu.config import LatticeConfig as JLatticeConfig
from kmc_tpu.lattice import grid as jg
from kmc_tpu.lattice import rejection_free as jrf
from kmc_tpu_torch import cli as tcli
from kmc_tpu_torch import convert
from kmc_tpu_torch.config import LatticeConfig
from kmc_tpu_torch.lattice import grid as tg
from kmc_tpu_torch.lattice import rejection_free as trf
from kmc_tpu_torch.ops.hashing import cell_uniform
from kmc_tpu_torch.testing import rf_tie

RATES = dict(hop_prob=0.3, ass_prob=0.4, diss_prob=0.2)
TIME_RTOL = 1e-5


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


def _cfgs(size, **kw):
    jcfg = JLatticeConfig(height=size, width=size, **{**RATES, **kw})
    return jcfg, LatticeConfig(**jcfg.to_dict())


def _tstate(st):
    return convert.lattice_from_numpy(
        {k: np.asarray(v) for k, v in st._asdict().items()})


def _jstate(ts):
    return jg.LatticeState(**{k: jnp.asarray(v) for k, v in
                              convert.lattice_to_numpy(ts).items()})


def _random_state(size, seed, fill):
    """A kmc_tpu LatticeState with species 0..MAX_SPECIES drawn by numpy:
    each cell occupied with probability ``fill``."""
    rs = np.random.default_rng(seed)
    grid = rs.integers(1, jg.MAX_SPECIES + 1, (size, size)).astype(np.int32)
    grid[rs.random((size, size)) >= fill] = 0
    disp = rs.integers(-5, 6, (size, size, 2)).astype(np.int32)
    return jg.LatticeState(grid=jnp.asarray(grid), disp=jnp.asarray(disp),
                           step=jnp.asarray(seed, jnp.int32),
                           seed=jnp.asarray(seed + 1, jnp.int32),
                           time=jnp.asarray(0.0, jnp.float32))


def _same(got, want, where, time=TIME_RTOL):
    for f in ("grid", "disp", "step", "seed"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      f"{f} {where}")
    np.testing.assert_allclose(float(got.time), float(want.time), rtol=time,
                               err_msg=f"time {where}")


@pytest.mark.parametrize("size,fill", [(8, 1.0), (16, 0.5), (32, 0.1)])
def test_event_rates_bitwise(size, fill):
    jcfg, tcfg = _cfgs(size)
    jrates = jax.jit(lambda g: jrf.event_rates(g, jcfg))
    for seed in range(3):
        st = _random_state(size, seed, fill)
        want = np.asarray(jrates(st.grid))
        got = trf.event_rates(torch.from_numpy(np.array(st.grid)), tcfg)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    if size == 8:       # kmc_tpu's hand-made case (test_rates_tensor)
        grid = torch.zeros((8, 8), dtype=torch.int32)
        grid[2, 2] = grid[2, 3] = 1
        grid[5, 5] = 2
        r = trf.event_rates(grid, tcfg)
        assert float(r[0, 2, 2]) == pytest.approx(tcfg.ass_prob / 8)
        assert float(r[1, 2, 2]) == pytest.approx(tcfg.hop_prob / 4)
        assert float(r[0, 5, 5]) == pytest.approx(tcfg.hop_prob / 8)
        assert float(r[4, 5, 5]) == pytest.approx(tcfg.diss_prob / 8)
        assert float(r[:, 0, 0].sum()) == 0.0


def test_gumbel_fields_within_one_ulp_per_log():
    shape = (128, 128)
    jfield = jax.jit(jrf._gumbel_field, static_argnums=0)
    jlog = jax.jit(jnp.log)
    differ = cells = 0
    for step in (0, 7, 123456):
        salt = torch.arange(8)[:, None, None] + 3 * 16 + trf.SALT_RF_GUMBEL
        got = trf._gumbel_field(shape, torch.tensor(step), salt).double()
        for c in range(8):
            one = trf._gumbel_field(shape, torch.tensor(step), salt[c])
            assert torch.equal(one.double(), got[c])
            want = np.asarray(jfield(shape, jnp.int32(step),
                                     jnp.int32(int(salt[c])))).astype(
                                         np.float64)
            g = got[c].numpy()
            ulp = np.spacing(np.abs(want).astype(np.float32)).astype(
                np.float64)
            assert (np.abs(g - want) <= ulp + 2.0 ** -23).all()
            differ += int((g != want).sum())
            cells += g.size
            # each of the two logs on the same arguments within one ulp
            u = cell_uniform(shape, torch.tensor(step), salt[c]).clamp(
                min=1e-12)
            for x in (u, -torch.log(u)):
                np.testing.assert_array_max_ulp(
                    np.asarray(jlog(jnp.asarray(x.numpy()))),
                    torch.log(x).numpy(), maxulp=1)
    assert 0.15 < differ / cells < 0.3, differ / cells


def _j_scores(st, cfg):
    """kmc_tpu's Gumbel-max scores, computed as its rf_step computes them."""
    h, w = st.grid.shape
    rates = jrf.event_rates(st.grid, cfg)
    salt = st.seed * 16
    scores = jnp.stack([
        jnp.log(jnp.maximum(rates[c], jrf._TINY))
        + jrf._gumbel_field((h, w), st.step, salt + jrf.SALT_RF_GUMBEL + c)
        for c in range(8)])
    return jnp.where(rates > 0, scores, -jnp.inf)


SELECT_CASES = {
    # name: (size, particles, events or batches, k_events, thinning)
    "serial": (16, 60, 30, None, None),
    "parallel": (32, 200, 10, 64, "parallel"),
    "greedy": (32, 200, 10, 64, "greedy"),
    "parallel_few_live": (16, 6, 10, 64, "parallel"),
}


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_select_and_apply_on_jax_scores(case):
    """Along a kmc_tpu trajectory, the port's selection and update from
    kmc_tpu's own scores give kmc_tpu's next state."""
    size, n, steps, k, thinning = SELECT_CASES[case]
    jcfg, tcfg = _cfgs(size)
    if k is None:
        jstep = jax.jit(lambda s: jrf.rf_step(s, jcfg))
    else:
        jstep = jax.jit(lambda s: jrf.rf_batch_step(s, jcfg, k, 3, thinning))
    jscores = jax.jit(lambda s: _j_scores(s, jcfg))
    st = jg.init_lattice(jcfg, seed=4, n_particles=n)
    kept = 0
    for i in range(steps):
        scores = jscores(st)
        nxt = jstep(st)
        ts = _tstate(st)
        flat, keep = trf._select(torch.from_numpy(np.array(scores)), k,
                                 3, thinning or "parallel")
        if k is None:
            want_flat = np.asarray(jnp.argmax(scores)).reshape(1)
        else:
            want_flat = np.asarray(jax.lax.top_k(scores.reshape(-1), k)[1])
        np.testing.assert_array_equal(flat.numpy(), want_flat, f"step {i}")
        rates = trf.event_rates(ts.grid, tcfg)
        _same(trf._apply(ts, flat, keep, rates.sum()), nxt, f"step {i}",
              time=1e-6)
        kept += int(keep.sum())
        st = nxt
    assert kept > steps if k else kept == steps


def test_top_k_order_with_ties():
    v = np.array([1.0, 3.0, 3.0, 2.0, 3.0, -np.inf, -np.inf, 5.0, -np.inf,
                  2.0, 1.0, -np.inf], np.float32)
    for k in (1, 3, 5, 8, 12):
        want_v, want_i = jax.lax.top_k(jnp.asarray(v), k)
        got_v, got_i = trf._top_k(torch.from_numpy(v).reshape(1, 3, 4), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # ties by the lower index first, as lax.top_k orders them
    got = trf._top_k(torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0]), 3)[1]
    assert got.tolist() == [1, 2, 4]


def _free_running(jstep, tstep, st, tcfg, n, k_events=None):
    """Run both packages ``n`` events (batches) from ``st``; returns the
    event count compared before an ulp-tie parting (n if none)."""
    ts = _tstate(st)
    for i in range(n):
        common = ts
        st, ts = jstep(st), tstep(ts)
        same = all(np.array_equal(getattr(ts, f).numpy(),
                                  np.asarray(getattr(st, f)))
                   for f in ("grid", "disp", "step"))
        if not same:
            assert rf_tie(common, tcfg, k_events), f"parted at {i}, no tie"
            return i
        _same(ts, st, f"event {i}")
    return n


def test_free_running_serial_matches():
    jcfg, tcfg = _cfgs(16)
    st = jg.init_lattice(jcfg, seed=3, n_particles=40)
    done = _free_running(jax.jit(lambda s: jrf.rf_step(s, jcfg)),
                         lambda s: trf.rf_step(s, tcfg), st, tcfg, 300)
    assert done >= 100


@pytest.mark.parametrize("thinning", ["parallel", "greedy"])
def test_free_running_batches_match(thinning):
    jcfg, tcfg = _cfgs(32)
    st = jg.init_lattice(jcfg, seed=5, n_particles=120)
    done = _free_running(
        jax.jit(lambda s: jrf.rf_batch_step(s, jcfg, 64, 3, thinning)),
        lambda s: trf.rf_batch_step(s, tcfg, 64, 3, thinning), st, tcfg, 30,
        k_events=64)
    assert done >= 10


def test_chunk_time_compensation():
    """chunk dt == 0 iff no event fired; time accumulates from zero within
    a chunk and is added to the start time once, so it advances even where
    one event's dt is below ulp(time)."""
    jcfg, tcfg = _cfgs(16)
    chunk = trf._make_rf_chunk_dt(tcfg, 20)
    st = tg.init_lattice(tcfg, seed=2, n_particles=30, device="cpu")
    st = st._replace(time=torch.tensor(1e7, dtype=torch.float32))
    out, dt = chunk(st)
    assert float(dt) > 0 and int(out.step) == 20
    assert float(out.time) == float(torch.tensor(1e7) + dt) > 1e7
    jout, jdt = jrf._make_rf_chunk_dt(jcfg, 20)(_jstate(st))
    np.testing.assert_allclose(float(dt), float(jdt), rtol=TIME_RTOL)
    _same(out, jout, "chunk of 20")
    assert torch.equal(trf.make_rf_chunk(tcfg, 20)(st).grid, out.grid)

    empty = tg.init_lattice(tcfg, seed=2, n_particles=0, device="cpu")
    out, dt = chunk(empty)
    assert float(dt) == 0.0 and float(out.time) == 0.0
    assert int(out.step) == 20 and not out.grid.any()

    bchunk = trf.make_rf_batch_chunk(tcfg, 5, k_events=8)
    out, dts = bchunk(st)
    assert dts.shape == (5,) and (dts > 0).all()
    _, dts = bchunk(empty)
    assert (dts == 0).all()


@pytest.mark.parametrize("fill", ["empty", "jammed"])
def test_run_until_stops_without_events(fill):
    """A grid with no possible event (empty, or every cell at MAX_SPECIES)
    stops after one chunk with the time unchanged, as in kmc_tpu."""
    jcfg, tcfg = _cfgs(8)
    st = tg.init_lattice(tcfg, seed=0, n_particles=0, device="cpu")
    if fill == "jammed":
        st = st._replace(grid=torch.full_like(st.grid, tg.MAX_SPECIES))
    assert float(trf.event_rates(st.grid, tcfg).sum()) == 0.0
    out = trf.run_until(st, tcfg, 100.0, chunk=16)
    want = jrf.run_until(_jstate(st), jcfg, 100.0, chunk=16)
    assert int(out.step) == int(want.step) == 16
    assert float(out.time) == float(want.time) == 0.0
    assert torch.equal(out.grid, st.grid)
    active = tg.init_lattice(tcfg, seed=1, n_particles=10, device="cpu")
    assert float(trf.run_until(active, tcfg, 5.0, chunk=16).time) >= 5.0


def test_single_event_and_conservation():
    """kmc_tpu's test of the same name on the port."""
    _, cfg = _cfgs(16)
    st = tg.init_lattice(cfg, seed=3, n_particles=40, device="cpu")
    for _ in range(50):
        st2 = trf.rf_step(st, cfg)
        assert int(tg.particle_count(st2)) == 40
        assert int((st2.grid != st.grid).sum()) <= 2   # source + target
        assert float(st2.time) > float(st.time)
        st = st2
    assert int(st.step) == 50


@pytest.mark.parametrize("thinning", ["greedy", "parallel"])
def test_batched_conservation_and_separation(thinning):
    """kmc_tpu's test of the same name on the port, with the separation
    checked directly: the kept events' changed cells lie >= 3 apart
    (Chebyshev, periodic) unless they belong to one event."""
    _, cfg = _cfgs(32)
    st = tg.init_lattice(cfg, seed=5, n_particles=120, device="cpu")
    for _ in range(30):
        st2 = trf.rf_batch_step(st, cfg, 16, 3, thinning)
        assert int(tg.particle_count(st2)) == 120
        assert float(st2.time) >= float(st.time)
        flat, keep = trf._select(
            trf._scores(st, trf.event_rates(st.grid, cfg)), 16, 3, thinning)
        _, y, x, ty, tx = trf._cells(flat[keep], 32, 32)
        for i in range(len(y)):
            for j in range(i):
                for a in ((y[i], x[i]), (ty[i], tx[i])):
                    for b in ((y[j], x[j]), (ty[j], tx[j])):
                        dy = abs(int(a[0]) - int(b[0]))
                        dx = abs(int(a[1]) - int(b[1]))
                        assert max(min(dy, 32 - dy), min(dx, 32 - dx)) >= 3
        st = st2


def test_parallel_thinning_subset_of_greedy():
    """kmc_tpu's test of the same name on the port: on identical states the
    parallel rule's changed cells are a subset of the greedy rule's."""
    _, cfg = _cfgs(32)
    st = tg.init_lattice(cfg, seed=9, n_particles=200, device="cpu")
    for i in range(10):
        g = trf.rf_batch_step(st, cfg, 32, 3, "greedy")
        p = trf.rf_batch_step(st, cfg, 32, 3, "parallel")
        ch_g = set(map(tuple, torch.nonzero(g.grid != st.grid).tolist()))
        ch_p = set(map(tuple, torch.nonzero(p.grid != st.grid).tolist()))
        assert ch_p <= ch_g, (i, ch_p - ch_g)
        st = g._replace(step=st.step + 1)


def _rf_args(out, device_flag):
    return ["--engine", "lattice", "--lattice-rf", "--out", str(out),
            "--seed", "2", "--quiet", "--out-every", "50",
            "--set", "height=32", "--set", "width=32",
            "--set", "density=0.1", "--set", "ass_prob=0.3",
            "--set", "diss_prob=0.1", *device_flag]


def _assert_same_rf_files(jd, td):
    with open(os.path.join(jd, "lattice.dat")) as f:
        want = [r.split() for r in f.read().splitlines()]
    with open(os.path.join(td, "lattice.dat")) as f:
        got = [r.split() for r in f.read().splitlines()]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:-1] == w[:-1]                  # every column but time
        assert float(g[-1]) == pytest.approx(float(w[-1]), rel=TIME_RTOL)
    j = np.load(os.path.join(jd, "lattice_checkpoint.npz"))
    t = np.load(os.path.join(td, "lattice_checkpoint.npz"))
    assert sorted(t.files) == sorted(j.files)
    for k in ("grid", "disp", "step", "seed"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    np.testing.assert_allclose(t["time"], j["time"], rtol=TIME_RTOL)
    return got


def test_cli_lattice_rf_matches(tmp_path, capsys):
    """--lattice-rf through both CLIs at 32^2: 200 events in chunks of 50,
    then a resume of 100."""
    jd, td = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(["--steps", "200", *_rf_args(jd, ["--platform",
                                                        "cpu"])]) == 0
    assert tcli.main(["--steps", "200", *_rf_args(td, ["--device",
                                                        "cpu"])]) == 0
    rows = _assert_same_rf_files(jd, td)
    assert [int(r[0]) for r in rows] == [50, 100, 150, 200]
    assert len({r[1] for r in rows}) == 1                # mass conserved
    times = [float(r[-1]) for r in rows]
    assert times == sorted(times) and times[0] > 0

    capsys.readouterr()
    assert jcli.main(["--steps", "100", *_rf_args(jd, ["--platform",
                                                        "cpu"])]) == 0
    assert tcli.main(["--steps", "100", *_rf_args(td, ["--device",
                                                        "cpu"])]) == 0
    said = capsys.readouterr().out
    assert said.count("resuming lattice from") == 2 and "at step 200" in said
    rows = _assert_same_rf_files(jd, td)
    assert [int(r[0]) for r in rows][-2:] == [250, 300]
