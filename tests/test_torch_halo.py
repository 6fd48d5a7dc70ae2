"""The port's domain-decomposed lattice (kmc_tpu_torch/parallel/halo.py,
lattice/step.py:make_sharded_lattice_step) against kmc_tpu's, bitwise on
grid and disp, on the CPU.

Four ranks are separate processes joined by gloo (``parallel/launch.py``;
they import no JAX); each steps its block and rank 0 gathers the grid.
The counterparts of tests/test_halo.py:

* the halo step (``make_halo_lattice_step``) on 2 x 2 and 4 x 1 rank grids
  against the port's single step and kmc_tpu's ``make_lattice_step``: 64^2,
  density 0.12, ass 0.25, diss 0.08, seed 9, 30 steps;
* ``make_halo_pallas_step`` (the plain route of ``lattice_block_call`` on
  CPU tensors) against ``make_halo_lattice_step``, seed 21, 12 steps;
* ``make_sharded_lattice_step(chunk=10)`` on 2 x 2 against kmc_tpu's
  ``make_lattice_chunk(cfg, 10)`` at 32^2.

In this process (one rank, a 1 x 1 grid): ``halo_pad`` is the periodic
pad, both halo forms and the sharded chunk equal the whole-grid step, and
the block checks refuse grids that do not cut into even blocks.
"""

import os

import jax
import numpy as np
import pytest
import torch

from kmc_tpu.config import LatticeConfig as JLatticeConfig
from kmc_tpu.lattice import grid as jgrid
from kmc_tpu.lattice import step as jstep
from kmc_tpu_torch.config import LatticeConfig
from kmc_tpu_torch.lattice.grid import init_lattice
from kmc_tpu_torch.lattice.step import (make_lattice_chunk,
                                        make_sharded_lattice_step)
from kmc_tpu_torch.parallel import halo
from kmc_tpu_torch.parallel.launch import spawn
from kmc_tpu_torch.parallel.mesh import grid_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_ENV = dict(os.environ, OMP_NUM_THREADS="1")
RANK_TIMEOUT = 300
CASE = dict(height=64, width=64, density=0.12, ass_prob=0.25,
            diss_prob=0.08)


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


def run_ranks(tmp_path, shape, form, cfg, seed, steps, chunk=1):
    """The halo check on nx * ny gloo ranks; rank 0's gathered grid and
    disp, and each rank's K3 launches (0: the plain route)."""
    save = tmp_path / f"{form}_{shape[0]}x{shape[1]}"
    save.mkdir()
    logs = spawn(shape[0] * shape[1], [
        "-m", "kmc_tpu_torch.testing", "halo", "--device", "cpu",
        "--shape", str(shape[0]), str(shape[1]), "--form", form,
        "--height", str(cfg["height"]), "--width", str(cfg["width"]),
        "--density", str(cfg["density"]), "--ass", str(cfg["ass_prob"]),
        "--diss", str(cfg["diss_prob"]), "--seed", str(seed),
        "--steps", str(steps), "--chunk", str(chunk), "--save", str(save)],
        timeout=RANK_TIMEOUT, cwd=REPO, env=RANK_ENV)
    for log in logs:
        assert '"k3": 0' in log.strip().splitlines()[-1]
    z = np.load(save / "halo.npz")
    assert int(z["step"]) == steps and float(z["time"]) == steps
    return z["grid"], z["disp"]


def jax_steps(cfg, seed, steps, chunk=None):
    jcfg = JLatticeConfig(**cfg)
    st = jgrid.init_lattice(jcfg, seed=seed)
    if chunk:
        st = jstep.make_lattice_chunk(jcfg, chunk)(st)
    else:
        step = jstep.make_lattice_step(jcfg)
        for _ in range(steps):
            st = step(st)
    return np.asarray(st.grid), np.asarray(st.disp)


def port_steps(cfg, seed, steps):
    tcfg = LatticeConfig(**cfg)
    st = make_lattice_chunk(tcfg, steps)(init_lattice(tcfg, seed=seed,
                                                      device="cpu"))
    return st.grid.numpy(), st.disp.numpy()


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_halo_step_matches_single_device(tmp_path, shape):
    grid, disp = run_ranks(tmp_path, shape, "plain", CASE, 9, 30)
    for want in (port_steps(CASE, 9, 30), jax_steps(CASE, 9, 30)):
        np.testing.assert_array_equal(grid, want[0])
        np.testing.assert_array_equal(disp, want[1])
    st0 = jgrid.init_lattice(JLatticeConfig(**CASE), seed=9)
    assert int(grid.sum()) == int(jgrid.particle_count(st0))


def test_halo_pallas_matches_plain_halo(tmp_path):
    fused = run_ranks(tmp_path, (2, 2), "pallas", CASE, 21, 12)
    plain = run_ranks(tmp_path, (2, 2), "plain", CASE, 21, 12)
    for a, b in zip(fused, plain):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fused[0], jax_steps(CASE, 21, 12)[0])


def test_sharded_chunk_matches_jax_chunk_on_2x2(tmp_path):
    lc = LatticeConfig()
    cfg = dict(height=32, width=32, density=0.1, ass_prob=lc.ass_prob,
               diss_prob=lc.diss_prob)
    grid, disp = run_ranks(tmp_path, (2, 2), "sharded", cfg, 11, 10,
                           chunk=10)
    want = jax_steps(cfg, 11, 10, chunk=10)
    np.testing.assert_array_equal(grid, want[0])
    np.testing.assert_array_equal(disp, want[1])


# ---------------------------------------------------------------------------
# one rank: a 1 x 1 grid in this process

def test_halo_pad_is_the_periodic_pad():
    m = grid_mesh((1, 1), "cpu")
    x = torch.arange(6 * 10 * 2, dtype=torch.int32).reshape(6, 10, 2)
    for width in (1, 4):
        want = np.pad(x.numpy(), ((width,) * 2, (width,) * 2, (0, 0)),
                      mode="wrap")
        np.testing.assert_array_equal(halo.halo_pad(x, width, m).numpy(),
                                      want)
        padded = halo.halo_pad(x, width, m)
        padded[:width] = padded[-width:] = 0
        padded[:, :width] = padded[:, -width:] = 0
        halo.refresh_ghosts([padded], m, width)
        np.testing.assert_array_equal(padded.numpy(), want)
        np.testing.assert_array_equal(
            halo.crop(halo.halo_pad(x, width, m), width).numpy(), x.numpy())


@pytest.mark.parametrize("form", ["plain", "pallas", "sharded"])
def test_single_rank_forms_match_whole_grid(form):
    cfg = LatticeConfig(height=32, width=48, density=0.15, ass_prob=0.3,
                        diss_prob=0.1)
    m = grid_mesh((1, 1), "cpu")
    st0 = init_lattice(cfg, seed=4, device="cpu")
    want = make_lattice_chunk(cfg, 12)(st0)
    if form == "sharded":
        got = make_sharded_lattice_step(cfg, m, chunk=6)
        got = got(got(halo.shard_lattice(st0, cfg, m)))
    else:
        make = (halo.make_halo_lattice_step if form == "plain"
                else halo.make_halo_pallas_step)
        step, got = make(cfg, m), halo.shard_lattice(st0, cfg, m)
        for _ in range(12):
            got = step(got)
    got = halo.gather_lattice(got, cfg, m)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 1)])
def test_plain_step_on_halo_blocks_matches_whole_grid(shape):
    """The plain step on the halo-padded blocks cut from the whole grid
    (testing.halo_blocks), each at its negative global origin, cropped and
    put together, equals the whole-grid step, every step (on 1 x 1 the
    block is larger than the grid, as one card's shard is)."""
    from kmc_tpu_torch.lattice.step import (lattice_step,
                                            lattice_step_arrays,
                                            step_variant)
    from kmc_tpu_torch.testing import step_halo_blocks

    cfg = LatticeConfig(height=32, width=32, density=0.15, ass_prob=0.3,
                        diss_prob=0.1)
    st = init_lattice(cfg, seed=5, device="cpu")
    seen = set()
    for i in range(48):
        seen.add(step_variant(st))
        grid, disp, _ = step_halo_blocks(st, cfg, shape, lattice_step_arrays)
        st = lattice_step(st, cfg)
        assert torch.equal(grid, st.grid) and torch.equal(disp, st.disp), i
    assert len(seen) == 8


def test_block_checks():
    m = grid_mesh((1, 1), "cpu")
    assert halo.block_origin(LatticeConfig(height=8, width=12), m) == (0, 0)
    for h, w in ((6, 7), (2, 8)):
        with pytest.raises(ValueError, match="even"):
            halo.block_origin(LatticeConfig(height=h, width=w), m)
    with pytest.raises(ValueError, match="ranks"):
        grid_mesh((2, 2), "cpu")
