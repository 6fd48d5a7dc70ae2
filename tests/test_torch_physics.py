"""Physics checks of kmc_tpu's suite re-run on the port, at the same sizes,
step counts and bounds:

* tests/test_diffusion.py: free-receptor and free-ligand (3D) mean square
  displacement per step against 2 D dt / 9 within 35 %, and the hard
  no-overlap invariant after 100 dense diffusion rounds under all three
  collision-rule settings;
* tests/test_step.py::test_invariants_under_load: a dense box with
  boosted rates and widened gates, 8 chunks of 50 steps of the port's
  step_fn, every invariant after each chunk (kmc_tpu_torch.utils.checks);
* tests/test_lattice.py: the lattice engine's mass conservation, exact
  particle count, species cap and diffusion-only MSD per step against
  hop_prob * (1 - density) within 15 %.

The port runs on the CPU here.  This module imports no JAX.
"""

import numpy as np
import pytest
import torch

from kmc_tpu_torch import rng
from kmc_tpu_torch.config import LatticeConfig, SimConfig
from kmc_tpu_torch.engine.clusters import cluster_labels
from kmc_tpu_torch.engine.diffusion import diffuse
from kmc_tpu_torch.engine.step import make_chunk_fn
from kmc_tpu_torch.lattice.grid import (MAX_SPECIES, init_lattice, msd,
                                        particle_count)
from kmc_tpu_torch.lattice.step import make_lattice_chunk
from kmc_tpu_torch.state import init_state
from kmc_tpu_torch.utils.checks import (assert_invariants,
                                        counters_consistent,
                                        no_cross_cluster_overlap,
                                        topology_mutual)


@pytest.fixture(scope="module", autouse=True)
def _small_torch():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def small_cfg():
    """tests/conftest.py's small_cfg as the port's config."""
    return SimConfig(n_a=24, n_b=8, cell_range_x=2000.0, cell_range_y=2000.0,
                     cell_range_z=600.0, out_every=50)


def _diffuse_steps(st, cfg, n, start=0):
    """n diffusion-only rounds, keyed as tests/test_diffusion.py keys them."""
    for s in range(start, start + n):
        info = cluster_labels(st, cfg)
        skey = rng.stream_key(rng.step_key(st.key, s), rng.STREAM_MOVE)
        st = diffuse(st, info, skey, cfg)
    return st


def test_free_receptor_msd(small_cfg):
    """Per-step displacement is 2 sqrt(D dt / 6) U at a uniform angle
    (main.cpp:585-595): E[dr^2] = 2 D dt / 9."""
    cfg = small_cfg.replace(n_b=1)              # nearly pure receptors
    st = init_state(cfg, 0, device="cpu")
    n_steps = 120
    xy0 = st.a_xy[0].numpy()
    st = _diffuse_steps(st, cfg, n_steps)
    d = st.a_xy[0].numpy() - xy0
    keep = np.all(np.abs(d) < cfg.cell_range_x / 4, axis=1)   # no wraps
    msd = np.mean(np.sum(d[keep] ** 2, axis=1)) / n_steps
    want = 2 * cfg.rb_a_d * cfg.time_step / 9
    assert abs(msd - want) / want < 0.35, (msd, want)


def test_free_ligand_msd_3d(small_cfg):
    cfg = small_cfg.replace(n_a=2, n_b=32, cell_range_z=100000.0)
    st = init_state(cfg, 0, device="cpu")
    n_steps = 100
    c0 = st.b_center[0].numpy()
    st = _diffuse_steps(st, cfg, n_steps)
    d = st.b_center[0].numpy() - c0
    keep = np.all(np.abs(d) < cfg.cell_range_x / 4, axis=1)
    msd = np.mean(np.sum(d[keep] ** 2, axis=1)) / n_steps
    want = 2 * cfg.rb_b_d * cfg.time_step / 9
    assert abs(msd - want) / want < 0.35, (msd, want)


@pytest.mark.parametrize("sweep,exact", [(True, True), (True, False),
                                         (False, True)])
def test_no_overlap_after_many_steps(small_cfg, sweep, exact):
    """Dense box: both collision rules keep the hard no-overlap invariant
    (the sweep rule through its cleanup loop)."""
    cfg = small_cfg.replace(cell_range_x=700.0, cell_range_y=700.0,
                            cell_range_z=400.0, sweep_collisions=sweep,
                            sweep_exact_cleanup=exact)
    st = _diffuse_steps(init_state(cfg, 1, device="cpu"), cfg, 100)
    assert_invariants(st, cfg, f"after dense diffusion (sweep={sweep}/"
                               f"{exact})")


def test_invariants_under_load(small_cfg):
    """Dense box + boosted association rates: bonds form, complexes build,
    and every invariant holds throughout."""
    cfg = small_cfg.replace(
        cell_range_x=800.0, cell_range_y=800.0, cell_range_z=300.0,
        ass_rate=0.5, mono_cis_ass_rate=0.2, cis_ass_rate=0.2,
        diss_rate=1e-3, bond_dist_cutoff=30.0, bond_thetapd_cutoff=90.0,
        bond_thetaot_cutoff=170.0, cis_dist_cutoff=25.0,
        cis_thetaot_cutoff=60.0)
    st = init_state(cfg, 4, device="cpu")
    chunk = make_chunk_fn(cfg, 50, device="cpu")
    saw_bond = saw_rl = False
    for _ in range(8):
        st, obs = chunk(st)
        assert_invariants(st, cfg, f"at step {int(st.step[0])}")
        saw_bond = saw_bond or int(obs.bond_num[0]) > 0
        saw_rl = saw_rl or int(obs.bond_rl[0]) > 0
    assert saw_bond, "no bond ever formed in a dense boosted run"
    if saw_rl:
        # a receptor-ligand bond implies a ligand-seeded cluster of >= 2
        assert int(st.max_complex[0]) >= 2


def test_checks_flag_broken_states(small_cfg):
    """Each invariant check catches what it is for, per replica."""
    cfg = small_cfg
    st = init_state(cfg, 2, device="cpu")
    assert topology_mutual(st, cfg).all()
    assert counters_consistent(st, cfg).all()
    one_sided = st._replace(a_trans=st.a_trans.clone())
    one_sided.a_trans[0, 3] = cfg.n_a               # no b_partner back-link
    assert not topology_mutual(one_sided, cfg)[0]
    with pytest.raises(AssertionError, match="topology"):
        assert_invariants(one_sided, cfg)
    stacked = st._replace(a_xy=st.a_xy.clone())
    stacked.a_xy[0, 1] = stacked.a_xy[0, 0] + 5.0   # two receptors overlap
    assert not no_cross_cluster_overlap(stacked, cfg)[0]


# ---------------------------------------------------------------------------
# the lattice engine (tests/test_lattice.py's sizes, step counts, bounds)


def test_lattice_mass_conservation():
    cfg = LatticeConfig(height=64, width=64, density=0.1, ass_prob=0.3,
                        diss_prob=0.05)
    st = init_lattice(cfg, seed=0, device="cpu")
    n0 = int(particle_count(st))
    st = make_lattice_chunk(cfg, 200)(st)
    assert int(particle_count(st)) == n0
    assert int(st.step) == 200 and float(st.time) == 200.0


def test_lattice_exact_particle_count():
    cfg = LatticeConfig(height=32, width=32)
    st = init_lattice(cfg, seed=1, n_particles=100, device="cpu")
    assert int(particle_count(st)) == 100


def test_lattice_species_cap():
    cfg = LatticeConfig(height=32, width=32, density=0.5, ass_prob=1.0,
                        diss_prob=0.0)
    st = init_lattice(cfg, seed=5, device="cpu")
    st = make_lattice_chunk(cfg, 200)(st)
    assert int(st.grid.max()) <= MAX_SPECIES


def test_lattice_diffusion_only_msd():
    """Signed two-pass hopping: every monomer attempts each step with its
    own sign, so at low density MSD/step ~= hop_prob * (1 - density)."""
    cfg = LatticeConfig(height=128, width=128, density=0.02, ass_prob=0.0,
                        diss_prob=0.0, hop_prob=0.5)
    st = init_lattice(cfg, seed=2, device="cpu")
    n = 400
    st = make_lattice_chunk(cfg, n)(st)
    got = float(msd(st)) / n
    want = cfg.hop_prob * (1 - cfg.density)
    assert abs(got - want) / want < 0.15, (got, want)
