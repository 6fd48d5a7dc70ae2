"""The port's counterpart of tests/test_mini_validation.py: ~2k eager steps
of a dense reduced config on the CPU against the same PRE-REGISTERED
tolerance bands, so statistical regressions in the port's integrated step
(rates, gates, mobility, RNG) are caught without the golden oracle.

The bands are that file's, unchanged (registered from an 8-replica
calibration run of kmc_tpu: mean bond_rl at step 2000 = 1.25, range 0..3;
receptor free-diffusion MSD/step analytic = 2*D*dt/9 = 2.222 A^2), and
so is the configuration (fused_align=False: the unfused idealize in both
packages)."""

import numpy as np
import pytest
import torch

from kmc_tpu_torch.config import SimConfig
from kmc_tpu_torch.parallel.ensemble import init_ensemble, make_ensemble_chunk

REPLICAS = 8
STEPS = 2000
CHUNK = 500


@pytest.fixture(autouse=True)
def _small_torch():
    """Two torch threads per test worker, as the port's other test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _dense_cfg():
    return SimConfig(n_a=24, n_b=8, cell_range_x=700.0, cell_range_y=700.0,
                     cell_range_z=200.0, fused_align=False)


def test_mini_validation_bands():
    cfg = _dense_cfg()
    st0 = init_ensemble(cfg, REPLICAS, seed=0, device="cpu")
    x0 = st0.a_xy.numpy().copy()
    chunk = make_ensemble_chunk(cfg, CHUNK, device="cpu")

    st, obs = st0, None
    for _ in range(STEPS // CHUNK):
        st, obs = chunk(st)

    rl = obs.bond_rl.numpy()
    mono = obs.bond_mono_cis.numpy()
    cis = obs.bond_cis.numpy()
    bn = obs.bond_num.numpy()
    mx = obs.max_complex.numpy()

    # counter identity (reference invariant, main.cpp:1931-1938)
    np.testing.assert_array_equal(bn, rl + mono + cis)

    # pre-registered kinetics band: trans bonds form but slowly at this
    # density (calibration mean 1.25/replica at step 2000)
    assert 0.2 <= rl.mean() <= 3.5, rl
    assert mx.max() <= 10

    # free-receptor MSD per step vs the analytic reference moment 2*D*dt/9
    # (minimum-image displacement; drift << box/2 over this horizon)
    x1 = st.a_xy.numpy()
    d = x1 - x0
    for ax, box in enumerate((cfg.cell_range_x, cfg.cell_range_y)):
        d[..., ax] -= box * np.round(d[..., ax] / box)
    free = (st.a_trans.numpy() < 0) & (st.a_cis.numpy() < 0)
    msd = float(np.sum(d**2, axis=-1)[free].mean()) / STEPS
    analytic = 2 * cfg.rb_a_d * cfg.time_step / 9
    assert 0.75 * analytic <= msd <= 1.25 * analytic, (msd, analytic)

    # trajectories finite, steps advanced, in-box
    assert np.isfinite(x1).all()
    assert int(st.step[0]) == STEPS + 1
    assert (np.abs(x1[..., 0]) <= cfg.cell_range_x).all()
