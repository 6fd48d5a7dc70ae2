"""Port parity: the six reaction channels and the observables of
kmc_tpu_torch against kmc_tpu under identical keys -- topology, the dirty
flag and every counter bitwise -- on bonded states and on states built for
each channel to fire (rates raised so that p >= 1 where a channel must
fire, as tests/test_reactions.py does)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmc_tpu import rng as jrng
from kmc_tpu.engine.clusters import cluster_labels as j_labels
from kmc_tpu.engine.observables import observe as j_observe
from kmc_tpu.engine.reactions import react as j_react
from kmc_tpu_torch import convert
from kmc_tpu_torch import rng as trng
from kmc_tpu_torch.engine.clusters import cluster_labels as t_labels
from kmc_tpu_torch.engine.observables import observe as t_observe
from kmc_tpu_torch.engine.reactions import react as t_react

from helpers import ideal_cis_pair, ideal_trans_pair
from test_torch_clusters import (BONDED_FIXTURES, jax_fields, port_cfg,
                                 spread_state, stack_fields)


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


def _encounters(cfg):
    """Unbonded molecules at ideal bond geometry: trans pairs on two sites
    of one ligand, two receptors competing for one site, a cis pair."""
    st = spread_state(cfg, 5)
    st = ideal_trans_pair(st, a=0, b=0, site=1, cfg=cfg)
    st = ideal_trans_pair(st, a=1, b=0, site=3, cfg=cfg)
    st = st._replace(a_xy=st.a_xy.at[2].set(st.a_xy[0]),
                     a_psi=st.a_psi.at[2].set(st.a_psi[0]))
    st = ideal_cis_pair(st, 3, 4, cfg, xy=(400.0, -300.0), psi=0.7)
    st2 = ideal_trans_pair(spread_state(cfg, 6), a=5, b=2, site=2, cfg=cfg,
                           center_xy=(-300.0, 200.0), alpha=1.1, bond=True)
    st2 = ideal_cis_pair(st2, 6, 7, cfg, xy=(-300.0, -300.0), psi=-0.4)
    return [st, st2]


def _states(cfg):
    return [b(cfg) for b in BONDED_FIXTURES] + _encounters(cfg)


RATES = {
    "reference": {},
    "fast_association": dict(ass_rate=1.0, mono_cis_ass_rate=1.0,
                             cis_ass_rate=1.0),
    "fast_dissociation": dict(diss_rate=1.0, mono_cis_diss_rate=1.0,
                              cis_diss_rate=1.0),
    "half_dissociation": dict(diss_rate=0.03, mono_cis_diss_rate=0.03,
                              cis_diss_rate=0.03),
}


@pytest.mark.parametrize("rates", sorted(RATES))
@pytest.mark.parametrize("step", [2, 31])
def test_react_bitwise(small_cfg, rates, step):
    cfg = small_cfg.replace(**RATES[rates])
    tcfg = port_cfg(cfg)
    states = _states(cfg)
    ts = convert.from_numpy(stack_fields(states))
    out = t_react(ts, trng.step_key(ts.key, step), tcfg)
    for r, st in enumerate(states):
        want = jax_fields(j_react(st, jrng.step_key(st.key, step), cfg))
        for f in ("a_trans", "a_site", "a_cis", "b_partner", "dirty"):
            np.testing.assert_array_equal(getattr(out, f)[r].numpy(),
                                          want[f], f"{f} replica {r}")


def test_channels_fire(small_cfg):
    """The raised-rate cases do exercise association and dissociation."""
    fired = {}
    for rates in ("fast_association", "fast_dissociation"):
        cfg = port_cfg(small_cfg.replace(**RATES[rates]))
        ts = convert.from_numpy(stack_fields(_states(small_cfg)))
        out = t_react(ts, trng.step_key(ts.key, 2), cfg)
        fired[rates] = ((out.a_trans != ts.a_trans).sum().item(),
                        (out.a_cis != ts.a_cis).sum().item())
    assert min(fired["fast_association"]) > 0, fired
    assert min(fired["fast_dissociation"]) > 0, fired


@pytest.mark.parametrize("step", [1, 9])
def test_observables_bitwise(small_cfg, step):
    cfg = small_cfg.replace(**RATES["fast_association"])
    tcfg = port_cfg(cfg)
    states = _states(cfg)
    ts = convert.from_numpy(stack_fields(states))
    ts = ts._replace(step=torch.full_like(ts.step, step),
                     max_complex=torch.arange(len(states), dtype=torch.int32))
    reacted = t_react(ts, trng.step_key(ts.key, step), tcfg)
    obs = t_observe(reacted, t_labels(ts, tcfg), tcfg)
    for r, st in enumerate(states):
        st = st._replace(step=jnp.int32(step), max_complex=jnp.int32(r))
        js = j_react(st, jrng.step_key(st.key, step), cfg)
        jo = j_observe(js, j_labels(st, cfg), cfg)
        for f in jo._fields:
            np.testing.assert_array_equal(getattr(obs, f)[r].numpy(),
                                          np.asarray(getattr(jo, f)), f)
