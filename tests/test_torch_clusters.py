"""Port parity: cluster labels of kmc_tpu_torch against kmc_tpu, bitwise,
on bonded states (trans pairs, cis pairs, merged complexes, a long chain).

This module also holds the bonded-state fixtures the other port tests
import: JAX states built with tests/helpers.py, carried to the port as
numpy through kmc_tpu_torch.convert."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmc_tpu.engine.clusters import cluster_labels as j_labels
from kmc_tpu.geometry import quat_from_euler, quat_mul
from kmc_tpu_torch import convert
from kmc_tpu_torch.config import SimConfig as TConfig
from kmc_tpu_torch.engine.clusters import cluster_labels as t_labels

from helpers import ideal_cis_pair, ideal_trans_pair


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


# ---------------------------------------------------------------------------
# Bonded JAX states (single replica each) and the bridge to the port.

def jax_state(fields):
    """A single-replica JAX SimState from numpy fields."""
    from kmc_tpu.state import SimState

    return SimState(**{
        f: (jax.random.wrap_key_data(jnp.asarray(fields[f])) if f == "key"
            else jnp.asarray(fields[f])) for f in SimState._fields})


def spread_state(cfg, seed):
    """kmc_tpu's spread_state(cfg, seed) (random_init), placed by the port's
    initializer, which draws the same keys (test_torch_ensemble holds the
    two initializers equal); the JAX one recompiles its loops per call."""
    from kmc_tpu_torch import rng
    from kmc_tpu_torch.engine.init import random_init_from_key

    ts = random_init_from_key(port_cfg(cfg), rng.key_from_seed(seed)[None])
    return jax_state(convert.to_numpy(ts, batched=False))

def _bond_trans(st, a, b, site, cfg):
    na = cfg.n_a
    return st._replace(a_trans=st.a_trans.at[a].set(na + b),
                       a_site=st.a_site.at[a].set(site),
                       b_partner=st.b_partner.at[b, site - 1].set(a))


def _bond_cis(st, a1, a2):
    return st._replace(a_cis=st.a_cis.at[a1].set(a2).at[a2].set(a1))


def loose_trans(cfg, seed=0):
    """A trans pair knocked off its ideal seat."""
    st = ideal_trans_pair(spread_state(cfg, seed), a=0, b=0, site=1, cfg=cfg,
                          bond=True)
    return st._replace(a_xy=st.a_xy.at[0].add(jnp.asarray([4.0, -3.0])),
                       a_psi=st.a_psi.at[0].add(0.3))


def unlaid_ligand(cfg, seed=1):
    """A bonded ligand tilted out of the plane and marked not laid."""
    st = ideal_trans_pair(spread_state(cfg, seed), a=2, b=1, site=2, cfg=cfg,
                          bond=True)
    return st._replace(
        b_quat=st.b_quat.at[1].set(quat_mul(quat_from_euler(0.4, 0.2, 0.1),
                                            st.b_quat[1])),
        b_laid=st.b_laid.at[1].set(False),
        b_center=st.b_center.at[1, 2].add(17.0))


def loose_cis(cfg, seed=2):
    st = ideal_cis_pair(spread_state(cfg, seed), 0, 1, cfg, bond=True)
    return st._replace(a_xy=st.a_xy.at[1].add(jnp.asarray([3.0, 2.0])))


def merged_complex(cfg, seed=0):
    """Two ligands joined through a cis-bonded receptor pair."""
    st = ideal_trans_pair(spread_state(cfg, seed), a=0, b=0, site=1, cfg=cfg,
                          bond=True)
    ux = np.array([np.cos(float(st.a_psi[0])), np.sin(float(st.a_psi[0]))])
    a1_xy = np.asarray(st.a_xy[0]) - ux * (2 * cfg.rb_a_radius + 9.0)
    st = st._replace(
        a_xy=st.a_xy.at[1].set(jnp.asarray(a1_xy)),
        a_psi=st.a_psi.at[1].set(st.a_psi[0] + jnp.pi + 0.05),
        b_center=st.b_center.at[1].set(
            jnp.asarray([a1_xy[0] - 120.0, a1_xy[1], cfg.plane_z])),
        b_laid=st.b_laid.at[1].set(True))
    return _bond_trans(_bond_cis(st, 0, 1), 1, 1, 2, cfg)


def long_chain(cfg, seed=3):
    """B0 - A0 = A1 - B1 - A2 = A3 - B2 - ... : a chain deeper than
    align_depth from its only laid ligand B0 (unreached tail).  B0 sits at
    the origin like the JAX suite's bonded fixtures: the snapped chain then
    lies within a few hundred A of it."""
    st = spread_state(cfg, seed)
    nb_chain = min(cfg.n_b, cfg.n_a // 2 + 1)
    for k in range(nb_chain - 1):
        st = _bond_trans(st, 2 * k, k, 1, cfg)
        st = _bond_trans(st, 2 * k + 1, k + 1, 2, cfg)
        st = _bond_cis(st, 2 * k, 2 * k + 1)
    laid = jnp.zeros_like(st.b_laid).at[0].set(True)
    return st._replace(
        b_laid=laid,
        b_center=st.b_center.at[0].set(jnp.asarray([0.0, 0.0, cfg.plane_z])))


def no_bonds(cfg, seed=4):
    return spread_state(cfg, seed)


BONDED_FIXTURES = (loose_trans, unlaid_ligand, loose_cis, merged_complex,
            long_chain, no_bonds)


def jax_fields(st):
    """A JAX SimState (batched or not) as a dict of numpy arrays."""
    d = {f: np.asarray(getattr(st, f)) for f in st._fields if f != "key"}
    d["key"] = np.asarray(jax.random.key_data(st.key))
    return d


def stack_fields(states):
    fs = [jax_fields(s) for s in states]
    return {k: np.stack([f[k] for f in fs]) for k in fs[0]}


def port_cfg(cfg):
    return TConfig(**cfg.to_dict())


def bonded_batch(cfg):
    """(list of JAX states, the same states as one port batch)."""
    states = [b(cfg) for b in BONDED_FIXTURES]
    return states, convert.from_numpy(stack_fields(states))


# ---------------------------------------------------------------------------

def test_labels_bitwise_on_bonded_states(small_cfg):
    states, ts = bonded_batch(small_cfg)
    info = t_labels(ts, port_cfg(small_cfg))
    for r, st in enumerate(states):
        ji = j_labels(st, small_cfg)
        for f in ji._fields:
            np.testing.assert_array_equal(getattr(info, f)[r].numpy(),
                                          np.asarray(getattr(ji, f)), f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_labels_bitwise_on_random_topologies(small_cfg, seed):
    """Random mutual topologies, including clusters of many molecules."""
    from test_torch_config_geometry import _random_state_np

    fields = _random_state_np(small_cfg, seed, r=4)
    ts = convert.from_numpy(fields)
    info = t_labels(ts, port_cfg(small_cfg))
    for r in range(4):
        js = spread_state(small_cfg, 0)._replace(
            a_trans=jnp.asarray(fields["a_trans"][r]),
            a_cis=jnp.asarray(fields["a_cis"][r]),
            b_partner=jnp.asarray(fields["b_partner"][r]))
        ji = j_labels(js, small_cfg)
        for f in ji._fields:
            np.testing.assert_array_equal(getattr(info, f)[r].numpy(),
                                          np.asarray(getattr(ji, f)), f)


def test_closure_guard_matches(small_cfg):
    """Both packages refuse a closure depth that cannot cover n."""
    cfg = small_cfg.replace(label_closure_iters=4)       # 2^4 < 32
    _, ts = bonded_batch(small_cfg)
    with pytest.raises(AssertionError):
        j_labels(no_bonds(small_cfg), cfg)
    with pytest.raises(AssertionError):
        t_labels(ts, port_cfg(cfg))
