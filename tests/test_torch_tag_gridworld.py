"""The port's TagGridWorld (``warpdrive_tpu_torch/envs/tag_gridworld.py``)
against the JAX package's: the batched step from the same states and
actions bit for bit (full and partial observations, tied nearest taggers,
wall hits, tags, auto-resets), a pool reset with the JAX draw's rows
injected, and the port's consistency checker against the numpy reference
at the JAX tests' configs and seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.envs.tag_gridworld import (
    TpuTagGridWorld,
    TpuTagGridWorldWithResetPool,
)
from warpdrive_tpu_torch.envs import register_all_envs
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.envs.tag_gridworld import (
    STEP_ACTIONS,
    TagGridWorld,
    TorchTagGridWorld,
    TorchTagGridWorldWithResetPool,
)
from warpdrive_tpu_torch.tools.consistency import EnvironmentCPUvsDevice
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.env_registrar import env_registrar

_OBS = Constants.OBSERVATIONS


def _engines(config, num_envs, pool=False, seed=0):
    jax_cls = TpuTagGridWorldWithResetPool if pool else TpuTagGridWorld
    port_cls = TorchTagGridWorldWithResetPool if pool else TorchTagGridWorld
    return (JaxEnvEngine(env_obj=jax_cls(**config), num_envs=num_envs,
                         seed=seed),
            EnvEngine(env_obj=port_cls(**config), num_envs=num_envs,
                      seed=seed, device="cpu"))


def _to_port(jax_state, port_state):
    """The JAX state's values under the port's state names."""
    return {k: torch.from_numpy(np.array(jax_state[k])) for k in port_state}


def _assert_same(port_state, jax_state, label):
    for name, value in port_state.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jax_state[name]),
                                      err_msg=f"{name} {label}")
        assert value.dtype == torch.from_numpy(
            np.array(jax_state[name])).dtype


def _tied_state(jax_engine, grid):
    """Envs 0-2 with nearest taggers at equal distances from the runner
    (four, two of three, and all on one cell); the rest drawn at random."""
    rng = np.random.RandomState(11)
    E, N = jax_engine.n_envs, jax_engine.n_agents
    x = rng.randint(0, grid + 1, (E, N)).astype(np.int32)
    y = rng.randint(0, grid + 1, (E, N)).astype(np.int32)
    x[0], y[0] = [3, 7, 5, 5, 5], [5, 5, 3, 7, 5]
    x[1], y[1] = [8, 2, 3, 6, 5], [5, 5, 1, 9, 5]
    x[2], y[2] = [6, 6, 6, 6, 2], [6, 6, 6, 6, 2]
    state = dict(jax_engine.state)
    state["loc_x"], state["loc_y"] = jnp.asarray(x), jnp.asarray(y)
    state[Constants.TIMESTEP] = jnp.asarray(rng.randint(0, 15, (E,)),
                                            jnp.int32)
    return state


@pytest.mark.parametrize("full", [True, False], ids=["full_obs", "partial_obs"])
def test_step_matches_jax_bit_for_bit(full):
    """Port ``step`` and ``auto_reset`` vs the JAX engine's from the same
    states and actions, 40 steps at E = 16: every state array bit for bit
    (no tolerance), through ties of the nearest tagger, wall hits, tags and
    done-driven resets.  The JAX step runs eagerly: compiled, XLA turns a
    division by a constant (``t / episode_length``, ``x / grid_length``)
    into a product with its reciprocal, which may move the last bit; run op
    by op it divides as written, as the port and the numpy reference do."""
    config = {"num_taggers": 4, "grid_length": 10, "episode_length": 20,
              "seed": 3, "use_full_observation": full}
    jeng, peng = _engines(config, num_envs=16)
    jstep = jeng.step
    jreset = jeng.auto_reset
    jstate = _tied_state(jeng, config["grid_length"])
    pstate = _to_port(jstate, peng.state)

    # the ties are there: env 0's four taggers, env 1's first two
    d2 = ((np.asarray(jstate["loc_x"])[:, :-1]
           - np.asarray(jstate["loc_x"])[:, -1:]) ** 2
          + (np.asarray(jstate["loc_y"])[:, :-1]
             - np.asarray(jstate["loc_y"])[:, -1:]) ** 2)
    assert (d2[0] == d2[0].min()).sum() == 4
    assert (d2[1] == d2[1].min()).sum() == 2

    rng = np.random.RandomState(5)
    seen = {"wall": False, "tag": False, "done": False}
    for t in range(40):
        actions = rng.randint(0, 5, (16, 5, 1)).astype(np.int32)
        if t == 0:
            actions[:3] = 0  # keep the tied layouts for the first obs
        jout = jstep(jstate, jnp.asarray(actions))
        pout = peng.step(pstate, torch.from_numpy(actions))
        _assert_same(pout, jout, f"after step {t}")
        moved = [pstate[c].numpy() + STEP_ACTIONS[actions[..., 0]][..., i]
                 for i, c in enumerate(("loc_x", "loc_y"))]
        seen["wall"] |= bool(any(((m < 0) | (m > 10)).any() for m in moved))
        seen["tag"] |= bool((pout[Constants.REWARDS].numpy() >= 9).any())
        seen["done"] |= bool((pout[Constants.DONE] > 0).any())
        jstate = jreset(jout, jax.random.PRNGKey(t))
        pstate = peng.auto_reset(pout, peng.store.generator)
        _assert_same(pstate, jstate, f"after reset {t}")
    assert all(seen.values()), seen


def test_pool_reset_rows_and_observations_match_jax():
    """A forced-and-partial pool reset with the JAX draw's rows injected
    through ``pool_idx``: the port's state equals the JAX engine's bit for
    bit, the reset positions are the pool rows, and the reset envs'
    observations are ``observe_fn`` of those rows (not the snapshot's).
    The JAX functions run eagerly, as in the step test."""
    config = {"num_taggers": 3, "grid_length": 8, "episode_length": 10,
              "seed": 5, "reset_pool_size": 6, "use_full_observation": False}
    jeng, peng = _engines(config, num_envs=7, pool=True)
    for target, pool in peng.store.pools.items():
        np.testing.assert_array_equal(pool.numpy(),
                                      np.asarray(jeng.store.pools[target]))
    assert "loc_x" not in peng.store.snapshot  # the pool alone resets them

    rng = np.random.RandomState(2)
    actions = rng.randint(0, 5, (7, 4, 1)).astype(np.int32)
    jout = jeng.step(dict(jeng.state), jnp.asarray(actions))
    done = np.array([1, 0, 1, 1, 0, 0, 1], np.int32)
    jout[Constants.DONE] = jnp.asarray(done)
    pout = _to_port(jout, peng.state)

    key = jax.random.PRNGKey(9)
    jreset = jeng.auto_reset(jout, key)
    pools = sorted(jeng.store.pools.items())
    keys = jax.random.split(key, len(pools))
    pool_idx = {
        target: torch.from_numpy(np.array(jax.random.randint(
            k, (7,), 0, pool.shape[0], dtype=jnp.int32)))
        for k, (target, pool) in zip(keys, pools)
    }
    preset = peng.auto_reset(pout, pool_idx=pool_idx)
    _assert_same(preset, jreset, "after the pool reset")

    fresh = peng.env.observe_fn(preset)
    for e in range(7):
        if done[e]:
            for target, idx in pool_idx.items():
                np.testing.assert_array_equal(
                    preset[target][e].numpy(),
                    peng.store.pools[target][idx[e]].numpy())
            np.testing.assert_array_equal(preset[_OBS][e].numpy(),
                                          fresh[e].numpy())
            assert int(preset[Constants.TIMESTEP][e]) == 0
        else:
            np.testing.assert_array_equal(preset[_OBS][e].numpy(),
                                          pout[_OBS][e].numpy())


def test_full_observation_layout():
    env = TorchTagGridWorld(num_taggers=3, grid_length=10, episode_length=8)
    engine = EnvEngine(env_obj=env, num_envs=2, device="cpu")
    obs = engine.state[_OBS]
    assert tuple(obs.shape) == (2, 4, 17) and obs.dtype == torch.float32
    np.testing.assert_array_equal(obs[0, :, 12:16].numpy(), np.eye(4))
    assert engine.step_physics is None and engine.observe is None
    assert not engine.has_split_step


def test_consistency_full_obs():
    EnvironmentCPUvsDevice(
        TagGridWorld, TorchTagGridWorld,
        {"full_obs": {"num_taggers": 4, "grid_length": 10,
                      "episode_length": 50, "seed": 3}},
        num_envs=3, num_episodes=2, device="cpu",
    ).test_env_reset_and_step(threshold_pct=1.0, seed=31)


def test_consistency_partial_obs():
    EnvironmentCPUvsDevice(
        TagGridWorld, TorchTagGridWorld,
        {"partial_obs": {"num_taggers": 6, "grid_length": 12,
                         "episode_length": 40, "use_full_observation": False,
                         "seed": 3}},
        num_envs=3, num_episodes=2, device="cpu",
    ).test_env_reset_and_step(threshold_pct=1.0, seed=37)


class _CpuPool(TagGridWorld):
    def __init__(self, reset_pool_size=None, **kw):
        super().__init__(**kw)


def test_pool_lockstep():
    """Across pool resets at 0.1%: every drawn row is a row of its pool,
    and the numpy env, synced to it, stays in lockstep."""
    EnvironmentCPUvsDevice(
        _CpuPool, TorchTagGridWorldWithResetPool,
        {"pool": {"num_taggers": 3, "grid_length": 6, "episode_length": 12,
                  "seed": 5, "reset_pool_size": 4}},
        num_envs=4, num_episodes=3, device="cpu",
    ).test_env_reset_and_step(threshold_pct=0.1, seed=13)


def test_registrar_names_match_jax():
    register_all_envs()
    assert env_registrar.get("TagGridWorld", backend="torch") is TorchTagGridWorld
    assert env_registrar.get("TagGridWorldWithResetPool",
                             backend="torch") is TorchTagGridWorldWithResetPool
    assert env_registrar.get("TagGridWorld", backend="cpu") is TagGridWorld
