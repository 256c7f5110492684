"""The port's engine facade (``warpdrive_tpu_torch/envs/engine.py``)
against the JAX package's, in the pattern of ``tests/test_engine_facade.py``:
the gym-style aliases ``reset()`` and ``obs_at_reset()``, the soft reset
of finished replicas, and ``step_all_envs``'s outputs, in the shared Box
mode (CartPole) and in the separate mode with Dict observations
(AsymmetricPursuit), where every observation placeholder is restored by a
reset.  Observations are compared exactly: both sides restore the same
float32 snapshot."""

import numpy as np
import pytest
import torch

from warpdrive_tpu.envs import register_all_envs as jax_register_all_envs
from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.utils.env_registrar import env_registrar as jax_registrar
from warpdrive_tpu_torch.envs import register_all_envs
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.env_registrar import env_registrar

PURSUIT = {"num_pursuers": 2, "num_evaders": 3, "grid_length": 8.0,
           "episode_length": 5}


@pytest.fixture(scope="module", autouse=True)
def _register():
    register_all_envs()
    jax_register_all_envs()


def _engines(name, env_config, num_envs=4, separate=False):
    """The JAX engine and the port's, of one registered env."""
    engines = []
    for registrar, backend, engine_cls, kw in (
            (jax_registrar, "tpu", JaxEnvEngine, {}),
            (env_registrar, "torch", EnvEngine, {"device": "cpu"})):
        env = registrar.get(name, backend=backend)(**env_config)
        engines.append(engine_cls(
            env_obj=env, num_envs=num_envs, seed=0,
            policy_tag_to_agent_id_map=env.policy_map() if separate else None,
            create_separate_placeholders_for_each_policy=separate, **kw))
    return engines


def test_reset_step_cycle_and_soft_reset():
    jeng, eng = _engines("ClassicControlCartPoleEnv",
                         {"episode_length": 5, "seed": 1})
    obs0 = eng.reset_all_envs()
    assert obs0.shape == (4, 1, 4)
    np.testing.assert_array_equal(eng.obs_at_reset(), jeng.obs_at_reset())
    for _ in range(5):
        out = eng.step_all_envs(np.ones((4, 1), np.int32))
    assert sorted(out) == sorted(jeng.step_all_envs(np.ones((4, 1),
                                                            np.int32)))
    assert (out[Constants.DONE] > 0).all()
    eng.reset_only_done_envs()
    assert (eng.state[Constants.TIMESTEP] == 0).all()
    np.testing.assert_array_equal(
        eng.state[Constants.OBSERVATIONS].numpy(),
        np.repeat(eng.obs_at_reset()[None], 4, axis=0))
    # the gym alias
    torch.testing.assert_close(eng.reset(), obs0, rtol=0, atol=0)


def test_reset_after_stepping_actually_resets():
    _, eng = _engines("ClassicControlCartPoleEnv",
                      {"episode_length": 50, "reset_pool_size": 0,
                       "seed": 4})
    for _ in range(3):
        eng.step_all_envs(np.ones((4, 1), np.int32))
    assert int(eng.state[Constants.TIMESTEP].max()) == 3
    eng.reset()
    assert int(eng.state[Constants.TIMESTEP].max()) == 0


def test_separate_dict_mode_aliases_and_resets():
    jeng, eng = _engines("AsymmetricPursuit", PURSUIT, separate=True)
    at_reset, jat = eng.obs_at_reset(), jeng.obs_at_reset()
    assert list(at_reset) == list(jat) == [
        "observations_evader_self", "observations_evader_nearest_pursuer",
        "observations_evader_action_mask", "observations_pursuer"]
    for name, value in jat.items():
        np.testing.assert_array_equal(at_reset[name], value)

    first = eng.reset()
    assert list(first) == list(at_reset)
    rng = np.random.RandomState(0)
    for _ in range(3):
        actions = {"pursuer": rng.randint(5, size=(4, 2, 1)),
                   "evader": rng.randint(5, size=(4, 3, 1))}
        out = eng.step_all_envs(actions)
        jout = jeng.step_all_envs(actions)
    assert list(out) == list(jout)
    moved = [name for name in at_reset
             if not torch.equal(eng.state[name], first[name])]
    assert moved, "three steps changed no observation"
    obs = eng.reset()
    for name, value in at_reset.items():  # every placeholder restored
        np.testing.assert_array_equal(obs[name].numpy(),
                                      np.repeat(value[None], 4, axis=0))
    assert (eng.state[Constants.TIMESTEP] == 0).all()


def test_soft_reset_restores_every_obs_placeholder_of_done_envs():
    _, eng = _engines("AsymmetricPursuit", PURSUIT, separate=True)
    at_reset = eng.obs_at_reset()
    state = dict(eng.state)
    for _ in range(5):
        state = eng.step(state, {"pursuer": torch.ones(4, 2, 1),
                                 "evader": torch.full((4, 3, 1), 3)})
    done = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    state[Constants.DONE] = done
    reset = eng.auto_reset(state)
    for name, value in at_reset.items():
        np.testing.assert_array_equal(reset[name][done > 0].numpy(),
                                      np.repeat(value[None], 2, axis=0))
        assert torch.equal(reset[name][done == 0], state[name][done == 0])
