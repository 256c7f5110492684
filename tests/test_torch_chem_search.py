"""The port's chem-search envs (``warpdrive_tpu_torch/envs/
chem_search.py``: one atom in 2-D and 3-D modes, two atoms) and DummyEnv
(``envs/dummy_env.py``) against their numpy references (the lockstep
checker) and against the JAX package's steps, on the JAX tests' small
configs: an 8 x 8 synthetic landscape with the z-slab 2-6, and a 6 x 6 x
3 two-atom mesh.  Positions and done flags are exact; observations and
rewards within 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_chem_search import _cfg, _cfg_two_atom
from warpdrive_tpu.envs import chem_search as jax_chem
from warpdrive_tpu.envs.dummy_env import TpuDummyEnv
from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu_torch.envs import chem_search as port_chem
from warpdrive_tpu_torch.envs.dummy_env import DummyEnv, TorchDummyEnv
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.tools.consistency import (
    EnvironmentCPUvsDevice,
    draw_actions,
    pack_actions,
)
from warpdrive_tpu_torch.training.trainer_a2c import TrainerA2C
from warpdrive_tpu_torch.utils.constants import Constants

ATOL = 1e-6  # float32 observations and rewards; positions are exact

CASES = {
    "one_atom_2d": ("SingleAgentOneAtomChemSearch", lambda: _cfg(False)),
    "one_atom_3d": ("SingleAgentOneAtomChemSearch", lambda: _cfg(True)),
    "two_atom": ("SingleAgentTwoAtomChemSearch", _cfg_two_atom),
}


def test_synthetic_landscape_matches_jax():
    for args in ((8, 8, 4), (6, 5, 3)):
        np.testing.assert_array_equal(
            port_chem.make_synthetic_landscape(*args, seed=4, amplitude=0.5),
            jax_chem.make_synthetic_landscape(*args, seed=4, amplitude=0.5))


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_vs_torch_through_the_checker(case):
    name, cfg = CASES[case]
    EnvironmentCPUvsDevice(
        cpu_env_class=getattr(port_chem, name),
        device_env_class=getattr(port_chem, f"Torch{name}"),
        env_configs={case: cfg()}, num_envs=4, num_episodes=2, device="cpu",
    ).test_env_reset_and_step(threshold_pct=0.1, seed=19)


def _lockstep(jax_env, port_env, num_envs, steps, seed, exact=()):
    """Step both engines from the same state with the same numpy-drawn
    actions; ``exact`` arrays and the integer ones must be equal, the
    other float arrays within ATOL."""
    jeng = JaxEnvEngine(env_obj=jax_env, num_envs=num_envs, seed=0)
    peng = EnvEngine(env_obj=port_env, num_envs=num_envs, seed=0,
                     device="cpu")
    jstep = jax.jit(jeng.step)
    jstate, pstate = dict(jeng.state), dict(peng.state)
    rng = np.random.RandomState(seed)
    for t in range(steps):
        actions = pack_actions(draw_actions(rng, peng), peng)
        jstate = jstep(jstate, jnp.asarray(actions.numpy()))
        pstate = peng.step(pstate, actions)
        for key, value in pstate.items():
            want, got = np.asarray(jstate[key]), value.numpy()
            assert got.dtype == want.dtype, key
            if key in exact or not value.is_floating_point():
                np.testing.assert_array_equal(got, want, err_msg=f"{key} {t}")
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                           err_msg=f"{key} t={t}")
        jstate = jeng.auto_reset(jstate, jax.random.PRNGKey(t))
        pstate = peng.auto_reset(pstate)
    return pstate


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax(case):
    """60 steps of 64 envs, across done-driven resets; out-of-slab moves
    and the periodic wrap on both sides of the grid occur."""
    name, cfg = CASES[case]
    jax_env = getattr(jax_chem, f"Tpu{name}")(**cfg())
    port_env = getattr(port_chem, f"Torch{name}")(**cfg())
    last = _lockstep(jax_env, port_env, 64, 60, seed=3)
    assert last["position"].shape[1] == 1


def test_wrap_is_a_floor_modulo_on_negative_coordinates():
    """A -x move from x = 0 wraps to nx - 1 (torch's ``%`` on integer
    tensors is a floor modulo, as ``jnp.mod``)."""
    cfg = _cfg(False)
    env = port_chem.TorchSingleAgentOneAtomChemSearch(
        **dict(cfg, initial_state=[0, 0, 3]))
    engine = EnvEngine(env_obj=env, num_envs=2, device="cpu")
    state = engine.step(dict(engine.state),
                        torch.tensor([[[1]], [[3]]], dtype=torch.int32))
    np.testing.assert_array_equal(state["position"][:, 0].numpy(),
                                  [[7, 0, 3], [0, 7, 3]])


def test_z_rules_of_the_three_modes():
    """2-D: leaving the slab keeps the bad position and pays -max_denergy;
    3-D: the z-move is cancelled at a plain lookup; two atoms: reverted
    and -max_denergy."""
    base = _cfg(False)
    up = torch.tensor([[[4]]], dtype=torch.int32)  # +z from z = 5
    # the mode follows the start's and the target's z: equal is 2-D
    for final_z, want_z, want_r in ((5, 6, -1.0), (4, 5, None)):
        env = port_chem.TorchSingleAgentOneAtomChemSearch(
            **dict(base, initial_state=[1, 1, 5], final_state=[6, 6, final_z]))
        assert env.is_3d == (final_z != 5)
        engine = EnvEngine(env_obj=env, num_envs=1, device="cpu")
        out = engine.step(dict(engine.state), up)
        assert int(out["position"][0, 0, 2]) == want_z
        if want_r is not None:  # clip(-max_denergy / max_denergy) = -1
            assert float(out[Constants.REWARDS][0, 0]) == want_r
    assert base["z_slab_upper"] == 6
    two = _cfg_two_atom()
    env = port_chem.TorchSingleAgentTwoAtomChemSearch(
        **dict(two, initial_state=[1, 1, 3, 4, 4, 2]))
    engine = EnvEngine(env_obj=env, num_envs=1, device="cpu")
    out = engine.step(dict(engine.state),
                      torch.tensor([[[0, 4]]], dtype=torch.int32))
    assert out["position"][0, 0].tolist() == [1, 1, 3, 4, 4, 2]
    assert float(out[Constants.REWARDS][0, 0]) == -1.0


def test_trains_a2c(tmp_path):
    env = port_chem.TorchSingleAgentOneAtomChemSearch(**_cfg(True))
    engine = EnvEngine(env_obj=env, num_envs=10, seed=2, device="cpu")
    cfg = {
        "name": "chem", "env": {},
        "trainer": {"num_envs": 10, "num_episodes": 40,
                    "train_batch_size": 500, "seed": 6},
        "policy": {"shared": {"to_train": True, "algorithm": "A2C",
                              "gamma": 0.97, "lr": 0.003,
                              "model": {"type": "fully_connected",
                                        "fc_dims": [32, 32]}}},
        "saving": {"metrics_log_freq": 1, "model_params_save_freq": 1000},
    }
    trainer = TrainerA2C(env_wrapper=engine, config=cfg, verbose=False,
                         results_dir=str(tmp_path / "r"))
    trainer.train()
    rew, _ = trainer.evaluate_episodes()
    assert np.isfinite(rew["shared"]).all()
    assert trainer.fetch_logged_episode()["position"].shape[1:] == (1, 3)


DUMMY_CONFIGS = {
    "time_done": {"num_agents": 5, "episode_length": 3, "target": 10_000},
    "target_done": {"num_agents": 5, "episode_length": 10, "target": 16},
}


def test_dummy_numpy_vs_torch_through_the_checker():
    EnvironmentCPUvsDevice(
        cpu_env_class=DummyEnv, device_env_class=TorchDummyEnv,
        env_configs=DUMMY_CONFIGS, num_envs=3, num_episodes=2, device="cpu",
    ).test_env_reset_and_step(threshold_pct=0.1, seed=5)


@pytest.mark.parametrize("name", sorted(DUMMY_CONFIGS))
def test_dummy_step_matches_jax(name):
    cfg = DUMMY_CONFIGS[name]
    _lockstep(TpuDummyEnv(**cfg), TorchDummyEnv(**cfg), 3, 12, seed=1,
              exact=("x", Constants.OBSERVATIONS))


def test_dummy_in_place_updates():
    engine = EnvEngine(env_obj=TorchDummyEnv(num_agents=4, episode_length=4,
                                             target=10_000),
                       num_envs=2, device="cpu")
    engine.reset_all_envs()
    x0, y0 = engine.state["x"].clone(), engine.state["y"].clone()
    engine.step_all_envs(np.zeros((2, 4, 1), dtype=np.int32))
    assert torch.equal(engine.state["x"], x0 / 2.0)
    assert torch.equal(engine.state["y"], y0 * 2)
