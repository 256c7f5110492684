"""Training on the eager host-env backend (``CpuEnvEngine``: numpy
reference envs on the host, the models and updates on the trainer's
device), after ``tests/test_cpu_backend_training.py``: A2C on TagGridWorld
and DDPG on Pendulum train, evaluate and fetch episodes; an evaluation in
the middle of training leaves the live engine as it was; the CLI's
``trainer.env_backend`` builds the backend.  Against the JAX package's
eager backend: the port's rollout, replaying JAX's actions from the same
reset, records JAX's batch bit for bit, and one update of each algorithm
on JAX's batch from JAX's parameters lands within 1e-5 of JAX's (as
``tests/test_torch_trainer_a2c.py`` holds the device path's updates)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from warpdrive_tpu.envs import register_all_envs as jax_register
from warpdrive_tpu.envs.cpu_engine import CpuEnvEngine as JaxCpuEnvEngine
from warpdrive_tpu.training.trainer_a2c import TrainerA2C as JaxTrainerA2C
from warpdrive_tpu.training.trainer_ddpg import TrainerDDPG as JaxTrainerDDPG
from warpdrive_tpu_torch.envs import register_all_envs
from warpdrive_tpu_torch.envs.cpu_engine import CpuEnvEngine
from warpdrive_tpu_torch.models.fully_connected import params_from_flax
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.training.trainer_a2c import TrainerA2C
from warpdrive_tpu_torch.training.trainer_ddpg import TrainerDDPG
from warpdrive_tpu_torch.utils import config as port_config

UPDATE_TOL = 1e-5

register_all_envs()
jax_register()


def _cfg(num_envs, T=20, iters=4):
    return {
        "name": "tg_cpu",
        "env": {},
        "trainer": {"num_envs": num_envs,
                    "num_episodes": (iters * T * num_envs) // 30,
                    "train_batch_size": T * num_envs, "seed": 3},
        "policy": {"shared": {"to_train": True, "algorithm": "A2C",
                              "gamma": 0.95, "lr": 0.005,
                              "model": {"type": "fully_connected",
                                        "fc_dims": [16, 16]}}},
        "saving": {"metrics_log_freq": 2, "model_params_save_freq": 1000},
    }


def _ddpg_cfg():
    return {
        "name": "pend_cpu", "env": {},
        "trainer": {"num_envs": 4, "num_episodes": 24,
                    "train_batch_size": 40, "seed": 5, "n_step": 1},
        "policy": {"shared": {
            "to_train": True, "algorithm": "DDPG", "gamma": 0.98,
            "lr": {"actor": 0.001, "critic": 0.002}, "tau": 0.05,
            "model": {"type": "fully_connected_actor_critic",
                      "actor": {"type": "fully_connected_actor",
                                "fc_dims": [16], "output_w": 2.0},
                      "critic": {"type": "fully_connected_action_value_critic",
                                 "fc_dims": [16]}},
        }},
        "saving": {"metrics_log_freq": 2, "model_params_save_freq": 1000},
    }


_TG = {"num_taggers": 3, "grid_length": 6, "episode_length": 30, "seed": 5}
_PEND = {"episode_length": 20, "reset_pool_size": 0, "seed": 3}


def _last_metrics(path):
    lines = (path / "results.json").read_text().splitlines()
    assert lines
    return json.loads(lines[-1])["metrics"]["shared"]


@pytest.mark.parametrize("native", [True, False])
def test_cpu_backend_trains_tag_gridworld(native, tmp_path):
    eng = CpuEnvEngine(env_name="TagGridWorld", env_config=_TG, num_envs=4,
                       native=native, device="cpu")
    assert eng.is_eager and eng.state["observations"].shape[0] == 4
    trainer = TrainerA2C(env_wrapper=eng, config=_cfg(4), verbose=False,
                         results_dir=str(tmp_path / "r"))
    before = {k: v.clone() for k, v in
              trainer.models["shared"].state_dict().items()}
    trainer.train()
    assert trainer.iters_completed == trainer.num_iters
    metrics = _last_metrics(tmp_path / "r")
    assert np.isfinite(metrics["Total loss"])
    assert np.isfinite(metrics["Mean episodic reward"])
    assert any(not torch.equal(v, before[k]) for k, v in
               trainer.models["shared"].state_dict().items())
    rew, steps = trainer.evaluate_episodes(use_argmax=True)
    assert rew["shared"].shape == (4, 4)
    assert (steps["shared"] <= 30).all()
    assert any("state_dict" in f for f in os.listdir(tmp_path / "r"))
    # profile_phases restores the engine's envs too
    state = {k: v.clone() for k, v in eng.state.items()}
    trainer.profile_phases(repeats=1)
    for k, v in state.items():
        assert torch.equal(eng.state[k], v), k


def test_cpu_backend_fetch_episode_states(tmp_path):
    eng = CpuEnvEngine(env_name="TagGridWorld",
                       env_config={"num_taggers": 2, "grid_length": 5,
                                   "episode_length": 15, "seed": 2},
                       num_envs=3, device="cpu")
    trainer = TrainerA2C(env_wrapper=eng, config=_cfg(3, T=10, iters=2),
                         verbose=False, results_dir=str(tmp_path / "r"))
    traj = trainer.fetch_episode_states(["observations"],
                                        include_rewards_actions=True)
    assert traj["observations"].shape[0] >= 2
    assert traj["rewards"].shape[0] == traj["observations"].shape[0] - 1
    assert np.isfinite(traj["rewards"]).all()
    # the logger and full-state checkpoints need the device engine
    for call in (trainer.fetch_logged_episode, trainer.save_full_state):
        with pytest.raises(NotImplementedError, match="eager"):
            call()


def test_cpu_backend_trains_ddpg_pendulum(tmp_path):
    eng = CpuEnvEngine(env_name="ClassicControlPendulumEnv", env_config=_PEND,
                       num_envs=4, device="cpu")
    trainer = TrainerDDPG(env_wrapper=eng, config=_ddpg_cfg(), verbose=False,
                          results_dir=str(tmp_path / "r"))
    trainer.train()
    assert trainer.iters_completed == trainer.num_iters
    metrics = _last_metrics(tmp_path / "r")
    assert np.isfinite(metrics["Total loss"])
    assert metrics["Buffer full"] == 1.0
    rew, _ = trainer.evaluate_episodes()
    assert np.isfinite(rew["shared"]).all()


def test_eager_mid_training_eval_does_not_corrupt_engine(tmp_path):
    eng = CpuEnvEngine(env_name="TagGridWorld",
                       env_config={"num_taggers": 2, "grid_length": 5,
                                   "episode_length": 20, "seed": 7},
                       num_envs=3, device="cpu")
    cfg = _cfg(3, T=10, iters=2)
    cfg["trainer"]["evaluator"] = True
    trainer = TrainerA2C(env_wrapper=eng, config=cfg, verbose=False,
                         results_dir=str(tmp_path / "r"))
    trainer._iteration(0)  # envs mid-episode
    before = {k: v.clone() for k, v in eng.state.items()}
    env_locs = [(e.loc_x.copy(), e.loc_y.copy(), e.timestep)
                for e in eng.envs]
    trainer.evaluate_episodes(use_argmax=True)
    trainer.fetch_episode_states(["observations"])
    for k, v in before.items():
        assert torch.equal(eng.state[k], v), k
    for (x0, y0, t0), e in zip(env_locs, eng.envs):
        np.testing.assert_array_equal(x0, e.loc_x)
        np.testing.assert_array_equal(y0, e.loc_y)
        assert t0 == e.timestep


@pytest.mark.parametrize("backend", ["cpu", "cpp"])
def test_cli_env_backend_builds_the_eager_backend(backend, tmp_path):
    cfg = port_config.load_run_config("single_cartpole")
    cfg["trainer"].update({"num_envs": 6, "train_batch_size": 120,
                           "num_episodes": 6, "env_backend": backend})
    cfg["env"].update({"episode_length": 40})
    trainer = port_train.setup_trainer_and_train(
        cfg, verbose=False, device="cpu", results_dir=str(tmp_path / "r"))
    assert isinstance(trainer.engine, CpuEnvEngine)
    assert trainer.engine._native is not None  # g++ builds here
    assert trainer.iters_completed == 2
    assert np.isfinite(_last_metrics(tmp_path / "r")["Total loss"])


def _jax_eager(kind, tmp_path):
    """A JAX eager trainer after one iteration, with the parameters it
    started from, the batch it recorded and what its update returned."""
    if kind == "a2c":
        jeng = JaxCpuEnvEngine(env_name="TagGridWorld", env_config=_TG,
                               num_envs=4, native=False)
        jtrainer = JaxTrainerA2C(env_wrapper=jeng, config=_cfg(4),
                                 verbose=False,
                                 results_dir=str(tmp_path / "jax"))
        name = "_eager_update_fn"
    else:
        jeng = JaxCpuEnvEngine(env_name="ClassicControlPendulumEnv",
                               env_config=_PEND, num_envs=4, native=False)
        jtrainer = JaxTrainerDDPG(env_wrapper=jeng, config=_ddpg_cfg(),
                                  verbose=False,
                                  results_dir=str(tmp_path / "jax"))
        name = "_eager_replay_update_fn"
    seen = {}
    update = getattr(jtrainer, name)

    def spy(*args):
        seen["before"] = jax.tree_util.tree_map(np.asarray, args[0])
        seen["batch"] = jax.tree_util.tree_map(np.asarray, args[-3 if kind
                                                                == "a2c"
                                                                else -2])
        seen["timestep"] = float(args[-2 if kind == "a2c" else -1])
        out = update(*args)
        seen["after"] = jax.tree_util.tree_map(np.asarray, out[0])
        return out

    setattr(jtrainer, name, spy)
    jtrainer._eager_iteration(0)
    return seen


def _assert_state_near(module, flax_params, what, before=None):
    """``module`` within UPDATE_TOL of ``flax_params``; where ``before``
    (flax) is given, the update moved the parameters far beyond that."""
    want = params_from_flax(flax_params)
    if before is not None:
        start = params_from_flax(before)
        assert max(float((want[k] - start[k]).abs().max()) for k in want) \
            > 10 * UPDATE_TOL, what
    for key, value in module.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=0, atol=UPDATE_TOL,
                                   err_msg=f"{what} {key}")


def test_a2c_eager_rollout_and_update_match_jax(tmp_path):
    seen = _jax_eager("a2c", tmp_path)
    eng = CpuEnvEngine(env_name="TagGridWorld", env_config=_TG, num_envs=4,
                       native=False, device="cpu")
    port = TrainerA2C(env_wrapper=eng, config=_cfg(4), verbose=False,
                      results_dir=str(tmp_path / "port"))
    batch = {k: torch.from_numpy(v) for k, v in seen["batch"].items()}
    # the rollout, replaying JAX's actions from the same reset
    replay = port._rollout(actions=batch["actions_shared"])
    for key, value in batch.items():
        assert torch.equal(replay[key].to(value.dtype), value), key
    # one update on JAX's batch from JAX's parameters
    port.models["shared"].load_state_dict(
        params_from_flax(seen["before"]["shared"]))
    metrics = port._update(batch, seen["timestep"])
    assert np.isfinite(float(metrics["shared"]["Total loss"]))
    _assert_state_near(port.models["shared"], seen["after"]["shared"],
                       "A2C", before=seen["before"]["shared"])


def test_ddpg_eager_update_matches_jax(tmp_path):
    seen = _jax_eager("ddpg", tmp_path)
    eng = CpuEnvEngine(env_name="ClassicControlPendulumEnv",
                       env_config=_PEND, num_envs=4, native=False,
                       device="cpu")
    port = TrainerDDPG(env_wrapper=eng, config=_ddpg_cfg(), verbose=False,
                       results_dir=str(tmp_path / "port"))
    nets = seen["before"]
    for net in ("actor", "critic"):
        port.nets[net]["shared"].load_state_dict(
            params_from_flax(nets[net]["shared"]))
        port.targets[net]["shared"].load_state_dict(
            params_from_flax(nets[f"target_{net}"]["shared"]))
    rows = {k: torch.from_numpy(v) for k, v in seen["batch"].items()}
    metrics = port._replay_update(rows, seen["timestep"])
    assert metrics["shared"]["Buffer full"] == 1.0
    for net in ("actor", "critic"):
        _assert_state_near(port.nets[net]["shared"],
                           seen["after"][net]["shared"], net,
                           before=nets[net]["shared"])
        _assert_state_near(port.targets[net]["shared"],
                           seen["after"][f"target_{net}"]["shared"],
                           f"target {net}")
