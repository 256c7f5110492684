"""The port's trainer on the full-step path (envs whose ``step_fn`` writes
their own observations, with or without reset pools) against the JAX
package's: two A2C updates of a small ``tag_gridworld`` config from the
same parameters, optimizer state and recorded batch, the rollout replaying
the JAX-recorded actions, CPU training of the five A2C run configs of this
path, the CLI, a CartPole learning check, the DDPG run configs' trainer,
and that no run config is left out."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.training.scripts.train import setup_trainer as jax_setup
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.models.fully_connected import (
    adam_state_from_optax,
    params_from_flax,
)
from warpdrive_tpu_torch.ops import knn_obs
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.utils import config as port_config

# As in test_torch_trainer_a2c.py: after two updates the parameters agree
# to 1e-5, far below the learning rate (1e-3); the two frameworks sum the
# gradients in other orders.
PARAM_ATOL = 1e-5

FULL_STEP_CONFIGS = ["tag_gridworld", "tag_gridworld_with_reset_pool",
                     "single_cartpole", "single_acrobot", "single_mountain_car"]


def _gridworld_config(load, **trainer):
    cfg = load("tag_gridworld")
    cfg["env"].update({"grid_length": 10, "episode_length": 20})
    cfg["trainer"].update({"num_envs": 5, "train_batch_size": 200,
                           "num_episodes": 100, "seed": 3, **trainer})
    cfg["saving"]["metrics_log_freq"] = 5
    return cfg


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX trainer, its initial carry and the batch its rollout records."""
    trainer = jax_setup(_gridworld_config(jax_config.load_run_config),
                        verbose=False,
                        results_dir=str(tmp_path_factory.mktemp("jax")))
    carry = trainer._carry
    rollout = jax.jit(trainer._build_rollout_profile_fn())
    _, batch = rollout(carry, jax.random.PRNGKey(0))
    batch = jax.tree_util.tree_map(np.asarray, batch)
    return trainer, carry, batch


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_trainer(tmp_path, name="port"):
    return port_train.setup_trainer(
        _gridworld_config(port_config.load_run_config), verbose=False,
        results_dir=str(tmp_path / name), device="cpu",
    )


def test_two_updates_match_jax(jax_run, tmp_path):
    jtrainer, carry, batch = jax_run
    port = _port_trainer(tmp_path)
    params, opt = carry["params"], carry["opt"]
    port.models["shared"].load_state_dict(
        params_from_flax(_host(params["shared"])))
    port.optimizers["shared"].load_state_dict(
        adam_state_from_optax(_host(opt["shared"])))
    update = jax.jit(jtrainer._make_update(with_metrics=True))
    port_batch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}

    for step, timestep in enumerate((0, 200)):
        params, opt, jmetrics = update(params, opt, batch,
                                       jnp.float32(timestep),
                                       jax.random.PRNGKey(1))
        metrics = port._update(port_batch, timestep)
        for name in ("Total loss", "Gradient norm", "Learning rate"):
            np.testing.assert_allclose(float(metrics["shared"][name]),
                                       float(jmetrics["shared"][name]),
                                       rtol=1e-5)
        if step == 0:
            mu = adam_state_from_optax(_host(opt["shared"]))["mu"]
            for name, m in port.optimizers["shared"].state_dict()["mu"].items():
                np.testing.assert_array_equal(
                    np.sign(m.numpy()), np.sign(mu[name].numpy()),
                    err_msg=f"first-step gradient sign, {name}")

    want = params_from_flax(_host(params["shared"]))
    for name, p in port.models["shared"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)


def test_rollout_replays_jax_actions(jax_run, tmp_path):
    """The JAX-recorded actions through the port's full-step rollout from
    the same state, across auto-resets: done flags and rewards equal,
    observations within 6e-8 (an ulp below 1: compiled XLA divides
    ``t / episode_length`` and ``x / grid_length`` through the reciprocal),
    and no kNN kernel launched."""
    _, carry, batch = jax_run
    port = _port_trainer(tmp_path)
    assert not port.engine.has_split_step
    assert "observations" in port._env_state
    for name, value in port._env_state.items():
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(carry["env_state"][name]),
                                      err_msg=name)
    knn_obs.reset_launch_counts()
    got = port._rollout(torch.from_numpy(batch["actions_shared"].copy()))
    assert knn_obs.LAUNCH_COUNTS == dict.fromkeys(knn_obs.KERNELS, 0)
    np.testing.assert_array_equal(got["done"].numpy(), batch["done"])
    assert (batch["done"] > 0).any()  # the replay crosses an auto-reset
    np.testing.assert_array_equal(got["actions_shared"].numpy(),
                                  batch["actions_shared"])
    np.testing.assert_array_equal(got["rewards_shared"].numpy(),
                                  batch["rewards_shared"])
    np.testing.assert_allclose(got["obs_shared"].numpy(), batch["obs_shared"],
                               rtol=0, atol=6e-8)


def _results(path):
    with open(os.path.join(path, "results.json"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


# per config: the cuts to a small CPU run, and the state arrays its reset
# pools target
_SMALL = {
    "tag_gridworld": ({"grid_length": 10, "episode_length": 20}, []),
    "tag_gridworld_with_reset_pool": (
        {"grid_length": 10, "episode_length": 20}, ["loc_x", "loc_y"]),
    "single_cartpole": ({"episode_length": 50, "reset_pool_size": 20},
                        ["state"]),
    "single_acrobot": ({"episode_length": 20, "reset_pool_size": 20},
                       ["state"]),
    "single_mountain_car": ({"episode_length": 40, "reset_pool_size": 20},
                            ["state"]),
}


@pytest.mark.parametrize("name", FULL_STEP_CONFIGS)
def test_cpu_training_of_each_config(name, tmp_path):
    """Four envs, 20 steps an iteration, five iterations: finite metrics,
    moved parameters, a checkpoint and, where the config has them, its
    reset pools registered."""
    env_cuts, pool_targets = _SMALL[name]
    cfg = port_config.load_run_config(name)
    cfg["env"].update(env_cuts)
    cfg["trainer"].update({"num_envs": 4, "train_batch_size": 80, "seed": 2})
    cfg["trainer"]["num_episodes"] = 400 // env_cuts["episode_length"]
    cfg["saving"]["metrics_log_freq"] = 5
    trainer = port_train.setup_trainer(cfg, verbose=False,
                                       results_dir=str(tmp_path / "res"),
                                       device="cpu")
    assert sorted(trainer.engine.store.pools) == pool_targets
    before = {k: v.clone()
              for k, v in trainer.models["shared"].state_dict().items()}
    trainer.train()
    assert trainer.iters_completed == trainer.num_iters == 5
    [record] = _results(tmp_path / "res")
    assert all(np.isfinite(v) for v in record["metrics"]["shared"].values())
    assert any(not torch.equal(v, before[k])
               for k, v in trainer.models["shared"].state_dict().items())
    assert "shared_400.state_dict" in os.listdir(tmp_path / "res")


def test_cli_trains_single_cartpole_on_the_cpu(tmp_path):
    """``-e single_cartpole --device cpu --num_envs 1000 --num_episodes
    100``: ``--num_envs`` sets the replicas alone, as in the JAX CLI, so an
    iteration keeps the config's 50,000 env-steps, 50 a replica, and the
    run takes one iteration.  Too few episodes for one batch raise, as in
    JAX: ``--num_envs 4 --num_episodes 8`` is 4,000 env-steps."""
    trainer = port_train.main([
        "-e", "single_cartpole", "--device", "cpu", "--num_envs", "1000",
        "--num_episodes", "100", "--results_dir", str(tmp_path / "cli"),
    ])
    assert trainer.num_envs == 1000 and trainer.train_batch_size == 50000
    assert trainer.training_batch_size_per_env == 50
    assert trainer.iters_completed == 1
    assert trainer.engine.store.pools["state"].shape[0] == 1000
    assert "shared_50000.state_dict" in os.listdir(tmp_path / "cli")
    with pytest.raises(ValueError, match="Not enough episodes"):
        port_train.main([
            "-e", "single_cartpole", "--device", "cpu", "--num_envs", "4",
            "--num_episodes", "8", "--results_dir", str(tmp_path / "cli2"),
        ])


def test_cartpole_learns(tmp_path):
    """The port's A2C on CartPole (20 envs, 100 steps an iteration, 100
    iterations, episodes of 200, no pool; ``test_training_cartpole.py``'s
    config) raises the logged mean episodic reward, a running mean over
    every episode finished so far, by at least 10% from iteration 10 to
    iteration 100.  One CPU run of the JAX trainer at this config and seed
    rose 21% (22.514 to 27.256)."""
    cfg = port_config.load_run_config("single_cartpole")
    cfg["trainer"].update({"num_envs": 20, "train_batch_size": 2000,
                           "num_episodes": 1000, "seed": 11})
    cfg["env"].update({"episode_length": 200, "reset_pool_size": 0,
                       "seed": 5})
    cfg["saving"].update({"metrics_log_freq": 10,
                          "model_params_save_freq": 10_000})
    port_train.setup_trainer_and_train(cfg, verbose=False, device="cpu",
                                       results_dir=str(tmp_path / "res"))
    records = _results(tmp_path / "res")
    assert [r["iterations completed"] for r in records] == list(
        range(10, 101, 10))
    rewards = [r["metrics"]["shared"]["Mean episodic reward"]
               for r in records]
    assert rewards[-1] >= 1.1 * rewards[0], rewards


@pytest.mark.parametrize("name,item", [("asymmetric_pursuit", "8")])
def test_left_out_run_configs_raise(name, item, tmp_path):
    """No run config is left out any more: ``asymmetric_pursuit``, which
    raised naming ROADMAP queue 1 item ``item`` until that item was ported,
    now builds its trainer on the CPU, and an unknown name raises."""
    cfg = port_config.load_run_config(name)
    assert cfg["name"] == name
    cfg["trainer"].update({"num_envs": 2, "train_batch_size": 20,
                           "num_episodes": 1})
    trainer = port_train.setup_trainer(cfg, results_dir=str(tmp_path / "x"),
                                       verbose=False, device="cpu")
    assert trainer.engine.separate_placeholders
    cfg["name"] = "not_a_run_config"
    with pytest.raises(KeyError):
        port_train.setup_trainer(cfg, results_dir=str(tmp_path / "y"),
                                 device="cpu")


@pytest.mark.parametrize("name,env", [
    ("single_pendulum", "ClassicControlPendulumEnv"),
    ("single_continuous_mountain_car",
     "ClassicControlContinuousMountainCarEnv")])
def test_ddpg_run_configs_build_a_ddpg_trainer(name, env, tmp_path):
    """The DDPG run configs, once left out, build a ``TrainerDDPG`` on the
    full-step path, with their Box bound (``output_w``) and window."""
    from warpdrive_tpu_torch.training.trainer_ddpg import TrainerDDPG

    cfg = port_config.load_run_config(name)
    cfg["env"].update({"episode_length": 20, "reset_pool_size": 20})
    cfg["trainer"].update({"num_envs": 4, "train_batch_size": 40})
    trainer = port_train.setup_trainer(cfg, results_dir=str(tmp_path / "x"),
                                       device="cpu", verbose=False)
    assert isinstance(trainer, TrainerDDPG)
    assert type(trainer.engine.env).__name__ == f"Torch{env}"
    assert not trainer.engine.has_split_step
    assert trainer.buffer_capacity == 10 + 5 - 1
    output_w = cfg["policy"]["shared"]["model"]["actor"]["output_w"]
    assert trainer.nets["actor"]["shared"].action_scale == output_w


@pytest.mark.parametrize("name", FULL_STEP_CONFIGS + [
    "single_pendulum", "single_continuous_mountain_car"])
def test_run_config_copies_parse_equal_to_jax(name):
    port_dir, jax_dir = port_config._RUN_CONFIG_DIR, jax_config._RUN_CONFIG_DIR
    assert port_config.load_yaml(os.path.join(port_dir, f"{name}.yaml")) == \
        jax_config.load_yaml(os.path.join(jax_dir, f"{name}.yaml"))
    assert port_config.load_run_config(name) == jax_config.load_run_config(name)
