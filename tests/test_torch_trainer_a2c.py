"""The port's A2C trainer (``warpdrive_tpu_torch/training``) against the JAX
package's, on a small TagContinuous config (10 agents, 5 envs, batch 200,
fc (32, 32)): the update from the same parameters, optimizer state and
recorded batch, the rollout replaying the JAX-recorded actions, a CPU
training run with checkpoints and a resume, the CLI, and the port's copies
of the run configs."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from warpdrive_tpu.tools.consistency import _assert_all_close
from warpdrive_tpu.training.scripts import train as jax_train
from warpdrive_tpu.training.scripts.train import setup_trainer as jax_setup
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.models.fully_connected import (
    adam_state_from_optax,
    params_from_flax,
)
from warpdrive_tpu_torch.ops import knn_obs
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.utils import config as port_config

# Parameters after two updates agree to 1e-5, 2e-3 of the runner's lr: the
# two frameworks sum the gradients in other orders (relative differences of
# 1e-6 or less here), and Adam's normalized step turns those into parameter
# differences far below lr.  Adam's first step is g / (|g| + 1e-8), which
# would turn float noise in a gradient near 0 into +-lr.  The test checks
# that this did not happen: after the first update every entry of the first
# moment (0.1 g) has the same sign on both sides, so every entry is then
# compared; gradients that are exactly 0 (inputs that are always 0) are 0 on
# both sides.
PARAM_ATOL = 1e-5


def _config(load, **trainer):
    cfg = load("tag_continuous")
    cfg["env"].update({"num_taggers": 2, "num_runners": 8,
                       "episode_length": 20, "num_other_agents_observed": 4})
    cfg["trainer"].update({"num_envs": 5, "train_batch_size": 200,
                           "num_episodes": 100, "seed": 3, **trainer})
    for policy in ("runner", "tagger"):
        cfg["policy"][policy]["model"]["fc_dims"] = [32, 32]
    cfg["saving"]["metrics_log_freq"] = 5
    return cfg


def _port_trainer(tmp_path, name="port", **trainer):
    return port_train.setup_trainer(
        _config(port_config.load_run_config, **trainer), verbose=False,
        results_dir=str(tmp_path / name), device="cpu",
    )


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX trainer, its initial carry and the batch its rollout records."""
    trainer = jax_setup(_config(jax_config.load_run_config), verbose=False,
                        results_dir=str(tmp_path_factory.mktemp("jax")))
    carry = trainer._carry
    rollout = jax.jit(trainer._build_rollout_profile_fn())
    _, batch = rollout(carry, jax.random.PRNGKey(0))
    batch = jax.tree_util.tree_map(np.asarray, batch)
    return trainer, carry, batch


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_two_updates_match_jax(jax_run, tmp_path):
    jtrainer, carry, batch = jax_run
    port = _port_trainer(tmp_path)
    params, opt = carry["params"], carry["opt"]
    for tag in port.policies:
        port.models[tag].load_state_dict(params_from_flax(_host(params[tag])))
        port.optimizers[tag].load_state_dict(
            adam_state_from_optax(_host(opt[tag])))
    update = jax.jit(jtrainer._make_update(with_metrics=True))
    port_batch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}

    for step, timestep in enumerate((0, 200)):
        params, opt, jmetrics = update(params, opt, batch,
                                       jnp.float32(timestep),
                                       jax.random.PRNGKey(1))
        metrics = port._update(port_batch, timestep)
        for tag in port.policies:
            for name in ("Total loss", "Gradient norm", "Learning rate"):
                np.testing.assert_allclose(float(metrics[tag][name]),
                                           float(jmetrics[tag][name]),
                                           rtol=1e-5)
            if step == 0:
                mu = adam_state_from_optax(_host(opt[tag]))["mu"]
                for name, m in port.optimizers[tag].state_dict()["mu"].items():
                    np.testing.assert_array_equal(
                        np.sign(m.numpy()), np.sign(mu[name].numpy()),
                        err_msg=f"first-step gradient sign, {tag} {name}")

    for tag in port.policies:
        want = params_from_flax(_host(params[tag]))
        for name, p in port.models[tag].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{tag} {name}")


def test_rollout_replays_jax_actions(jax_run, tmp_path):
    """The JAX-recorded actions through the port's rollout from the same
    seeded state: observations and rewards within the consistency
    oracle's 1%, done flags equal, across an auto-reset."""
    jtrainer, carry, batch = jax_run
    port = _port_trainer(tmp_path)
    for name, value in port._env_state.items():
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(carry["env_state"][name]),
                                      err_msg=name)
    T, E = batch["done"].shape
    actions = np.zeros((T, E, port.engine.n_agents, 2), np.int32)
    for tag, ids in port.policy_tag_to_agent_id_map.items():
        actions[:, :, ids] = batch[f"actions_{tag}"]
    knn_obs.reset_launch_counts()
    got = port._rollout(torch.from_numpy(actions))
    assert knn_obs.LAUNCH_COUNTS == dict.fromkeys(knn_obs.KERNELS, 0)
    np.testing.assert_array_equal(got["done"].numpy(), batch["done"])
    assert (batch["done"] > 0).any()  # the replay crosses an auto-reset
    for tag in port.policies:
        np.testing.assert_array_equal(got[f"actions_{tag}"].numpy(),
                                      batch[f"actions_{tag}"])
        for t in range(T):
            for kind in ("obs", "rewards"):
                _assert_all_close(got[f"{kind}_{tag}"][t].numpy(),
                                  batch[f"{kind}_{tag}"][t], 1.0,
                                  f"{kind}_{tag} at t={t}")


def _results(path):
    with open(os.path.join(path, "results.json"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def test_cpu_training_run_checkpoints_and_resume(tmp_path):
    trainer = port_train.setup_trainer_and_train(
        _config(port_config.load_run_config, num_episodes=100),
        verbose=False, results_dir=str(tmp_path / "res"), device="cpu",
    )
    assert trainer.iters_completed == trainer.num_iters == 10
    assert trainer.current_timestep == 2000
    records = _results(tmp_path / "res")
    assert [r["iterations completed"] for r in records] == [5, 10]
    for record in records:
        assert set(record["metrics"]) == {"runner", "tagger"}
        for metrics in record["metrics"].values():
            assert all(np.isfinite(v) for v in metrics.values())
    assert len(trainer.phase_ms) == 10
    files = os.listdir(tmp_path / "res")
    for tag in ("runner", "tagger"):
        assert f"{tag}_2000.state_dict" in files

    # a new run resumes from the checkpoints: parameters and timestep
    cfg = _config(port_config.load_run_config, num_episodes=20)
    for tag in ("runner", "tagger"):
        cfg["policy"][tag]["model"]["model_ckpt_filepath"] = str(
            tmp_path / "res" / f"{tag}_2000.state_dict")
    resumed = port_train.setup_trainer(cfg, verbose=False,
                                       results_dir=str(tmp_path / "res2"),
                                       device="cpu")
    assert resumed.current_timestep == 2000
    for tag in ("runner", "tagger"):
        for name, value in resumed.models[tag].state_dict().items():
            torch.testing.assert_close(value,
                                       trainer.models[tag].state_dict()[name],
                                       rtol=0, atol=0)
    resumed.train()
    assert resumed.current_timestep == 2000 + 2 * 200
    assert "runner_2400.state_dict" in os.listdir(tmp_path / "res2")


def test_cli_main_on_a_tiny_config(tmp_path):
    cfg = _config(port_config.load_run_config)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    trainer = port_train.main([
        "-e", str(path), "--num_episodes", "20", "--num_envs", "4",
        "--results_dir", str(tmp_path / "cli"), "--device", "cpu",
    ])
    # --num_envs sets num_envs alone, as in the JAX CLI: an iteration keeps
    # the config's 200 env-steps, 50 a replica
    assert trainer.num_envs == 4 and trainer.train_batch_size == 200
    assert trainer.training_batch_size_per_env == 50
    assert trainer.iters_completed == 2
    assert "tagger_400.state_dict" in os.listdir(tmp_path / "cli")
    # -a runs the auto-scaler (tests/test_torch_autoscaler.py); -n 2 on the
    # CPU trains two gloo ranks (tests/test_torch_multiprocess.py); on cuda
    # it needs two cards, and a coordinator needs the world's size and this
    # process's id, each checked before anything starts
    for flags, match in ((["-n", "2", "--device", "cuda"], "2 GPUs"),
                         (["--coordinator", "localhost:1234"],
                          "--num_processes")):
        with pytest.raises(ValueError, match=match):
            port_train.main(["-e", str(path), "--device", "cpu", *flags])


def test_left_out_features_raise(tmp_path):
    # the eager host-env backend is ported: both names build it, "cpp"
    # with the C++ steppers required
    for backend in ("cpu", "cpp"):
        cfg = _config(port_config.load_run_config, env_backend=backend)
        trainer = port_train.setup_trainer(
            cfg, results_dir=str(tmp_path / backend), verbose=False,
            device="cpu")
        assert trainer._is_eager and trainer.engine._native is not None
    # several devices need a process group of that many ranks
    # (tests/test_torch_multiprocess.py trains inside one)
    with pytest.raises(ValueError, match="initialized process group"):
        port_train.setup_trainer(_config(port_config.load_run_config),
                                 num_devices=2, device="cpu",
                                 results_dir=str(tmp_path / "n2"))
    # the update options and profile_phases are ported: they build and run
    cfg = _config(port_config.load_run_config, update_recompute_obs=True,
                  batch_dtype="bfloat16", num_episodes=10)
    cfg["policy"]["runner"].update(num_epochs=2, remat=True)
    cfg["policy"]["tagger"]["model"]["dtype"] = "bfloat16"
    trainer = port_train.setup_trainer(cfg, results_dir=str(tmp_path / "z"),
                                       verbose=False, device="cpu")
    assert trainer._recompute_obs
    assert trainer.update_options["runner"].remat
    assert {"iteration_ms", "rollout_ms", "update_ms"} <= set(
        trainer.profile_phases(repeats=1))
    # every run config of the JAX package's CLI builds through the port's
    # (asymmetric_pursuit was the last to be ported)
    assert set(port_train._ENV_SETUPS) == set(jax_train._ENV_SETUPS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_train.setup_trainer(_config(port_config.load_run_config),
                                     results_dir=str(tmp_path / "y"))


@pytest.mark.parametrize("name", ["default_configs", "tag_continuous"])
def test_run_config_copies_parse_equal_to_jax(name):
    port_dir, jax_dir = port_config._RUN_CONFIG_DIR, jax_config._RUN_CONFIG_DIR
    assert os.path.abspath(port_dir) != os.path.abspath(jax_dir)
    assert port_config.load_yaml(os.path.join(port_dir, f"{name}.yaml")) == \
        jax_config.load_yaml(os.path.join(jax_dir, f"{name}.yaml"))
    if name == "tag_continuous":
        assert port_config.load_run_config(name) == \
            jax_config.load_run_config(name)
        assert port_config.load_run_config(name)["env"]["knn_algorithm"] == \
            "pallas_mxu_exact"


def test_training_config_observes_through_the_single_tile_variant():
    """The shipped config's 110 agents stay on the single-tile kernel."""
    cfg = port_config.load_run_config("tag_continuous")
    env = TorchTagContinuous(**cfg["env"])
    assert env.num_agents == 110 and env.obs_size == 81
    assert env.knn_algorithm == "pallas_mxu_exact"
