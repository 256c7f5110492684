"""``TrainerBase.profile_phases`` in the port
(``warpdrive_tpu_torch/training/trainer_base.py``) on the CPU: the JAX
package's keys (from a JAX trainer's own call), positive times, the
breakdown on ``perf_stats``, and the trainer's state -- models, optimizer
states, rollout env state, episodic accounting, generators -- unchanged bit
for bit after the call, so training goes on as without it; for the A2C
trainer with minibatched PPO and for DDPG."""

import copy

import numpy as np
import pytest
import torch

from warpdrive_tpu.training.scripts.train import setup_trainer as jax_setup
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.training.trainer_base import _to_host
from warpdrive_tpu_torch.utils import config as port_config


def _a2c_config(load, minibatched=True):
    cfg = load("tag_continuous")
    cfg["env"].update({"num_taggers": 2, "num_runners": 8,
                       "episode_length": 20, "num_other_agents_observed": 4})
    cfg["trainer"].update({"num_envs": 4, "train_batch_size": 40,
                           "num_episodes": 20, "seed": 3})
    for tag in ("runner", "tagger"):
        cfg["policy"][tag]["model"]["fc_dims"] = [16, 16]
        if minibatched:
            cfg["policy"][tag].update(algorithm="PPO", num_epochs=2,
                                      num_minibatches=2)
    cfg["saving"]["metrics_log_freq"] = 1
    return cfg


def _ddpg_config(load):
    cfg = load("single_pendulum")
    cfg["env"].update({"episode_length": 8, "reset_pool_size": 0, "seed": 3})
    cfg["trainer"].update({"num_envs": 4, "train_batch_size": 20,
                           "num_episodes": 20, "n_step": 3, "seed": 7})
    for net in ("actor", "critic"):
        cfg["policy"]["shared"]["model"][net]["fc_dims"] = [16, 16]
    cfg["saving"]["metrics_log_freq"] = 1
    return cfg


CONFIGS = {"a2c_ppo_minibatched": _a2c_config, "ddpg": _ddpg_config}


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """The keys of the JAX trainer's ``profile_phases`` result."""
    trainer = jax_setup(_a2c_config(jax_config.load_run_config, False),
                        verbose=False,
                        results_dir=str(tmp_path_factory.mktemp("jax")))
    return set(trainer.profile_phases(repeats=1))


def _state(trainer):
    return {"training": _to_host(trainer._training_state()),
            "engine": _to_host(dict(trainer.engine.state)),
            "generators": [trainer.generator.get_state(),
                           trainer.engine.store.generator.get_state()],
            "timestep": trainer.current_timestep,
            "phase_ms": list(trainer.phase_ms)}


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            _assert_same(a[key], b[key], f"{path}/{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_profile_phases_keys_times_and_restored_state(name, jax_keys,
                                                      tmp_path):
    cfg = CONFIGS[name](port_config.load_run_config)
    trainer = port_train.setup_trainer(copy.deepcopy(cfg), verbose=False,
                                       results_dir=str(tmp_path / "a"),
                                       device="cpu")
    twin = port_train.setup_trainer(copy.deepcopy(cfg), verbose=False,
                                    results_dir=str(tmp_path / "b"),
                                    device="cpu")
    trainer._iteration(0)  # profile mid-run, as a bench would
    twin._iteration(0)
    trainer.current_timestep = twin.current_timestep = 40
    before = _state(trainer)

    prof = trainer.profile_phases(repeats=2)
    assert set(prof) == jax_keys
    for key in ("iteration_ms", "rollout_ms", "update_ms", "steps_per_sec",
                "rollout_steps_per_sec"):
        assert np.isfinite(prof[key]) and prof[key] > 0, key
    assert prof["update_ms_direct"] is True
    assert prof["update_ms_residual"] == max(
        prof["iteration_ms"] - prof["rollout_ms"], 0.0)
    for key in ("iteration_ms", "rollout_ms", "update_ms"):
        assert len(prof[f"{key}_repeats"]) == 2
        assert prof[key] == min(prof[f"{key}_repeats"])
    steps = trainer.training_batch_size_per_env * trainer.num_envs
    assert prof["steps_per_sec"] == pytest.approx(
        steps / (prof["iteration_ms"] / 1e3))

    _assert_same(_state(trainer), before)
    trainer.train()
    twin.train()
    _assert_same(_to_host(trainer._training_state()),
                 _to_host(twin._training_state()))
    stats = trainer.perf_stats.get_perf_stats()
    assert stats["Profiled update time per iter (ms)"] == prof["update_ms"]
    assert stats["Profiled rollout time per iter (ms)"] == prof["rollout_ms"]
