"""The training CLI's ``--num_envs`` in the port
(``warpdrive_tpu_torch/training/scripts/train.py``) and in the JAX package
(``warpdrive_tpu/training/scripts/train.py``): one command line, run through
both CLIs' config handling up to a built trainer, gives the same
``num_envs``, ``train_batch_size`` and number of iterations, or the same
error.  On a CartPole run config cut to size (episodes of 20 steps, 80
env-steps an iteration, no pool, fc (8, 8))."""

import sys

import pytest
import yaml

from warpdrive_tpu.training.scripts import train as jax_train
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.training.scripts import train as port_train


def _small_cartpole(tmp_path):
    cfg = jax_config.load_yaml(
        f"{jax_config._RUN_CONFIG_DIR}/single_cartpole.yaml")
    cfg["env"].update({"episode_length": 20, "reset_pool_size": 0})
    cfg["trainer"].update({"num_envs": 4, "train_batch_size": 80,
                           "num_episodes": 8})
    cfg["policy"]["shared"]["model"]["fc_dims"] = [8, 8]
    path = tmp_path / "small_cartpole.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _built(module, **kw):
    """A stand-in for ``setup_trainer_and_train`` that builds the trainer
    (no training) and records its batch algebra, or the error."""
    seen = []

    def build(run_config, *args, results_dir=None, **_):
        try:
            trainer = module.setup_trainer(run_config, results_dir=results_dir,
                                           verbose=False, **kw)
            seen.append((trainer.num_envs, trainer.train_batch_size,
                         trainer.training_batch_size_per_env,
                         trainer.num_iters))
        except (AssertionError, ValueError) as exc:
            seen.append((type(exc), str(exc).splitlines()[0]))
        return None

    return build, seen


@pytest.mark.parametrize("flags,want", [
    # 16 replicas share the 80 env-steps: 5 a replica, 160 / 80 iterations
    (["--num_envs", "16", "--num_episodes", "8"], (16, 80, 5, 2)),
    (["--num_envs", "2", "--num_episodes", "12"], (2, 80, 40, 3)),
    # 40 env-steps of episodes cannot fill one batch of 80
    (["--num_envs", "8", "--num_episodes", "2"], ValueError),
    # more replicas than env-steps in a batch
    (["--num_envs", "100"], AssertionError),
])
def test_num_envs_matches_the_jax_cli(flags, want, tmp_path, monkeypatch):
    path = _small_cartpole(tmp_path)
    argv = ["-e", path, *flags, "--results_dir", str(tmp_path / "out")]

    port_build, port_seen = _built(port_train, device="cpu")
    monkeypatch.setattr(port_train, "setup_trainer_and_train", port_build)
    port_train.main(argv)

    jax_build, jax_seen = _built(jax_train)
    monkeypatch.setattr(jax_train, "setup_trainer_and_train", jax_build)
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    jax_train.main()

    assert port_seen == jax_seen
    if isinstance(want, tuple):
        assert port_seen == [want]
    else:
        assert port_seen[0][0] is want
