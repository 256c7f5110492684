"""The port's episode animation (``warpdrive_tpu_torch/tools/animate.py``),
after ``tests/test_logged_episode_animation.py``: a small TagContinuous
trainer's device-side episode log, then an animation file drawn from it,
or, where the tracks are not logged, from ``fetch_episode_states``.  The
module imports matplotlib only when it draws."""

import subprocess
import sys

import numpy as np

from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.training.trainer_a2c import TrainerA2C

_ENV = dict(num_taggers=2, num_runners=6, grid_length=10.0,
            episode_length=15, use_full_observation=False,
            num_other_agents_observed=3, seed=9)


def _trainer(tmp_path, engine, env, num_envs=3):
    taggers = [i for i in range(env.num_agents) if env.agent_type[i] == 1]
    runners = [i for i in range(env.num_agents) if env.agent_type[i] == 0]
    cfg = {
        "name": "tc_anim",
        "env": {},
        "trainer": {"num_envs": num_envs, "num_episodes": 20,
                    "train_batch_size": num_envs * 5, "seed": 2},
        "policy": {
            "tagger": {"to_train": True, "algorithm": "A2C",
                       "model": {"type": "fully_connected", "fc_dims": [16]}},
            "runner": {"to_train": True, "algorithm": "A2C",
                       "model": {"type": "fully_connected", "fc_dims": [16]}},
        },
        "saving": {"metrics_log_freq": 100, "model_params_save_freq": 1000},
    }
    return TrainerA2C(
        env_wrapper=engine, config=cfg,
        policy_tag_to_agent_id_map={"tagger": taggers, "runner": runners},
        verbose=False, results_dir=str(tmp_path / "r"),
    )


def _device_trainer(tmp_path, num_envs=3):
    env = TorchTagContinuous(**_ENV)
    engine = EnvEngine(env_obj=env, num_envs=num_envs, seed=9, device="cpu")
    return _trainer(tmp_path, engine, env, num_envs)


def test_fetch_logged_episode(tmp_path):
    trainer = _device_trainer(tmp_path)
    traj = trainer.fetch_logged_episode()
    assert set(traj) == {"loc_x", "loc_y", "still_in_the_game"}
    T = traj["loc_x"].shape[0]
    assert 2 <= T <= trainer.engine.episode_length + 1
    assert traj["loc_x"].shape == (T, trainer.engine.n_agents)
    np.testing.assert_allclose(
        traj["loc_x"][0], trainer.engine.store.snapshot["loc_x"].numpy())
    assert np.abs(np.diff(traj["loc_x"], axis=0)).sum() > 0


def test_logger_to_animation_file(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from warpdrive_tpu_torch.tools.animate import (
        generate_tag_rollout_animation,
    )

    trainer = _device_trainer(tmp_path)
    anim = generate_tag_rollout_animation(trainer, fps=10)
    out = tmp_path / "rollout.gif"
    anim.save(str(out), writer="pillow")
    assert out.exists() and out.stat().st_size > 1000
    assert anim._save_count == trainer.fetch_logged_episode()["loc_x"].shape[0]


def test_unlogged_tracks_animate_from_fetched_states(tmp_path):
    """Without the tracks in the episode log the animation reads
    ``fetch_episode_states``, as the JAX helper does."""
    import matplotlib

    matplotlib.use("Agg")
    from warpdrive_tpu_torch.tools.animate import (
        generate_tag_rollout_animation,
    )

    trainer = _device_trainer(tmp_path)
    trainer.engine.store.log_names = []
    fetched = []
    fetch = trainer.fetch_episode_states
    trainer.fetch_episode_states = lambda names, **kw: fetched.append(
        names) or fetch(names, **kw)
    anim = generate_tag_rollout_animation(trainer, fps=10)
    assert fetched == [["loc_x", "loc_y", "still_in_the_game"]]
    out = tmp_path / "fetched.gif"
    anim.save(str(out), writer="pillow")
    assert out.exists() and out.stat().st_size > 1000


def test_animate_imports_no_matplotlib():
    code = ("import sys; import warpdrive_tpu_torch.tools.animate; "
            "print('matplotlib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "False"
