"""TagContinuous's full-observation mode in the port
(``TorchTagContinuous.full_observation``) against the JAX package and the
numpy reference: the observation of random states with observers out of the
game (1e-6), the step beside JAX's on the full-observation configs of
``tests/test_consistency_tag_continuous.py`` and on the 2 + 8 env of the
JAX package's multichip dry run (observations 1e-6, from JAX's state each
step), the lockstep checker, one A2C and one PPO update from JAX's weights
and batch (1e-5), and the constructor's defaults."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.envs.tag_continuous import TpuTagContinuous
from warpdrive_tpu.training.scripts.train import setup_trainer as jax_setup
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.envs import tag_continuous as port_tag_continuous
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.envs.tag_continuous import (
    TagContinuous,
    TorchTagContinuous,
)
from warpdrive_tpu_torch.models.fully_connected import (
    adam_state_from_optax,
    params_from_flax,
)
from warpdrive_tpu_torch.tools.consistency import (
    EnvironmentCPUvsDevice,
    draw_actions,
    pack_actions,
)
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.utils import config as port_config
from warpdrive_tpu_torch.utils.constants import Constants

_OBS = Constants.OBSERVATIONS
OBS_ATOL = 1e-6  # float32 features; the divisions are the same on both
PHYS_ATOL = 1e-5  # cos/sin of the two frameworks, as in the kNN tests
PARAM_ATOL = 1e-5  # one update, as in test_torch_trainer_a2c.py

FULL_OBS_CONFIGS = {
    # tests/test_consistency_tag_continuous.py's full-observation cases
    "full_obs": {"num_taggers": 2, "num_runners": 8, "grid_length": 20.0,
                 "episode_length": 30, "use_full_observation": True,
                 "seed": 274880},
    "easy_tagging": {"num_taggers": 4, "num_runners": 6, "grid_length": 5.0,
                     "episode_length": 40, "use_full_observation": True,
                     "tagging_distance": 0.25, "seed": 11},
    # the JAX package's multichip dry run (__graft_entry__.py)
    "dry_run": {"num_taggers": 2, "num_runners": 8, "grid_length": 10.0,
                "episode_length": 8, "num_acceleration_levels": 5,
                "num_turn_levels": 5, "use_full_observation": True,
                "seed": 0},
}


@pytest.fixture
def no_knn(monkeypatch):
    """Fail on any call of the kNN observation (kernel or plain)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the full observation called the kNN path")

    monkeypatch.setattr(port_tag_continuous, "knn_observation", refuse)


def _random_state(env, E, seed):
    """Random positions in a small box, a quarter of the agents out."""
    rng = np.random.RandomState(seed)
    N = env.num_agents
    f32 = np.float32
    return {
        "loc_x": rng.uniform(0, 2, (E, N)).astype(f32),
        "loc_y": rng.uniform(0, 2, (E, N)).astype(f32),
        "speed": rng.uniform(0, 1, (E, N)).astype(f32),
        "acceleration": rng.uniform(-0.1, 0.1, (E, N)).astype(f32),
        "direction": rng.uniform(0, 2 * np.pi, (E, N)).astype(f32),
        "still_in_the_game": (rng.uniform(size=(E, N)) > 0.25).astype(
            np.int32),
        Constants.TIMESTEP: rng.randint(0, env.episode_length,
                                        (E,)).astype(np.int32),
    }


@pytest.mark.parametrize("name", sorted(FULL_OBS_CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_observation_matches_jax_with_dead_observers(name, seed):
    cfg = FULL_OBS_CONFIGS[name]
    jenv, penv = TpuTagContinuous(**cfg), TorchTagContinuous(**cfg)
    state = _random_state(penv, 6, seed)
    want = np.asarray(jax.vmap(jenv.observe_fn)(
        {k: jnp.asarray(v) for k, v in state.items()}))
    got = penv.observe_batch_fn(
        {k: torch.from_numpy(v) for k, v in state.items()}).numpy()
    assert got.shape == want.shape == (6, penv.num_agents, penv.obs_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=OBS_ATOL)
    dead = state["still_in_the_game"] == 0
    assert dead.any()
    # a dead observer sees zero relative features and time: only the
    # others' types and in-game flags stay
    N = penv.num_agents
    rows = got[dead][:, :-1].reshape(-1, 7, N - 1)
    assert (rows[:, :5] == 0).all() and (got[dead][:, -1] == 0).all()


@pytest.mark.parametrize("name", sorted(FULL_OBS_CONFIGS))
def test_step_matches_jax(name, no_knn):
    """60 steps of numpy-drawn actions with done-driven resets; each step
    of the port starts from JAX's state.  Observations within 1e-6, the
    physics within 1e-5, integer arrays equal, and no call of the kNN
    path."""
    cfg = FULL_OBS_CONFIGS[name]
    jeng = JaxEnvEngine(env_obj=TpuTagContinuous(**cfg), num_envs=4, seed=0)
    peng = EnvEngine(env_obj=TorchTagContinuous(**cfg), num_envs=4, seed=0,
                     device="cpu")
    jstep = jax.jit(jeng.step)
    jstate = dict(jeng.state)
    rng = np.random.RandomState(9)
    for t in range(60):
        actions = pack_actions(draw_actions(rng, peng), peng)
        pstate = {k: torch.from_numpy(np.array(jstate[k]))
                  for k in peng.state}
        out = peng.step(pstate, actions)
        jstate = jstep(jstate, jnp.asarray(actions.numpy()))
        for key, value in out.items():
            want = np.asarray(jstate[key])
            if value.is_floating_point():
                atol = OBS_ATOL if key == _OBS else PHYS_ATOL
                np.testing.assert_allclose(value.numpy(), want, rtol=0,
                                           atol=atol, err_msg=f"{key} {t}")
            else:
                np.testing.assert_array_equal(value.numpy(), want,
                                              err_msg=f"{key} t={t}")
        jstate = jeng.auto_reset(jstate, jax.random.PRNGKey(t))


def test_numpy_vs_torch_through_the_checker():
    EnvironmentCPUvsDevice(
        cpu_env_class=TagContinuous, device_env_class=TorchTagContinuous,
        env_configs=FULL_OBS_CONFIGS, num_envs=3, num_episodes=2,
        device="cpu",
    ).test_env_reset_and_step(threshold_pct=1.0, seed=41)


def _config(load, algorithm):
    cfg = load("tag_continuous")
    cfg["env"].update({"num_taggers": 2, "num_runners": 8,
                       "episode_length": 20, "use_full_observation": True})
    cfg["trainer"].update({"num_envs": 5, "train_batch_size": 100,
                           "num_episodes": 10, "seed": 3})
    for policy in ("runner", "tagger"):
        cfg["policy"][policy]["model"]["fc_dims"] = [32, 32]
        cfg["policy"][policy]["algorithm"] = algorithm
    return cfg


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("algorithm", ["A2C", "PPO"])
def test_one_update_matches_jax(algorithm, tmp_path):
    jtrainer = jax_setup(_config(jax_config.load_run_config, algorithm),
                         verbose=False, results_dir=str(tmp_path / "jax"))
    carry = jtrainer._carry
    _, batch = jax.jit(jtrainer._build_rollout_profile_fn())(
        carry, jax.random.PRNGKey(0))
    batch = _host(batch)
    port = port_train.setup_trainer(
        _config(port_config.load_run_config, algorithm), verbose=False,
        results_dir=str(tmp_path / "port"), device="cpu")
    assert port.engine.env.knn_algorithm == "pallas_mxu_exact"  # inert
    params, opt = carry["params"], carry["opt"]
    for tag in port.policies:
        port.models[tag].load_state_dict(params_from_flax(_host(params[tag])))
        port.optimizers[tag].load_state_dict(
            adam_state_from_optax(_host(opt[tag])))
        assert port.models[tag].Dense_0.weight.shape[1] == 7 * 9 + 1
    params, _, jmetrics = jax.jit(jtrainer._make_update(with_metrics=True))(
        params, opt, batch, jnp.float32(0), jax.random.PRNGKey(1))
    metrics = port._update({k: torch.from_numpy(v.copy())
                            for k, v in batch.items()}, 0)
    for tag in port.policies:
        np.testing.assert_allclose(float(metrics[tag]["Total loss"]),
                                   float(jmetrics[tag]["Total loss"]),
                                   rtol=1e-5)
        want = params_from_flax(_host(params[tag]))
        for name, p in port.models[tag].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{tag} {name}")


def test_training_takes_no_knn_path(tmp_path, no_knn):
    trainer = port_train.setup_trainer(
        _config(port_config.load_run_config, "A2C"), verbose=False,
        results_dir=str(tmp_path / "r"), device="cpu")
    trainer.train()
    assert trainer.iters_completed == 2
    rew, _ = trainer.evaluate_episodes()
    assert np.isfinite(rew["runner"]).all()


def test_defaults_construct_and_step():
    env = TorchTagContinuous()
    assert env.use_full_observation and env.num_agents == 11
    engine = EnvEngine(env_obj=env, num_envs=3, device="cpu")
    obs = engine.reset()
    assert obs.shape == (3, 11, 7 * 10 + 1)
    rng = np.random.RandomState(0)
    for _ in range(5):
        out = engine.step_all_envs(
            pack_actions(draw_actions(rng, engine), engine))
    assert torch.isfinite(out[_OBS]).all()
    assert (engine.state[Constants.TIMESTEP] == 5).all()
    np.testing.assert_array_equal(engine.obs_at_reset(), obs[0].numpy())
