"""The port's evaluation, episode fetching and logging, and full-state
checkpoints (``warpdrive_tpu_torch/training/trainer_base.py``,
``core/episode_log.py``) against the JAX package's, on the CPU at a small
size: ``evaluate_episodes`` in lockstep with JAX (A2C's most likely actions
on CartPole, DDPG's noise-free ones on Pendulum; rewards within 1e-4, step
sums equal), DDPG's ``fetch_episode_states`` in lockstep, the training that
follows an evaluation unchanged, the ``trainer.evaluator`` metrics, the
``EpisodeLogger`` per ``tests/test_episode_logger.py``,
``fetch_logged_episode`` on a small TagContinuous against JAX's (1%), A2C's
action probabilities, and a resume from a full-state checkpoint bit for bit
(A2C on CartPole per ``tests/test_full_state_checkpoint.py``, and DDPG on
Pendulum)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.training.scripts.train import setup_trainer as jax_setup
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.core.episode_log import EpisodeLogger
from warpdrive_tpu_torch.envs import register_all_envs
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.models.fully_connected import params_from_flax
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.utils import config as port_config
from warpdrive_tpu_torch.utils.constants import Constants

_OBS = Constants.OBSERVATIONS
# evaluation sums up to 50 rewards an env: the two frameworks' float32
# dynamics (sin/cos, compiled XLA against eager torch) differ in last bits
EVAL_TOL = 1e-4


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _classic_config(load, name, env_seed=5, **trainer):
    """CartPole (A2C) or Pendulum (DDPG) at 16 envs, 10 steps an
    iteration, episodes of 50, a pool of 40, fc (16, 16)."""
    cfg = load(name)
    cfg["env"].update({"episode_length": 50, "reset_pool_size": 40,
                       "seed": env_seed})
    cfg["trainer"].update({"num_envs": 16, "train_batch_size": 160,
                           "num_episodes": 20, "seed": 3, **trainer})
    model = cfg["policy"]["shared"]["model"]
    for net in ("actor", "critic") if "actor" in model else (None,):
        (model[net] if net else model)["fc_dims"] = [16, 16]
    cfg["saving"].update({"metrics_log_freq": 2,
                          "model_params_save_freq": 10_000})
    return cfg


_CLASSIC = {"a2c": "single_cartpole", "ddpg": "single_pendulum"}


def _port_trainer(tmp_path, kind, name="port", **trainer):
    cfg = _classic_config(port_config.load_run_config, _CLASSIC[kind],
                          **trainer)
    return port_train.setup_trainer(cfg, verbose=False, device="cpu",
                                    results_dir=str(tmp_path / name))


def _copy_params(jtrainer, port):
    """The JAX trainer's nets into the port's."""
    carry = jtrainer._carry
    if "params" in carry:
        for tag, params in carry["params"].items():
            port.models[tag].load_state_dict(params_from_flax(_host(params)))
        return
    for net in ("actor", "critic"):
        for tag, params in carry[net].items():
            port.nets[net][tag].load_state_dict(
                params_from_flax(_host(params)))


def _start_both_from(jtrainer, port, generator_seed=0):
    """Give both engines one spread-out start: pool rows of initial states
    (each env its own) and their observations, as a state as built, which
    the next ``reset_all_envs`` keeps."""
    eng = port.engine
    rng = np.random.default_rng(generator_seed)
    rows = rng.choice(eng.store.pools["state"].shape[0], eng.n_envs,
                      replace=False)
    state = dict(eng.state)
    state["state"] = eng.store.pools["state"][torch.from_numpy(rows)]
    state[_OBS] = eng.env.observe_fn(state).to(state[_OBS].dtype)
    eng.state = state
    eng._first_reset_done = False
    jeng = jtrainer.engine
    jeng.state = {**jeng.state, "state": jnp.asarray(state["state"].numpy()),
                  _OBS: jnp.asarray(state[_OBS].numpy())}
    jeng._first_reset_done = False


@pytest.mark.parametrize("kind", ["a2c", "ddpg"])
def test_evaluate_episodes_in_lockstep_with_jax(kind, tmp_path):
    """The same nets from the same spread-out states: A2C's most likely
    actions on CartPole, whose episodes end at different steps, and DDPG's
    noise-free ones on Pendulum.  Per policy (16, 1) rewards within 1e-4
    and (16,) step sums equal."""
    cfg = _classic_config(jax_config.load_run_config, _CLASSIC[kind])
    jtrainer = jax_setup(cfg, verbose=False,
                         results_dir=str(tmp_path / "jax"))
    port = _port_trainer(tmp_path, kind)
    _copy_params(jtrainer, port)
    _start_both_from(jtrainer, port)
    jrew, jsteps = jtrainer.evaluate_episodes(use_argmax=True)
    rew, steps = port.evaluate_episodes(use_argmax=True)
    assert sorted(rew) == sorted(jrew) == ["shared"]
    assert rew["shared"].shape == (16, 1) and steps["shared"].shape == (16,)
    np.testing.assert_array_equal(steps["shared"], np.asarray(jsteps["shared"]))
    np.testing.assert_allclose(rew["shared"], np.asarray(jrew["shared"]),
                               rtol=EVAL_TOL, atol=EVAL_TOL)
    if kind == "a2c":
        # the episodes ended at different steps, and some before the end
        assert len(set(steps["shared"].tolist())) > 1
        assert steps["shared"].min() < 50
    else:
        assert (steps["shared"] == 49).all()  # done on the 50th step


def test_ddpg_fetch_episode_states_in_lockstep_with_jax(tmp_path):
    cfg = _classic_config(jax_config.load_run_config, "single_pendulum")
    jtrainer = jax_setup(cfg, verbose=False,
                         results_dir=str(tmp_path / "jax"))
    port = _port_trainer(tmp_path, "ddpg")
    _copy_params(jtrainer, port)
    _start_both_from(jtrainer, port)
    want = jtrainer.fetch_episode_states(["state"], env_id=3,
                                         include_rewards_actions=True)
    _start_both_from(jtrainer, port)
    got = port.fetch_episode_states(["state"], env_id=3,
                                    include_rewards_actions=True)
    assert sorted(got) == sorted(want)
    assert got["state"].shape == (51, 1, 2)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=EVAL_TOL, atol=EVAL_TOL, err_msg=key)


def _nets_state(trainer) -> dict:
    if hasattr(trainer, "nets"):
        return {f"{net}.{k}": v.clone() for net in ("actor", "critic")
                for k, v in trainer.nets[net]["shared"].state_dict().items()}
    return {k: v.clone()
            for k, v in trainer.models["shared"].state_dict().items()}


@pytest.mark.parametrize("kind", ["a2c", "ddpg"])
def test_evaluation_leaves_the_next_iteration_unchanged(kind, tmp_path):
    """Two iterations with an evaluation and an episode fetch between them
    give the nets, env state and episodic accounting of two iterations
    without, bit for bit: evaluation steps the engine's own state and draws
    from its own generator."""
    runs = {}
    for evaluate in (False, True):
        trainer = _port_trainer(tmp_path, kind, name=f"run{evaluate}")
        trainer._iteration(0)
        if evaluate:
            trainer.evaluate_episodes(use_argmax=False)
            trainer.fetch_episode_states(["state"])
        trainer._iteration(160)
        runs[evaluate] = trainer
    a, b = runs[False], runs[True]
    for k, v in _nets_state(a).items():
        assert torch.equal(v, _nets_state(b)[k]), k
    for name, v in a._env_state.items():
        assert torch.equal(v, b._env_state[name]), name
    assert torch.equal(a._ep_sum, b._ep_sum)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_evaluator_flag_adds_the_test_metrics(tmp_path):
    trainer = _port_trainer(tmp_path, "a2c", evaluator=True)
    trainer.train()
    with open(os.path.join(tmp_path / "port", "results.json"),
              encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    assert [r["iterations completed"] for r in records] == [2, 4, 6]
    for record in records:
        metrics = record["metrics"]["shared"]
        assert 1 <= metrics["Mean episodic steps (test)"] <= 50
        # CartPole pays 1 a step
        assert metrics["Mean episodic reward (test)"] == pytest.approx(
            metrics["Mean episodic steps (test)"])


# ------------------------------------------------------ the episode logger
def _gridworld_engine():
    register_all_envs()
    return EnvEngine(env_name="TagGridWorld",
                     env_config={"num_taggers": 4, "grid_length": 6,
                                 "episode_length": 8, "seed": 1},
                     num_envs=3, seed=0, device="cpu")


def test_log_reset_step_fetch():
    engine = _gridworld_engine()
    logger = EpisodeLogger(engine.store)
    assert logger.log_names == ["loc_x", "loc_y"]
    state = dict(engine.state)
    buffers = logger.init_buffers(state, env_id=1)
    assert logger.verify_mask(buffers, last_step=0)
    gen = torch.Generator().manual_seed(0)
    for t in range(1, 5):
        actions = torch.randint(0, 5, (3, engine.n_agents, 1), generator=gen)
        state = engine.step(state, actions)
        buffers = logger.log_step(buffers, state, t, env_id=1)
    assert logger.verify_mask(buffers, last_step=4)
    assert not logger.verify_mask(buffers, last_step=6)
    fetched = logger.fetch(buffers, last_step=4)
    for name in logger.log_names:
        assert fetched[name].shape == (5, engine.n_agents)
        np.testing.assert_array_equal(fetched[name][-1],
                                      state[name][1].numpy())


def test_log_mask_contiguity_guard():
    engine = _gridworld_engine()
    logger = EpisodeLogger(engine.store)
    state = dict(engine.state)
    buffers = logger.init_buffers(state, env_id=0)
    logged = logger.log_step(buffers, state, t=2, env_id=0)
    assert int(buffers["_log_mask_"][2]) == 0  # the input is left as it was
    assert not logger.verify_mask(logged, last_step=2)
    with pytest.raises(AssertionError):
        logger.fetch(logged, last_step=2)


# -------------------------------------------------- TagContinuous episodes
def _tag_config(load):
    """``tests/test_torch_trainer_a2c.py``'s small TagContinuous: 2 taggers
    + 8 runners, k = 4, 5 envs, episodes of 20, fc (32, 32)."""
    cfg = load("tag_continuous")
    cfg["env"].update({"num_taggers": 2, "num_runners": 8,
                       "episode_length": 20, "num_other_agents_observed": 4})
    cfg["trainer"].update({"num_envs": 5, "train_batch_size": 200,
                           "num_episodes": 100, "seed": 3})
    for policy in ("runner", "tagger"):
        cfg["policy"][policy]["model"]["fc_dims"] = [32, 32]
    return cfg


@pytest.fixture(scope="module")
def tag_pair(tmp_path_factory):
    jtrainer = jax_setup(_tag_config(jax_config.load_run_config),
                         verbose=False,
                         results_dir=str(tmp_path_factory.mktemp("jax")))
    port = port_train.setup_trainer(
        _tag_config(port_config.load_run_config), verbose=False,
        device="cpu", results_dir=str(tmp_path_factory.mktemp("port")))
    _copy_params(jtrainer, port)
    return jtrainer, port


def test_fetch_logged_episode_matches_jax(tag_pair):
    """The most likely actions from the same reset: ``loc_x``, ``loc_y``
    and ``still_in_the_game`` of env 2 at every step up to the episode's
    end, within 1%, and the mask contiguous."""
    jtrainer, port = tag_pair
    want = jtrainer.fetch_logged_episode(env_id=2)
    got = port.fetch_logged_episode(env_id=2)
    assert sorted(got) == sorted(want) == ["loc_x", "loc_y",
                                           "still_in_the_game"]
    for name, value in want.items():
        assert got[name].shape == np.asarray(value).shape == (21, 10)
        np.testing.assert_allclose(got[name], np.asarray(value), rtol=1e-2,
                                   atol=1e-2, err_msg=name)


def test_a2c_fetch_episode_states_with_probabilities(tag_pair):
    """States from the reset state on, rewards and actions, and each
    policy's probabilities of the states acted on: rows of 1, and the
    model's softmax of the reset state's observations at step 0."""
    _, port = tag_pair
    out = port.fetch_episode_states(["loc_x", "still_in_the_game"],
                                    env_id=1, include_rewards_actions=True,
                                    include_probabilities=True)
    steps = out["rewards"].shape[0]
    assert out["loc_x"].shape == (steps + 1, 10)
    assert out["actions"].shape == (steps, 10, 2)
    start = port.engine.store.snapshot["loc_x"].numpy()
    np.testing.assert_array_equal(out["loc_x"][0], start)
    for tag, ids in port.policy_tag_to_agent_id_map.items():
        probs = out["probabilities"][tag]
        assert len(probs) == 2  # two action components
        for i, p in enumerate(probs):
            assert p.shape[:2] == (steps, len(ids))
            np.testing.assert_allclose(p.sum(-1), 1.0, atol=1e-6)
            obs0 = port.engine.store.snapshot[_OBS][torch.as_tensor(ids)]
            want = torch.softmax(port.models[tag](obs0)[0][i], -1)
            np.testing.assert_allclose(p[0], want.detach().numpy(),
                                       atol=1e-6)


def test_ddpg_fetch_logged_episode_needs_logged_arrays(tmp_path):
    port = _port_trainer(tmp_path, "ddpg")
    assert port.engine.store.log_names == []
    with pytest.raises(AssertionError, match="log_data_across_episode"):
        port.fetch_logged_episode()


# ----------------------------------------------------------------- resume
@pytest.mark.parametrize("kind", ["a2c", "ddpg"])
def test_resume_from_full_state_is_bit_exact(kind, tmp_path):
    """Run A: 6 iterations through ``train()``.  Run B: 3 iterations, then
    ``save_full_state``.  Run C: a fresh trainer of other seeds (other
    nets, draws, initial state and reset pool), ``load_full_state`` and
    ``train()`` for the last 3.  A and C end equal bit for bit: nets,
    optimizer moments and counts, the env state, the generators."""
    def trainer(name, seed, env_seed=5):
        return _port_trainer(tmp_path, kind, name=name, seed=seed,
                             env_seed=env_seed)

    a = trainer("a", 3)
    a.train()
    b = trainer("b", 3)
    for _ in range(3):
        b._iteration(b.current_timestep)
        b.current_timestep += b.train_batch_size
        b.iters_completed += 1
    path = b.save_full_state()
    assert os.path.basename(path) == "full_state_480.ckpt"
    c = trainer("c", 4, env_seed=6)
    assert not torch.equal(c.engine.store.pools["state"],
                           a.engine.store.pools["state"])
    c.load_full_state(path)
    assert (c.current_timestep, c.iters_completed) == (480, 3)
    c.train()
    assert c.iters_completed == a.iters_completed == 6
    for k, v in _nets_state(a).items():
        assert torch.equal(v, _nets_state(c)[k]), k
    opts = a.optimizers
    opt_pairs = ([(opts["shared"], c.optimizers["shared"])] if kind == "a2c"
                 else [(opts[n]["shared"], c.optimizers[n]["shared"])
                       for n in ("actor", "critic")])
    for oa, oc in opt_pairs:
        sa, sc = oa.state_dict(), oc.state_dict()
        assert sa["count"] == sc["count"] > 0
        for moment in ("mu", "nu"):
            for name, m in sa[moment].items():
                assert torch.equal(m, sc[moment][name]), (moment, name)
    for name, v in a._env_state.items():
        assert torch.equal(v, c._env_state[name]), name
    assert torch.equal(a.generator.get_state(), c.generator.get_state())
    if kind == "ddpg":
        for net in ("actor", "critic"):
            for k, v in a.targets[net]["shared"].state_dict().items():
                assert torch.equal(v, c.targets[net]["shared"].state_dict()[k])
        for key, v in a._window.items():
            assert torch.equal(v, c._window[key]), key
        assert torch.equal(a._ou["shared"], c._ou["shared"])
