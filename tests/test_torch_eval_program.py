"""The evaluation and fetch programs (``warpdrive_tpu_torch/training/
trainer_base.py``: ``evaluate_episodes``, ``fetch_episode_states``,
``fetch_logged_episode``; ``core/episode_log.py:log_step_into``) on the
CPU, where each step program calls its body directly over the static
episode state and records that a card captures:

- each call equals the plain episode loop it replaces (the engine's
  functional step over a dict, Python lists of records, the functional
  ``EpisodeLogger.log_step`` under the done gate) bit for bit, drawn and
  most likely actions alike, from the same evaluation generator state;
- the programs are cached by mode and by what is recorded, keep their
  storages, and another ``env_id`` takes the same program;
- against the JAX package on a seeded TagContinuous: the most likely
  actions' evaluation (step sums equal, rewards within 1e-4) and logged
  episode (1%), and the drawn evaluation by statistics (mean episode
  steps of 256 CartPole envs within 5 standard errors);
- ``train()`` with the evaluator's warm-up trains exactly as without it.
"""

import copy

import numpy as np
import pytest
import torch

from warpdrive_tpu.training.scripts.train import setup_trainer as jax_setup
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.core.episode_log import EpisodeLogger
from warpdrive_tpu_torch.core.program import storages
from warpdrive_tpu_torch.models.fully_connected import params_from_flax
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.utils import config as port_config
from warpdrive_tpu_torch.utils.constants import Constants

_DONE = Constants.DONE
# as tests/test_torch_trainer_eval.py: up to 20 rewards an env of float32
# dynamics summed in other orders by XLA and torch
EVAL_TOL = 1e-4


def _tag_config(load, **trainer):
    """A small TagContinuous: 2 taggers + 8 runners, k = 4, 5 envs,
    episodes of 20, fc (32, 32), A2C."""
    cfg = load("tag_continuous")
    cfg["env"].update({"num_taggers": 2, "num_runners": 8,
                       "episode_length": 20, "num_other_agents_observed": 4})
    cfg["trainer"].update({"num_envs": 5, "train_batch_size": 100,
                           "num_episodes": 20, "seed": 3, **trainer})
    for policy in ("runner", "tagger"):
        cfg["policy"][policy]["model"]["fc_dims"] = [32, 32]
    cfg["saving"].update({"metrics_log_freq": 10**9,
                          "model_params_save_freq": 10**9})
    return cfg


def _pendulum_config(load):
    cfg = load("single_pendulum")
    cfg["env"].update({"episode_length": 12, "reset_pool_size": 20,
                       "seed": 4})
    cfg["trainer"].update({"num_envs": 6, "train_batch_size": 60,
                           "num_episodes": 20, "seed": 2})
    for net in ("actor", "critic"):
        cfg["policy"]["shared"]["model"][net]["fc_dims"] = [16, 16]
    return cfg


def _port(tmp_path, name, cfg):
    return port_train.setup_trainer(copy.deepcopy(cfg), verbose=False,
                                    device="cpu",
                                    results_dir=str(tmp_path / name))


def _host(x):
    return np.asarray(x)


# ------------------------------------------------ the plain episode loops
@torch.no_grad()
def _plain_evaluate(trainer, use_argmax):
    """The episode loop the evaluation program replaces: a functional
    step over a dict from a forced reset, the sums rebound each step."""
    engine = trainer.engine
    E, N = trainer.local_envs, engine.n_agents
    alive = torch.ones((E,), dtype=torch.bool)
    rew_sum = torch.zeros((E, N))
    step_sum = torch.zeros((E,), dtype=torch.int32)
    engine.reset_all_envs()
    state = dict(engine.state)
    for _ in range(engine.episode_length):
        actions = trainer._act_fn(state, use_argmax=use_argmax,
                                  generator=trainer.eval_generator)
        state = engine.step(state, actions)
        alive = alive & (state[_DONE] == 0)
        rew_sum = rew_sum + engine.rewards_of(state) \
            * alive.to(torch.float32)[:, None]
        step_sum = step_sum + alive.to(torch.int32)
    return rew_sum, step_sum


@torch.no_grad()
def _plain_fetch(trainer, names, env_id):
    engine = trainer.engine
    engine.reset_all_envs()
    state = dict(engine.state)
    recs = {name: [state[name][env_id]] for name in names}
    probs, rewards, actions_rec, done = [], [], [], []
    for _ in range(engine.episode_length):
        actions, logits_of = trainer._act_fn(
            state, use_argmax=False, generator=trainer.eval_generator,
            return_logits=True)
        probs.append(torch.softmax(logits_of["runner"][1][env_id], dim=-1))
        state = engine.step(state, actions)
        for name in names:
            recs[name].append(state[name][env_id])
        rewards.append(engine.rewards_of(state)[env_id])
        actions_rec.append(actions[env_id])
        done.append(state[_DONE][env_id])
    return ({k: torch.stack(v) for k, v in recs.items()},
            torch.stack(probs), torch.stack(rewards),
            torch.stack(actions_rec), torch.stack(done))


@torch.no_grad()
def _plain_logged(trainer, env_id):
    engine = trainer.engine
    logger = EpisodeLogger(engine.store)
    engine.reset_all_envs()
    state = dict(engine.state)
    buffers = logger.init_buffers(state, env_id)
    done_seen = torch.zeros((), dtype=torch.bool)
    for t in range(1, engine.episode_length + 1):
        actions = trainer._act_fn(state, use_argmax=True,
                                  generator=trainer.eval_generator)
        state = engine.step(state, actions)
        logged = logger.log_step(buffers, state, t, env_id)
        buffers = {k: torch.where(done_seen, buffers[k], v)
                   for k, v in logged.items()}
        done_seen = done_seen | (state[_DONE][env_id] > 0)
    return buffers


def _same_start(a, b):
    """Trainer ``b``'s evaluation generator and store state as ``a``'s."""
    b.eval_generator.set_state(a.eval_generator.get_state())
    b.engine.store.generator.set_state(a.engine.store.generator.get_state())


@pytest.mark.parametrize("use_argmax", [True, False])
def test_evaluation_program_equals_the_plain_loop(use_argmax, tmp_path):
    cfg = _tag_config(port_config.load_run_config)
    trainer, plain = _port(tmp_path, "a", cfg), _port(tmp_path, "b", cfg)
    for _ in range(2):  # the second call replays the cached program
        _same_start(trainer, plain)
        rew, steps = trainer.evaluate_episodes(use_argmax=use_argmax)
        want_rew, want_steps = _plain_evaluate(plain, use_argmax)
        for tag, ids in trainer.policy_tag_to_agent_id_map.items():
            np.testing.assert_array_equal(rew[tag], want_rew[:, ids].numpy())
            np.testing.assert_array_equal(steps[tag], want_steps.numpy())
        assert torch.equal(trainer.eval_generator.get_state(),
                           plain.eval_generator.get_state())
    assert list(trainer._episode_programs) == [("evaluate", use_argmax)]


def test_fetch_episode_states_program_equals_the_plain_loop(tmp_path):
    cfg = _tag_config(port_config.load_run_config)
    trainer, plain = _port(tmp_path, "a", cfg), _port(tmp_path, "b", cfg)
    names = ["loc_x", "still_in_the_game"]
    ptrs = None
    for env_id in (1, 3):  # one program for either env row
        _same_start(trainer, plain)
        out = trainer.fetch_episode_states(names, env_id=env_id,
                                           include_rewards_actions=True,
                                           include_probabilities=True)
        recs, probs, rewards, actions, done = _plain_fetch(plain, names,
                                                           env_id)
        done = done.numpy() > 0
        end = int(np.argmax(done)) + 1 if done.any() else 20
        for name in names:
            np.testing.assert_array_equal(out[name],
                                          recs[name][: end + 1].numpy())
        np.testing.assert_array_equal(out["rewards"], rewards[:end].numpy())
        np.testing.assert_array_equal(out["actions"], actions[:end].numpy())
        np.testing.assert_array_equal(out["probabilities"]["runner"][1],
                                      probs[:end].numpy())
        program = trainer._episode_programs[
            ("fetch", tuple(names), True, True)]
        if ptrs is not None:
            assert storages(program.buffers) == ptrs
        ptrs = storages(program.buffers)
    assert len(trainer._episode_programs) == 1


def test_fetch_logged_episode_program_equals_the_plain_loop(tmp_path):
    cfg = _tag_config(port_config.load_run_config)
    trainer, plain = _port(tmp_path, "a", cfg), _port(tmp_path, "b", cfg)
    for env_id in (2, 0):
        _same_start(trainer, plain)
        got = trainer.fetch_logged_episode(env_id=env_id)
        buffers = _plain_logged(plain, env_id)
        last = len(got["loc_x"]) - 1
        assert EpisodeLogger.verify_mask(buffers, last)
        for name, value in got.items():
            np.testing.assert_array_equal(value,
                                          buffers[name][: last + 1].numpy())


def test_log_step_into_gates_a_frozen_row():
    logger = EpisodeLogger.__new__(EpisodeLogger)
    logger.episode_length, logger.log_names = 3, ["x"]
    state = {"x": torch.arange(6.0).reshape(2, 3)}
    buffers = logger.init_buffers(state, 1)
    t, env = torch.tensor([1]), torch.tensor([0])
    logger.log_step_into(buffers, state, t, env,
                         frozen=torch.tensor([False]))
    np.testing.assert_array_equal(buffers["x"][1].numpy(), [0.0, 1.0, 2.0])
    logger.log_step_into(buffers, {"x": state["x"] + 10}, t + 1, env,
                         frozen=torch.tensor([True]))
    assert not buffers["x"][2].any() and buffers["_log_mask_"].tolist() == [
        1, 1, 0, 0]


# ------------------------------------------------------------ against JAX
def _flat(params):
    import jax
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def tag_pair(tmp_path_factory):
    jtrainer = jax_setup(_tag_config(jax_config.load_run_config),
                         verbose=False,
                         results_dir=str(tmp_path_factory.mktemp("jax")))
    port = _port(tmp_path_factory.mktemp("port"), "port",
                 _tag_config(port_config.load_run_config))
    for tag, params in jtrainer._carry["params"].items():
        port.models[tag].load_state_dict(params_from_flax(_flat(params)))
    return jtrainer, port


def test_argmax_evaluation_program_matches_jax(tag_pair):
    jtrainer, port = tag_pair
    jrew, jsteps = jtrainer.evaluate_episodes(use_argmax=True)
    rew, steps = port.evaluate_episodes(use_argmax=True)
    assert sorted(rew) == sorted(jrew) == ["runner", "tagger"]
    for tag in rew:
        np.testing.assert_array_equal(steps[tag], _host(jsteps[tag]))
        np.testing.assert_allclose(rew[tag], _host(jrew[tag]),
                                   rtol=EVAL_TOL, atol=EVAL_TOL)


def test_logged_episode_program_matches_jax(tag_pair):
    jtrainer, port = tag_pair
    want = jtrainer.fetch_logged_episode(env_id=4)
    got = port.fetch_logged_episode(env_id=4)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].shape == _host(value).shape
        np.testing.assert_allclose(got[name], _host(value), rtol=1e-2,
                                   atol=1e-2, err_msg=name)


def _cartpole_config(load):
    cfg = load("single_cartpole")
    cfg["env"].update({"episode_length": 40, "reset_pool_size": 0,
                       "seed": 9})
    cfg["trainer"].update({"num_envs": 256, "train_batch_size": 2560,
                           "num_episodes": 64, "seed": 1})
    cfg["policy"]["shared"]["model"]["fc_dims"] = [8, 8]
    return cfg


def test_drawn_evaluation_program_matches_jax_by_statistics(tmp_path):
    """The same nets from the same start state, actions drawn on each side
    from its own stream: the mean episode length of 256 envs alike within
    5 standard errors of the difference."""
    jtrainer = jax_setup(_cartpole_config(jax_config.load_run_config),
                         verbose=False, results_dir=str(tmp_path / "jax"))
    port = _port(tmp_path, "port", _cartpole_config(
        port_config.load_run_config))
    port.models["shared"].load_state_dict(params_from_flax(
        _flat(jtrainer._carry["params"]["shared"])))
    _, jsteps = jtrainer.evaluate_episodes(use_argmax=False)
    _, steps = port.evaluate_episodes(use_argmax=False)
    a = steps["shared"].astype(np.float64)
    b = _host(jsteps["shared"]).astype(np.float64)
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert se > 0 and abs(a.mean() - b.mean()) < 5 * se
    assert len(set(a.tolist())) > 3  # the draws spread the episodes


def test_evaluator_warm_up_leaves_training_unchanged(tmp_path):
    """``train()`` with ``trainer.evaluator`` (the warm-up evaluation
    before the first iteration, then the evaluation at each log point)
    and without: the same nets, Adam states and rollout state bit for
    bit; the evaluator's program was built before the first iteration."""
    runs = {}
    for evaluator in (False, True):
        cfg = _pendulum_config(port_config.load_run_config)
        cfg["trainer"]["evaluator"] = evaluator
        cfg["saving"].update({"metrics_log_freq": 1,
                              "model_params_save_freq": 10**9})
        trainer = _port(tmp_path, f"eval{evaluator}", cfg)
        trainer.train()
        runs[evaluator] = trainer
    off, on = runs[False], runs[True]
    assert off._episode_programs is None
    assert list(on._episode_programs) == [("evaluate", True)]
    for net in ("actor", "critic"):
        for kind in ("nets", "targets"):
            a = getattr(off, kind)[net]["shared"].state_dict()
            b = getattr(on, kind)[net]["shared"].state_dict()
            for key in a:
                assert torch.equal(a[key], b[key]), (kind, net, key)
        assert off.optimizers[net]["shared"].count == \
            on.optimizers[net]["shared"].count > 0
    for name, value in off._env_state.items():
        assert torch.equal(value, on._env_state[name]), name
    assert torch.equal(off.generator.get_state(), on.generator.get_state())
