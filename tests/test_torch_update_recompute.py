"""``trainer.update_recompute_obs`` in the port
(``warpdrive_tpu_torch/training/trainer_a2c.py``): the rollout records each
step's pre-step state in place of observations, and the update derives each
minibatch's observations from it with ``engine.observe`` on its ``T x
E_mb`` env rows.  On ``tests/test_update_recompute_obs.py``'s TagContinuous
(2 taggers + 8 runners, k = 4, 8 envs x 20 steps, fc (16, 16)), on the CPU:

- the batch holds no observations, and its state records are copies;
- the derived observations equal the stored ones bit for bit (each row
  observed at its own timestep);
- parameters after 3 iterations equal the store path's within 1e-5
  (``PARAM_ATOL``; bit for bit where the two paths make the same
  operations, which all but PPO's do: its behaviour log-probs come from a
  forward of the whole batch on one path and of each minibatch on the
  other), whole-batch, shuffled and contiguous minibatches and PPO over
  2 epochs x 2 minibatches;
- one such update matches the JAX package's recompute update within 1e-5.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_update_options import jax_index_tables
from test_update_recompute_obs import ENV_KW, _make_trainer
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.models.fully_connected import (
    adam_state_from_optax,
    params_from_flax,
)
from warpdrive_tpu_torch.training.trainer_a2c import TrainerA2C

PARAM_ATOL = 1e-5
NUM_ENVS = 8


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tmp_path, name, config):
    env = TorchTagContinuous(**ENV_KW)
    engine = EnvEngine(env_obj=env, num_envs=NUM_ENVS, seed=5, device="cpu")
    pmap = {
        "tagger": [i for i in range(env.num_agents) if env.agent_type[i] == 1],
        "runner": [i for i in range(env.num_agents) if env.agent_type[i] == 0],
    }
    return TrainerA2C(env_wrapper=engine, config=copy.deepcopy(config),
                      policy_tag_to_agent_id_map=pmap, verbose=False,
                      results_dir=str(tmp_path / name))


def _config(recompute, **policy):
    """The JAX test's config (its ``_make_trainer``), recompute on or off."""
    pol = dict({"to_train": True, "algorithm": "A2C", "gamma": 0.98,
                "lr": 0.01,
                "model": {"type": "fully_connected", "fc_dims": [16, 16]}},
               **policy)
    return {
        "name": "recompute_test",
        "env": {},
        "trainer": {"num_envs": NUM_ENVS, "num_episodes": 8 * NUM_ENVS,
                    "train_batch_size": 20 * NUM_ENVS, "seed": 17,
                    "update_recompute_obs": recompute},
        "policy": {"runner": dict(pol), "tagger": dict(pol)},
        "saving": {"metrics_log_freq": 10**9,
                   "model_params_save_freq": 10**9},
    }


def test_recompute_batch_holds_no_observations(tmp_path):
    trainer = _port(tmp_path, "rec", _config(True))
    assert trainer._recompute_obs
    first = {k: v.clone() for k, v in trainer._env_state.items()}
    batch = trainer._rollout()
    assert "phys" in batch and not any(k.startswith("obs_") for k in batch)
    assert set(batch["phys"]) == {
        "_timestep_", "loc_x", "loc_y", "speed", "direction",
        "acceleration", "still_in_the_game"}
    T = trainer.training_batch_size_per_env
    for name, record in batch["phys"].items():
        assert record.shape[0] == T
        # copies: the first step's record is the state before the rollout,
        # untouched by the steps that followed
        torch.testing.assert_close(record[0], first[name], rtol=0, atol=0)
        assert record.data_ptr() != trainer._env_state[name].data_ptr()
    steps = batch["phys"]["_timestep_"]
    assert not torch.equal(steps[0], steps[1])
    phys_bytes = sum(v.numel() * v.element_size()
                     for v in batch["phys"].values())
    obs_bytes = 4 * T * trainer.num_envs * trainer.engine.n_agents * \
        trainer.engine.env.obs_size
    assert phys_bytes * 4 < obs_bytes


def test_derived_observations_equal_the_stored_ones(tmp_path):
    store = _port(tmp_path, "store", _config(False))
    rec = _port(tmp_path, "rec", _config(True))
    stored, recorded = store._rollout(), rec._rollout()
    torch.testing.assert_close(stored["done"], recorded["done"], rtol=0,
                               atol=0)
    T, E = stored["done"].shape
    rows = {k: v.reshape((T * E,) + v.shape[2:])
            for k, v in recorded["phys"].items()}
    for tag in rec.policies:
        derived = rec._observe_policy(tag)(rows)
        want = stored[f"obs_{tag}"]
        torch.testing.assert_close(derived.reshape(want.shape), want,
                                   rtol=0, atol=0)


def _params_after(trainer, iters=3):
    for i in range(iters):
        trainer._iteration(i * trainer.training_batch_size_per_env
                           * trainer.num_envs)
    return {tag: {k: v.clone() for k, v in m.state_dict().items()}
            for tag, m in trainer.models.items()}


@pytest.mark.parametrize("policy,exact", [
    ({}, True),
    (dict(num_minibatches=2, shuffle_minibatches=False), True),
    (dict(num_minibatches=2, shuffle_minibatches=True), True),
    (dict(algorithm="PPO", num_epochs=2, num_minibatches=2), False),
])
def test_recompute_matches_store(policy, exact, tmp_path):
    p_store = _params_after(_port(tmp_path, "s", _config(False, **policy)))
    p_rec = _params_after(_port(tmp_path, "r", _config(True, **policy)))
    for tag in p_store:
        for name, value in p_store[tag].items():
            atol = 0 if exact else PARAM_ATOL
            torch.testing.assert_close(p_rec[tag][name], value, rtol=0,
                                       atol=atol, msg=f"{tag} {name}")


def test_recompute_update_matches_jax(tmp_path):
    """PPO over 2 epochs x 2 shuffled minibatches on a JAX recompute
    rollout's batch: JAX's permutation table injected, the behaviour
    log-probs taken per minibatch on both sides."""
    kw = dict(algorithm="PPO", num_epochs=2, num_minibatches=2)
    jtrainer = _make_trainer(True, **kw)
    carry = jtrainer._carry
    rollout = jax.jit(jtrainer._build_rollout_profile_fn())
    _, batch = rollout(carry, jax.random.PRNGKey(0))
    batch = _host(batch)
    port = _port(tmp_path, "port", _config(True, **kw))
    for tag in port.policies:
        port.models[tag].load_state_dict(
            params_from_flax(_host(carry["params"][tag])))
        port.optimizers[tag].load_state_dict(
            adam_state_from_optax(_host(carry["opt"][tag])))
    port_batch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()
                  if k != "phys"}
    port_batch["phys"] = {k: torch.from_numpy(batch["phys"][k].copy())
                          for k in port._make_batch()["phys"]}

    k_down = jax.random.PRNGKey(1)
    tables = jax_index_tables(jtrainer, k_down, NUM_ENVS)
    assert set(tables) == {"runner", "tagger"}
    update = jax.jit(jtrainer._make_update(with_metrics=True))
    params, _, jmetrics = update(carry["params"], carry["opt"], batch,
                                 jnp.float32(0), k_down)
    metrics = port._update(port_batch, 0, index_tables=tables)
    for tag in port.policies:
        np.testing.assert_allclose(float(metrics[tag]["Total loss"]),
                                   float(jmetrics[tag]["Total loss"]),
                                   rtol=1e-5, atol=1e-6)
        want = params_from_flax(_host(params[tag]))
        for name, p in port.models[tag].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{tag} {name}")
