"""Action masks from a shared ``action_mask`` state array in the port,
against the JAX package: the JAX tests' ``MaskedBandit`` (1 agent, 3
actions, action 0 forbidden) and its torch counterpart.  The masked action
is never drawn (Gumbel-max over logits with -1e20 added), the rollout
records the mask, one update from JAX's weights and batch agrees within
1e-5, and training keeps every loss finite."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_action_mask import MaskedBandit
from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.training.trainer_a2c import TrainerA2C as JaxTrainerA2C
from warpdrive_tpu_torch.envs.base import TorchEnvironmentContext
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.models.fully_connected import (
    adam_state_from_optax,
    params_from_flax,
)
from warpdrive_tpu_torch.training.trainer_a2c import TrainerA2C
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.data_feed import DataFeed
from warpdrive_tpu_torch.utils.spaces import Box, Discrete

PARAM_ATOL = 1e-5  # one update, as in test_torch_trainer_a2c.py


class TorchMaskedBandit(TorchEnvironmentContext):
    """1-agent, 3-action bandit whose mask forbids action 0."""

    name = "MaskedBandit"

    def __init__(self, episode_length=4):
        self.num_agents = 1
        self.episode_length = episode_length
        self.action_space = {0: Discrete(3)}
        self.observation_space = {0: Box(-1.0, 1.0, shape=(2,))}

    def reset(self):
        return {0: np.zeros(2, np.float32)}

    def get_data_dictionary(self):
        feed = DataFeed()
        feed.add_data(
            Constants.ACTION_MASK,
            np.array([[0.0, 1.0, 1.0]], np.float32),  # (agents, n_actions)
            save_copy_and_apply_at_reset=True,
        )
        return feed

    def step_fn(self, state):
        t = state[Constants.TIMESTEP] + 1
        a = state[Constants.ACTIONS][:, 0, 0]
        out = dict(state)
        out[Constants.OBSERVATIONS] = torch.stack(
            [torch.cos(a.to(torch.float32)), torch.sin(t.to(torch.float32))],
            dim=1)[:, None, :]
        out[Constants.REWARDS] = (a == 1).to(torch.float32)[:, None]
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = (t >= self.episode_length).to(torch.int32)
        return out


def _config(algorithm="A2C"):
    return {
        "trainer": {"num_envs": 8, "num_episodes": 160,
                    "train_batch_size": 64, "seed": 5},  # T = 8
        "policy": {"shared": {"to_train": True, "algorithm": algorithm,
                              "gamma": 0.9, "lr": 1e-3,
                              "model": {"type": "fully_connected",
                                        "fc_dims": [8]}}},
        "saving": {"metrics_log_freq": 5},
    }


def _port(tmp_path, algorithm="A2C"):
    engine = EnvEngine(env_obj=TorchMaskedBandit(), num_envs=8, seed=0,
                       device="cpu")
    return TrainerA2C(env_wrapper=engine, config=_config(algorithm),
                      verbose=False, results_dir=str(tmp_path / "p"))


def test_masked_actions_are_never_sampled(tmp_path):
    trainer = _port(tmp_path)
    state = dict(trainer.engine.state)
    for _ in range(50):
        actions = trainer._act_fn(state, use_argmax=False,
                                  generator=trainer.eval_generator)
        assert (actions != 0).all(), "masked action was sampled"
    batch = trainer._rollout()
    assert batch["mask_shared"].shape == (8, 8, 1, 3)
    assert (batch["mask_shared"][..., 0] == 0).all()
    assert (batch["actions_shared"] != 0).all()


@pytest.mark.parametrize("algorithm", ["A2C", "PPO"])
def test_one_update_matches_jax(algorithm, tmp_path):
    jeng = JaxEnvEngine(env_obj=MaskedBandit(), num_envs=8, seed=0)
    jcfg = _config(algorithm)
    jcfg["saving"]["basedir"] = str(tmp_path / "j")
    jtr = JaxTrainerA2C(env_wrapper=jeng, config=jcfg, verbose=False,
                        results_dir=str(tmp_path / "j"))
    carry = jtr._carry
    _, batch = jax.jit(jtr._build_rollout_profile_fn())(
        carry, jax.random.PRNGKey(0))
    batch = jax.tree_util.tree_map(np.asarray, batch)
    assert (batch["actions_shared"] != 0).all()

    port = _port(tmp_path, algorithm)
    host = jax.tree_util.tree_map(np.asarray, carry)
    port.models["shared"].load_state_dict(
        params_from_flax(host["params"]["shared"]))
    port.optimizers["shared"].load_state_dict(
        adam_state_from_optax(host["opt"]["shared"]))
    params, _, jmetrics = jax.jit(jtr._make_update(with_metrics=True))(
        carry["params"], carry["opt"], batch, jnp.float32(0),
        jax.random.PRNGKey(1))
    metrics = port._update({k: torch.from_numpy(v.copy())
                            for k, v in batch.items()}, 0)
    for name in ("Total loss", "Mean entropy"):
        np.testing.assert_allclose(float(metrics["shared"][name]),
                                   float(jmetrics["shared"][name]),
                                   rtol=1e-5)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   params["shared"]))
    for name, p in port.models["shared"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)


def test_training_keeps_the_losses_finite(tmp_path):
    trainer = _port(tmp_path)
    metrics = trainer._iteration(0)["shared"]
    assert np.isfinite(float(metrics["Total loss"]))
    assert np.isfinite(float(metrics["Mean entropy"]))
    trainer.train()
    rew, _ = trainer.evaluate_episodes()
    assert np.isfinite(rew["shared"]).all()
