"""Shared Dict observations and the agent-dim-last layout in the port
against the JAX package, on torch counterparts of the JAX tests'
``MiniDictObsEnv`` (3 agents, Dict {pos (1), others (2)}) and
``MiniLastDimEnv`` (2 agents, features (3,) stored (E, 3, agents)): the
placeholders, the flattened policy observations over seeded steps (exact:
both sides compute the same float32 operations), one A2C update from JAX's
weights and batch (1e-5), training, and the trainer/engine flag checks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_dict_obs_and_layout import MiniDictObsEnv, MiniLastDimEnv
from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.training.trainer_a2c import TrainerA2C as JaxTrainerA2C
from warpdrive_tpu_torch.envs.base import TorchEnvironmentContext
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.ops import reset as reset_kernel
from warpdrive_tpu_torch.models.fully_connected import (
    adam_state_from_optax,
    params_from_flax,
)
from warpdrive_tpu_torch.training.trainer_a2c import TrainerA2C
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.data_feed import DataFeed
from warpdrive_tpu_torch.utils.spaces import Discrete

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_REWARDS = Constants.REWARDS
PARAM_ATOL = 1e-5  # one update, as in test_torch_trainer_a2c.py


class TorchMiniDictObsEnv(TorchEnvironmentContext):
    """3 agents on a line; each one's observation is a Dict {pos (1,),
    others (2,)}: the other agents' positions in agent order."""

    num_agents = 3
    episode_length = 8
    name = "MiniDictObsEnv"

    def __init__(self):
        self.action_space = {a: Discrete(3) for a in range(self.num_agents)}
        self.observation_space = None  # inferred from the Dict obs
        self.pos = None

    def _obs(self):
        return {a: {"pos": np.array([self.pos[a]], dtype=np.float32),
                    "others": np.delete(self.pos, a).astype(np.float32)}
                for a in range(self.num_agents)}

    def reset(self):
        self.pos = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
        return self._obs()

    def get_data_dictionary(self):
        feed = DataFeed()
        feed.add_data("pos", self.pos, save_copy_and_apply_at_reset=True)
        return feed

    def step_fn(self, state):
        t = state[Constants.TIMESTEP] + 1
        act = state[_ACTIONS][..., 0].to(torch.float32) - 1.0  # {-1, 0, 1}
        pos = state["pos"] + 0.1 * act  # (E, N)
        n = self.num_agents
        k = torch.arange(n - 1)[None, :]
        others_of = k + (k >= torch.arange(n)[:, None]).long()  # (N, N-1)
        out = dict(state)
        out["pos"] = pos
        out[f"{_OBS}_pos"] = pos[..., None]
        out[f"{_OBS}_others"] = pos[:, others_of]
        out[_REWARDS] = -torch.abs(pos)
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = (t >= self.episode_length).to(torch.int32)
        return out


class TorchMiniLastDimEnv(TorchEnvironmentContext):
    """2 agents whose observations are written agent-dim-last: (3, A)."""

    num_agents = 2
    episode_length = 6
    name = "MiniLastDimEnv"

    def __init__(self):
        self.action_space = {a: Discrete(2) for a in range(self.num_agents)}
        self.observation_space = None
        self.x = None

    def reset(self):
        self.x = np.array([0.5, -0.5], dtype=np.float32)
        feat = np.stack([self.x, 2.0 * self.x, self.x ** 2], axis=0)
        return {a: feat[:, a] for a in range(self.num_agents)}

    def get_data_dictionary(self):
        feed = DataFeed()
        feed.add_data("x", self.x, save_copy_and_apply_at_reset=True)
        return feed

    def step_fn(self, state):
        t = state[Constants.TIMESTEP] + 1
        act = state[_ACTIONS][..., 0].to(torch.float32)
        x = state["x"] + 0.1 * (act - 0.5)
        out = dict(state)
        out["x"] = x
        out[_OBS] = torch.stack([x, 2.0 * x, x ** 2], dim=1)  # (E, 3, A)
        out[_REWARDS] = -torch.abs(x)
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = (t >= self.episode_length).to(torch.int32)
        return out


CASES = {
    "dict": (MiniDictObsEnv, TorchMiniDictObsEnv, "first", 4),
    "last": (MiniLastDimEnv, TorchMiniLastDimEnv, "last", 3),
}


def _config(num_envs, T=6, iters=3):
    return {
        "name": "mini", "env": {},
        "trainer": {"num_envs": num_envs, "num_episodes": 40,
                    "train_batch_size": T * num_envs, "seed": 1},
        "policy": {"shared": {"to_train": True, "algorithm": "A2C",
                              "gamma": 0.9, "lr": 0.01,
                              "model": {"type": "fully_connected",
                                        "fc_dims": [8]}}},
        "saving": {"metrics_log_freq": 2, "model_params_save_freq": 1000},
    }


def _pair(case, tmp_path):
    jax_cls, port_cls, layout, E = CASES[case]
    jeng = JaxEnvEngine(env_obj=jax_cls(), num_envs=E, seed=2,
                        obs_dim_corresponding_to_num_agents=layout)
    peng = EnvEngine(env_obj=port_cls(), num_envs=E, seed=2, device="cpu",
                     obs_dim_corresponding_to_num_agents=layout)
    kw = dict(config=_config(E), verbose=False,
              obs_dim_corresponding_to_num_agents=layout)
    jtr = JaxTrainerA2C(env_wrapper=jeng, results_dir=str(tmp_path / "j"),
                        **kw)
    ptr = TrainerA2C(env_wrapper=peng, results_dir=str(tmp_path / "p"), **kw)
    return jeng, peng, jtr, ptr


@pytest.mark.parametrize("case", sorted(CASES))
def test_placeholders_and_policy_obs_match_jax(case, tmp_path):
    jeng, peng, jtr, ptr = _pair(case, tmp_path)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in peng.state.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jeng.state.items()
         if k != Constants.RNG}
    assert peng.placeholder_groups[None]["keys"] == \
        jeng.placeholder_groups[None]["keys"]
    if case == "dict":
        assert peng.obs_entry_names() == ["observations_pos",
                                          "observations_others"]
    else:
        assert peng.state[_OBS].shape == (3, 3, 2)
    jstate, pstate = dict(jeng.state), dict(peng.state)
    rng = np.random.RandomState(3)
    for t in range(10):
        jobs, jmask = jtr._policy_obs_and_mask(jstate, None, "shared")
        pobs, pmask = ptr._policy_obs_and_mask(pstate, None, "shared")
        assert jmask is None and pmask is None
        np.testing.assert_array_equal(pobs.numpy(), np.asarray(jobs),
                                      err_msg=f"t={t}")
        acts = rng.randint(2, size=(peng.n_envs, peng.n_agents, 1))
        jstate = jeng.auto_reset(jeng.step(jstate, jnp.asarray(acts)),
                                 jax.random.PRNGKey(t))
        pstate = peng.auto_reset(peng.step(pstate, torch.from_numpy(acts)))
    if case == "last":  # the agent axis moved back to second
        stored = pstate[_OBS]
        np.testing.assert_array_equal(
            ptr._policy_obs_and_mask(pstate, None, "shared")[0].numpy(),
            stored.transpose(1, 2).numpy())


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_update_matches_jax(case, tmp_path):
    _, _, jtr, ptr = _pair(case, tmp_path)
    carry = jtr._carry
    _, batch = jax.jit(jtr._build_rollout_profile_fn())(
        carry, jax.random.PRNGKey(0))
    batch = _host(batch)
    params, opt = carry["params"], carry["opt"]
    ptr.models["shared"].load_state_dict(
        params_from_flax(_host(params["shared"])))
    ptr.optimizers["shared"].load_state_dict(
        adam_state_from_optax(_host(opt["shared"])))
    params, opt, jmetrics = jax.jit(jtr._make_update(with_metrics=True))(
        params, opt, batch, jnp.float32(0), jax.random.PRNGKey(1))
    metrics = ptr._update({k: torch.from_numpy(v.copy())
                           for k, v in batch.items()}, 0)
    np.testing.assert_allclose(float(metrics["shared"]["Total loss"]),
                               float(jmetrics["shared"]["Total loss"]),
                               rtol=1e-5)
    want = params_from_flax(_host(params["shared"]))
    for name, p in ptr.models["shared"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trains_and_evaluates(case, tmp_path):
    _, peng, _, ptr = _pair(case, tmp_path)
    assert ptr.models["shared"].Dense_0.weight.shape[1] == 3
    ptr.train()
    rew, _ = ptr.evaluate_episodes()
    assert rew["shared"].shape == (peng.n_envs, peng.n_agents)
    assert np.isfinite(rew["shared"]).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_reset_kernel_plan_takes_either_layouts_state(case, tmp_path):
    """The store keeps every at-reset snapshot row-major whatever layout it
    was handed (the agent-dim-last observations arrive transposed), so
    the reset kernel's plan (``ops/reset.plan``, which a card runs before
    its launch) takes the trainer's env state after a step."""
    _, peng, _, ptr = _pair(case, tmp_path)
    assert all(t.is_contiguous() for t in peng.store.snapshot.values())
    state = dict(ptr._env_state)
    actions = torch.zeros_like(state[_ACTIONS])
    new = peng.step(state, actions)
    entries = reset_kernel.plan(ptr._env_state, new, peng.store.snapshot,
                                peng.store.pools, {})
    assert {name for name, *_ in entries} >= set(peng.store.snapshot)


def test_trainer_engine_flag_mismatch_raises(tmp_path):
    """As in the JAX package: the separate flag must match the engine's
    (ValueError), and so must the agent-dim layout (AssertionError)."""
    cfg = _config(2)
    for cls, engine_cls in ((JaxTrainerA2C, JaxEnvEngine),
                            (TrainerA2C, EnvEngine)):
        kw = {} if engine_cls is JaxEnvEngine else {"device": "cpu"}
        eng = engine_cls(env_obj=(MiniDictObsEnv() if cls is JaxTrainerA2C
                                  else TorchMiniDictObsEnv()),
                         num_envs=2, seed=2, **kw)
        with pytest.raises(ValueError, match="separate"):
            cls(env_wrapper=eng, config=cfg, verbose=False,
                create_separate_placeholders_for_each_policy=True,
                results_dir=str(tmp_path / "x"))
        with pytest.raises(AssertionError, match="agent dim"):
            cls(env_wrapper=eng, config=cfg, verbose=False,
                obs_dim_corresponding_to_num_agents="last",
                results_dir=str(tmp_path / "y"))


def test_last_layout_takes_1d_features_only():
    class TwoDimFeatures(TorchMiniLastDimEnv):
        def reset(self):
            super().reset()
            return {a: np.zeros((2, 2), np.float32) for a in range(2)}

    with pytest.raises(AssertionError, match="1-D"):
        EnvEngine(env_obj=TwoDimFeatures(), num_envs=2, device="cpu",
                  obs_dim_corresponding_to_num_agents="last")
