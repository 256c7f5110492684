"""
EnvEngine: the vectorized environment runtime on one device.

The port's counterpart of ``warpdrive_tpu/envs/engine.py``.  It

* builds the batched device state from the env's host-side reset and its
  DataFeeds (single-env arrays replicated across replicas) and registers
  the env's reset pools,
* creates the shared observation/action/reward placeholders,
* exposes the functions a rollout composes, each taking and returning a
  dict of batched tensors without touching its input: ``step`` (write the
  actions, then the env's whole ``step_fn``, or on the split path
  ``step_physics`` then ``observe``), ``auto_reset``, and on the split path
  ``step_physics`` and ``observe`` (``None`` on the full-step path),
* refreshes, after a reset that drew reset-pool rows, the observations of
  the reset replicas from the env's ``observe_fn`` (restoring the
  at-reset snapshot would leave them one step stale),
* offers the gym-like conveniences ``reset_all_envs``,
  ``reset_only_done_envs`` and ``step_all_envs``, which keep the engine's
  own ``state``,
* and ``rewards_of``, the all-agent rewards a trainer records.

Separate per-policy placeholders and Dict observations raise
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdrive_tpu_torch.core.reset import make_auto_reset_fn
from warpdrive_tpu_torch.core.state import StateStore
from warpdrive_tpu_torch.training.data_loader import (
    create_and_push_data_placeholders,
)
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.device import resolve_device
from warpdrive_tpu_torch.utils.env_registrar import (
    env_registrar as default_registrar,
)
from warpdrive_tpu_torch.utils.spaces import Box

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_REWARDS = Constants.REWARDS


class EnvEngine:
    """Vectorized environment engine over ``num_envs`` replicas on
    ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``)."""

    def __init__(
        self,
        env_obj=None,
        env_name: str = None,
        env_config: dict = None,
        num_envs: int = 2,
        env_registrar=None,
        seed: int = 0,
        create_separate_placeholders_for_each_policy: bool = False,
        obs_dim_corresponding_to_num_agents: str = "first",
        device="cuda",
    ):
        self.device = resolve_device(device)
        registrar = env_registrar or default_registrar
        if env_obj is None:
            assert env_name is not None, "pass env_obj or env_name"
            env_cls = registrar.get(env_name, backend="torch")
            env_obj = env_cls(**(env_config or {}))
        self.env = env_obj
        self.has_split_step = bool(getattr(self.env, "has_split_step", False))
        if not self.has_split_step:
            # the full-step path: the env's whole step_fn writes its own
            # observations, so there is no split pair to compose
            self.step_physics = None
            self.observe = None
        self.n_envs = int(num_envs)
        self.n_agents = int(self.env.num_agents)
        self.episode_length = int(self.env.episode_length)

        # --- host-side first reset: infer spaces & initial obs -------------
        obs = self.env.reset()
        self._agent_ids = sorted(obs.keys())
        assert len(self._agent_ids) == self.n_agents
        if not isinstance(getattr(self.env, "observation_space", None), dict):
            self.env.observation_space = {
                aid: Box(-np.inf, np.inf, shape=np.asarray(obs[aid]).shape)
                for aid in self._agent_ids
            }
        self.action_space = self.env.action_space
        self.observation_space = self.env.observation_space

        # --- batched device state -------------------------------------------
        self.store = StateStore(
            num_envs=self.n_envs,
            num_agents=self.n_agents,
            episode_length=self.episode_length,
            device=self.device,
            seed=seed,
        )
        self.store.push(self.env.get_data_dictionary())
        self.store.push(self.env.get_tensor_dictionary())
        pool_feed = self.env.get_reset_pool_dictionary()
        if pool_feed:
            self.store.push(pool_feed)

        placeholder_meta = create_and_push_data_placeholders(
            self.store,
            obs,
            self.observation_space,
            self.action_space,
            create_separate_placeholders_for_each_policy=(
                create_separate_placeholders_for_each_policy
            ),
            obs_dim_corresponding_to_num_agents=(
                obs_dim_corresponding_to_num_agents
            ),
        )
        self._act_dtype = torch.from_numpy(
            np.zeros((), dtype=placeholder_meta["groups"][None]["action"][1])
        ).dtype

        self.auto_reset = self._make_auto_reset()
        self.state = self.store.state
        self._first_reset_done = False

    def _make_auto_reset(self):
        """The done-driven reset; with reset pools, followed by the
        observation refresh of the replicas it reset."""
        base_auto_reset = make_auto_reset_fn(
            self.store.snapshot, self.store.pools
        )
        if not self.store.pools:
            return base_auto_reset
        observe_fn = getattr(self.env, "observe_fn", None)
        if observe_fn is None:
            # without the refresh every pool reset would serve one step of
            # observations of the fixed snapshot beside a pool row's state
            raise NotImplementedError(
                "reset pools need the env's observe_fn, which refreshes the "
                "observations of the replicas a pool reset has reset"
            )

        def auto_reset(state: dict, generator: torch.Generator = None,
                       force: bool = False, pool_idx: dict = None) -> dict:
            done = state[Constants.DONE] > 0
            if force:
                done = torch.ones_like(done)
            new_state = base_auto_reset(state, generator, force=force,
                                        pool_idx=pool_idx)
            if _OBS in new_state:
                fresh = observe_fn(dict(new_state))
                mask = done.reshape(done.shape + (1,) * (fresh.ndim - 1))
                new_state[_OBS] = torch.where(
                    mask, fresh.to(new_state[_OBS].dtype), new_state[_OBS]
                )
            return new_state

        return auto_reset

    def rewards_of(self, state: dict) -> torch.Tensor:
        """All-agent rewards ``(envs, agents)`` of a state."""
        return state[_REWARDS]

    # ------------------------------------------------------------ the steps
    def _as_actions(self, actions) -> torch.Tensor:
        a = torch.as_tensor(actions, device=self.device)
        if a.ndim == 2:  # (envs, agents) -> add the action-type axis
            a = a[..., None]
        return a.to(self._act_dtype)

    def step_physics(self, state: dict, actions) -> dict:
        """Split path: dynamics, rewards and done flags of every replica
        for ``actions`` of shape ``(envs, agents[, components])``
        (``None`` on the full-step path)."""
        return self.env.physics_fn(dict(state), self._as_actions(actions))

    def observe(self, state: dict) -> torch.Tensor:
        """Split path: observations ``(envs, agents, obs_dim)`` of the
        current state (``None`` on the full-step path)."""
        return self.env.observe_batch_fn(dict(state))

    def write_actions(self, state: dict, actions) -> dict:
        """Write ``actions`` into the ``sampled_actions`` placeholder."""
        state = dict(state)
        state[_ACTIONS] = self._as_actions(actions)
        return state

    def step(self, state: dict, actions=None) -> dict:
        """Write ``actions`` (when given), then the env's whole
        ``step_fn``, or on the split path physics and then observations."""
        if actions is not None:
            state = self.write_actions(state, actions)
        if not self.has_split_step:
            return self.env.step_fn(dict(state))
        out = self.step_physics(state, state[_ACTIONS])
        out[_OBS] = self.observe(out)
        return out

    # ------------------------------------------------------- stateful facade
    def reset_all_envs(self) -> torch.Tensor:
        """Force-reset every replica and return the batched observations.
        The very first call returns the initial state as built."""
        if self._first_reset_done:
            self.state = self.auto_reset(
                self.state, self.store.generator, force=True
            )
        self._first_reset_done = True
        return self.state[_OBS]

    def reset_only_done_envs(self):
        """Reset the finished replicas only."""
        self._first_reset_done = True
        self.state = self.auto_reset(self.state, self.store.generator)

    def step_all_envs(self, actions) -> dict:
        """Step every replica with ``actions`` of shape
        ``(envs, agents[, components])`` and return the device tensors of
        observations, rewards and done flags."""
        self._first_reset_done = True
        self.state = self.step(self.state, actions)
        return {
            Constants.DONE: self.state[Constants.DONE],
            _OBS: self.state[_OBS],
            _REWARDS: self.state[_REWARDS],
        }
