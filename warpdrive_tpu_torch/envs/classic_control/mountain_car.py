"""
MountainCar-v0 (discrete) environment.

The port's counterpart of
``warpdrive_tpu/envs/classic_control/mountain_car.py``: the classic gym
mountain car.  The done flag carries the success marker: ``done=2`` when
the goal is reached before the episode ends, which the trainer's
negative/positive env downsampling reads
(``algos/policygradient.py:env_selection_weights``, ``neg_pos_env_ratio``).
"""

from __future__ import annotations

import numpy as np
import torch

from warpdrive_tpu_torch.envs.base import TorchEnvironmentContext
from warpdrive_tpu_torch.envs.classic_control.base import (
    SingleAgentEnv,
    SingleStateFeed,
    get_action_for_single_agent,
    map_to_single_agent,
)
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.env_registrar import env_registrar
from warpdrive_tpu_torch.utils.spaces import Box, Discrete

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_REWARDS = Constants.REWARDS

MIN_POSITION = -1.2
MAX_POSITION = 0.6
MAX_SPEED = 0.07
GOAL_POSITION = 0.5
GOAL_VELOCITY = 0.0
FORCE = 0.001
GRAVITY = 0.0025


class ClassicControlMountainCarEnv(SingleAgentEnv):
    """Numpy reference implementation (float32)."""

    name = "ClassicControlMountainCarEnv"

    def __init__(self, episode_length=500, env_backend="cpu", reset_pool_size=0,
                 seed=None):
        super().__init__(episode_length, env_backend, reset_pool_size, seed=seed)
        self.action_space = map_to_single_agent(Discrete(3))
        self.observation_space = map_to_single_agent(
            Box(-np.inf, np.inf, shape=(2,), dtype=np.float32)
        )
        self.state = None

    def _sample_initial_state(self) -> np.ndarray:
        position = self.np_random.uniform(low=-0.6, high=-0.4)
        return np.array([position, 0.0], dtype=np.float32)

    def reset(self):
        self.timestep = 0
        if self.reset_pool_size < 2:
            self.np_random = np.random.RandomState(self.seed)
        self.state = self._sample_initial_state()
        return map_to_single_agent(self.state.copy())

    def step(self, action=None):
        self.timestep += 1
        action = get_action_for_single_agent(action)
        if isinstance(action, np.ndarray):
            action = int(action.reshape(-1)[0])
        position, velocity = (np.float32(v) for v in self.state)
        velocity += np.float32((action - 1) * FORCE) + np.float32(
            np.cos(3 * position) * (-GRAVITY)
        )
        velocity = np.clip(velocity, -MAX_SPEED, MAX_SPEED).astype(np.float32)
        position = np.float32(position + velocity)
        position = np.clip(position, MIN_POSITION, MAX_POSITION).astype(np.float32)
        if position == MIN_POSITION and velocity < 0:
            velocity = np.float32(0.0)
        self.state = np.array([position, velocity], dtype=np.float32)
        terminated = bool(position >= GOAL_POSITION and velocity >= GOAL_VELOCITY)
        obs = map_to_single_agent(self.state.copy())
        rew = map_to_single_agent(-1.0)
        done = {"__all__": self.timestep >= self.episode_length or terminated}
        return obs, rew, done, {}


class TorchClassicControlMountainCarEnv(
    SingleStateFeed, ClassicControlMountainCarEnv, TorchEnvironmentContext
):
    """The batched device step on the ``(envs, 1, 2)`` state."""

    def observe_fn(self, state: dict) -> torch.Tensor:
        """Observations ``(envs, 1, 2)``: the state itself."""
        return state["state"].to(torch.float32)

    def step_fn(self, state: dict) -> dict:
        s = state["state"]  # (E, 1, 2)
        E = s.shape[0]
        action = state[_ACTIONS].reshape(E).to(torch.float32)
        t = state[Constants.TIMESTEP] + 1

        position, velocity = s[:, 0, 0], s[:, 0, 1]
        velocity = velocity + (action - 1.0) * FORCE + torch.cos(
            3.0 * position
        ) * (-GRAVITY)
        velocity = torch.clamp(velocity, -MAX_SPEED, MAX_SPEED)
        position = torch.clamp(position + velocity, MIN_POSITION, MAX_POSITION)
        velocity = torch.where(
            (position == MIN_POSITION) & (velocity < 0), 0.0, velocity
        )
        new_s = torch.stack([position, velocity], dim=1)[:, None, :]

        terminated = (position >= GOAL_POSITION) & (velocity >= GOAL_VELOCITY)
        # done=2 marks success; the timeout wins a tie with it
        done = torch.where(
            t >= self.episode_length, 1, torch.where(terminated, 2, 0)
        ).to(torch.int32)

        out = dict(state)
        out["state"] = new_s
        out[_OBS] = new_s
        out[_REWARDS] = -torch.ones((E, 1), dtype=torch.float32,
                                    device=s.device)
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = done
        return out


env_registrar.add(ClassicControlMountainCarEnv, backend="cpu")
env_registrar.add(TorchClassicControlMountainCarEnv, backend="torch")
