"""
Continuous MountainCar environment (Box action).

The port's counterpart of
``warpdrive_tpu/envs/classic_control/continuous_mountain_car.py``: force is
the clipped continuous action, reward is ``100 * terminated - 0.1 * a^2``,
done=1 on goal or timeout.  It trains with DDPG and OU exploration noise.
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
from warpdrive_tpu_torch.utils.spaces import Box

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_REWARDS = Constants.REWARDS

MIN_ACTION = -1.0
MAX_ACTION = 1.0
MIN_POSITION = -1.2
MAX_POSITION = 0.6
MAX_SPEED = 0.07
GOAL_POSITION = 0.45
GOAL_VELOCITY = 0.0
POWER = 0.0015


class ClassicControlContinuousMountainCarEnv(SingleAgentEnv):
    """Numpy reference implementation (float32)."""

    name = "ClassicControlContinuousMountainCarEnv"

    def __init__(self, episode_length=1000, env_backend="cpu", reset_pool_size=0,
                 seed=None):
        super().__init__(episode_length, env_backend, reset_pool_size, seed=seed)
        self.action_space = map_to_single_agent(
            Box(MIN_ACTION, MAX_ACTION, shape=(1,), dtype=np.float32)
        )
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
        action = np.float32(np.asarray(action).reshape(-1)[0])
        position, velocity = (np.float32(v) for v in self.state)
        force = np.clip(action, MIN_ACTION, MAX_ACTION).astype(np.float32)
        velocity += np.float32(force * POWER) - np.float32(
            0.0025 * np.cos(3 * position)
        )
        velocity = np.clip(velocity, -MAX_SPEED, MAX_SPEED).astype(np.float32)
        position = np.float32(position + velocity)
        position = np.clip(position, MIN_POSITION, MAX_POSITION).astype(np.float32)
        if position == MIN_POSITION and velocity < 0:
            velocity = np.float32(0.0)
        self.state = np.array([position, velocity], dtype=np.float32)
        terminated = bool(position >= GOAL_POSITION and velocity >= GOAL_VELOCITY)
        rew = 100.0 if terminated else 0.0
        rew -= float(action) ** 2 * 0.1
        obs = map_to_single_agent(self.state.copy())
        done = {"__all__": self.timestep >= self.episode_length or terminated}
        return obs, map_to_single_agent(rew), done, {}


class TorchClassicControlContinuousMountainCarEnv(
    SingleStateFeed, ClassicControlContinuousMountainCarEnv,
    TorchEnvironmentContext,
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
        force = torch.clamp(action, MIN_ACTION, MAX_ACTION)
        velocity = velocity + force * POWER - 0.0025 * torch.cos(3.0 * position)
        velocity = torch.clamp(velocity, -MAX_SPEED, MAX_SPEED)
        position = torch.clamp(position + velocity, MIN_POSITION, MAX_POSITION)
        velocity = torch.where(
            (position == MIN_POSITION) & (velocity < 0), 0.0, velocity
        )
        new_s = torch.stack([position, velocity], dim=1)[:, None, :]
        terminated = (position >= GOAL_POSITION) & (velocity >= GOAL_VELOCITY)

        out = dict(state)
        out["state"] = new_s
        out[_OBS] = new_s
        out[_REWARDS] = (
            torch.where(terminated, 100.0, 0.0) - action**2 * 0.1
        )[:, None].to(torch.float32)
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = ((t >= self.episode_length) | terminated).to(
            torch.int32
        )
        return out


env_registrar.add(ClassicControlContinuousMountainCarEnv, backend="cpu")
env_registrar.add(TorchClassicControlContinuousMountainCarEnv, backend="torch")
