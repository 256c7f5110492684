"""
Pendulum environment (continuous torque).

The port's counterpart of ``warpdrive_tpu/envs/classic_control/pendulum.py``:
cost computed on the PRE-step angle, reward ``-(angle_norm(th)^2 + 0.1
thdot^2 + 0.001 u^2)``, obs ``(cos th, sin th, thdot)``, done only at
episode end, g = 9.81.  The angle normalization is a floor modulo, Python's
``%``, which on a tensor is ``torch.remainder`` (not ``torch.fmod``).
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

MAX_SPEED = 8.0
MAX_TORQUE = 2.0
DT = 0.05
G = 9.81
M = 1.0
L = 1.0


def _angle_normalize(x, np_mod):
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class ClassicControlPendulumEnv(SingleAgentEnv):
    """Numpy reference implementation (float32)."""

    name = "ClassicControlPendulumEnv"

    def __init__(self, episode_length=500, env_backend="cpu", reset_pool_size=0,
                 seed=None):
        super().__init__(episode_length, env_backend, reset_pool_size, seed=seed)
        self.action_space = map_to_single_agent(
            Box(-MAX_TORQUE, MAX_TORQUE, shape=(1,), dtype=np.float32)
        )
        self.observation_space = map_to_single_agent(
            Box(-np.inf, np.inf, shape=(3,), dtype=np.float32)
        )
        self.state = None  # (theta, theta_dot)

    def _sample_initial_state(self) -> np.ndarray:
        th = self.np_random.uniform(low=-np.pi, high=np.pi)
        thdot = self.np_random.uniform(low=-1.0, high=1.0)
        return np.array([th, thdot], dtype=np.float32)

    def _obs(self) -> np.ndarray:
        th, thdot = self.state
        return np.array([np.cos(th), np.sin(th), thdot], dtype=np.float32)

    def reset(self):
        self.timestep = 0
        if self.reset_pool_size < 2:
            self.np_random = np.random.RandomState(self.seed)
        self.state = self._sample_initial_state()
        return map_to_single_agent(self._obs())

    def _sync_obs(self):
        return map_to_single_agent(self._obs())

    def step(self, action=None):
        self.timestep += 1
        action = get_action_for_single_agent(action)
        u = np.clip(
            np.float32(np.asarray(action).reshape(-1)[0]), -MAX_TORQUE, MAX_TORQUE
        )
        th, thdot = (np.float32(v) for v in self.state)
        costs = (
            _angle_normalize(th, np) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        )
        newthdot = thdot + np.float32(
            (3 * G / (2 * L) * np.sin(th) + 3.0 / (M * L**2) * u) * DT
        )
        newthdot = np.clip(newthdot, -MAX_SPEED, MAX_SPEED).astype(np.float32)
        newth = np.float32(th + newthdot * DT)
        self.state = np.array([newth, newthdot], dtype=np.float32)
        obs = map_to_single_agent(self._obs())
        rew = map_to_single_agent(float(-costs))
        done = {"__all__": self.timestep >= self.episode_length}
        return obs, rew, done, {}


class TorchClassicControlPendulumEnv(
    SingleStateFeed, ClassicControlPendulumEnv, TorchEnvironmentContext
):
    """The batched device step on the ``(envs, 1, 2)`` (theta, theta_dot)
    state."""

    def observe_fn(self, state: dict) -> torch.Tensor:
        """Observations ``(envs, 1, 3)`` of the state."""
        th, thdot = state["state"][:, 0, 0], state["state"][:, 0, 1]
        return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=1)[
            :, None, :
        ].to(torch.float32)

    def step_fn(self, state: dict) -> dict:
        s = state["state"]  # (E, 1, 2)
        E = s.shape[0]
        action = state[_ACTIONS].reshape(E).to(torch.float32)
        t = state[Constants.TIMESTEP] + 1

        u = torch.clamp(action, -MAX_TORQUE, MAX_TORQUE)
        th, thdot = s[:, 0, 0], s[:, 0, 1]
        costs = _angle_normalize(th, torch) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (
            3 * G / (2 * L) * torch.sin(th) + 3.0 / (M * L**2) * u
        ) * DT
        newthdot = torch.clamp(newthdot, -MAX_SPEED, MAX_SPEED)
        newth = th + newthdot * DT

        out = dict(state)
        out["state"] = torch.stack([newth, newthdot], dim=1)[:, None, :]
        out[_OBS] = torch.stack(
            [torch.cos(newth), torch.sin(newth), newthdot], dim=1
        )[:, None, :]
        out[_REWARDS] = (-costs)[:, None]
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = (t >= self.episode_length).to(torch.int32)
        return out


env_registrar.add(ClassicControlPendulumEnv, backend="cpu")
env_registrar.add(TorchClassicControlPendulumEnv, backend="torch")
