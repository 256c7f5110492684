"""
DummyEnv: the minimal test environment.

The port's counterpart of ``warpdrive_tpu/envs/dummy_env.py``: it exercises
the framework's plumbing -- state transfer and in-place updates (``x /=
multiplier``, ``y *= multiplier``), a "reach target" condition over the
agents setting the done flag, and the observations written by the step.
``DummyEnv`` is the port's own copy of the numpy reference;
``TorchDummyEnv`` adds the batched ``step_fn``.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdrive_tpu_torch.envs.base import TorchEnvironmentContext
from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.data_feed import DataFeed
from warpdrive_tpu_torch.utils.env_registrar import env_registrar
from warpdrive_tpu_torch.utils.spaces import Discrete

_OBS = Constants.OBSERVATIONS
_REWARDS = Constants.REWARDS


class DummyEnv:
    """Numpy reference of the dummy test env."""

    name = "DummyEnv"

    def __init__(self, num_agents=5, episode_length=3, multiplier=2.0,
                 target=100, seed=None):
        self.num_agents = int(num_agents)
        self.episode_length = int(episode_length)
        self.multiplier = float(multiplier)
        self.target = int(target)
        self.np_random = np.random.RandomState(seed)
        self.action_space = {a: Discrete(3) for a in range(self.num_agents)}
        self.observation_space = None
        self.x = None
        self.y = None
        self.timestep = None

    def _obs(self):
        return {
            a: np.array([self.x[a], float(self.y[a])], dtype=np.float32)
            for a in range(self.num_agents)
        }

    def reset(self):
        self.timestep = 0
        self.x = np.full(self.num_agents, 2.0**self.episode_length,
                         dtype=np.float32)
        self.y = np.arange(1, self.num_agents + 1, dtype=np.int32)
        return self._obs()

    def step(self, actions=None):
        self.timestep += 1
        self.x = self.x / self.multiplier
        self.y = (self.y * self.multiplier).astype(np.int32)
        reach = bool((self.y >= self.target).any())
        obs = self._obs()
        rew = {a: 0.0 for a in range(self.num_agents)}
        done = {"__all__": self.timestep >= self.episode_length or reach}
        return obs, rew, done, {}


class TorchDummyEnv(DummyEnv, TorchEnvironmentContext):
    """The batched step over ``(envs, agents)`` tensors."""

    def get_data_dictionary(self) -> DataFeed:
        data = DataFeed()
        data.add_data("x", self.x, save_copy_and_apply_at_reset=True)
        data.add_data("y", self.y, save_copy_and_apply_at_reset=True)
        return data

    def _multiplier(self, device: torch.device) -> torch.Tensor:
        """The divisor as a tensor on ``device``, made once a device (CUDA
        divides by a host scalar through its reciprocal)."""
        cache = self.__dict__.setdefault("_multiplier_by_device", {})
        if device not in cache:
            cache[device] = torch.tensor(np.float32(self.multiplier),
                                         device=device)
        return cache[device]

    def step_fn(self, state: dict) -> dict:
        t = state[Constants.TIMESTEP] + 1
        x = state["x"] / self._multiplier(state["x"].device)
        y = (state["y"] * self.multiplier).to(torch.int32)
        reach = (y >= self.target).any(dim=1)
        out = dict(state)
        out["x"] = x
        out["y"] = y
        out[_OBS] = torch.stack([x, y.to(torch.float32)], dim=2)
        out[_REWARDS] = torch.zeros_like(x)
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = ((t >= self.episode_length) | reach).to(
            torch.int32)
        return out


env_registrar.add(DummyEnv, backend="cpu")
env_registrar.add(TorchDummyEnv, backend="torch", name="DummyEnv")
