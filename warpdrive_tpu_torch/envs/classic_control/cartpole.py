"""
CartPole-v1 environment (numpy reference + batched PyTorch step).

The port's counterpart of ``warpdrive_tpu/envs/classic_control/cartpole.py``:
the classic cart-pole with the Euler kinematics integrator, one function
``_cartpole_dynamics`` shared by the numpy reference and the device step
(which keeps its order of operations: ``x + TAU * x_dot`` is a product and
then a sum, two kernels, never contracted to an FMA in eager PyTorch).

Reward is +1 every step (including the terminating one); ``done=1`` on pole
fall, cart out of bounds, or episode end.
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

# Physical constants of the classic cart-pole.
GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSPOLE + MASSCART
LENGTH = 0.5  # half the pole's length
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD_RADIANS = 12 * 2 * np.pi / 360
X_THRESHOLD = 2.4


def _cartpole_dynamics(x, x_dot, theta, theta_dot, force, np_mod):
    """One Euler step of the cart-pole ODE (numpy and torch alike)."""
    costheta = np_mod.cos(theta)
    sintheta = np_mod.sin(theta)
    temp = (force + POLEMASS_LENGTH * theta_dot**2 * sintheta) / TOTAL_MASS
    thetaacc = (GRAVITY * sintheta - costheta * temp) / (
        LENGTH * (4.0 / 3.0 - MASSPOLE * costheta**2 / TOTAL_MASS)
    )
    xacc = temp - POLEMASS_LENGTH * thetaacc * costheta / TOTAL_MASS
    x = x + TAU * x_dot
    x_dot = x_dot + TAU * xacc
    theta = theta + TAU * theta_dot
    theta_dot = theta_dot + TAU * thetaacc
    return x, x_dot, theta, theta_dot


class ClassicControlCartPoleEnv(SingleAgentEnv):
    """Numpy reference implementation (gym-parity dynamics, float32)."""

    name = "ClassicControlCartPoleEnv"

    def __init__(self, episode_length=500, env_backend="cpu", reset_pool_size=0,
                 seed=None):
        super().__init__(episode_length, env_backend, reset_pool_size, seed=seed)
        self.action_space = map_to_single_agent(Discrete(2))
        self.observation_space = map_to_single_agent(
            Box(-np.inf, np.inf, shape=(4,), dtype=np.float32)
        )
        self.state = None

    def _sample_initial_state(self) -> np.ndarray:
        return self.np_random.uniform(low=-0.05, high=0.05, size=(4,)).astype(
            np.float32
        )

    def reset(self):
        self.timestep = 0
        if self.reset_pool_size < 2:
            # fixed initial state for every reset
            self.np_random = np.random.RandomState(self.seed)
        self.state = self._sample_initial_state()
        return map_to_single_agent(self.state.copy())

    def step(self, action=None):
        self.timestep += 1
        action = get_action_for_single_agent(action)
        if isinstance(action, np.ndarray):
            action = int(action.reshape(-1)[0])
        force = FORCE_MAG if action > 0.5 else -FORCE_MAG
        x, x_dot, theta, theta_dot = (np.float32(v) for v in self.state)
        x, x_dot, theta, theta_dot = _cartpole_dynamics(
            x, x_dot, theta, theta_dot, np.float32(force), np
        )
        self.state = np.array([x, x_dot, theta, theta_dot], dtype=np.float32)
        terminated = bool(
            x < -X_THRESHOLD
            or x > X_THRESHOLD
            or theta < -THETA_THRESHOLD_RADIANS
            or theta > THETA_THRESHOLD_RADIANS
        )
        obs = map_to_single_agent(self.state.copy())
        rew = map_to_single_agent(1.0)
        done = {"__all__": self.timestep >= self.episode_length or terminated}
        return obs, rew, done, {}


class TorchClassicControlCartPoleEnv(
    SingleStateFeed, ClassicControlCartPoleEnv, TorchEnvironmentContext
):
    """The batched device step on the ``(envs, 1, 4)`` state."""

    def observe_fn(self, state: dict) -> torch.Tensor:
        """Observations ``(envs, 1, 4)``: the state itself."""
        return state["state"].to(torch.float32)

    def step_fn(self, state: dict) -> dict:
        s = state["state"]  # (E, 1, 4)
        E = s.shape[0]
        action = state[_ACTIONS].reshape(E)
        t = state[Constants.TIMESTEP] + 1

        force = torch.where(action > 0.5, FORCE_MAG, -FORCE_MAG).to(
            torch.float32
        )
        x, x_dot, theta, theta_dot = _cartpole_dynamics(
            s[:, 0, 0], s[:, 0, 1], s[:, 0, 2], s[:, 0, 3], force, torch
        )
        new_s = torch.stack([x, x_dot, theta, theta_dot], dim=1)[:, None, :]
        terminated = (
            (x < -X_THRESHOLD)
            | (x > X_THRESHOLD)
            | (theta < -THETA_THRESHOLD_RADIANS)
            | (theta > THETA_THRESHOLD_RADIANS)
        )

        out = dict(state)
        out["state"] = new_s
        out[_OBS] = new_s
        out[_REWARDS] = torch.ones((E, 1), dtype=torch.float32, device=s.device)
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = ((t >= self.episode_length) | terminated).to(
            torch.int32
        )
        return out


env_registrar.add(ClassicControlCartPoleEnv, backend="cpu")
env_registrar.add(TorchClassicControlCartPoleEnv, backend="torch")
