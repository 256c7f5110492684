"""
Acrobot environment (discrete torque, RK4-integrated two-link dynamics).

The port's counterpart of ``warpdrive_tpu/envs/classic_control/acrobot.py``:
torque from {-1, 0, 1}, one RK4 step of the two-link ODE, angle wrapping to
[-pi, pi], velocity bounds (4*pi, 9*pi), reward -1 (0 on the terminating
step), obs = (cos th1, sin th1, cos th2, sin th2, dth1, dth2), done at
terminal height or episode end.

The RK4 integrator and ODE are shared between the numpy reference and the
device step through a module-switch argument (``np`` or ``torch``), so there
is one place the physics lives.  The angle wrap is a floor modulo, Python's
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
from warpdrive_tpu_torch.utils.spaces import Box, Discrete

_OBS = Constants.OBSERVATIONS
_ACTIONS = Constants.ACTIONS
_REWARDS = Constants.REWARDS

LINK_LENGTH_1 = 1.0
LINK_MASS_1 = 1.0
LINK_MASS_2 = 1.0
LINK_COM_POS_1 = 0.5
LINK_COM_POS_2 = 0.5
LINK_MOI = 1.0
GRAVITY = 9.8
DT = 0.2
MAX_VEL_1 = 4 * np.pi
MAX_VEL_2 = 9 * np.pi
AVAIL_TORQUE = np.array([-1.0, 0.0, 1.0], dtype=np.float32)


def _dsdt(s, torque, np_mod):
    """Two-link ODE right-hand side."""
    m1, m2 = LINK_MASS_1, LINK_MASS_2
    l1 = LINK_LENGTH_1
    lc1, lc2 = LINK_COM_POS_1, LINK_COM_POS_2
    i1 = i2 = LINK_MOI
    g = GRAVITY
    theta1, theta2, dtheta1, dtheta2 = s[0], s[1], s[2], s[3]

    d1 = (
        m1 * lc1**2
        + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * np_mod.cos(theta2))
        + i1
        + i2
    )
    d2 = m2 * (lc2**2 + l1 * lc2 * np_mod.cos(theta2)) + i2
    phi2 = m2 * lc2 * g * np_mod.cos(theta1 + theta2 - np.pi / 2)
    phi1 = (
        -m2 * l1 * lc2 * dtheta2**2 * np_mod.sin(theta2)
        - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * np_mod.sin(theta2)
        + (m1 * lc1 + m2 * l1) * g * np_mod.cos(theta1 - np.pi / 2)
        + phi2
    )
    ddtheta2 = (
        torque
        + d2 / d1 * phi1
        - m2 * l1 * lc2 * dtheta1**2 * np_mod.sin(theta2)
        - phi2
    ) / (m2 * lc2**2 + i2 - d2**2 / d1)
    ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
    return np_mod.stack([dtheta1, dtheta2, ddtheta1, ddtheta2])


def _rk4_step(s, torque, np_mod):
    """One RK4 step."""
    k1 = _dsdt(s, torque, np_mod)
    k2 = _dsdt(s + k1 * (DT / 2), torque, np_mod)
    k3 = _dsdt(s + k2 * (DT / 2), torque, np_mod)
    k4 = _dsdt(s + k3 * DT, torque, np_mod)
    return s + DT / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def _wrap(x, np_mod):
    """Wrap an angle into [-pi, pi] with a floor modulo."""
    return ((x + np.pi) % (2 * np.pi)) - np.pi


def _integrate(s, torque, np_mod):
    ns = _rk4_step(s, torque, np_mod)
    th1 = _wrap(ns[0], np_mod)
    th2 = _wrap(ns[1], np_mod)
    dth1 = np_mod.clip(ns[2], -MAX_VEL_1, MAX_VEL_1)
    dth2 = np_mod.clip(ns[3], -MAX_VEL_2, MAX_VEL_2)
    return np_mod.stack([th1, th2, dth1, dth2])


def _observation(s, np_mod):
    return np_mod.stack(
        [
            np_mod.cos(s[0]),
            np_mod.sin(s[0]),
            np_mod.cos(s[1]),
            np_mod.sin(s[1]),
            s[2],
            s[3],
        ]
    )


class ClassicControlAcrobotEnv(SingleAgentEnv):
    """Numpy reference implementation (float32)."""

    name = "ClassicControlAcrobotEnv"

    def __init__(self, episode_length=500, env_backend="cpu", reset_pool_size=0,
                 seed=None):
        super().__init__(episode_length, env_backend, reset_pool_size, seed=seed)
        self.action_space = map_to_single_agent(Discrete(3))
        self.observation_space = map_to_single_agent(
            Box(-np.inf, np.inf, shape=(6,), dtype=np.float32)
        )
        self.state = None

    def _sample_initial_state(self) -> np.ndarray:
        return self.np_random.uniform(low=-0.1, high=0.1, size=(4,)).astype(
            np.float32
        )

    def reset(self):
        self.timestep = 0
        if self.reset_pool_size < 2:
            self.np_random = np.random.RandomState(self.seed)
        self.state = self._sample_initial_state()
        return map_to_single_agent(_observation(self.state, np).astype(np.float32))

    def _sync_obs(self):
        return map_to_single_agent(_observation(self.state, np).astype(np.float32))

    def step(self, action=None):
        self.timestep += 1
        action = get_action_for_single_agent(action)
        if isinstance(action, np.ndarray):
            action = int(action.reshape(-1)[0])
        torque = np.float32(AVAIL_TORQUE[action])
        s = self.state.astype(np.float32)
        self.state = _integrate(s, torque, np).astype(np.float32)
        terminated = bool(
            -np.cos(self.state[0]) - np.cos(self.state[1] + self.state[0]) > 1.0
        )
        obs = map_to_single_agent(_observation(self.state, np).astype(np.float32))
        rew = map_to_single_agent(0.0 if terminated else -1.0)
        done = {"__all__": self.timestep >= self.episode_length or terminated}
        return obs, rew, done, {}


class TorchClassicControlAcrobotEnv(
    SingleStateFeed, ClassicControlAcrobotEnv, TorchEnvironmentContext
):
    """The batched device step: the ODE helpers index the state by its
    component, so they run unchanged on the ``(4, envs)`` transpose of the
    ``(envs, 1, 4)`` state."""

    def observe_fn(self, state: dict) -> torch.Tensor:
        """Observations ``(envs, 1, 6)`` of the state."""
        sT = state["state"][:, 0, :].T  # (4, E)
        return _observation(sT, torch).T[:, None, :].to(torch.float32)

    def step_fn(self, state: dict) -> dict:
        s = state["state"]  # (E, 1, 4)
        E = s.shape[0]
        action = state[_ACTIONS].reshape(E)
        t = state[Constants.TIMESTEP] + 1

        # AVAIL_TORQUE is exactly [-1, 0, 1]
        torque = (action - 1).to(torch.float32)
        new_sT = _integrate(s[:, 0, :].T, torque, torch)  # (4, E)
        terminated = (-torch.cos(new_sT[0]) - torch.cos(new_sT[1] + new_sT[0])) > 1.0

        out = dict(state)
        out["state"] = new_sT.T[:, None, :].contiguous()
        out[_OBS] = _observation(new_sT, torch).T[:, None, :].contiguous()
        out[_REWARDS] = torch.where(terminated, 0.0, -1.0)[:, None].to(
            torch.float32
        )
        out[Constants.TIMESTEP] = t
        out[Constants.DONE] = ((t >= self.episode_length) | terminated).to(
            torch.int32
        )
        return out


env_registrar.add(ClassicControlAcrobotEnv, backend="cpu")
env_registrar.add(TorchClassicControlAcrobotEnv, backend="torch")
