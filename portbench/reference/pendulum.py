"""
Pendulum in plain PyTorch, the benchmark's yardstick for the env layer of
the DDPG cell.  Written from the published rules (gym's ``Pendulum-v0``, as
WarpDrive's classic-control example ships it) and the configuration file
alone; it reads nothing of the program.

* the state of each env is ``(theta, theta_dot)`` and a step count;
* a step with torque ``u`` (clipped to ``[-2, 2]``) costs ``angle(theta)^2
  + 0.1 theta_dot^2 + 0.001 u^2`` on the PRE-step state, where ``angle``
  maps to ``[-pi, pi)`` by a floor modulo; the reward is minus the cost;
* ``theta_dot += (3 g / (2 l) sin(theta) + 3 / (m l^2) u) dt``, clipped to
  ``[-8, 8]``, then ``theta += theta_dot dt``, with ``g = 9.81``, ``m = l =
  1``, ``dt = 0.05``;
* the observation is ``(cos theta, sin theta, theta_dot)``;
* an env is done when its step count reaches the episode's length, never
  before, and is then reset to a row of the reset pool drawn uniformly per
  env, its step count to 0.

Departures from upstream, each kept as the port keeps it:

* ``g = 9.81`` (gym's default is 10.0);
* the starting state and the reset pool are drawn once, on the host, from
  ``numpy.random.RandomState(env seed)``: ``theta`` uniform on ``[-pi,
  pi)``, then ``theta_dot`` uniform on ``[-1, 1)``, first the starting
  state shared by every env, then each pool row in turn (gym draws each
  reset anew).
"""

from __future__ import annotations

import numpy as np
import torch

MAX_SPEED = 8.0
MAX_TORQUE = 2.0
DT = 0.05
G = 9.81
M = 1.0
L = 1.0


def angle_normalize(x):
    """``x`` mapped to ``[-pi, pi)`` by a floor modulo (Python's ``%``)."""
    return ((x + np.pi) % (2 * np.pi)) - np.pi


def initial_states(seed: int, pool_size: int):
    """``(start (2,), pool (pool_size, 2))`` float32 arrays: the starting
    ``(theta, theta_dot)`` and the reset pool, in the order they are
    drawn."""
    rs = np.random.RandomState(seed)

    def draw():
        theta = rs.uniform(low=-np.pi, high=np.pi)
        theta_dot = rs.uniform(low=-1.0, high=1.0)
        return np.array([theta, theta_dot], dtype=np.float32)

    start = draw()
    pool = np.stack([draw() for _ in range(pool_size)]) if pool_size else \
        np.zeros((0, 2), np.float32)
    return start, pool


class Pendulum:
    """``num_envs`` Pendulums on ``device``; a state is ``{"x": (E, 2)
    float32 (theta, theta_dot), "t": (E,) int32 steps}``."""

    def __init__(self, env_cfg: dict, seed: int, num_envs: int, device):
        self.episode_length = int(env_cfg["episode_length"])
        start, pool = initial_states(seed, int(env_cfg.get(
            "reset_pool_size", 0)))
        self.device = device
        self.pool = torch.as_tensor(pool, device=device)
        self.start = {
            "x": torch.as_tensor(start, device=device).repeat(num_envs, 1),
            "t": torch.zeros(num_envs, dtype=torch.int32, device=device)}

    @staticmethod
    def observe(state: dict) -> torch.Tensor:
        """``(E, 3)``: cos theta, sin theta, theta_dot."""
        theta, theta_dot = state["x"][:, 0], state["x"][:, 1]
        return torch.stack([torch.cos(theta), torch.sin(theta), theta_dot],
                           dim=1)

    def step(self, state: dict, torque: torch.Tensor):
        """``(new state, reward (E,), done (E,) int32)`` for ``torque``
        ``(E,)``."""
        u = torch.clamp(torque.to(torch.float32), -MAX_TORQUE, MAX_TORQUE)
        theta, theta_dot = state["x"][:, 0], state["x"][:, 1]
        cost = angle_normalize(theta) ** 2 + 0.1 * theta_dot ** 2 \
            + 0.001 * u ** 2
        theta_dot = theta_dot + (
            3 * G / (2 * L) * torch.sin(theta) + 3.0 / (M * L ** 2) * u
        ) * DT
        theta_dot = torch.clamp(theta_dot, -MAX_SPEED, MAX_SPEED)
        theta = theta + theta_dot * DT
        t = state["t"] + 1
        done = (t >= self.episode_length).to(torch.int32)
        return ({"x": torch.stack([theta, theta_dot], dim=1), "t": t},
                -cost, done)

    def draw_rows(self, generator_state: torch.Tensor,
                  num_envs: int) -> torch.Tensor:
        """A pool row for each env, uniform: torch's ``randint`` from a
        generator on the device at ``generator_state`` (the draw is made at
        every step; only the done envs take their rows)."""
        generator = torch.Generator(device=self.device)
        generator.set_state(generator_state)
        return torch.randint(0, self.pool.shape[0], (num_envs,),
                             generator=generator, device=self.device)

    def reset(self, state: dict, done: torch.Tensor,
              rows: torch.Tensor) -> dict:
        """The envs that are ``done`` put at pool rows ``rows`` ``(E,)``,
        their step counts to 0; the others as they are."""
        mask = done > 0
        return {"x": torch.where(mask[:, None], self.pool[rows.long()],
                                 state["x"]),
                "t": torch.where(mask, torch.zeros_like(state["t"]),
                                 state["t"])}
