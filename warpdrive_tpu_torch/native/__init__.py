"""
Native (C++) batched steppers for the eager host-env backend.

The port's own copy of ``warpdrive_tpu/native``: ``native_envs.cpp`` holds
the steppers of CartPole, Pendulum, MountainCar, ContinuousMountainCar,
Acrobot, TagGridWorld (step and observe) and TagContinuous (step and
observe); this module builds it at first use with ``g++`` and the JAX
module's flags (``-O3 -march=native -fopenmp``, so the two libraries step
alike on one host) into ``warpdrive_tpu_torch/_build/libwdnative-<digest>.so``
(the digest covers the source and the flags), and exposes batched
**adapters** that :class:`~warpdrive_tpu_torch.envs.cpu_engine.CpuEnvEngine`
uses in place of its per-env Python loop: one C call advances every env
replica.

An adapter owns the stacked state arrays between resets; the Python env
objects stay the source of ``reset()`` (their seeding semantics apply).  It
starts from the envs as their last reset left them (the JAX module's
adapters reset them once more, which with a reset pool puts the C++ path a
pool draw ahead of the Python loop).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "native_envs.cpp"
BUILD_DIR = _HERE.parent / "_build"
# the JAX module's flags (warpdrive_tpu/native/__init__.py), so that both
# libraries contract a*b + c into FMAs alike on one host
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
_LOCK = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def library_path() -> Path:
    """Where the library built from ``native_envs.cpp`` lives."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwdnative-{digest.hexdigest()[:16]}.so"


def get_lib() -> ctypes.CDLL:
    """Build (if missing) and load the native library.  Raises
    :class:`NativeBuildError` when no working ``g++`` is available."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               text=True, timeout=120)
            except FileNotFoundError as exc:
                raise NativeBuildError(f"g++ not found: {exc}") from exc
            except subprocess.CalledProcessError as exc:
                raise NativeBuildError(
                    f"native build failed:\n{exc.stderr}") from exc
            os.replace(tmp, out)
        _lib = ctypes.CDLL(str(out))
        _declare(_lib)
        return _lib


def _declare(lib):
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.wd_cartpole_step.argtypes = [
        ctypes.c_int, f32p, i32p, i32p, f32p, i32p, ctypes.c_int,
    ]
    lib.wd_cartpole_step.restype = None
    lib.wd_pendulum_step.argtypes = [
        ctypes.c_int, f32p, f32p, i32p, f32p, i32p, ctypes.c_int, f32p,
    ]
    lib.wd_pendulum_step.restype = None
    lib.wd_mountain_car_step.argtypes = [
        ctypes.c_int, f32p, i32p, i32p, f32p, i32p, ctypes.c_int,
    ]
    lib.wd_mountain_car_step.restype = None
    lib.wd_continuous_mountain_car_step.argtypes = [
        ctypes.c_int, f32p, f32p, i32p, f32p, i32p, ctypes.c_int,
    ]
    lib.wd_continuous_mountain_car_step.restype = None
    lib.wd_acrobot_step.argtypes = [
        ctypes.c_int, f32p, i32p, i32p, f32p, i32p, ctypes.c_int, f32p,
    ]
    lib.wd_acrobot_step.restype = None
    lib.wd_tag_gridworld_step.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i32p, i32p, i32p,
        f32p, i32p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double,
    ]
    lib.wd_tag_gridworld_step.restype = None
    lib.wd_tag_gridworld_observe.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, i32p, i32p,
        ctypes.c_int, ctypes.c_int, f32p,
    ]
    lib.wd_tag_gridworld_observe.restype = None
    lib.wd_tag_continuous_step.argtypes = [
        ctypes.c_int, ctypes.c_int, f32p, f32p, f32p, f32p, f32p, i32p,
        i32p, i32p, f32p, i32p, f32p, f32p, i32p, f32p, f32p,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int,
    ]
    lib.wd_tag_continuous_step.restype = None
    lib.wd_tag_continuous_observe.argtypes = [
        ctypes.c_int, ctypes.c_int, f32p, f32p, f32p, f32p, f32p, i32p,
        i32p, i32p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, f32p,
    ]
    lib.wd_tag_continuous_observe.restype = None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class _AdapterBase:
    """Batched native stepper behind a uniform interface:

    * ``reset_all(envs)`` / ``reset_rows(idx, envs)`` — pull fresh state
      from the python env objects (their ``reset()`` RNG semantics apply),
    * ``step(actions) -> (obs, rewards, dones)`` — one native call over
      all replicas; ``timesteps`` is maintained internally,
    * ``snapshot()`` / ``restore(snap)`` — deep copies of the stacked
      arrays (for mid-training eval isolation).
    """

    def __init__(self, envs):
        self.lib = get_lib()
        self.n_envs = len(envs)
        self.env = envs[0]
        self.timesteps = np.zeros((self.n_envs,), np.int32)

    def snapshot(self):
        return {
            k: v.copy()
            for k, v in self.__dict__.items()
            if isinstance(v, np.ndarray)
        }

    def restore(self, snap):
        for k, v in snap.items():
            setattr(self, k, v.copy())


class _StateVecAdapter(_AdapterBase):
    """Shared machinery for the single-agent classic-control envs whose
    whole state is a flat float32 vector (``env.state``).  Subclasses set
    ``state_dim`` and implement ``_step_native``; ``observe`` defaults to
    the raw state (obs == state envs)."""

    state_dim: int
    action_dtype = np.int32

    def __init__(self, envs):
        super().__init__(envs)
        self.state = np.zeros((self.n_envs, self.state_dim), np.float32)
        # fixed seed + no pool -> reset() reseeds and redraws the SAME
        # state every episode (classic_control/base.py); cache it so the
        # frequent done-driven resets skip the python RandomState round-trip
        env = self.env
        self._fixed_reset = (
            env.reset_pool_size < 2 and env.seed is not None
        )
        # the envs as their last reset left them: a reset here would draw
        # a pool row more than the Python loop draws
        for e, env in enumerate(envs):
            self.state[e] = env.state

    def reset_all(self, envs):
        self.timesteps[:] = 0
        for e, env in enumerate(envs):
            env.reset()
            self.state[e] = env.state
        return self.observe()

    def reset_rows(self, idx, envs):
        if self._fixed_reset:
            self.state[idx] = self._fixed_state(envs[idx[0]])
            self.timesteps[idx] = 0
            return
        for e in idx:
            envs[e].reset()
            self.state[e] = envs[e].state
            self.timesteps[e] = 0

    def _fixed_state(self, env):
        if not hasattr(self, "_cached_reset_state"):
            env.reset()
            self._cached_reset_state = np.asarray(env.state, np.float32).copy()
        return self._cached_reset_state

    def observe(self):
        return self.state[:, None, :].copy()  # (E, 1, state_dim)

    def _actions_1d(self, actions):
        return np.ascontiguousarray(
            np.asarray(actions).reshape(self.n_envs, -1)[:, 0],
            self.action_dtype,
        )

    def step(self, actions):
        acts = self._actions_1d(actions)
        rewards = np.empty((self.n_envs,), np.float32)
        dones = np.empty((self.n_envs,), np.int32)
        obs = self._step_native(acts, rewards, dones)
        return obs, rewards[:, None], dones


class CartPoleAdapter(_StateVecAdapter):
    env_class_names = ("ClassicControlCartPoleEnv",)
    state_dim = 4

    def _step_native(self, acts, rewards, dones):
        self.lib.wd_cartpole_step(
            self.n_envs, _f32p(self.state), _i32p(acts),
            _i32p(self.timesteps), _f32p(rewards), _i32p(dones),
            int(self.env.episode_length),
        )
        return self.state[:, None, :].copy()


class PendulumAdapter(_StateVecAdapter):
    env_class_names = ("ClassicControlPendulumEnv",)
    state_dim = 2
    action_dtype = np.float32

    def observe(self):
        th, thdot = self.state[:, 0], self.state[:, 1]
        return np.stack(
            [np.cos(th), np.sin(th), thdot], axis=-1
        ).astype(np.float32)[:, None, :]

    def _step_native(self, acts, rewards, dones):
        obs = np.empty((self.n_envs, 3), np.float32)
        self.lib.wd_pendulum_step(
            self.n_envs, _f32p(self.state), _f32p(acts),
            _i32p(self.timesteps), _f32p(rewards), _i32p(dones),
            int(self.env.episode_length), _f32p(obs),
        )
        return obs[:, None, :]


class MountainCarAdapter(_StateVecAdapter):
    env_class_names = ("ClassicControlMountainCarEnv",)
    state_dim = 2

    def _step_native(self, acts, rewards, dones):
        self.lib.wd_mountain_car_step(
            self.n_envs, _f32p(self.state), _i32p(acts),
            _i32p(self.timesteps), _f32p(rewards), _i32p(dones),
            int(self.env.episode_length),
        )
        return self.state[:, None, :].copy()


class ContinuousMountainCarAdapter(_StateVecAdapter):
    env_class_names = ("ClassicControlContinuousMountainCarEnv",)
    state_dim = 2
    action_dtype = np.float32

    def _step_native(self, acts, rewards, dones):
        self.lib.wd_continuous_mountain_car_step(
            self.n_envs, _f32p(self.state), _f32p(acts),
            _i32p(self.timesteps), _f32p(rewards), _i32p(dones),
            int(self.env.episode_length),
        )
        return self.state[:, None, :].copy()


class AcrobotAdapter(_StateVecAdapter):
    env_class_names = ("ClassicControlAcrobotEnv",)
    state_dim = 4

    def observe(self):
        s = self.state
        return np.stack(
            [
                np.cos(s[:, 0]), np.sin(s[:, 0]),
                np.cos(s[:, 1]), np.sin(s[:, 1]),
                s[:, 2], s[:, 3],
            ],
            axis=-1,
        ).astype(np.float32)[:, None, :]

    def _step_native(self, acts, rewards, dones):
        obs = np.empty((self.n_envs, 6), np.float32)
        self.lib.wd_acrobot_step(
            self.n_envs, _f32p(self.state), _i32p(acts),
            _i32p(self.timesteps), _f32p(rewards), _i32p(dones),
            int(self.env.episode_length), _f32p(obs),
        )
        return obs[:, None, :]


class TagGridWorldAdapter(_AdapterBase):
    env_class_names = ("TagGridWorld",)

    def __init__(self, envs):
        super().__init__(envs)
        env = self.env
        self.n_agents = int(env.num_agents)
        self.loc_x = np.zeros((self.n_envs, self.n_agents), np.int32)
        self.loc_y = np.zeros((self.n_envs, self.n_agents), np.int32)
        self._obs_dim = (
            4 * self.n_agents + 1 if env.use_full_observation else 6
        )
        for e, env in enumerate(envs):  # as their last reset left them
            self.loc_x[e] = env.loc_x
            self.loc_y[e] = env.loc_y

    def reset_all(self, envs):
        self.timesteps[:] = 0
        for e, env in enumerate(envs):
            env.reset()
            self.loc_x[e] = env.loc_x
            self.loc_y[e] = env.loc_y
        return self.observe()

    def reset_rows(self, idx, envs):
        for e in idx:
            envs[e].reset()
            self.loc_x[e] = envs[e].loc_x
            self.loc_y[e] = envs[e].loc_y
            self.timesteps[e] = 0

    def observe(self):
        obs = np.empty(
            (self.n_envs, self.n_agents, self._obs_dim), np.float32
        )
        self.lib.wd_tag_gridworld_observe(
            self.n_envs, self.n_agents, int(self.env.grid_length),
            _i32p(self.loc_x), _i32p(self.loc_y), _i32p(self.timesteps),
            int(self.env.episode_length),
            1 if self.env.use_full_observation else 0, _f32p(obs),
        )
        return obs

    def step(self, actions):
        actions = np.ascontiguousarray(
            actions.reshape(self.n_envs, self.n_agents), np.int32
        )
        rewards = np.empty((self.n_envs, self.n_agents), np.float32)
        dones = np.empty((self.n_envs,), np.int32)
        env = self.env
        self.lib.wd_tag_gridworld_step(
            self.n_envs, self.n_agents, int(env.grid_length),
            _i32p(self.loc_x), _i32p(self.loc_y), _i32p(actions),
            _i32p(self.timesteps), _f32p(rewards), _i32p(dones),
            int(env.episode_length), float(env.wall_hit_penalty),
            float(env.tag_reward_for_tagger),
            float(env.tag_penalty_for_runner),
            float(env.step_cost_for_tagger),
        )
        return self.observe(), rewards, dones


class TagContinuousAdapter(_AdapterBase):
    env_class_names = ("TagContinuous",)

    def __init__(self, envs):
        super().__init__(envs)
        env = self.env
        self.n_agents = N = int(env.num_agents)
        E = self.n_envs
        self.loc_x = np.zeros((E, N), np.float32)
        self.loc_y = np.zeros((E, N), np.float32)
        self.speed = np.zeros((E, N), np.float32)
        self.direction = np.zeros((E, N), np.float32)
        self.acceleration = np.zeros((E, N), np.float32)
        self.still = np.ones((E, N), np.int32)
        # static config (shared across replicas; rounded exactly as the
        # numpy reference rounds them)
        from warpdrive_tpu_torch.envs.tag_continuous import _EPS

        self._is_tagger = np.ascontiguousarray(
            env.is_tagger.astype(np.int32)
        )
        self._skill = np.ascontiguousarray(env.skill_levels, np.float32)
        self._step_rewards = np.ascontiguousarray(
            env.step_rewards, np.float32
        )
        self._acc_table = np.ascontiguousarray(
            env.acceleration_actions, np.float32
        )
        self._turn_table = np.ascontiguousarray(env.turn_actions, np.float32)
        self._speed_denom = np.float32(env.max_speed + _EPS)
        self.reset_all(envs)

    def _reset_rows_(self, idx):
        # TagContinuous resets are deterministic: starting arrays are drawn
        # once at construction (tag_continuous.py:307-315) — no python
        # env.reset() round-trip (which would rebuild the O(N^2 k) obs)
        env = self.env
        self.loc_x[idx] = env.starting_location_x
        self.loc_y[idx] = env.starting_location_y
        self.speed[idx] = 0.0
        self.direction[idx] = env.starting_directions
        self.acceleration[idx] = 0.0
        self.still[idx] = 1
        self.timesteps[idx] = 0

    def reset_all(self, envs):
        self._reset_rows_(slice(None))
        return self.observe()

    def reset_rows(self, idx, envs):
        self._reset_rows_(idx)

    def observe(self):
        env = self.env
        D = int(env.obs_size)
        obs = np.empty((self.n_envs, self.n_agents, D), np.float32)
        self.lib.wd_tag_continuous_observe(
            self.n_envs, self.n_agents, _f32p(self.loc_x),
            _f32p(self.loc_y), _f32p(self.speed), _f32p(self.direction),
            _f32p(self.acceleration), _i32p(self.still),
            _i32p(self.timesteps), _i32p(self._is_tagger),
            int(env.episode_length), float(env.grid_diagonal),
            float(self._speed_denom),
            1 if env.use_full_observation else 0,
            int(env.num_other_agents_observed), _f32p(obs),
        )
        return obs

    def step(self, actions):
        env = self.env
        acts = np.ascontiguousarray(
            np.asarray(actions).reshape(self.n_envs, self.n_agents, 2),
            np.int32,
        )
        rewards = np.empty((self.n_envs, self.n_agents), np.float32)
        dones = np.empty((self.n_envs,), np.int32)
        self.lib.wd_tag_continuous_step(
            self.n_envs, self.n_agents, _f32p(self.loc_x),
            _f32p(self.loc_y), _f32p(self.speed), _f32p(self.direction),
            _f32p(self.acceleration), _i32p(self.still), _i32p(acts),
            _i32p(self.timesteps), _f32p(rewards), _i32p(dones),
            _f32p(self._acc_table), _f32p(self._turn_table),
            _i32p(self._is_tagger), _f32p(self._skill),
            _f32p(self._step_rewards), int(env.episode_length),
            float(env.max_speed), float(env.grid_length),
            float(env.edge_hit_penalty),
            float(env.distance_margin_for_reward),
            float(env.tag_reward_for_tagger),
            float(env.tag_penalty_for_runner),
            float(env.end_of_game_reward_for_runner),
            1 if env.runner_exits_game_after_tagged else 0,
        )
        return self.observe(), rewards, dones


_ADAPTERS = {}
for _cls in (
    CartPoleAdapter,
    PendulumAdapter,
    MountainCarAdapter,
    ContinuousMountainCarAdapter,
    AcrobotAdapter,
    TagGridWorldAdapter,
    TagContinuousAdapter,
):
    for _name in _cls.env_class_names:
        _ADAPTERS[_name] = _cls


def adapter_for(env) -> type | None:
    """The adapter class for a python env object, or None. Matches on the
    MRO, so the torch subclasses (TorchClassicControlCartPoleEnv, ...) hit
    their numpy base's adapter."""
    for klass in type(env).__mro__:
        if klass.__name__ in _ADAPTERS:
            return _ADAPTERS[klass.__name__]
    return None
