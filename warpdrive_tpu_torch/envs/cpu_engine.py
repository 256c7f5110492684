"""
The eager host-env backend: the port's counterpart of
``warpdrive_tpu/envs/cpu_engine.py``.

:class:`CpuEnvEngine` runs N of the NUMPY REFERENCE envs on the host behind
the engine facade the trainers read -- ``is_eager``, the spaces, the
placeholder-group metadata, ``reset_all_envs``, ``step_all_envs`` and the
soft reset ``reset_only_done_envs`` -- as the reference trains with
``env_backend='cpu'``.  The envs are stateful Python objects, so there is
no pure step to compose: a trainer sees ``is_eager`` and steps the engine
once a rollout step, while the model forward, sampling and the update stay
on the trainer's device.

Per step the policy's actions come to the host (a device-to-host copy,
which waits for the device) and the observations, rewards and done flags
go to ``device``; ``state`` holds them there as tensors.  That round trip
is this backend's nature, not an accident of the port: the device path is
:class:`~warpdrive_tpu_torch.envs.engine.EnvEngine`.

Env families with a C++ batched stepper (:mod:`warpdrive_tpu_torch.native`)
step the whole fleet in one C call instead of the per-env Python loop:
``native="auto"`` (the default) uses it where one exists and falls back to
the loop when ``g++`` cannot build it, ``True`` requires it, ``False``
forces the loop (``tests/test_torch_native_backend.py`` holds the two
alike).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.device import resolve_device
from warpdrive_tpu_torch.utils.env_registrar import (
    env_registrar as default_registrar,
)
from warpdrive_tpu_torch.utils.spaces import (
    Box,
    Discrete,
    MultiDiscrete,
    normalize_space_map,
)

_OBS = Constants.OBSERVATIONS
_REWARDS = Constants.REWARDS
_DONE = Constants.DONE
_TIMESTEP = Constants.TIMESTEP


class CpuEnvEngine:
    """N numpy reference envs on the host behind the (eager) engine
    facade, their outputs on ``device`` (``"cuda"`` unless the caller asks
    for ``"cpu"``)."""

    is_eager = True
    env_backend = "cpu"
    has_split_step = False
    separate_placeholders = False
    obs_dim_corresponding_to_num_agents = "first"

    def __init__(
        self,
        env_obj=None,
        env_name: str = None,
        env_config: dict = None,
        num_envs: int = 2,
        env_registrar=None,
        native: bool | str = "auto",
        device="cuda",
    ):
        """``env_obj`` is replicated (rebuilt from ``env_config`` when
        given, else deep-copied), or ``env_name`` built from the registry's
        ``"cpu"`` backend with ``env_config``; the numpy envs draw from
        their own seeds."""
        self.device = resolve_device(device)
        registrar = env_registrar or default_registrar
        if env_obj is None:
            assert env_name is not None, "pass env_obj or env_name"
            env_cls = registrar.get(env_name, backend="cpu")
            self._make_env = lambda: env_cls(**(env_config or {}))
        elif env_config is not None:
            env_cls = type(env_obj)
            self._make_env = lambda: env_cls(**env_config)
        else:
            # replicate the constructed object: a fresh type(env_obj)()
            # would drop its constructor's arguments
            self._make_env = lambda: copy.deepcopy(env_obj)
        self.envs = [self._make_env() for _ in range(num_envs)]
        self.env = self.envs[0]
        self.n_envs = int(num_envs)
        # the eager backend does not shard: no mesh, every env row here
        self.mesh = None
        self.env_rows = slice(0, self.n_envs)
        self.n_agents = int(self.env.num_agents)
        self.episode_length = int(self.env.episode_length)
        self._done = np.zeros((num_envs,), np.int32)
        self._timestep = np.zeros((num_envs,), np.int32)

        # spaces and the placeholder group (Box observations only)
        obs0 = [env.reset() for env in self.envs]
        self._agent_ids = sorted(obs0[0].keys())
        first = obs0[0][self._agent_ids[0]]
        assert not isinstance(first, dict), (
            "the eager backend takes Box observations; EnvEngine runs Dict "
            "observations on the device"
        )
        if not isinstance(getattr(self.env, "observation_space", None),
                          dict):
            self.env.observation_space = {
                aid: Box(-np.inf, np.inf, shape=np.asarray(obs0[0][aid]).shape)
                for aid in self._agent_ids
            }
        self.observation_space = normalize_space_map(
            self.env.observation_space)
        self.action_space = normalize_space_map(self.env.action_space)
        a_space = self.action_space[self._agent_ids[0]]
        if isinstance(a_space, Discrete):
            spec = (1, np.int32)
        elif isinstance(a_space, MultiDiscrete):
            spec = (len(a_space.nvec), np.int32)
        elif isinstance(a_space, Box):
            spec = (int(a_space.shape[0]), np.float32)
        else:
            raise NotImplementedError(repr(a_space))
        self.num_action_types = spec[0]
        self._group = {"mode": "box", "keys": [], "action": spec}

        # the C++ batched stepper: the adapter owns the stacked state, the
        # Python envs stay the source of reset() semantics
        self._native = None
        if native:
            from warpdrive_tpu_torch import native as native_mod

            adapter_cls = native_mod.adapter_for(self.env)
            if adapter_cls is not None:
                try:
                    self._native = adapter_cls(self.envs)
                except native_mod.NativeBuildError:
                    if native is True:
                        raise
            elif native is True:
                raise ValueError(
                    f"no native stepper for {type(self.env).__name__}")

        self._set_state(self._stack(obs0), None)

    # ------------------------------------------------------------- metadata
    def group_info(self, tag=None) -> dict:
        return self._group

    def obs_entry_names(self, tag=None) -> list:
        return [_OBS]

    def rewards_of(self, state: dict) -> torch.Tensor:
        return state[_REWARDS]

    # -------------------------------------------------------------- helpers
    def _stack(self, dicts) -> np.ndarray:
        return np.stack([
            np.stack([np.asarray(d[a]) for a in self._agent_ids])
            for d in dicts
        ]).astype(np.float32)

    def _set_state(self, obs: np.ndarray, rewards):
        """``state``: the host arrays on the device."""
        if rewards is None:
            rewards = np.zeros((self.n_envs, self.n_agents), np.float32)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.state = {
            _OBS: dev(np.asarray(obs, np.float32)),
            _REWARDS: dev(np.asarray(rewards, np.float32)),
            _DONE: dev(self._done.copy()),
            _TIMESTEP: dev(self._timestep.copy()),
        }

    def _outputs(self) -> dict:
        return {k: self.state[k] for k in (_OBS, _REWARDS, _DONE)}

    # --------------------------------------------------------------- facade
    def reset_all_envs(self) -> torch.Tensor:
        """Reset every replica; returns the observations on the device."""
        self._done[:] = 0
        self._timestep[:] = 0
        if self._native is not None:
            obs = self._native.reset_all(self.envs)
        else:
            obs = self._stack([env.reset() for env in self.envs])
        self._set_state(obs, None)
        return self.state[_OBS]

    reset = reset_all_envs

    def _host_actions(self, actions) -> np.ndarray:
        if isinstance(actions, torch.Tensor):
            actions = actions.cpu().numpy()  # waits for the device
        actions = np.asarray(actions)
        return actions[..., None] if actions.ndim == 2 else actions

    def step_all_envs(self, actions) -> dict:
        """Step every replica with ``actions`` ``(envs, agents[,
        components])`` (a tensor anywhere, or an array); returns the
        observations, rewards and done flags on the device."""
        actions = self._host_actions(actions)
        if self._native is not None:
            obs, rew, dones = self._native.step(actions)
            self._done[:] = dones
            self._timestep += 1
            self._set_state(obs, rew)
            return self._outputs()
        obs_l, rew_l = [], []
        for e, env in enumerate(self.envs):
            act_dict = {}
            for i, a in enumerate(self._agent_ids):
                space = self.action_space[a]
                act_dict[a] = (actions[e, i, 0] if isinstance(space, Discrete)
                               else actions[e, i])
            obs, rew, done, _ = env.step(act_dict)
            obs_l.append(obs)
            rew_l.append({a: np.float32(rew[a]) for a in self._agent_ids})
            self._done[e] = (int(done["__all__"]) if isinstance(done, dict)
                             else int(done))
        self._timestep += 1
        self._set_state(self._stack(obs_l), self._stack(rew_l))
        return self._outputs()

    def reset_only_done_envs(self):
        """Reset the replicas whose done flag is set (read on the host)."""
        idx = np.nonzero(self._done)[0]
        if not len(idx):
            return
        if self._native is not None:
            self._native.reset_rows(idx, self.envs)
            obs = self._native.observe()
        else:
            obs = self.state[_OBS].cpu().numpy().copy()  # not a view
            for e in idx:
                reset = self.envs[e].reset()
                obs[e] = np.stack([np.asarray(reset[a])
                                   for a in self._agent_ids])
        self._done[idx] = 0
        self._timestep[idx] = 0
        rewards = self.state[_REWARDS]
        self._set_state(obs, None)
        self.state[_REWARDS] = rewards

    def snapshot_runtime_state(self) -> dict:
        """A deep copy of the envs and the facade's state, so an episode of
        evaluation or fetching can run on the live engine and leave it as
        it found it (``restore_runtime_state``)."""
        return {
            "envs": copy.deepcopy(self.envs),
            "done": self._done.copy(),
            "timestep": self._timestep.copy(),
            "state": {k: v.clone() for k, v in self.state.items()},
            "native": (self._native.snapshot() if self._native is not None
                       else None),
        }

    def restore_runtime_state(self, snap: dict):
        self.envs = snap["envs"]
        self.env = self.envs[0]
        self._done = snap["done"].copy()
        self._timestep = snap["timestep"].copy()
        self.state = {k: v.clone() for k, v in snap["state"].items()}
        if self._native is not None and snap.get("native") is not None:
            self._native.restore(snap["native"])
            self._native.env = self.env
