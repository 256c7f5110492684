"""
The StateStore: a named registry of batched environment-state tensors.

The port's counterpart of ``warpdrive_tpu/core/state.py``.  The environment
state is a ``dict[str, torch.Tensor]`` whose every tensor lies on the store's
device and carries the env-replica axis first.  Pushing data:

* casts to 32-bit types (``cast_to_32bit``): float64/float16 -> float32,
  int64 -> int32, bool -> int32;
* replicates single-env arrays across the replica axis;
* snapshots arrays flagged ``save_copy_and_apply_at_reset`` so done-driven
  resets can restore them;
* keeps scalars host-side as python numbers (``meta``);
* registers reset pools mapping a target array to a bank of candidate reset
  values.

Queries, as the JAX store answers them: ``is_on_device``, ``get_shape``,
``get_dtype`` (a ``torch.dtype``), ``reset_pool``, ``pull`` (a numpy copy)
and ``names``.

Built-in entries: ``_done_`` (int32 per env, 0 = running, 1 = terminated,
2 = terminated-with-success) and ``_timestep_`` (int32 per env).

Randomness: the JAX store keeps a per-env PRNG key array ``_rng_`` in the
state.  Here the store instead owns ONE ``torch.Generator`` on its device,
seeded from ``seed`` (``store.generator``); every draw the engine makes
(reset-pool rows, random actions) takes it explicitly.  The two frameworks
give different numbers from the same seed, so parity tests inject the draws.
"""

from __future__ import annotations

import numpy as np
import torch

from warpdrive_tpu_torch.utils.constants import Constants
from warpdrive_tpu_torch.utils.data_feed import DataFeed


def cast_to_32bit(arr: np.ndarray) -> np.ndarray:
    """64-bit -> 32-bit, bool -> int32."""
    arr = np.asarray(arr)
    if arr.dtype in (np.float64, np.float16):
        return arr.astype(np.float32)
    if arr.dtype == np.int64:
        return arr.astype(np.int32)
    if arr.dtype == np.bool_:
        return arr.astype(np.int32)
    return arr


class StateStore:
    """
    Owns the batched env-state tensors, their at-reset snapshots, reset
    pools, meta scalars and the store's random generator.
    """

    def __init__(
        self,
        num_envs: int,
        num_agents: int,
        episode_length: int,
        device: torch.device,
        seed: int = 0,
    ):
        assert num_envs > 0 and num_agents > 0 and episode_length > 0
        self.num_envs = int(num_envs)
        self.num_agents = int(num_agents)
        self.episode_length = int(episode_length)
        self.device = torch.device(device)

        # meta scalars available to step functions as python constants
        self.meta = {
            "n_envs": self.num_envs,
            "n_agents": self.num_agents,
            "episode_length": self.episode_length,
            "seed": int(seed),
        }

        # name -> batched tensor (leading axis = env replica)
        self.state: dict = {}
        # name -> SINGLE-env snapshot tensor restored on done
        self.snapshot: dict = {}
        # target name -> pool tensor (pool_size, *single_env_shape)
        self.pools: dict = {}
        # names with dense per-timestep episode logging
        self.log_names: list = []
        # name -> dtype/shape bookkeeping (single-env shape)
        self._specs: dict = {}

        self.state[Constants.DONE] = torch.zeros(
            (self.num_envs,), dtype=torch.int32, device=self.device
        )
        self.state[Constants.TIMESTEP] = torch.zeros(
            (self.num_envs,), dtype=torch.int32, device=self.device
        )
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    # ------------------------------------------------------------------ push
    def push(self, data_feed: DataFeed):
        """Push a DataFeed of single-env arrays into the store, replicated
        across replicas."""
        for name, entry in data_feed.items():
            data = entry["data"]
            if entry.get("is_reset_pool"):
                self._add_reset_pool(name, entry)
                continue
            if np.isscalar(data) or (
                isinstance(data, np.ndarray) and data.ndim == 0
            ):
                value = np.asarray(data)
                if value.dtype == np.float64:
                    value = value.astype(np.float32)
                self.meta[name] = value.item()
                continue

            # row-major, whatever the layout handed in: the reset kernel
            # (ops/reset.py) reads a snapshot row as contiguous bytes
            arr = np.ascontiguousarray(cast_to_32bit(np.asarray(data)))
            single = torch.as_tensor(arr, device=self.device).clone()
            assert name not in self.state, f"array {name!r} already on store"
            self.state[name] = single.unsqueeze(0).repeat(
                (self.num_envs,) + (1,) * arr.ndim
            )
            self._specs[name] = {"shape": arr.shape, "dtype": str(arr.dtype)}

            if entry.get("save_copy_and_apply_at_reset"):
                self.snapshot[name] = single
            if entry.get("log_data_across_episode"):
                self.log_names.append(name)

    def _add_reset_pool(self, name: str, entry: dict):
        target = entry["reset_target"]
        pool = np.ascontiguousarray(cast_to_32bit(np.asarray(entry["data"])))
        assert target is not None
        if target in self._specs:
            spec = self._specs[target]
            assert tuple(pool.shape[1:]) == tuple(spec["shape"]), (
                f"reset pool {name!r}: trailing shape {pool.shape[1:]} does not "
                f"match target {target!r} shape {spec['shape']}"
            )
            assert str(pool.dtype) == spec["dtype"], (
                f"reset pool {name!r}: dtype {pool.dtype} != target "
                f"{spec['dtype']}"
            )
        assert target not in self.pools, f"target {target!r} already has a pool"
        self.pools[target] = torch.as_tensor(pool, device=self.device).clone()

    # ----------------------------------------------------------------- query
    def is_on_device(self, name: str) -> bool:
        """Whether ``name`` is a batched state tensor (not a meta scalar or
        a pool)."""
        return name in self.state

    def get_shape(self, name: str) -> tuple:
        """The batched shape of ``name``, the env replica axis first."""
        return tuple(self.state[name].shape)

    def get_dtype(self, name: str) -> torch.dtype:
        return self.state[name].dtype

    def reset_pool(self, target: str) -> torch.Tensor:
        """The bank of reset values of ``target``, ``(pool_size,
        *single_env_shape)``."""
        return self.pools[target]

    def pull(self, name: str) -> np.ndarray:
        """A host copy of one state tensor (the reference data manager's
        ``pull_data_from_device``)."""
        return self.state[name].detach().cpu().numpy().copy()

    def names(self) -> list:
        return list(self.state.keys())
