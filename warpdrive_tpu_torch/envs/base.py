"""
The environment-side contract for device-resident environments.

The port's counterpart of ``warpdrive_tpu/envs/base.py``.  An environment
class subclasses BOTH its numpy reference implementation (gym-style
``reset()/step(actions_dict)``) AND this context, which declares the
device-side state and the batched step functions.

Unlike the JAX package, whose step functions act on ONE replica and are
``vmap``-ed by the engine, every function here acts on the whole batch: each
state tensor carries the env-replica axis first, written out.  The JAX
package's two batched forms of the full step, ``step_fn`` vmapped per
replica and the lane-packed ``step_batch_fn``, agree bit for bit; both are
this one batched ``step_fn``.
"""

from __future__ import annotations

from warpdrive_tpu_torch.utils.data_feed import DataFeed


class TorchEnvironmentContext:
    """
    Mixin declaring the device-side state and step functions of an env.

    * :meth:`get_data_dictionary` -- single-env state arrays (+ scalars) to
      place on the device; called after the host-side ``reset()``.
    * :meth:`get_tensor_dictionary` -- extra placeholders (rarely needed).
    * :meth:`get_reset_pool_dictionary` -- banks of candidate reset values.

    An env gives one of two step contracts.

    Full step:

    * ``step_fn(state) -> state`` -- the step of ALL replicas: it reads the
      ``sampled_actions`` placeholder ``(envs, agents, components)`` and
      writes the env's state, ``observations``, ``rewards``, ``_done_`` (0
      running, 1 terminated, 2 terminated with success) and ``_timestep_``;
    * ``observe_fn(state) -> obs`` -- the observations ``(envs, agents,
      obs_dim)`` of a batched state; the engine refreshes the observations
      of the replicas a reset pool has just reset with it.

    Split step (TagContinuous):

    * ``physics_fn(state, actions) -> state`` -- dynamics, rewards and the
      done/timestep update for ALL replicas, with ``actions`` an
      ``(envs, agents, components)`` tensor, WITHOUT writing
      ``observations``;
    * ``observe_fn(state) -> obs`` -- the pure observation of the current
      batched state, ``(envs, agents, obs_dim)``.

    ``has_split_step`` tells the engine and the trainer which path the env
    takes.
    """

    def get_data_dictionary(self) -> DataFeed:
        return DataFeed()

    def get_tensor_dictionary(self) -> DataFeed:
        return DataFeed()

    def get_reset_pool_dictionary(self) -> DataFeed:
        return DataFeed()

    def step_fn(self, state: dict) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def has_split_step(self) -> bool:
        return hasattr(self, "physics_fn") and hasattr(self, "observe_fn")
