"""
The environment-side contract for device-resident environments.

The port's counterpart of ``warpdrive_tpu/envs/base.py``.  An environment
class subclasses BOTH its numpy reference implementation (gym-style
``reset()/step(actions_dict)``) AND this context, which declares the
device-side state and the batched step functions.

Unlike the JAX package, whose step functions act on ONE replica and are
``vmap``-ed by the engine, every function here acts on the whole batch: each
state tensor carries the env-replica axis first, written out.
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

    Split-step contract (the only step path of this slice):

    * ``physics_fn(state, actions) -> state`` -- dynamics, rewards and the
      done/timestep update for ALL replicas, with ``actions`` an
      ``(envs, agents, components)`` integer tensor, WITHOUT writing
      ``observations``;
    * ``observe_fn(state) -> obs`` -- the pure observation of the current
      batched state, ``(envs, agents, obs_dim)``.

    ``has_split_step`` tells the engine the split path exists.
    """

    def get_data_dictionary(self) -> DataFeed:
        return DataFeed()

    def get_tensor_dictionary(self) -> DataFeed:
        return DataFeed()

    def get_reset_pool_dictionary(self) -> DataFeed:
        return DataFeed()

    @property
    def has_split_step(self) -> bool:
        return hasattr(self, "physics_fn") and hasattr(self, "observe_fn")
