"""
DataFeed: a declarative builder for named state arrays.

The port's copy of ``warpdrive_tpu/utils/data_feed.py``: envs declare their
per-env state arrays, which of them must be restored on done-driven resets,
which are logged densely across an episode, and optional reset pools.  The
port's ``StateStore`` consumes this to build its dict of batched tensors.
"""

from __future__ import annotations

import numpy as np


class DataFeed(dict):
    """Dict builder mapping array name -> feed entry."""

    def add_data(
        self,
        name: str,
        data,
        save_copy_and_apply_at_reset: bool = False,
        log_data_across_episode: bool = False,
        **kwargs,
    ):
        """
        Register one named array (or scalar) of per-env state.

        :param name: unique array name.
        :param data: numpy array / list / scalar.  Arrays are the state of a
            SINGLE environment; the engine replicates across replicas.
        :param save_copy_and_apply_at_reset: snapshot the value at push time
            and restore it whenever the env's done flag is set
            (cf. reference ``data_manager.py:282-305`` + ``reset.cu:9-63``).
        :param log_data_across_episode: allocate a dense per-timestep episode
            log buffer for this array (cf. reference
            ``data_manager.py:307-339`` + ``log.cu:31-62``).
        """
        assert isinstance(name, str) and name not in self, f"duplicate name {name!r}"
        self[name] = {
            "data": data,
            "save_copy_and_apply_at_reset": bool(save_copy_and_apply_at_reset),
            "log_data_across_episode": bool(log_data_across_episode),
            "is_reset_pool": False,
            "reset_target": None,
        }
        self[name].update(kwargs)

    def add_data_list(self, data_list):
        """
        Register many entries at once; items may be ``(name, data)`` tuples,
        ``(name, data, save_copy...)`` tuples or DataFeed dicts
        (cf. reference ``data_feed.py:46-87``).
        """
        assert isinstance(data_list, (list, tuple))
        for item in data_list:
            if isinstance(item, dict):  # nested DataFeed
                for name, entry in item.items():
                    assert name not in self
                    self[name] = entry
            elif isinstance(item, (list, tuple)):
                self.add_data(*item)
            else:
                raise ValueError(f"Cannot add {item!r} to a DataFeed")

    def add_pool_for_reset(self, name: str, data, reset_target: str):
        """
        Register a pool of candidate reset values for ``reset_target``.

        On every done-driven reset, a pool row is sampled uniformly per env
        and written into the target array (cf. reference
        ``data_manager.py:231-241`` + ``numba_function_manager.py:430-476``).
        The pool's leading axis indexes candidates; trailing shape must match
        the target's single-env shape.
        """
        arr = np.asarray(data)
        assert arr.ndim >= 2, "a reset pool needs a leading candidate axis"
        assert isinstance(name, str) and name not in self
        self[name] = {
            "data": arr,
            "save_copy_and_apply_at_reset": False,
            "log_data_across_episode": False,
            "is_reset_pool": True,
            "reset_target": reset_target,
        }
