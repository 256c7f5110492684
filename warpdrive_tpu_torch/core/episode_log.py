"""
Dense per-timestep episode logger.

The port's counterpart of ``warpdrive_tpu/core/episode_log.py``: for one
env replica, record the state of every array the env flagged
``log_data_across_episode`` at every timestep of an episode into
time-major ``(episode_length + 1, *single_env_shape)`` buffers on the
device, with a mask of the steps written.  ``log_step`` returns new
buffers and leaves its input as it was, as the JAX version does;
``reset_buffers`` and ``log_step_into`` write static buffers in place, at
a device step counter and env index, as a captured logging step needs.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = "_log_mask_"


class EpisodeLogger:
    """Episode logger over a :class:`StateStore`'s ``log_names``."""

    def __init__(self, store):
        self.episode_length = store.episode_length
        self.log_names = list(store.log_names)

    def init_buffers(self, state: dict, env_id: int = 0) -> dict:
        """Allocate the buffers and record the values at timestep 0."""
        buffers = {}
        for name in self.log_names:
            single = state[name][env_id]
            buf = torch.zeros((self.episode_length + 1,) + tuple(single.shape),
                              dtype=single.dtype, device=single.device)
            buf[0] = single
            buffers[name] = buf
        mask = torch.zeros((self.episode_length + 1,), dtype=torch.int32,
                           device=next(iter(state.values())).device)
        mask[0] = 1
        buffers[_MASK] = mask
        return buffers

    def log_step(self, buffers: dict, state: dict, t: int,
                 env_id: int = 0) -> dict:
        """Record env ``env_id``'s state at timestep ``t``.  Whether the
        steps before were logged is a property of the mask, which
        :meth:`verify_mask` checks."""
        new_buffers = {}
        for name in self.log_names:
            buf = buffers[name].clone()
            buf[t] = state[name][env_id]
            new_buffers[name] = buf
        mask = buffers[_MASK].clone()
        mask[t] = 1
        new_buffers[_MASK] = mask
        return new_buffers

    def reset_buffers(self, buffers: dict, state: dict, env_id: int = 0):
        """:meth:`init_buffers` into the static ``buffers``, in place."""
        for name in self.log_names:
            buffers[name].zero_()
            buffers[name][0] = state[name][env_id]
        buffers[_MASK].zero_()
        buffers[_MASK][0] = 1

    def log_step_into(self, buffers: dict, state: dict, t: torch.Tensor,
                      env: torch.Tensor, frozen: torch.Tensor = None):
        """Record env row ``env``'s state at timestep ``t`` (both ``(1,)``
        long device tensors) into ``buffers``, in place; where ``frozen``
        (a ``(1,)`` bool device tensor) is set, row ``t`` keeps what it
        holds."""
        for name in self.log_names + [_MASK]:
            buf = buffers[name]
            new = (state[name].index_select(0, env) if name != _MASK
                   else torch.ones((1,), dtype=buf.dtype, device=buf.device))
            if frozen is not None:
                keep = frozen.reshape((1,) * buf.ndim)
                new = torch.where(keep, buf.index_select(0, t), new)
            buf.index_copy_(0, t, new)

    @staticmethod
    def verify_mask(buffers: dict, last_step: int) -> bool:
        """Steps ``0..last_step`` were all logged, and none after."""
        mask = buffers[_MASK].cpu().numpy()
        return bool(mask[: last_step + 1].all()) and not bool(
            mask[last_step + 1:].any()
        )

    def fetch(self, buffers: dict, last_step: int) -> dict:
        """Logged trajectories ``0..last_step`` as numpy arrays."""
        assert self.verify_mask(buffers, last_step), \
            "log mask is not contiguous"
        return {
            name: np.asarray(buffers[name][: last_step + 1].cpu().numpy())
            for name in self.log_names
        }
