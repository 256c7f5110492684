"""
Done-driven auto-reset combinator.

The port's counterpart of ``warpdrive_tpu/core/reset.py``: one function over
the state dict that

* restores every snapshot-flagged tensor to its at-reset value for envs
  whose done flag is set (``torch.where``),
* gives every pool-backed target a pool row drawn uniformly per env instead,
* zeroes the done flags and timesteps of those envs.

``force`` resets every env regardless of done flags.  The function returns a
new dict and leaves its input untouched, as the JAX version does.
"""

from __future__ import annotations

import torch

from warpdrive_tpu_torch.utils.constants import Constants


def _bcast(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a per-env boolean mask to broadcast against an (env, ...) tensor."""
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def make_auto_reset_fn(snapshot: dict, pools: dict):
    """
    Build the auto-reset function for a given snapshot/pool registry.

    :param snapshot: name -> single-env at-reset tensor (restored on done).
    :param pools: target name -> (pool_size, *single_env_shape) candidate bank.
    :returns: ``auto_reset(state, generator=None, force=False, pool_idx=None)
        -> state``.  ``pool_idx`` maps a pool target to an ``(envs,)``
        integer tensor of pool rows that replaces the draw, so a test can
        feed this side and the JAX side the same rows.
    """
    snapshot = dict(snapshot)
    pools = dict(pools)

    def auto_reset(state: dict, generator: torch.Generator = None,
                   force: bool = False, pool_idx: dict = None) -> dict:
        done = state[Constants.DONE] > 0
        if force:
            done = torch.ones_like(done)
        new_state = dict(state)
        for name, snap in snapshot.items():
            if name not in state:
                # split-step path: derived arrays (e.g. observations) are
                # not carried through the rollout and need no restore
                continue
            cur = state[name]
            new_state[name] = torch.where(_bcast(done, cur.ndim), snap[None], cur)
        for target, pool in sorted(pools.items()):
            cur = state[target]
            if pool_idx is not None and target in pool_idx:
                idx = pool_idx[target].to(device=pool.device, dtype=torch.long)
            else:
                idx = torch.randint(
                    0, pool.shape[0], (done.shape[0],),
                    generator=generator, device=pool.device,
                )
            new_state[target] = torch.where(
                _bcast(done, cur.ndim), pool[idx], cur
            )
        new_state[Constants.TIMESTEP] = torch.where(
            done, 0, state[Constants.TIMESTEP]
        ).to(torch.int32)
        new_state[Constants.DONE] = torch.where(
            done, 0, state[Constants.DONE]
        ).to(torch.int32)
        return new_state

    return auto_reset
