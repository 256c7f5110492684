"""
Done-driven auto-reset combinator.

The port's counterpart of ``warpdrive_tpu/core/reset.py``: one function over
the state dict that

* restores every snapshot-flagged tensor to its at-reset value for envs
  whose done flag is set (``torch.where``),
* gives every pool-backed target a pool row drawn uniformly per env instead,
* zeroes the done flags and timesteps of those envs.

``force`` resets every env regardless of done flags.  The function returns a
new dict and leaves its input untouched, as the JAX version does; given a
destination ``out`` (the static state a captured step carries), it writes
the new state into ``out``'s tensors instead and returns them.  On a card
every reset is one launch of the reset kernel (``ops/reset.py``), into
``out`` or, without one, into fresh tensors for the entries it writes; on
the CPU it is the plain ``where`` chain (:func:`reset_plain`), written back
into ``out`` by ``core/program.py:assign_state`` where given.  Both draw
the pool rows alike, so they leave the generator alike.
"""

from __future__ import annotations

import torch

from warpdrive_tpu_torch.core.program import assign_state
from warpdrive_tpu_torch.ops import reset as reset_kernel
from warpdrive_tpu_torch.utils.constants import Constants


def _bcast(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a per-env boolean mask to broadcast against an (env, ...) tensor."""
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def reset_plain(state: dict, snapshot: dict, pools: dict, rows: dict,
                force: bool = False) -> dict:
    """The reset op by op, on any device: ``state`` with every snapshot
    name's rows and every pool target's (``pool[rows[target]]``) taken where
    an env is done (or ``force``), and those envs' timestep and done flag
    zeroed; a new dict, ``state``'s other entries as they are.  The reset
    kernel equals it bit for bit.

    :param rows: pool target -> ``(envs,)`` integer pool rows.
    """
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
        new_state[target] = torch.where(
            _bcast(done, cur.ndim), pool[rows[target]], cur
        )
    new_state[Constants.TIMESTEP] = torch.where(
        done, 0, state[Constants.TIMESTEP]
    ).to(torch.int32)
    new_state[Constants.DONE] = torch.where(
        done, 0, state[Constants.DONE]
    ).to(torch.int32)
    return new_state


def make_auto_reset_fn(snapshot: dict, pools: dict):
    """
    Build the auto-reset function for a given snapshot/pool registry.

    :param snapshot: name -> single-env at-reset tensor (restored on done).
    :param pools: target name -> (pool_size, *single_env_shape) candidate bank.
    :returns: ``auto_reset(state, generator=None, force=False, pool_idx=None,
        out=None) -> state``.  ``pool_idx`` maps a pool target to an
        ``(envs,)`` integer tensor of pool rows that replaces the draw, so a
        test can feed this side and the JAX side the same rows.  ``out``,
        the static state with ``state``'s entries, takes the new state
        in place; what is returned is then ``out``'s own tensors.
    """
    snapshot = dict(snapshot)
    pools = dict(pools)

    def auto_reset(state: dict, generator: torch.Generator = None,
                   force: bool = False, pool_idx: dict = None,
                   out: dict = None) -> dict:
        envs = state[Constants.DONE].shape[0]

        def rows_of(target):
            pool = pools[target]
            if pool_idx is not None and target in pool_idx:
                return pool_idx[target].to(device=pool.device,
                                           dtype=torch.long)
            return torch.randint(0, pool.shape[0], (envs,),
                                 generator=generator, device=pool.device)

        rows = {target: rows_of(target) for target in sorted(pools)}
        if not state[Constants.DONE].is_cuda:
            new_state = reset_plain(state, snapshot, pools, rows, force)
            if out is None:
                return new_state
            assign_state(out, new_state)
            return dict(out)
        if out is None:
            # fresh tensors for the entries the reset writes, the others
            # as they are (the kernel leaves those alone)
            written = {Constants.TIMESTEP, Constants.DONE, *snapshot, *pools}
            out = {name: torch.empty_like(
                       value, memory_format=torch.contiguous_format)
                   if name in written else value
                   for name, value in state.items()}
        reset_kernel.reset_into(out, state, snapshot, pools, rows,
                                force=force)
        return dict(out)

    return auto_reset
