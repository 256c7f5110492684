"""
The operations of one DDPG training iteration, from the model's shapes:
2 per multiply-add of every dense layer a row goes through
(``measure.mlp_forward_flops``), on the rows each part of the iteration
runs, and no work counted twice.  Plain Python over numbers, so the CPU
tests hold it to a hand count.

* the rollout: the actor forward on each of the ``T`` steps' rows;
* the targets: the target actor on the window's ``W`` rows, the target
  critic on its last ``W - 1``;
* the critic's loss: the critic forward on the ``W`` rows, its weight
  gradients and its input gradients but the first layer's (the
  observations and actions need none);
* the actor's loss: the actor forward and the critic forward on the ``W``
  rows, the critic's input gradients through every layer (back to the
  action), the actor's weight gradients and its input gradients but the
  first layer's; the critic's weight gradients are not taken.

A row is one agent of one env: ``rows`` is envs x agents.  The optimizers'
and the Polyak updates' elementwise work is left out.
"""

from __future__ import annotations

from portbench.measure import mlp_forward_flops


def iteration_ops(obs: int, actor_dims, critic_dims, actions: int, T: int,
                  W: int, rows: int) -> int:
    """Operations of one iteration whose window is full."""
    actor = mlp_forward_flops(obs, actor_dims, actions)
    critic = mlp_forward_flops(obs + actions, critic_dims, 1)
    actor_first = 2 * int(obs) * int(actor_dims[0])
    critic_first = 2 * (int(obs) + int(actions)) * int(critic_dims[0])
    rollout = T * actor
    targets = W * actor + (W - 1) * critic
    critic_loss = W * (critic + critic + (critic - critic_first))
    actor_loss = W * (actor + critic + critic + actor
                      + (actor - actor_first))
    return rows * (rollout + targets + critic_loss + actor_loss)
