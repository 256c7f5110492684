"""``mfu.ddpg``: the whole iteration's share of the card's peak for the
configuration's matmul precision (float32 outside the tensor cores, 67
TFLOP/s, at the card's full 700 W: PERF.md gives the power limit beside
every reading).

Operations an iteration, from the model's shapes (``ddpg_ops.
iteration_ops``): the actor forward on the rollout's T x E rows, the
target actor on the window's W x E rows and the target critic on (W - 1)
x E, the critic's forward and backward (weight gradients, input gradients
but the first layer's) on W x E, and the actor's loss: the actor and the
critic forward on W x E, the critic's input gradients back to the action,
the actor's weight and input gradients but the first layer's.  At the
single_pendulum configuration (3 observations, both trunks (64, 64), one
action; T = 5, W = 9, E = 10,000): an actor row is 2 x (3 x 64 + 64 x 64
+ 64 x 1) = 8,704 operations, a critic row 2 x (4 x 64 + 64 x 64 + 64 x
1) = 8,832; an env makes 5 x 8,704 + 9 x 8,704 + 8 x 8,832 + 9 x (3 x
8,832 - 512) + 9 x (8,704 + 2 x 8,832 + 2 x 8,704 - 384) = 816,896, and
the iteration 8.16896e9 operations.  The time is the mean iteration of the
window, start mark to start mark."""

NAME = "mfu.ddpg"
UNIT = "%"
LAYER = "whole step"
MOVES = "train_env_steps_per_s"
SOURCE = "program_span"


def read(info: dict):
    from portbench.measure import PEAKS

    iters = info.get("iter_ms") or []
    if not iters or info.get("platform") != "gpu":
        return None
    seconds = 1e-3 * sum(iters) / len(iters)
    return 100.0 * info["iteration_ops"] / (seconds * PEAKS[info["precision"]])
