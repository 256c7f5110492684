"""``mfu.train``: the whole iteration's share of the card's peak for the
configuration's matmul precision (float32 outside the tensor cores, 67
TFLOP/s, at the card's full 700 W: PERF.md gives the power limit beside
every reading).

Operations an iteration, from the model's shapes (``measure.
mlp_forward_flops``, ``mlp_update_flops``): every one of the T x E x N rows
goes through the policy once in the rollout and once forward and backward
in the update, and no work is counted twice.  At the tag_continuous
configuration (81 features, trunk (256, 256), 20 + 20 logits and a value
fused into 41 outputs): a forward row is 2 x (81 x 256 + 256 x 256 + 256 x
41) = 193,536 operations; the update's row adds the weight gradients
(193,536) and the input gradients of all layers but the first (193,536 -
41,472), 539,136 in all; 2,750,000 rows make 2.0149e12 operations an
iteration.  The time is the mean iteration of the window, start mark to
start mark."""

NAME = "mfu.train"
UNIT = "%"
LAYER = "whole step"
MOVES = "train_env_steps_per_s"
SOURCE = "program_span"


def read(info: dict):
    from portbench.measure import PEAKS

    iters = info.get("iter_ms") or []
    if not iters or info.get("platform") != "gpu":
        return None
    flops = info["rows_per_iter"] * (info["row_flops"]["forward"]
                                     + info["row_flops"]["update"])
    seconds = 1e-3 * sum(iters) / len(iters)
    return 100.0 * flops / (seconds * PEAKS[info["precision"]])
