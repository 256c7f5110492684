"""``iter_launches.ddpg``: what the host launches an iteration, in the
tracer's slice of steady hot iterations: the kernel nodes of each captured
graph (counted by the program from the graph itself at its capture,
through libcuda: the tracer's ``graph_nodes``) times its replays in the
slice (``Program.replays``, the tracer's ``replays``), plus the host's
fills of 0-dim device scalars outside any graph (the tracer's
``scalar_writes``: three OU schedules and two learning rates an
iteration), over the slice's iterations.  A hot iteration replays the
noise draw, ``T`` rollout steps, the append and the hot update.  Left
out: the graphs' memcpy and memset nodes, the replays' two int64 fills
(seed and offset) of the generator a graph draws from, the rollout's step
counter reset and the phase marks' events.  Nothing to read where the
program counts no scalar fills, or off the card."""

NAME = "iter_launches.ddpg"
UNIT = "count"
LAYER = "whole step"
MOVES = "train_env_steps_per_s"
SOURCE = "program_counter"


def read(info: dict):
    tracer = info.get("tracer")
    if not tracer or info.get("platform") != "gpu":
        return None
    if tracer.get("scalar_writes") is None:
        return None
    nodes = tracer["kernel_nodes"]
    kernels = sum(nodes.get(name, 0) * n
                  for name, n in tracer["replays"].items())
    return (kernels + tracer["scalar_writes"]) / tracer["iterations"]
