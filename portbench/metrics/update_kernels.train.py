"""``update_kernels.train``: the kernel nodes of one hot iteration's
update graphs: for each trained policy, the kernel nodes of its hot update
pass's CUDA graph (counted by the program from the graph itself at its
capture, through libcuda: ``core/trace.py:graph_node_counts``, the
tracer's ``graph_nodes`` counter) times the passes an iteration runs it
(the tracer's ``update_passes``, set when the trainer builds its
programs), summed over the policies.  Both are kept whether tracing is on
or off.  The update's work count, which a fusion of its kernels moves.
Not every launch of the update: the graphs' memcpy and memset nodes, and
what ``UpdatePass.begin`` launches outside the graphs every iteration (the
schedule scalars' fills and the shuffled table), are left out.  Nothing to
read where the program keeps no such counters."""

NAME = "update_kernels.train"
UNIT = "count"
LAYER = "update"
MOVES = "train_env_steps_per_s"
SOURCE = "program_counter"


def read(info: dict):
    if info.get("platform") != "gpu":
        return None
    try:
        from warpdrive_tpu_torch.core import trace
    except ImportError:  # a program without the tracer
        return None
    counters = trace.counters()
    passes, nodes = counters["update_passes"], counters["graph_nodes"]
    if not passes or any(program not in nodes for program in passes):
        return None
    return sum(nodes[program]["kernel"] * n
               for program, n in passes.items())
