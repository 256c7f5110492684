"""``step_kernels.sim``: the kernel nodes of the captured env-only step's
CUDA graph (the program ``captured env_only_step`` of
``presets.captured_loop``), which the program counts from the graph itself
at its capture, through libcuda (``core/trace.py:graph_node_counts``, the
tracer's ``graph_nodes`` counter, kept whether tracing is on or off): K1
and the env step's small kernels, which a fusion of them moves.  Not every
launch of a step: the graph's memcpy nodes (which run as ``memcpy32_post``
kernels) and memset nodes are left out, and so are the two int64 fills of
the generator's seed and offset that each replay runs outside the graph.
Nothing to read where the program keeps no such counter."""

NAME = "step_kernels.sim"
UNIT = "count"
LAYER = "whole step"
MOVES = "sim_env_steps_per_s"
SOURCE = "program_counter"

PROGRAM = "captured env_only_step"


def read(info: dict):
    if info.get("platform") != "gpu":
        return None
    try:
        from warpdrive_tpu_torch.core import trace
    except ImportError:  # a program without the tracer
        return None
    nodes = trace.counters()["graph_nodes"].get(PROGRAM)
    return None if nodes is None else nodes["kernel"]
