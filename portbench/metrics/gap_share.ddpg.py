"""``gap_share.ddpg``: the share of the graph replays' device span in which
the card waited between one replay and the next, in the tracer's slice of
steady hot iterations: the gaps between consecutive ``program.replay``
device extents (each a CUDA event before and after ``graph.replay()``)
over the span from the first extent's start to the last one's end
(``core/trace.py:summary``).  The card waits there for the host's call
path.  Nothing to read without the tracer's slice, or off the card."""

NAME = "gap_share.ddpg"
UNIT = "%"
LAYER = "device"
MOVES = "train_env_steps_per_s"
SOURCE = "program_span"


def read(info: dict):
    tracer = info.get("tracer")
    if not tracer or info.get("platform") != "gpu":
        return None
    replay = tracer["spans"].get("program.replay")
    if not replay or not replay["device_span_ms"]:
        return None
    return 100.0 * replay["gap_ms"] / replay["device_span_ms"]
