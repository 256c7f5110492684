"""``host_ms.ddpg``: the host's ms an iteration outside the graph
replays, in a slice of ``trace_units`` steady hot iterations run under the
port's tracer after the window (driven as the settling drives them): the
slice's host time less the host time of its ``program.replay`` spans (the
``graph.replay()`` calls), over its iterations.  What is left is the
host's call path: the Python of the iteration and of each program call,
``program.check_buffers`` (the storage walk), ``ddpg.schedules`` (the
schedules' and learning rates' fills), the phase marks, and the tracer's
own spans.  Nothing to read without the tracer's slice, or off the
card."""

NAME = "host_ms.ddpg"
UNIT = "ms"
LAYER = "host"
MOVES = "train_env_steps_per_s"
SOURCE = "program_span"


def read(info: dict):
    tracer = info.get("tracer")
    if not tracer or info.get("platform") != "gpu":
        return None
    replay = tracer["spans"].get("program.replay")
    if replay is None:
        return None
    return (tracer["host_ms"] - replay["host_ms"]) / tracer["iterations"]
