"""``idle_share.train``: the share of a traced slice of steady hot
iterations (``trace_units`` of them after the window, driven as the
settling drives them) in which no operation ran on the device: 1 - the
union of the profiler's device intervals over the slice's length
(``measure.summarize``).  The window's few log points are not in it."""

NAME = "idle_share.train"
UNIT = "%"
LAYER = "device"
MOVES = "train_env_steps_per_s"
SOURCE = "device_trace"


def read(info: dict):
    profile = info.get("profile")
    if not profile or not profile["device_ops"]:
        return None
    return profile["idle_share"]
