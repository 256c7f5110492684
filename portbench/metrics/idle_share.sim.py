"""``idle_share.sim``: the share of the traced replays of the captured
env-only step in which no operation ran on the device: 1 - the union of
the profiler's device intervals over the traced window's length."""

NAME = "idle_share.sim"
UNIT = "%"
LAYER = "device"
MOVES = "sim_env_steps_per_s"
SOURCE = "device_trace"


def read(info: dict):
    profile = info.get("profile")
    if not profile or not profile["device_ops"]:
        return None
    return profile["idle_share"]
