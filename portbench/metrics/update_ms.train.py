"""``update_ms.train``: the update's device ms an iteration, the mean over
the window's iterations of the trainer's own phase marks (CUDA events
around ``policy_update``'s pass programs: the forward and backward passes,
the A2C loss and ``ClippedAdam``)."""

NAME = "update_ms.train"
UNIT = "ms"
LAYER = "update"
MOVES = "train_env_steps_per_s"
SOURCE = "program_span"


def read(info: dict):
    phases = info.get("phase_ms") or []
    if not phases or info.get("platform") != "gpu":
        return None
    return sum(u for _, u in phases) / len(phases)
