"""``rollout_ms.train``: the rollout's device ms an iteration, the mean over
the window's iterations of the trainer's own phase marks (CUDA events
around the rollout-step replays of ``trainer_a2c.py``; the env step, the
kNN kernel K2, the policies' forward pass and the sampler)."""

NAME = "rollout_ms.train"
UNIT = "ms"
LAYER = "rollout"
MOVES = "train_env_steps_per_s"
SOURCE = "program_span"


def read(info: dict):
    phases = info.get("phase_ms") or []
    if not phases or info.get("platform") != "gpu":
        return None
    return sum(r for r, _ in phases) / len(phases)
