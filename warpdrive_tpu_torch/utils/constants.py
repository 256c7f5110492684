"""
Canonical array names used throughout the framework.

The port's copy of ``warpdrive_tpu/utils/constants.py``: the same names, so
state dicts, configs and tests read alike on both sides.  The store keeps
its random state in a ``torch.Generator`` instead of a ``_rng_`` array
(see ``core/state.py``), so ``RNG`` names no state entry here.
"""


class Constants:
    """Canonical names for the arrays flowing through the RL loop."""

    OBSERVATIONS = "observations"
    PROCESSED_OBSERVATIONS = "processed_observations"
    ACTIONS = "sampled_actions"
    REWARDS = "rewards"
    DONE_FLAGS = "done_flags"
    ACTION_MASK = "action_mask"

    # Built-in per-env state entries (auto-created by the StateStore).
    DONE = "_done_"
    TIMESTEP = "_timestep_"
    RNG = "_rng_"
