"""``step_mfu.sim``: the whole simulation step's share of its roofline on
the card: the least time the step's work could take (the larger of its
bytes at 3.35 TB/s and its operations at 67 TFLOP/s) over the step's time
in the window (window seconds over steps).

The bytes, each read or written once: the kNN observation's (``measure.
knn_bound_ms``: its inputs and its (E, N, 8k + 1) output), the state's
five float32 fields and in-game flags read and written, the rewards
written, and the actions (2 int32 an agent) written and read: 68 bytes an
agent beside the kNN's.  The operations (the distances' 5 an agent pair)
bound it far below the bytes, as in ``knn_roofline.sim``."""

NAME = "step_mfu.sim"
UNIT = "%"
LAYER = "whole step"
MOVES = "sim_env_steps_per_s"
SOURCE = "host_clock"


def read(info: dict):
    from portbench.measure import PEAK_BYTES_PER_S, knn_bound_ms

    if info.get("platform") != "gpu":
        return None
    E, N, k = info["envs"], info["agents"], info["k"]
    _, _, knn_bytes = knn_bound_ms(E, N, k, E * N * (N - 1))
    state_bytes = 68 * E * N
    least_ms = 1e3 * (knn_bytes + state_bytes) / PEAK_BYTES_PER_S
    return 100.0 * least_ms / info["step_ms"]
