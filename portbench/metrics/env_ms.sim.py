"""``env_ms.sim``: the simulation step's device ms outside the kNN kernels
(random actions, the observation's inputs, physics, tags and rewards, the
checksum and the auto-reset): every device operation's profiler time in
the traced replays, less the kernels ``knn_roofline.sim`` names, over the
traced steps."""

NAME = "env_ms.sim"
UNIT = "ms"
LAYER = "env step"
MOVES = "sim_env_steps_per_s"
SOURCE = "device_trace"


def read(info: dict):
    from portbench.harness import metric_reader

    kernels = info.get("traced_kernels") or []
    if not kernels:
        return None
    knn = metric_reader("knn_roofline.sim").KERNELS
    other = sum(e - s for name, s, e in kernels
                if not any(k in name for k in knn))
    return 1e-3 * other / info["traced_steps"]
