"""``knn_roofline.sim``: the kNN observation kernel's share of its roofline
in the simulation step: the least time of the kNN function at the cell's
(E, N, k) (``measure.knn_bound_ms``: each input read once and the output
written once at 3.35 TB/s, or the distance arithmetic at its peak,
whichever is larger; the bytes bound it by more than tenfold here) over
the kernel's device ms a step.

The kernel's device ms a step is the profiler's time of the kernels named
in ``KERNELS`` (the device functions of the port's kNN kernels, templates
in ``csrc/``) a launch, times the launches a step that ``LAUNCH_COUNTS``
credited to the traced replays.  A trace with device operations and none
of these kernels fails: the names have to be brought up to date."""

import sys

NAME = "knn_roofline.sim"
UNIT = "%"
LAYER = "kNN kernels"
MOVES = "sim_env_steps_per_s"
SOURCE = "device_trace"

KERNELS = ("scan_kernel", "tile_kernel", "ladder_kernel", "envlanes_kernel")


def knn_ms_per_step(info: dict):
    """The kNN kernels' device ms a traced step, or None without a device
    trace."""
    kernels = info.get("traced_kernels") or []
    if not kernels:
        return None
    knn = [(s, e) for name, s, e in kernels
           if any(k in name for k in KERNELS)]
    if not knn:
        raise RuntimeError("the device trace holds no kernel named in "
                           f"{KERNELS}")
    credited = sum(info["credited_launches"].values())
    per_launch_ms = 1e-3 * sum(e - s for s, e in knn) / len(knn)
    print(f"portbench: kNN launches profiled {len(knn)}, credited "
          f"{credited}, over {info['traced_steps']} steps", file=sys.stderr)
    return per_launch_ms * credited / info["traced_steps"]


def read(info: dict):
    from portbench.measure import knn_bound_ms

    ms = knn_ms_per_step(info)
    if ms is None:
        return None
    E, N, k = info["envs"], info["agents"], info["k"]
    bound, _, _ = knn_bound_ms(E, N, k, E * N * (N - 1))
    return 100.0 * bound / ms
