"""
The benchmark's arithmetic: percentiles, the published peaks of the card,
the least time of the kNN observation, the policy's operations, and the
reduction of a ``torch.profiler`` run to busy time, idle gaps and device
time by kernel.  Everything here is plain Python over numbers and event
lists, so the CPU tests hold it to hand-worked cases.
"""

from __future__ import annotations

import math

# one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAKS = {"float32": PEAK_F32_FLOPS, "tf32": 495e12,
         "bfloat16": PEAK_BF16_FLOPS}


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, interpolated linearly
    between the two nearest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def knn_bound_ms(E, N, k, d2_pairs, mxu_distance=False):
    """Least time for the kNN observation on the card: each input read once
    and the output written once at the HBM rate, or the distance arithmetic
    at its peak rate, whichever is larger.  A pair costs 5 float32 flops in
    the difference form (2 sub, 2 mul, 1 add) at 67 TFLOP/s, and in the
    MXU expansion 12 bf16 multiply-adds, 24 flops, at the tensor cores'
    989 TFLOP/s.  Returns ``(ms, "bytes" | "operations", bytes)``."""
    bytes_in = 4 * (3 * E * N + 5 * E * N + N + E)
    bytes_out = 4 * E * N * (8 * k + 1)
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S
    t_ops = (24 * d2_pairs / PEAK_BF16_FLOPS if mxu_distance
             else 5 * d2_pairs / PEAK_F32_FLOPS)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), bound_by, bytes_in + bytes_out


def mlp_forward_flops(in_features: int, fc_dims, outputs: int) -> int:
    """Operations of one row through the policy: 2 per multiply-add of
    every dense layer, the heads fused into one of ``outputs`` columns."""
    dims = [int(in_features), *(int(d) for d in fc_dims), int(outputs)]
    return sum(2 * a * b for a, b in zip(dims, dims[1:]))


def mlp_update_flops(in_features: int, fc_dims, outputs: int) -> int:
    """Operations of one row through the update's forward and backward
    passes: the forward, every layer's weight gradient, and every layer's
    input gradient but the first (the observations need none)."""
    forward = mlp_forward_flops(in_features, fc_dims, outputs)
    first = 2 * int(in_features) * int(fc_dims[0])
    return forward + forward + (forward - first)


# ------------------------------------------------------------- the profiler
def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(kernels, host_ops, window, top: int = 10) -> list:
    """The longest stretches of ``window`` ``(start, end)`` in which no
    kernel ran, each named by the innermost host op running at its middle
    (``"host idle"`` where none was): ``[[name, seconds], ...]``, longest
    first.  ``kernels`` and ``host_ops``: ``(name, start, end)`` in
    microseconds."""
    gaps, cursor = [], window[0]
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if window[1] > cursor:
        gaps.append((cursor, window[1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        covering = [(hs, he, name) for name, hs, he in host_ops
                    if hs <= mid <= he]
        # the innermost: the latest to start among those covering the middle
        name = max(covering)[2] if covering else "host idle"
        out.append([name, (e - s) * 1e-6])
    return out


def device_ops(kernels, top: int = 10) -> list:
    """``[[kernel, seconds], ...]``: device time summed by name, the
    largest first."""
    sums = {}
    for name, s, e in kernels:
        sums[name] = sums.get(name, 0.0) + (e - s)
    ranked = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
    return [[name, us * 1e-6] for name, us in ranked]


WINDOW_MARK = "portbench.window"


def profile_events(prof):
    """``(kernels, host_ops, window)`` of a finished ``torch.profiler.
    profile`` whose traced work ran inside ``record_function(WINDOW_MARK)``:
    ``(name, start_us, end_us)`` of every device operation (kernels,
    copies, sets; not the mark's own device range) and of every host op, and
    the mark's ``(start_us, end_us)``."""
    from torch.autograd import DeviceType

    rows = []
    try:  # the raw events: much faster than building FunctionEvents
        for ev in prof.profiler.kineto_results.events():
            start = ev.start_ns() / 1e3
            rows.append((ev.name(), ev.device_type() == DeviceType.CUDA,
                         start, start + ev.duration_ns() / 1e3))
    except AttributeError:
        for ev in prof.events():
            rows.append((ev.name, ev.device_type == DeviceType.CUDA,
                         ev.time_range.start, ev.time_range.end))
    marks = [(s, e) for name, cuda, s, e in rows
             if name == WINDOW_MARK and not cuda]
    if not marks:
        raise RuntimeError(f"the profile holds no {WINDOW_MARK!r} range")
    kernels = [(n, s, e) for n, cuda, s, e in rows
               if cuda and n != WINDOW_MARK]
    host = [(n, s, e) for n, cuda, s, e in rows
            if not cuda and n != WINDOW_MARK]
    return kernels, host, marks[0]


def summarize(kernels, host_ops, window_us) -> dict:
    """What a traced window gives: busy and window seconds, the idle share
    (%) and the breakdown's two lists."""
    lo, hi = window_us
    kernels = [(n, max(s, lo), min(e, hi)) for n, s, e in kernels
               if e > lo and s < hi]
    busy = union_us([(s, e) for _, s, e in kernels])
    length = hi - lo
    return {"busy_s": busy * 1e-6, "window_s": length * 1e-6,
            "idle_share": 100.0 * (1.0 - busy / length) if length else None,
            "device_ops": device_ops(kernels),
            "idle_gaps": idle_gaps(kernels, host_ops, window_us)}
