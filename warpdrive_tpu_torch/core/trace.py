"""
The port's tracer: spans and counters inside the program, on one timeline
with the device.

One process-wide tracer, off by default, like ``ops/knn_obs.py:
LAUNCH_COUNTS``.  A span site is written so that with tracing off it costs
one check of the module flag :data:`ON` and nothing else (no allocation, no
CUDA event, no context manager)::

    span = trace.begin("train.sync") if trace.ON else 0
    ...
    if span:
        trace.end(span)

A span records its name, its host start and end (``time.perf_counter_ns``),
its parent (the innermost span open when it began), the unit of work it
belongs to (the trainer's iteration index, or a program's replay index;
inherited from the parent) and, optionally, an event at each edge that
gives it a device extent: a CUDA event recorded on the current stream, or
the trainer's own phase marks (:class:`DeviceClock`).  Spans live in a
preallocated store of ``capacity`` entries; past it, ``dropped`` rises.

The shared clock: :func:`enable` waits for the card, records an anchor
event, waits again and reads the host clock; a device mark's host-clock
time is the anchor's plus ``anchor.elapsed_time(mark)``.  So host spans and
device extents sit on one timeline, and :func:`summary` puts each gap
between consecutive device extents of a span name down to the innermost
host span open at the gap's middle.  On the CPU a device mark is the host
clock itself, as ``DeviceClock`` has it.

While ``torch.profiler`` records, each span also opens a ``record_function``
range of its name, so a profiler's trace carries the program's names
beside the kernels.

A span left open by an exception is taken off the stack, and its
``record_function`` range exited, when a span around it ends.

Counters: host syncs (count and host ms blocked) and host fills of 0-dim
device scalars outside any graph (``scalar_writes``: the schedules' values,
learning rates among them, that a trainer writes before its programs run)
while tracing is on; at
every capture, on or off (capture is set-up), the node counts of the
captured graph by type, read through libcuda (:func:`graph_node_counts`);
and the passes an iteration of each hot update program, set when a trainer
builds them.  Replays are not counted twice: :func:`counters` reads
``Program.replays`` of each captured program still alive, and the
kernels' launches from the registry of launch counts
(``ops/cuda_build.py:LAUNCH_COUNTS``).
"""

from __future__ import annotations

import ctypes
import functools
import json
import time
import weakref

import torch
from torch.autograd import profiler as _autograd_profiler

# the span sites' one check
ON = False

_now = time.perf_counter_ns


class DeviceClock:
    """Time marks on the device's own clock: CUDA events on a card (read
    after the device has caught up), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def ms(self, start, stop) -> float:
        if self.cuda:
            return start.elapsed_time(stop)
        return 1e3 * (stop - start)


class _Tracer:
    """The store, the open spans and the counters."""

    def __init__(self, capacity: int = 0):
        self.allocate(capacity)
        self.first_id = 1
        self.clock = DeviceClock("cpu")
        self.device = torch.device("cpu")
        self.anchor = None
        self.anchor_ns = _now()
        # counted while tracing is on
        self.syncs = 0
        self.sync_ns = 0
        self.dropped = 0
        self.scalar_writes = 0
        # recorded at every capture and build, on or off
        self.programs = weakref.WeakValueDictionary()
        self.graph_nodes = {}
        self.update_passes = {}

    def allocate(self, capacity: int):
        self.cap = capacity
        self.n = 0
        self.name = [None] * capacity
        self.t0 = [0] * capacity
        self.t1 = [None] * capacity
        self.parent = [0] * capacity
        self.unit = [None] * capacity
        self.ev0 = [None] * capacity
        self.ev1 = [None] * capacity
        self.args = [None] * capacity
        self.ranges = [None] * capacity
        self.stack = []


_T = _Tracer()


def enable(device=None, capacity: int = 1 << 16):
    """Start tracing on ``device`` (default: the current CUDA device, else
    the CPU) into a fresh store of ``capacity`` spans; the counters counted
    while on start from 0."""
    global ON
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    t = _T
    t.first_id += max(t.n, 1)
    t.allocate(int(capacity))
    t.device, t.clock = device, DeviceClock(device)
    t.syncs, t.sync_ns, t.dropped, t.scalar_writes = 0, 0, 0, 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t.anchor = torch.cuda.Event(enable_timing=True)
        t.anchor.record()
        torch.cuda.synchronize(device)
    else:
        t.anchor = None
    t.anchor_ns = _now()
    ON = True


def disable():
    """Stop tracing; what was recorded stays readable."""
    global ON
    ON = False


def reset():
    """Stop tracing and drop every span and every counter."""
    disable()
    t = _T
    t.first_id += max(t.n, 1)
    t.allocate(0)
    t.syncs, t.sync_ns, t.dropped, t.scalar_writes = 0, 0, 0, 0
    t.programs = weakref.WeakValueDictionary()
    t.graph_nodes, t.update_passes = {}, {}


def begin(name: str, unit=None, device: bool = False, event=None,
          args: dict = None) -> int:
    """Open a span; returns its id (0 when the store is full).  ``unit``
    applies to a span with no parent (a child takes its parent's);
    ``event`` is its device start (a mark of :class:`DeviceClock`), or
    ``device`` asks for one on the current stream."""
    t = _T
    i = t.n
    if i >= t.cap:
        t.dropped += 1
        return 0
    t0 = _now()
    t.n = i + 1
    stack = t.stack
    parent = stack[-1] if stack else 0
    if parent:
        unit = t.unit[parent - t.first_id]
    t.name[i], t.parent[i], t.unit[i], t.args[i] = name, parent, unit, args
    if event is None and device:
        event = t.clock.mark()
    t.ev0[i] = event
    if _autograd_profiler._is_profiler_enabled:
        rf = _autograd_profiler.record_function(name)
        rf.__enter__()
        t.ranges[i] = rf
    span = t.first_id + i
    stack.append(span)
    t.t0[i] = t0
    return span


def end(span: int, event=None, args: dict = None):
    """Close the span ``span`` (and any left open inside it); ``event`` is
    its device end, else one is recorded if it has a device start."""
    t = _T
    i = span - t.first_id
    if not 0 <= i < t.n:
        return
    if event is None and t.ev0[i] is not None:
        event = t.clock.mark()
    t.ev1[i] = event
    if args:
        t.args[i] = {**(t.args[i] or {}), **args}
    ranges = t.ranges
    stack = t.stack
    if span in stack:
        while True:  # innermost first: the spans left open inside, then it
            top = stack.pop()
            j = top - t.first_id
            if ranges[j] is not None:
                ranges[j].__exit__(None, None, None)
                ranges[j] = None
            if top == span:
                break
    elif ranges[i] is not None:
        ranges[i].__exit__(None, None, None)
        ranges[i] = None
    t.t1[i] = _now()


# ------------------------------------------------------------- counters
def count_sync(device):
    """Wait for ``device``, counting the sync and the host ms it blocked."""
    t0 = _now()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    _T.syncs += 1
    _T.sync_ns += _now() - t0


def count_scalar_write():
    """A host fill of a 0-dim device scalar outside any graph (a call
    site checks :data:`ON` first)."""
    _T.scalar_writes += 1


def record_capture(program):
    """The ``Program`` ``program`` has captured its graph: keep its
    ``graph_nodes`` (the node counts by type, :func:`graph_node_counts`;
    ``None`` where they cannot be read) under its name, and a weak
    reference to it for its ``replays``."""
    t = _T
    t.programs[program.name] = program
    if program.graph_nodes is not None:
        t.graph_nodes[program.name] = dict(program.graph_nodes)


def record_update_passes(program: str, passes: int):
    """The hot update program ``program`` runs ``passes`` times an
    iteration."""
    _T.update_passes[program] = int(passes)


def counters() -> dict:
    """Every counter: ``syncs``, ``sync_ms``, ``dropped`` and
    ``scalar_writes`` (while on),
    ``graph_nodes`` and ``update_passes`` (at every capture and build),
    ``replays`` (``Program.replays`` of each captured program still alive,
    by name: the latest of a name) and ``<family>_launches`` for each
    family of registered launch counts (``knn_launches``,
    ``physics_launches``, ``sampler_launches``, ``reset_launches``:
    ``ops/cuda_build.py:LAUNCH_COUNTS``)."""
    from warpdrive_tpu_torch.ops import cuda_build  # which imports this one

    t = _T
    return {"syncs": t.syncs, "sync_ms": 1e-6 * t.sync_ns,
            "dropped": t.dropped, "scalar_writes": t.scalar_writes,
            "replays": {name: program.replays
                        for name, program in t.programs.items()},
            "graph_nodes": {k: dict(v) for k, v in t.graph_nodes.items()},
            "update_passes": dict(t.update_passes),
            **{f"{family}_launches": dict(counts)
               for family, counts in cuda_build.LAUNCH_COUNTS.items()}}


# ---------------------------------------------- a captured graph's nodes
# CUgraphNodeType (cuda.h): the types counted by name; the rest as "other"
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}
_CHILD_GRAPH = 4


@functools.cache
def _libcuda():
    lib = ctypes.CDLL("libcuda.so.1")
    for fn, argtypes in (
            (lib.cuGraphGetNodes, [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(ctypes.c_size_t)]),
            (lib.cuGraphNodeGetType, [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]),
            (lib.cuGraphChildGraphNodeGetGraph, [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)])):
        fn.argtypes, fn.restype = argtypes, ctypes.c_int  # CUresult
    return lib


def graph_node_counts(raw_graph: int) -> dict:
    """``{"kernel", "memcpy", "memset", "other": count}`` of the nodes of
    a captured ``cudaGraph_t`` (``CUDAGraph.raw_cuda_graph()``, kept with
    ``keep_graph=True``), child graphs' nodes included, through
    libcuda's ``cuGraphGetNodes`` and ``cuGraphNodeGetType``."""
    lib = _libcuda()
    counts = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0}

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned CUresult {rc}")

    def walk(graph):
        n = ctypes.c_size_t(0)
        check(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)),
              "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        check(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
              "cuGraphGetNodes")
        for node in nodes[:n.value]:
            kind = ctypes.c_int(-1)
            check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            if kind.value == _CHILD_GRAPH:
                child = ctypes.c_void_p()
                check(lib.cuGraphChildGraphNodeGetGraph(
                    node, ctypes.byref(child)),
                    "cuGraphChildGraphNodeGetGraph")
                walk(child)
            else:
                counts[_NODE_TYPES.get(kind.value, "other")] += 1

    walk(ctypes.c_void_p(raw_graph))
    return counts


# ---------------------------------------------------------- reading out
def _device_ns(mark) -> int:
    """A device mark's time on the host clock (ns)."""
    if isinstance(mark, float):  # DeviceClock's host clock (the CPU)
        return int(round(mark * 1e9))
    t = _T
    return t.anchor_ns + int(round(1e6 * t.anchor.elapsed_time(mark)))


def spans() -> list:
    """Every recorded span, closed or not, as a dict: ``id``, ``name``,
    ``parent`` (0: none), ``unit``, ``t0``/``t1`` (host ns; ``t1`` None
    while open), ``d0``/``d1`` (the device extent on the host clock, ns, or
    None) and ``args``.  Waits for the card first."""
    t = _T
    if t.device.type == "cuda" and t.anchor is not None:
        torch.cuda.synchronize(t.device)
    out = []
    for i in range(t.n):
        d0 = d1 = None
        if t.ev0[i] is not None and t.ev1[i] is not None:
            d0, d1 = _device_ns(t.ev0[i]), _device_ns(t.ev1[i])
        out.append({"id": t.first_id + i, "name": t.name[i],
                    "parent": t.parent[i], "unit": t.unit[i],
                    "t0": t.t0[i], "t1": t.t1[i],
                    "d0": d0, "d1": d1, "args": t.args[i]})
    return out


def _union_ns(intervals) -> int:
    total, end_ = 0, None
    for a, b in sorted(intervals):
        if end_ is None or a > end_:
            total += b - a
            end_ = b
        elif b > end_:
            total += b - end_
            end_ = b
    return total


def innermost(records: list, at_ns: int):
    """The name of the innermost closed span of ``records`` (sorted by
    ``t0``) open on the host at ``at_ns``, or None."""
    lo, hi = 0, len(records)
    while lo < hi:  # the last record starting at or before at_ns
        mid = (lo + hi) // 2
        if records[mid]["t0"] <= at_ns:
            lo = mid + 1
        else:
            hi = mid
    for r in reversed(records[:lo]):
        if r["t1"] >= at_ns:
            return r["name"]
    return None


def summarize(records: list) -> dict:
    """:func:`summary` of the span dicts ``records`` (:func:`spans`)."""
    closed = sorted((r for r in records if r["t1"] is not None),
                    key=lambda r: (r["t0"], -r["t1"]))
    children = {}
    for r in closed:
        if r["parent"]:
            children.setdefault(r["parent"], []).append(r)
    out = {}
    for r in closed:
        row = out.setdefault(r["name"], {
            "count": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": 0.0,
            "extents": []})
        host = r["t1"] - r["t0"]
        inner = _union_ns((max(c["t0"], r["t0"]), min(c["t1"], r["t1"]))
                          for c in children.get(r["id"], ())
                          if c["t1"] > r["t0"] and c["t0"] < r["t1"])
        row["count"] += 1
        row["host_ms"] += 1e-6 * host
        row["self_ms"] += 1e-6 * (host - inner)
        if r["d0"] is not None:
            row["device_ms"] += 1e-6 * (r["d1"] - r["d0"])
            row["extents"].append((r["d0"], r["d1"]))
    for name, row in out.items():
        extents = sorted(row.pop("extents"))
        gaps, by = [], {}
        reach = None
        for d0, d1 in extents:
            if reach is not None and d0 > reach:
                gaps.append((reach, d0))
                owner = innermost(closed, (reach + d0) // 2) or "(none)"
                by[owner] = by.get(owner, 0.0) + 1e-6 * (d0 - reach)
            reach = d1 if reach is None else max(reach, d1)
        row["device_extents"] = len(extents)
        row["device_span_ms"] = (1e-6 * (reach - extents[0][0])
                                 if extents else 0.0)
        row["gaps"] = len(gaps)
        row["gap_ms"] = 1e-6 * sum(b - a for a, b in gaps)
        row["gap_ms_by_host_span"] = by
    return out


def summary() -> dict:
    """For each span name: ``count``, ``host_ms``, ``self_ms`` (less what
    its children cover), ``device_ms``, and over its device extents in
    order of start: ``device_extents``, ``device_span_ms`` (the first's
    start to the last end), ``gaps`` and ``gap_ms`` (the device's time
    between one extent's end and the next one's start) and
    ``gap_ms_by_host_span`` (each gap put down to the innermost host span
    open at its middle).  Beside them every counter."""
    return {"spans": summarize(spans()), "counters": counters()}


def export_chrome(path: str) -> str:
    """Write the spans as a Chrome trace (Perfetto, ``chrome://tracing``):
    host spans on one track, device extents on another, microseconds from
    :func:`enable`, the counters under ``otherData``.  Returns ``path``."""
    origin = _T.anchor_ns
    events = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
               "args": {"name": label}}
              for tid, label in ((0, "host"), (1, "device"))]
    for r in spans():
        args = {"id": r["id"], "parent": r["parent"], "unit": r["unit"],
                **(r["args"] or {})}
        if r["t1"] is not None:
            events.append({"ph": "X", "name": r["name"], "pid": 0, "tid": 0,
                           "ts": 1e-3 * (r["t0"] - origin),
                           "dur": 1e-3 * (r["t1"] - r["t0"]), "args": args})
        if r["d0"] is not None:
            events.append({"ph": "X", "name": r["name"], "pid": 0, "tid": 1,
                           "ts": 1e-3 * (r["d0"] - origin),
                           "dur": 1e-3 * (r["d1"] - r["d0"]), "args": args})
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": counters()}, f)
    return path
