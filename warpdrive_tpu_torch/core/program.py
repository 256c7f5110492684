"""
Program: a body of in-place tensor work, captured once as a CUDA graph and
replayed.

The port's counterpart of ``jax.jit`` over a carry: the JAX trainer runs
its whole iteration as one donated program
(``warpdrive_tpu/training/trainer_a2c.py:185-195``) whose rollout and
minibatch passes are ``lax.scan`` bodies, and its presets' loop steps are
"pure functions ready for ``jax.jit``" (``warpdrive_tpu/presets.py:6``).
PyTorch runs op by op; a :class:`Program` gets the same "the host touches
the device once a step" from ``torch.cuda.CUDAGraph``.

A program is a ``body()`` that reads and writes static tensors in place --
its ``buffers``: the carry (env state, parameters, optimizer moments,
batch rows, counters) -- and returns outputs, if any.  JAX's functions
return a new carry; a body writes the new carry into the old one's storage
(``copy_``, ``index_copy_``), so that every replay finds its inputs where
the capture found them.  A body must be pure on the host: it runs twice
on the first call (the warm-up and the capture) and never again on a card,
so a host counter or a host read of a device value inside it would be
wrong or would raise.

On ``cuda`` the first call

* runs the body on a side stream (the warm-up: this is a real execution,
  the call's own effect, and where a kernel's library is built and loaded
  by ``ops/cuda_build.load`` and its shared-memory attribute set), then
* captures it with ``torch.cuda.graph(graph, pool=pool)`` (the capture runs
  nothing; Python's automatic garbage collection is off meanwhile), with
  every explicit ``torch.Generator`` the body draws from
  registered with the graph (``CUDAGraph.register_generator_state``), so
  that each replay draws the numbers that eager calls would have drawn and
  advances the generator as they would;

every later call replays the graph and credits the kernels' launch
counts (``ops/cuda_build.py:LAUNCH_COUNTS``, where each ops module
registers its own) with the launches their wrappers counted during the
capture, since a replay runs no wrapper.  A failed
capture or replay raises; nothing falls back to eager calls.  The graph is
captured with ``keep_graph=True``, so that its nodes are counted by type
(``graph_nodes``, and the tracer's ``graph_nodes`` counter) before it is
instantiated.

With the tracer on (``core/trace.py``) a call is the span ``program.call``
with the children ``program.check_buffers`` and ``program.replay`` (with a
device extent), and the first call on a card is ``program.capture``.

On the CPU a call runs the body directly, with the same static buffers
and in-place writes, so the CPU tests exercise the code a card captures.
So does every program called inside :func:`plain_calls`: the plain
version of the captured programs, which a comparison on the card runs on
the same buffers, and what a body that steps envs on the host (which no
graph can hold) runs under.

Every call checks that each buffer still has the storage it had when the
program was built: a graph keeps the addresses it captured, so a buffer
rebound in place of being written into would leave the program on a
stale tensor.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from warpdrive_tpu_torch.core import trace
from warpdrive_tpu_torch.ops import cuda_build


def _leaves(tree, path=()):
    """``(path, tensor)`` of every tensor of nested dicts, lists and
    tuples."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, path + (i,))


def storages(tree) -> dict:
    """``{path: data_ptr}`` of every tensor of ``tree``."""
    return {path: t.data_ptr() for path, t in _leaves(tree)}


def assign_state(static: dict, new: dict):
    """Write a step's new state ``new`` into the static state ``static``
    (the same entries; a nested dict entry by entry), in place: the end of
    a captured step's body."""
    if new.keys() != static.keys():
        raise ValueError(f"the step returned {sorted(new)}, the static state "
                         f"holds {sorted(static)}")
    for name, buf in static.items():
        value = new[name]
        if value is buf:
            continue
        if isinstance(buf, dict):
            assign_state(buf, value)
            continue
        if value.dtype != buf.dtype or value.shape != buf.shape:
            raise ValueError(f"{name}: the step returned {value.dtype} "
                             f"{tuple(value.shape)}, the static buffer is "
                             f"{buf.dtype} {tuple(buf.shape)}")
        buf.copy_(value)


def launches_of(fn):
    """Run ``fn``; return its result and ``{kernel: launches}`` that the
    kernels' wrappers counted meanwhile, with the launch counts set back.
    A capture launches nothing, so what its wrappers counted is what each
    replay launches (:func:`credit_launches`)."""
    families = cuda_build.LAUNCH_COUNTS
    before = {name: n for counts in families.values()
              for name, n in counts.items()}
    try:
        return fn(), {name: n - before.get(name, 0)
                      for counts in families.values()
                      for name, n in counts.items()
                      if n != before.get(name, 0)}
    finally:
        for counts in families.values():
            for name in counts:
                counts[name] = before.get(name, 0)


def credit_launches(launches: dict):
    """Add ``launches`` (``{kernel: launches}``) to each kernel's launch
    count: a replayed graph launches the kernels it captured without
    running their wrappers."""
    for name, n in launches.items():
        for counts in cuda_build.LAUNCH_COUNTS.values():
            if name in counts:
                counts[name] += n
                break


_PLAIN_CALLS = [0]


@contextlib.contextmanager
def plain_calls():
    """Inside, every :class:`Program` calls its body directly, on a card
    too (nothing is captured or replayed)."""
    _PLAIN_CALLS[0] += 1
    try:
        yield
    finally:
        _PLAIN_CALLS[0] -= 1


class Program:
    """``body()`` over the static ``buffers`` on ``device``: captured and
    replayed on a card, called directly elsewhere.

    :param generators: the explicit generators the body draws from.
    :param pool: a memory pool (``torch.cuda.graph_pool_handle()``) shared
        with other programs of one owner, which never run at once.
    """

    def __init__(self, body, buffers, device, generators=(), pool=None,
                 name: str = "program"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not hasattr(
                torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                f"{name}: this torch ({torch.__version__}) has no "
                "CUDAGraph.register_generator_state, which a captured "
                "program needs for its explicit generators (torch "
                "2.11.0+cu128 has it)")
        self.body = body
        self.buffers = buffers
        self.generators = tuple(generators)
        self.pool = pool
        self.name = name
        self.graph = None
        self.outputs = None
        self.launches = {}  # kernel -> launches a replay (the capture's)
        self.graph_nodes = None  # the captured graph's nodes by type
        self.replays = 0
        self._storages = storages(buffers)

    def check_buffers(self):
        """Raise if a buffer was rebound since the program was built."""
        now = storages(self.buffers)
        moved = sorted(str(path) for path in now.keys() | self._storages.keys()
                       if now.get(path) != self._storages.get(path))
        if moved:
            raise RuntimeError(
                f"{self.name}: buffers rebound since the program was built "
                f"({', '.join(moved)}); write into them in place")

    def __call__(self):
        on = trace.ON
        call = (trace.begin("program.call", unit=self.replays,
                            args={"program": self.name}) if on else 0)
        span = trace.begin("program.check_buffers") if on else 0
        self.check_buffers()
        if span:
            trace.end(span)
        if self.device.type != "cuda" or _PLAIN_CALLS[0]:
            result = self.body()
        elif self.graph is None:
            span = trace.begin("program.capture") if on else 0
            result = self._warm_up_and_capture()
            if span:
                trace.end(span)
        else:
            span = trace.begin("program.replay", device=True) if on else 0
            self.graph.replay()
            if span:
                trace.end(span)
            credit_launches(self.launches)
            self.replays += 1
            result = self.outputs
        if call:
            trace.end(call)
        return result

    def _warm_up_and_capture(self):
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            result = self.body()
        main.wait_stream(side)

        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for generator in self.generators:
            graph.register_generator_state(generator)

        def capture():
            with torch.cuda.graph(graph, pool=self.pool):
                return self.body()

        # no automatic collection while capturing: a dead program's graph,
        # freed when its reference cycle is collected, cannot be destroyed
        # while a stream captures, and the attempt invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            outputs, self.launches = launches_of(capture)
        finally:
            if collecting:
                gc.enable()
        self.graph_nodes = trace.graph_node_counts(graph.raw_cuda_graph())
        graph.instantiate()
        trace.record_capture(self)
        self.check_buffers()
        self.graph, self.outputs = graph, outputs
        return result
