"""
Start W local ranks of a ``torch.distributed`` group and wait for them.

The port's counterpart of the original WarpDrive's one-process-per-GPU
launcher: ``launch(fn, W, args, device=...)`` spawns W processes on a free
TCP port of this host, brings the group up in each
(:func:`~warpdrive_tpu_torch.parallel.mesh.initialize_multihost`, NCCL for
``cuda`` with rank ``r`` on ``cuda:r``, gloo for ``cpu``, or the backend
named), calls ``fn(device, *args)`` there, and returns each rank's result.
A rank that fails, or a run past ``timeout_s``, kills the others and
raises with the failed rank's traceback: a run either completes on every
rank or fails.  ``backend="gloo"`` with ``device="cuda:0"`` puts every rank
on one card (NCCL refuses two ranks on one GPU).

``fn`` must be importable by name in a fresh interpreter (a module-level
function; the children are spawned, not forked), and so must its module's
imports: a worker beside tests that import JAX keeps those imports inside
the test functions.  Results are passed back through ``torch.save``, so
tensors, arrays and plain data may be returned.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import socket
import sys
import tempfile
import time
import traceback

import torch

from warpdrive_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    default_backend,
    initialize_multihost,
)
from warpdrive_tpu_torch.utils.device import resolve_device


def free_port() -> int:
    """A TCP port of this host that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, backend: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:rank`` for NCCL over ``cuda``, the
    device as named otherwise (``cuda`` alone meaning ``cuda:0``)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl" and dev.index is None:
        return torch.device("cuda", rank)
    return torch.device("cuda", dev.index or 0)


def _rank_main(rank, world_size, port, backend, device, fn, args, outdir,
               threads):
    """A rank's life: join the group, run ``fn``, write its result (or its
    traceback) and leave with ``os._exit``.  Every collective has
    completed on every rank by the time ``fn`` returns; leaving without the
    interpreter's teardown spares the process group's threads a shutdown
    race that can abort a finished rank."""
    code = 1
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(device, backend, rank)
        initialize_multihost(f"127.0.0.1:{port}", world_size, rank,
                             backend=backend, device=dev,
                             timeout_s=DEFAULT_TIMEOUT_S)
        result = fn(dev, *args)
        torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))
        code = 0
    except BaseException:
        detail = traceback.format_exc()
        with open(os.path.join(outdir, f"rank{rank}.err"), "w",
                  encoding="utf-8") as f:
            f.write(detail)
        sys.stderr.write(detail)
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def launch(fn, world_size: int, args=(), device="cuda", backend: str = None,
           timeout_s: float = 600, threads: int = None) -> list:
    """Run ``fn(device, *args)`` on ``world_size`` spawned ranks; returns
    their results in rank order.  ``timeout_s`` None waits as long as the
    ranks run.  ``threads`` sets each rank's
    ``torch.set_num_threads``.  Raises before spawning when NCCL is asked
    for more ranks than there are cards (``ValueError``), or a card when
    there is none."""
    world_size = int(world_size)
    backend = backend or default_backend(device)
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world_size > cards:
            raise ValueError(
                f"{world_size} NCCL ranks need {world_size} GPUs, "
                f"{cards} visible; one rank a card (use device='cpu' for a "
                "gloo rehearsal)")
    resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    outdir = tempfile.mkdtemp(prefix="wdt_launch_")
    port = free_port()
    procs = [
        ctx.Process(target=_rank_main, name=f"rank{r}",
                    args=(r, world_size, port, backend, str(device), fn,
                          tuple(args), outdir, threads))
        for r in range(world_size)
    ]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + (float("inf") if timeout_s is None
                                       else timeout_s)
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(outdir, procs, failed))
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout_s} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(_failure(outdir, procs, failed))
        return [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        shutil.rmtree(outdir, ignore_errors=True)


def _failure(outdir: str, procs, failed: list) -> str:
    """The report of the rank that failed first: of the failed ranks, the
    one whose traceback was written first (a rank's failure breaks its
    peers' collectives, which fail after it)."""

    def written(rank):
        path = os.path.join(outdir, f"rank{rank}.err")
        return os.stat(path).st_mtime_ns if os.path.exists(path) else None

    times = {r: written(r) for r in failed}
    rank = min(failed, key=lambda r: (times[r] is None, times[r] or 0, r))
    detail = ""
    if times[rank] is not None:
        with open(os.path.join(outdir, f"rank{rank}.err"),
                  encoding="utf-8") as f:
            detail = f.read()
    return (f"rank {rank} of {len(procs)} exited with code "
            f"{procs[rank].exitcode}\n{detail}")
