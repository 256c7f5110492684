"""
The harness: finds a cell's parts by name, runs its driver, decides
``correct`` and prints the result.

``BENCHMARK.json`` names each cell's configuration and traffic.  The parts
are files under ``portbench/``, found by those names:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the traffic's parameters, among them the
  ``driver`` that runs its window (``drivers/<driver>.py``);
* ``workloads/<cell>.json``: the limit of every number the cell compares;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

A driver's ``run(ctx)`` builds the program, warms it up, measures the
window, reads what the per-layer readers need, frees the program and has
the reference judge its outputs; it returns a :class:`Run`.
"""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
# top-level module names the benchmark's process may never hold: JAX, its
# libraries and the JAX package (compared whole: the port's name begins
# with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "warpdrive_tpu")


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


@dataclass(frozen=True)
class Seeds:
    """The run's seeds, each drawn from ``--seed`` (any whole number):
    the env's layout, the trainer's draws, the benchmark's weights, the
    loop's actions, and the sample of answers compared."""

    env: int
    trainer: int
    weights: int
    actions: int
    sample: int

    @classmethod
    def of(cls, seed: int) -> "Seeds":
        words = np.random.SeedSequence(abs(int(seed))).generate_state(5)
        return cls(*(int(w) & 0x7FFFFFFF for w in words))


@dataclass
class Context:
    """What a driver is given."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seeds: Seeds
    seconds: float
    trace: bool
    device: object
    t_start: float
    control: bool = False
    settle: bool = True
    laps: list = field(default_factory=list)

    def lap(self, name: str):
        """Mark the end of a part of the set-up (printed with the run)."""
        self.laps.append((name, time.perf_counter() - self.t_start))

    def units(self) -> int:
        """The window's units of work (iterations or steps): ``--seconds``
        of them at the traffic's nominal pace, or the traffic's ``units``
        where it fixes them."""
        fixed = self.traffic.get("units")
        if fixed:
            return int(fixed)
        return max(1, int(np.ceil(1e3 * self.seconds
                                  / self.traffic["nominal_unit_ms"])))

    def scratch(self, name: str) -> Path:
        """A fixed folder of this cell's under the run's temporary folder."""
        base = Path(os.environ.get("TMPDIR") or "/tmp")
        path = base / "portbench" / self.cell["name"] / name
        path.mkdir(parents=True, exist_ok=True)
        return path


def sync(device):
    """Wait for the card (nothing to wait for elsewhere)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


# settling: a chunk this much faster than the slowest so far is past the
# turn; a process this old (seconds) stops settling whatever its pace
SETTLE_DROP = 0.06
SETTLE_UNTIL_S = 45.0


def settle(ctx: Context, chunk) -> str:
    """Run ``chunk()`` (``settle_chunk_units`` of the window's own work; it
    returns its seconds, ending with a sync) until the process has turned
    to its steady pace, or until it is ``SETTLE_UNTIL_S`` old.

    On the card's machine the host's launch path starts each process some
    11% slower and turns fast once, 8-50 s into the process (PERF.md, the
    settling).  The turn is judged by the process's own pace alone: a chunk
    ``SETTLE_DROP`` faster than the slowest chunk so far.  No outside pace
    enters, so a faster program settles as a slower one does.  Returns a
    line on what it saw."""
    if not ctx.settle:
        return "not settled"
    start, times = time.perf_counter(), []
    while True:
        times.append(chunk())
        if times[-1] < (1.0 - SETTLE_DROP) * max(times):
            how = "turned"
            break
        if time.perf_counter() - ctx.t_start >= SETTLE_UNTIL_S:
            how = "capped"
            break
    return (f"settled ({how}) in {time.perf_counter() - start:.3f} s, "
            f"{len(times)} chunks, s " + " ".join(f"{x:.4f}" for x in times))


@dataclass
class Run:
    """What a driver hands back."""

    e2e: dict
    numbers: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    info: dict = field(default_factory=dict)
    trace: dict = None
    control: dict = None


def set_dotted(tree: dict, dotted: str, value):
    """``tree[a][b] = value`` for ``dotted`` ``"a.b"``."""
    *path, last = dotted.split(".")
    for key in path:
        tree = tree[key]
    tree[last] = value


def cell_parts(name: str, overrides: dict = None):
    """``(bench, cell, config, traffic, limits)`` of the cell ``name``;
    ``overrides`` ``{"config": {dotted: value}, "traffic": {...}}`` (the
    tests' small sizes)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "workloads" / f"{name}.json")["limits"]
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    for dotted, value in (overrides or {}).get("config", {}).items():
        set_dotted(config, dotted, value)
    traffic.update((overrides or {}).get("traffic", {}))
    return bench, cell, config, traffic, limits


def metric_reader(name: str):
    """The module ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def execute(name: str, seed: int, seconds: float, trace: bool,
            device="cuda", overrides: dict = None, control: bool = False,
            t_start: float = None, settle: bool = True,
            laps: list = ()) -> dict:
    """Run the cell ``name`` once and return its result line's object (the
    ``checks`` key last).  Looks for no card: :func:`main` does.
    ``settle=False`` skips the settling (a comparison needs no steady
    pace); ``laps`` are set-up marks made before the call."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, config, traffic, limits = cell_parts(name,
                                                      overrides=overrides)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    ctx = Context(cell=cell, config=config, traffic=traffic, seed=int(seed),
                  seeds=Seeds.of(seed), seconds=float(seconds),
                  trace=bool(trace), device=torch.device(device),
                  t_start=t_start, control=control, settle=settle,
                  laps=list(laps))
    run = driver.run(ctx)
    print("portbench: set-up s " + " ".join(f"{n} {t:.3f}"
                                            for n, t in ctx.laps),
          file=sys.stderr)
    run.info["platform"] = "gpu" if ctx.device.type == "cuda" else "cpu"

    checks = {}
    for number, limit in limits.items():
        value = run.numbers[number]
        checks[number] = {"value": value, "limit": limit}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if _for_cell(m, name):
                metrics[m["name"]] = {"value": run.e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if not _for_cell(m, name):
                continue
            value = metric_reader(m["name"]).read(run.info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = ctx.device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": bool(correct), "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace and run.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    if control:
        line["control"] = run.control
    line["checks"] = checks
    return line


def main(argv=None, t_start: float = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(HERE / "_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / "_cache" / "torch_ext")
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    laps = [("torch", time.perf_counter() - t_start)]
    _, cell, _, _, _ = cell_parts(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.init()
    laps.append(("cuda", time.perf_counter() - t_start))
    line = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=t_start, laps=laps)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)} after the "
              "window; no result", file=sys.stderr)
        return 4
    for number, c in line["checks"].items():
        print(f"check {number} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
