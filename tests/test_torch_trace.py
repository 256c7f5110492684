"""The port's tracer (``warpdrive_tpu_torch/core/trace.py``) on the CPU, and
on a card the kernel nodes it counts in a captured graph:

- spans nest, take their parent's unit of work, and their self time is
  their duration less what their children cover (a fake clock);
- each device gap between consecutive extents of a span name is put down
  to the innermost host span open at its middle (hand-built marks);
- with tracing off no span is stored, no span is even begun and no CUDA
  event is made, across ``Program`` calls and three ``train()``
  iterations;
- three traced ``train()`` iterations through the programs: one
  ``rollout`` with T ``program.call`` children an iteration, the update's
  ``update.begin`` and passes under ``update``, ``rollout`` and ``update``
  equal to ``phase_ms`` from the same three marks an iteration;
- under ``torch.profiler`` each span is a host op of its name within its
  recorded extent; the Chrome export; the benchmark's readers of the
  tracer's counters; the kernels' launch families kept apart;
- on a card (skipped elsewhere): the kernel nodes of the flagship loop's
  graph and of a hot update pass are the kernels the profiler sees a
  replay, but for the replay's two int64 fills (seed and offset) of each
  generator the graph draws from, which run outside the graph; its memcpy
  nodes (run as CUDA's ``memcpy32_post`` kernels or as copies) and
  memset nodes are the copies and sets the profiler sees.

The file imports no JAX, so on a machine with a card and no JAX it runs
without the repo's ``conftest.py``::

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py -q
"""

import copy
import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch

from warpdrive_tpu_torch.core import trace
from warpdrive_tpu_torch.core.program import Program
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.utils import config as port_config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def tracer_reset():
    trace.reset()
    yield
    trace.reset()


class _FakeClock:
    """``trace._now``: each call returns the next of ``times`` (ns)."""

    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


MS = 1_000_000  # ns


class _Captured:
    """What :func:`trace.record_capture` reads of a captured ``Program``."""

    def __init__(self, name, kernel, memcpy=0, memset=0, replays=0):
        self.name, self.replays = name, replays
        self.graph_nodes = {"kernel": kernel, "memcpy": memcpy,
                            "memset": memset, "other": 0}


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


# --------------------------------------------------------------- spans
def test_spans_nest_with_parents_units_and_self_time(monkeypatch):
    # A [0, 100] holds B [10, 30] and C [40, 70]; C holds D [45, 50];
    # then a root E [200, 210] of its own unit
    monkeypatch.setattr(trace, "_now", _FakeClock(
        [0, 0, 10 * MS, 30 * MS, 40 * MS, 45 * MS, 50 * MS, 70 * MS,
         100 * MS, 200 * MS, 210 * MS]))
    trace.enable("cpu", capacity=5)
    a = trace.begin("A", unit=7)
    b = trace.begin("B", unit=99)  # a child takes its parent's unit
    trace.end(b)
    c = trace.begin("C")
    d = trace.begin("D")
    trace.end(d)
    trace.end(c)
    trace.end(a)
    e = trace.begin("E", unit=3)
    trace.end(e)
    assert trace.begin("F") == 0  # the store is full
    trace.end(0)  # a dropped span's end is a no-op
    trace.disable()

    spans = {r["name"]: r for r in trace.spans()}
    assert [spans[n]["parent"] for n in "ABCDE"] == [0, a, a, c, 0]
    assert [spans[n]["unit"] for n in "ABCDE"] == [7, 7, 7, 7, 3]
    assert (spans["D"]["t0"], spans["D"]["t1"]) == (45 * MS, 50 * MS)
    summary = trace.summary()
    rows = summary["spans"]
    assert {n: rows[n]["host_ms"] for n in "ABCDE"} == {
        "A": 100.0, "B": 20.0, "C": 30.0, "D": 5.0, "E": 10.0}
    # A less B and C; C less D
    assert {n: rows[n]["self_ms"] for n in "ABCDE"} == {
        "A": 50.0, "B": 20.0, "C": 25.0, "D": 5.0, "E": 10.0}
    assert all(rows[n]["count"] == 1 and rows[n]["device_ms"] == 0.0
               for n in "ABCDE")
    assert summary["counters"]["dropped"] == 1


def test_an_end_closes_what_was_left_open_inside_it(monkeypatch):
    monkeypatch.setattr(trace, "_now", _FakeClock(
        [0, 0, 1 * MS, 3 * MS, 4 * MS, 5 * MS, 6 * MS]))
    trace.enable("cpu")
    outer = trace.begin("outer")
    trace.begin("left open")
    trace.end(outer)
    after = trace.begin("after")  # a root again
    trace.end(after)
    spans = {r["name"]: r for r in trace.spans()}
    assert spans["left open"]["t1"] is None
    assert spans["after"]["parent"] == 0
    assert "left open" not in trace.summary()["spans"]
    trace.enable("cpu")  # a fresh store: the old ids close nothing
    trace.end(outer)
    assert trace.spans() == []


def test_an_open_child_leaves_no_profiler_range_open():
    """A program call that raises leaves its spans open; the end of the
    span around it exits their ``record_function`` ranges too, innermost
    first, so the profiler's later ops nest as they ran."""
    from torch.profiler import ProfilerActivity, profile

    carry = {"x": torch.zeros(4)}
    program = Program(lambda: carry["x"].add_(1.0), carry, "cpu",
                      name="stub")
    carry["x"] = torch.zeros(4)  # rebound: the storage check raises
    trace.enable("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outer = trace.begin("outer")
        with pytest.raises(RuntimeError, match="rebound"):
            program()
        trace.end(outer)
        after = trace.begin("after")
        torch.zeros(8).add_(1.0)
        trace.end(after)
    trace.disable()
    assert trace._T.stack == []
    assert all(r is None for r in trace._T.ranges[:trace._T.n])
    spans = {r["name"]: r for r in trace.spans()}
    assert spans["after"]["parent"] == 0
    assert spans["program.check_buffers"]["t1"] is None  # left open
    ops = {}
    for ev in prof.profiler.kineto_results.events():
        ops.setdefault(ev.name(), []).append(
            (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    names = ("outer", "program.call", "program.check_buffers", "after")
    assert all(len(ops.get(name, [])) == 1 for name in names), ops
    (o0, o1), = ops["outer"]
    (c0, c1), = ops["program.call"]
    (k0, k1), = ops["program.check_buffers"]
    (a0, a1), = ops["after"]
    assert o0 <= c0 <= k0 <= k1 <= c1 <= o1 <= a0 <= a1
    (z0, z1), = ops["aten::add_"][-1:]
    assert a0 <= z0 <= z1 <= a1


def test_gap_attribution_on_hand_built_marks_and_spans(monkeypatch):
    """Device marks on the CPU are the host clock (seconds), as
    ``DeviceClock`` gives them; host times are the fake clock's ns."""
    us = 1000  # ns
    monkeypatch.setattr(trace, "_now", _FakeClock(
        [0,                      # enable
         0,                      # loop begins
         10 * us, 20 * us,       # replay 1
         100 * us, 300 * us,     # host.work (holds the first gap's middle)
         310 * us, 320 * us,     # replay 2
         330 * us, 340 * us,     # replay 3
         500 * us, 510 * us,     # replay 4
         520 * us, 530 * us,     # replay 5 (inside replay 4's extent)
         1000 * us]))            # loop ends
    trace.enable("cpu")
    device = {1: (0, 200), 2: (260, 400), 3: (400, 600), 4: (700, 800),
              5: (720, 780)}
    loop = trace.begin("loop")
    for k in (1, 2, 3, 4, 5):
        if k == 2:
            work = trace.begin("host.work")
            trace.end(work)
        span = trace.begin("replay", event=device[k][0] * 1e-6)
        trace.end(span, event=device[k][1] * 1e-6)
    trace.end(loop)
    row = trace.summary()["spans"]["replay"]
    assert row["count"] == row["device_extents"] == 5
    assert row["device_ms"] == pytest.approx(0.2 + 0.14 + 0.2 + 0.1 + 0.06)
    assert row["device_span_ms"] == pytest.approx(0.8)
    # 200-260 (middle 230: host.work) and 600-700 (middle 650: loop);
    # 400-400 touches, and replay 5 lies inside replay 4
    assert row["gaps"] == 2
    assert row["gap_ms"] == pytest.approx(0.16)
    assert row["gap_ms_by_host_span"] == pytest.approx(
        {"host.work": 0.06, "loop": 0.1})
    assert trace.innermost([], 5) is None


# --------------------------------------------------- tracing off: a branch
def _small_tag_continuous(**trainer):
    cfg = port_config.load_run_config("tag_continuous")
    cfg["env"].update({"num_taggers": 2, "num_runners": 8,
                       "episode_length": 12, "num_other_agents_observed": 4})
    cfg["trainer"].update({"num_envs": 4, "train_batch_size": 40,
                           "num_episodes": 100, "seed": 7, **trainer})
    for tag in ("runner", "tagger"):
        cfg["policy"][tag]["model"]["fc_dims"] = [16, 16]
    cfg["saving"].update({"metrics_log_freq": 10**9,
                          "model_params_save_freq": 10**9})
    return cfg


def _trainer(tmp_path, name, **trainer):
    return port_train.setup_trainer(
        copy.deepcopy(_small_tag_continuous(**trainer)), verbose=False,
        results_dir=str(tmp_path / name), device="cpu")


class _CountingClock:
    """The trainer's clock, its marks counted."""

    def __init__(self, clock):
        self.clock, self.marks = clock, 0

    def mark(self):
        self.marks += 1
        return self.clock.mark()

    def ms(self, start, stop):
        return self.clock.ms(start, stop)


@pytest.mark.parametrize("programmed", [False, True])
def test_tracing_off_stores_nothing_and_makes_no_event(programmed, tmp_path,
                                                       monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("made or begun with tracing off")

    trainer = _trainer(tmp_path, "off")
    trainer._programmed = programmed  # the CPU's programs call their bodies
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(trace, "begin", refuse)
    carry = {"x": torch.zeros(3)}
    program = Program(lambda: carry["x"].add_(1.0), carry, "cpu",
                      name="stub")
    for _ in range(3):
        program()
    trainer.num_iters = 3
    trainer.train()
    assert trainer.iters_completed == 3
    assert trace.spans() == []
    counters = trace.counters()
    assert (counters["replays"], counters["syncs"], counters["dropped"]) == (
        {}, 0, 0)


# ------------------------------------------------- three traced iterations
def test_three_traced_train_iterations_on_the_cpu(tmp_path):
    trainer = _trainer(tmp_path, "on", dispatch_sync_freq=2)
    trainer._programmed = True  # through the programs, which call bodies
    trainer.clock = clock = _CountingClock(trainer.clock)
    T = trainer.training_batch_size_per_env
    trainer.num_iters = 3
    trace.enable("cpu")
    trainer.train()
    trace.disable()
    assert clock.marks == 3 * 3  # start, the rollout's end, the update's end

    records = trace.spans()
    by_id = {r["id"]: r for r in records}
    named = _by_name(records)
    iterations = named["train.iteration"]
    assert [r["unit"] for r in iterations] == [0, 1, 2]
    assert all(r["parent"] == 0 for r in iterations)
    tags = sorted(trainer.policies_to_train)
    for i, it in enumerate(iterations):
        children = [r for r in records if r["parent"] == it["id"]]
        phases = [r["name"] for r in children
                  if r["name"] in ("rollout", "update")]
        assert phases == ["rollout", "update"]
        rollout = next(r for r in children if r["name"] == "rollout")
        update = next(r for r in children if r["name"] == "update")
        calls = [r for r in records if r["parent"] == rollout["id"]]
        assert [r["name"] for r in calls] == ["program.call"] * T
        assert {r["args"]["program"] for r in calls} == {"rollout step"}
        assert all(r["unit"] == i for r in calls)
        inside = [r for r in records if r["parent"] == update["id"]]
        variant = "full" if i in (0, 2) else "hot"  # first and last: full
        passes = trainer.update_options[tags[0]].passes
        want = []
        for tag in tags:
            want += [("update.begin", None)] + [
                ("program.call", f"{tag} update pass ({variant})")] * passes
        assert [(r["name"], (r["args"] or {}).get("program"))
                for r in inside] == want
        # every program call holds its storage check
        for call in calls:
            kids = [r["name"] for r in records if r["parent"] == call["id"]]
            assert kids == ["program.check_buffers"]
        # rollout and update are phase_ms, from the same marks
        got = (1e-6 * (rollout["d1"] - rollout["d0"]),
               1e-6 * (update["d1"] - update["d0"]))
        assert got == pytest.approx(trainer.phase_ms[i], abs=1e-5)
        assert rollout["d1"] == update["d0"]
    # the second iteration syncs (dispatch_sync_freq 2), the last logs
    assert [by_id[r["parent"]]["unit"] for r in named["train.sync"]] == [1]
    assert [by_id[r["parent"]]["unit"]
            for r in named["train.log_point"]] == [2]
    counters = trace.counters()
    assert counters["syncs"] >= 1 and counters["dropped"] == 0
    assert counters["update_passes"] == {
        f"{tag} update pass (hot)": trainer.update_options[tag].passes
        for tag in tags}
    rows = trace.summary()["spans"]
    assert rows["program.call"]["count"] == 3 * (T + 2)
    assert rows["rollout"]["device_ms"] == pytest.approx(
        sum(r for r, _ in trainer.phase_ms), abs=1e-4)


# ------------------------------------------------------ the profiler's view
def test_spans_are_profiler_ops_of_their_names_within_their_extents(
        tmp_path):
    from torch.profiler import ProfilerActivity, profile

    carry = {"x": torch.zeros(64)}
    program = Program(lambda: carry["x"].mul_(1.5).add_(1.0), carry, "cpu",
                      name="stub")
    trace.enable("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        offset = time.time_ns() - time.perf_counter_ns()
        for _ in range(3):
            program()
        span = trace.begin("outside a program")
        trace.end(span)
    trace.disable()
    ops = {}
    for ev in prof.profiler.kineto_results.events():
        ops.setdefault(ev.name(), []).append(
            (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    records = trace.spans()
    assert {r["name"] for r in records} == {
        "program.call", "program.check_buffers", "outside a program"}
    slack = 1 * MS  # the two clocks' offset, read once
    for name, spans in _by_name(records).items():
        ranges = sorted(ops.get(name, []))
        assert len(ranges) == len(spans), name
        for r, (s, e) in zip(sorted(spans, key=lambda r: r["t0"]), ranges):
            assert r["t0"] + offset - slack <= s <= e <= (
                r["t1"] + offset + slack), name
            assert e - s <= r["t1"] - r["t0"]


def test_chrome_export_holds_every_span_and_the_counters(tmp_path):
    trace.enable("cpu")
    outer = trace.begin("outer", unit=4, args={"what": "a test"})
    inner = trace.begin("inner", event=time.perf_counter())
    trace.end(inner, event=time.perf_counter())
    trace.end(outer)
    stub = _Captured("stub", 3, memset=1, replays=5)
    trace.record_capture(stub)
    path = trace.export_chrome(str(tmp_path / "trace.json"))
    with open(path, encoding="utf-8") as f:
        exported = json.load(f)
    spans = [e for e in exported["traceEvents"] if e["ph"] == "X"]
    assert sorted((e["name"], e["tid"]) for e in spans) == [
        ("inner", 0), ("inner", 1), ("outer", 0)]
    outer_event = next(e for e in spans if e["name"] == "outer")
    assert outer_event["args"] == {"id": outer, "parent": 0, "unit": 4,
                                   "what": "a test"}
    assert exported["otherData"]["replays"] == {"stub": 5}
    assert exported["otherData"]["graph_nodes"]["stub"]["kernel"] == 3
    assert "knn_launches" in exported["otherData"]


def test_profile_trace_carries_the_spans(tmp_path):
    trainer = _trainer(tmp_path, "profiled")
    path = trainer.profile_trace(str(tmp_path / "trace"), iterations=1)
    with open(path, encoding="utf-8") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert "update.begin" in names
    assert not trace.ON  # off again, as it was


def test_sync_counter_counts_and_times(monkeypatch):
    monkeypatch.setattr(trace, "_now", _FakeClock([0, 0, 2 * MS, 5 * MS,
                                                   6 * MS, 7 * MS]))
    trace.enable("cpu")
    trace.count_sync("cpu")
    trace.count_sync("cpu")
    counters = trace.counters()
    assert (counters["syncs"], counters["sync_ms"]) == (2, 3.0)
    trace.enable("cpu")  # what is counted while on starts again
    assert trace.counters()["syncs"] == 0


def test_replays_are_read_from_the_live_programs():
    a, b = _Captured("a", 3), _Captured("b", 4)
    trace.record_capture(a)
    trace.record_capture(b)
    a.replays += 2
    assert trace.counters()["replays"] == {"a": 2, "b": 0}
    again = _Captured("a", 3, replays=1)  # a's graph built again
    trace.record_capture(again)
    assert trace.counters()["replays"] == {"a": 1, "b": 0}
    del again, b  # a program dropped: its replays go with it
    assert trace.counters()["replays"] == {}
    # its graph's nodes stay, for the readers
    assert trace.counters()["graph_nodes"]["b"]["kernel"] == 4


def test_counters_keep_the_physics_launches_apart_from_the_knn_ones():
    from warpdrive_tpu_torch.ops import knn_obs, tag_physics

    tag_physics.reset_launch_counts()
    knn_obs.reset_launch_counts()
    tag_physics.LAUNCH_COUNTS["tag_physics"] += 3
    try:
        counters = trace.counters()
        assert counters["physics_launches"] == {"tag_physics": 3}
        assert counters["knn_launches"] == dict.fromkeys(
            knn_obs.LAUNCH_COUNTS, 0)
    finally:
        tag_physics.reset_launch_counts()


# ------------------------------------- chip_smoke.py's profiled windows
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("windows,want", [
    ([(10, 10)], 1),
    ([(0, 10), (8, 10), (10, 10)], 3),
    ([(9, 10)] * 3, "recorded fewer"),
    ([(11, 10)], "11 profiled"),
    ([(9, 9)], "9 kNN launches credited"),
])
def test_a_window_with_dropped_records_is_profiled_again(
        monkeypatch, windows, want):
    """chip_smoke.py's ``_profiled_credited`` on stub windows of (profiled,
    credited): a window whose profiler recorded fewer kNN kernels is
    profiled again, after the reset, up to ``PROFILE_WINDOWS`` times; more
    recorded than credited, or credited launches other than the calls,
    fail at once."""
    smoke = _chip_smoke()
    assert smoke.PROFILE_WINDOWS == 3
    left, resets = list(windows), []
    monkeypatch.setattr(smoke, "_profiled",
                        lambda fn, calls, host: (1.0, *left.pop(0)))
    run = lambda: smoke._profiled_credited(  # noqa: E731
        "stub", None, 10, reset=lambda: resets.append(1))
    if isinstance(want, str):
        with pytest.raises(AssertionError, match=want):
            run()
    else:
        assert run() == (1.0, 10, 10, want)
        assert len(resets) == want and not left


# ----------------------------------------------- the benchmark's readers
def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_step_kernels_reader_on_hand_built_counters():
    reader = _reader("step_kernels.sim")
    gpu = {"platform": "gpu", "envs": 1024}
    assert reader.read({}) is None and reader.read({"platform": "cpu"}) is None
    assert reader.read(gpu) is None  # nothing captured
    trace.record_capture(_Captured("captured env_only_step", 71, memcpy=2,
                                   memset=1))
    trace.record_capture(_Captured("rollout step", 500))
    assert reader.read(gpu) == 71
    assert reader.read({"platform": "cpu"}) is None


def test_update_kernels_reader_on_hand_built_counters():
    reader = _reader("update_kernels.train")
    gpu = {"platform": "gpu"}
    assert reader.read({}) is None and reader.read(gpu) is None
    trace.record_update_passes("runner update pass (hot)", 1)
    trace.record_update_passes("tagger update pass (hot)", 4)
    trace.record_capture(_Captured("runner update pass (hot)", 300,
                                   memcpy=1, memset=2))
    assert reader.read(gpu) is None  # the tagger's not captured yet
    trace.record_capture(_Captured("tagger update pass (hot)", 250))
    trace.record_capture(_Captured("tagger update pass (full)", 400))
    assert reader.read(gpu) == 300 * 1 + 250 * 4
    assert reader.read({"platform": "cpu"}) is None


# ------------------------------------------------------------- on a card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _profiled_device_ops(fn, replays: int):
    """``{"kernel", "memcpy", "memset", "long_fills": count}`` of the device
    operations the profiler saw in each of ``replays`` calls of ``fn``, one
    profiled call at a time.  A graph's memcpy nodes run as CUDA's
    ``memcpy32_post`` kernels or as copies (``Memcpy ...``); ``long_fills``
    counts the int64 fills among the kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(replays):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts = {"kernel": 0, "memcpy": 0, "memset": 0, "long_fills": 0}
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            name = ev.name()
            if name.startswith("Memcpy") or name == "memcpy32_post":
                counts["memcpy"] += 1
            elif name.startswith("Memset"):
                counts["memset"] += 1
            else:
                counts["kernel"] += 1
                counts["long_fills"] += "FillFunctor<long>" in name
        seen.append(counts)
    return seen


def _assert_nodes_match_the_profiler(label, program, seen):
    """The graph's kernel nodes are the kernels the profiler saw a replay,
    but for the replay's own fills of the seed and offset of each
    generator the graph draws from (two int64 fills, outside the graph);
    its memcpy and memset nodes are the copies and sets it saw."""
    nodes = program.graph_nodes
    assert nodes["other"] == 0, (label, nodes)
    # the profiler drops an event now and then (PERF.md): most replays see
    # every operation, none sees more
    for kind in ("kernel", "memcpy", "memset"):
        counts = [s[kind] for s in seen]
        want = max(counts)
        assert counts.count(want) >= len(counts) - 1, (label, kind, seen)
        if kind == "kernel":
            extra = want - nodes["kernel"]
            assert extra in range(0, 2 * len(program.generators) + 1, 2), (
                label, nodes, seen)
            assert max(s["long_fills"] for s in seen) >= extra
        else:
            assert want == nodes[kind], (label, kind, nodes, seen)


@pytest.mark.cuda
def test_graph_kernel_nodes_match_the_profiler_on_card(card):
    from warpdrive_tpu_torch.presets import build_flagship, captured_loop

    system = build_flagship(num_envs=64, fc_dims=(32, 32), seed=3,
                            knn_algorithm="pallas_flat_exact", device=card)
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    loop = captured_loop(system, "env_only_step", gen)
    for _ in range(3):
        loop()
    nodes = loop.graph_nodes
    assert trace.counters()["graph_nodes"][loop.name] == nodes
    assert trace.counters()["replays"][loop.name] == loop.replays == 2
    seen = _profiled_device_ops(loop, 3)
    _assert_nodes_match_the_profiler("env_only_step", loop, seen)
    # the loop draws its actions and resets from its generator
    assert max(s["kernel"] for s in seen) == nodes["kernel"] + 2


@pytest.mark.cuda
def test_hot_update_pass_nodes_match_the_profiler_on_card(card, tmp_path):
    cfg = _small_tag_continuous()
    trainer = port_train.setup_trainer(cfg, verbose=False,
                                       results_dir=str(tmp_path / "card"),
                                       device=card)
    trainer.num_iters = 3  # full, hot (captured), full
    trainer.train()
    counters = trace.counters()
    for tag in sorted(trainer.policies_to_train):
        hot = trainer._programs[tag, "hot"]
        assert counters["update_passes"][hot.name] == (
            trainer.update_options[tag].passes)
        assert counters["graph_nodes"][hot.name] == hot.graph_nodes
        # one pass: replayed alone, it reads no row of a pass table
        assert trainer.update_options[tag].passes == 1
        _assert_nodes_match_the_profiler(hot.name, hot,
                                         _profiled_device_ops(hot, 3))


def test_counters_keep_the_sampler_launches_apart_from_the_knn_ones():
    """The draw kernel's family ``sampler`` is registered on its own, apart
    from ``knn``, and the tracer's summary lists ``sampler_launches``."""
    from warpdrive_tpu_torch.ops import cuda_build, gumbel_sample, knn_obs

    assert cuda_build.LAUNCH_COUNTS["sampler"] is gumbel_sample.LAUNCH_COUNTS
    assert not set(gumbel_sample.LAUNCH_COUNTS) & set(knn_obs.LAUNCH_COUNTS)
    gumbel_sample.reset_launch_counts()
    knn_obs.reset_launch_counts()
    gumbel_sample.LAUNCH_COUNTS["gumbel_sample"] += 2
    try:
        counters = trace.summary()["counters"]
        assert counters["sampler_launches"] == {"gumbel_sample": 2}
        assert counters["knn_launches"] == dict.fromkeys(
            knn_obs.LAUNCH_COUNTS, 0)
    finally:
        gumbel_sample.reset_launch_counts()


def test_counters_keep_the_reset_launches_apart_from_the_others():
    """The reset kernel's family ``reset`` is registered on its own, apart
    from ``knn``, ``physics`` and ``sampler``, and the tracer's summary
    lists ``reset_launches``."""
    from warpdrive_tpu_torch.ops import (
        cuda_build,
        gumbel_sample,
        knn_obs,
        reset,
        tag_physics,
    )

    assert cuda_build.LAUNCH_COUNTS["reset"] is reset.LAUNCH_COUNTS
    for other in (knn_obs, tag_physics, gumbel_sample):
        assert not set(reset.LAUNCH_COUNTS) & set(other.LAUNCH_COUNTS)
        other.reset_launch_counts()
    reset.reset_launch_counts()
    reset.LAUNCH_COUNTS["reset_when_done"] += 4
    try:
        counters = trace.summary()["counters"]
        assert counters["reset_launches"] == {"reset_when_done": 4}
        assert counters["knn_launches"] == dict.fromkeys(
            knn_obs.LAUNCH_COUNTS, 0)
        assert counters["physics_launches"] == {"tag_physics": 0}
        assert counters["sampler_launches"] == {"gumbel_sample": 0}
    finally:
        reset.reset_launch_counts()
