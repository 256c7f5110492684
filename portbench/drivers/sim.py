"""
The ``sim`` window: the port's captured env-only loop step, replayed back
to back.

Set-up builds the system from the configuration file
(``presets.build_flagship``), keeps its first state for the start's check,
captures ``presets.captured_loop(system, "env_only_step", generator)``
(random actions, the kNN observation, physics and rewards, the auto-reset;
one CUDA graph a step) and replays it ``warmup_units`` times; ``setup_s``
ends there.  Then it replays it until the pace is steady
(``harness.settle``, on the process's own pace).

The window replays it a fixed number of times (``--seconds`` at the
traffic's nominal pace); the host waits for the device only at its end.
Before each of ``samples`` steps drawn from the seed it copies the loop's
state and zeroes its observation checksum, and after the step it copies
the state and the checksum, all on the stream (no sync), for the reference
to judge: the checksum is the sum of the observation that the step's own
kNN kernel (K1, inside the replayed graph) produced.
``sim_env_steps_per_s`` is the steps times the envs over the window's host
time.  With ``--trace 1``, ``trace_units`` more replays run under
``torch.profiler``.

After the window the program observes each recorded state once more
(``engine.observe``, the same kernel called outside the graph): a second
witness, entry by entry, of what the checksum judges as a sum.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench import harness, measure
from portbench.harness import Run
from portbench.reference import simulation
from portbench.reference.tagenv import TagEnv


def run(ctx):
    from warpdrive_tpu_torch import presets
    from warpdrive_tpu_torch.ops import knn_obs

    device = ctx.device
    cfg = ctx.config
    env_cfg = cfg["env"]
    E = int(cfg["num_envs"])
    system = presets.build_flagship(
        num_envs=E, fc_dims=tuple(cfg["fc_dims"]), seed=ctx.seeds.env,
        knn_algorithm=env_cfg["knn_algorithm"], device=device)
    ctx.lap("system")
    start = {k: v.clone() for k, v in system["state"].items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(ctx.seeds.actions)
    loop = presets.captured_loop(system, "env_only_step", gen)
    state, checksum = loop.buffers["state"], loop.buffers["checksum"]
    for _ in range(int(ctx.traffic["warmup_units"])):
        loop()
    harness.sync(device)
    ctx.lap("warm-up")
    setup_s = time.perf_counter() - ctx.t_start

    def chunk():
        t = time.perf_counter()
        for _ in range(int(ctx.traffic["settle_chunk_units"])):
            loop()
        harness.sync(device)
        return time.perf_counter() - t

    settled = harness.settle(ctx, chunk)

    n = ctx.units()
    rng = np.random.default_rng(ctx.seeds.sample)
    picks = sorted(int(i) for i in rng.choice(
        n, min(int(ctx.traffic["samples"]), n), replace=False))
    pre = [{k: torch.empty_like(v) for k, v in state.items()} for _ in picks]
    post = [{k: torch.empty_like(v) for k, v in state.items()}
            for _ in picks]
    sums = torch.empty(len(picks), dtype=checksum.dtype, device=device)
    marks = dict(zip(picks, range(len(picks))))

    harness.sync(device)
    t0 = time.perf_counter()
    for i in range(n):
        j = marks.get(i)
        if j is None:
            loop()
            continue
        for k, v in state.items():
            pre[j][k].copy_(v)
        checksum.zero_()
        loop()
        for k, v in state.items():
            post[j][k].copy_(v)
        sums[j].copy_(checksum)
    host_s = time.perf_counter() - t0
    harness.sync(device)
    window_s = time.perf_counter() - t0
    e2e = {"setup_s": setup_s, "sim_env_steps_per_s": n * E / window_s}
    print(f"portbench: {settled}; {n} steps in {window_s:.3f} s, the host "
          f"done enqueuing at {host_s:.3f} s", file=sys.stderr)
    N = system["num_agents"]
    k = int(env_cfg["num_other_agents_observed"])
    info = {"step_ms": 1e3 * window_s / n, "envs": E, "agents": N, "k": k}

    trace = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        units = int(ctx.traffic["trace_units"])
        before = dict(knn_obs.LAUNCH_COUNTS)
        harness.sync(device)
        with profile(activities=activities) as prof:
            with record_function(measure.WINDOW_MARK):
                for _ in range(units):
                    loop()
                harness.sync(device)
        kernels, host, window = measure.profile_events(prof)
        trace = measure.summarize(kernels, host, window)
        info["profile"] = trace
        info["traced_kernels"] = [(nm, s, e) for nm, s, e in kernels
                                  if window[0] <= s <= window[1]]
        info["traced_steps"] = units
        info["credited_launches"] = knn_obs.launches_since(before)

    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    engine = system["engine"]
    with torch.no_grad():
        seen = [engine.observe(dict(p)) for p in pre]
    del loop, system, engine, state, checksum
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    env = TagEnv(env_cfg, ctx.seeds.env, E, device)
    samples = list(zip(pre, post))
    numbers = simulation.judge(samples, seen, sums.tolist(), env)
    numbers["mismatches"] += simulation.start_mismatches(start, env)
    print(f"portbench: reference {time.perf_counter() - t_ref:.3f} s over "
          f"{len(picks)} steps", file=sys.stderr)
    controls = None
    if ctx.control:
        low = TagEnv(env_cfg, ctx.seeds.env, E, device, torch.bfloat16)
        ctl_samples, ctl_obs, ctl_sums = simulation.control(samples, env,
                                                            low)
        controls = {"bfloat16": simulation.judge(ctl_samples, ctl_obs,
                                                 ctl_sums, env)}
    return Run(e2e=e2e, numbers=numbers, attempted=n, failed=0,
               memory_peak_bytes=memory, info=info, trace=trace,
               control=controls)
