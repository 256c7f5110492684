"""
The ``train`` window: the port's ``TrainerBase.train()`` as users run it.

Set-up builds the trainer from the configuration file (``setup_trainer``,
the CLI's builder), puts the benchmark's parameters, made on the device
from the seed, into its models, and runs its first ``compare_steps``
iterations through ``train()`` itself, recording what the reference needs.
On a card the first call of each program runs its body and captures it,
and later calls replay the graph: the first step runs the full update pass
and captures it, the second does so for the hot pass, the third replays
the hot pass (as every window iteration but the log points does) and the
fourth replays the full one at its log point.  It records each step's
batch (actions, rewards, done flags, a sample of observation rows and
every row's checksum), the losses the full steps report, Adam's first
moment after step 1, and the parameters after the last step.  That builds and captures every program the window replays;
``setup_s`` ends there.  Then it runs hot iterations until the pace is
steady (``harness.settle``), on the process's own pace.

The window is one more ``train()`` call of a fixed number of iterations
(``--seconds`` at the traffic's nominal pace), under the configuration's
``metrics_log_freq`` and ``dispatch_sync_freq``; the harness adds no sync
and no file of its own per iteration.  Its metrics:

* ``train_env_steps_per_s``: the env-steps of every iteration over the
  window's host time, which ends with ``train()``'s own closing sync;
* ``train_iter_ms_p90``: the 90th percentile of the iterations' times,
  each from its start mark on the stream (the trainer's own phase marks)
  to the next one's, the last to a mark after ``train()`` returned.

With ``--trace 1``, ``trace_units`` more hot iterations, driven as the
settling drives them (the window's steady iterations, without its few log
points), run under ``torch.profiler`` for the device's busy time and idle
gaps.
"""

from __future__ import annotations

import copy
import gc
import sys
import time

import numpy as np
import torch

from portbench import harness, measure
from portbench.harness import Run
from portbench.reference import a2c, training


class _MarkLog:
    """The trainer's clock in the window: the same marks (a CUDA event
    recorded on the stream on a card, the host clock elsewhere), taken by
    the benchmark and kept, so that every iteration's start is known."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            m = torch.cuda.Event(enable_timing=True)
            m.record()
        else:
            m = time.perf_counter()
        self.marks.append(m)
        return m

    def ms(self, start, stop) -> float:
        if self.cuda:
            return start.elapsed_time(stop)
        return 1e3 * (stop - start)


def _policies(cfg: dict, types: dict) -> dict:
    out = {}
    for tag, p in cfg["policy"].items():
        if not p.get("to_train", False):
            continue
        out[tag] = {"agent_type": types[tag], "lr": float(p["lr"]),
                    "gamma": float(p["gamma"]),
                    "vf_loss_coeff": float(p["vf_loss_coeff"]),
                    "entropy_coeff": float(p["entropy_coeff"]),
                    "max_grad_norm": (float(p["max_grad_norm"])
                                      if p.get("clip_grad_norm", True)
                                      else None)}
    return out


def _record_steps(trainer, rows: list):
    """Wrap the trainer's iteration so that each one's outputs are copied
    after it; returns the record and a function that unwraps."""
    rec = {"actions": [], "rewards": [], "done": [], "obs_rows": [],
           "obs_sums": [], "loss": [], "mu1": None}
    inner = trainer._iteration

    def iteration(timestep, full=True):
        metrics = inner(timestep, full)
        s = len(rec["actions"])
        batch = trainer._batch
        tags = sorted(trainer.policies_to_train)
        rec["actions"].append({t: batch[f"actions_{t}"].clone()
                               for t in tags})
        rec["rewards"].append({t: batch[f"rewards_{t}"].clone()
                               for t in tags})
        rec["done"].append(batch["done"].clone())
        rec["obs_rows"].append({r: {t: batch[f"obs_{t}"][r].clone()
                                    for t in tags} for r in rows[s]})
        rec["obs_sums"].append({t: training.row_sums(batch[f"obs_{t}"])
                                for t in tags})
        rec["loss"].append({t: metrics[t]["Total loss"].detach().clone()
                            for t in tags if metrics and t in metrics})
        if s == 0:
            rec["mu1"] = {t: {n: m.clone() for n, m in
                              trainer.optimizers[t].mu.items()}
                          for t in tags}
        return metrics

    trainer._iteration = iteration

    def unwrap():
        trainer._iteration = inner

    return rec, unwrap


def run(ctx):
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer

    device = ctx.device
    cfg = copy.deepcopy(ctx.config["run_config"])
    cfg["env"]["seed"] = ctx.seeds.env
    cfg["trainer"]["seed"] = ctx.seeds.trainer
    results = ctx.scratch("results")
    cfg["saving"]["basedir"] = str(results)
    trainer = setup_trainer(cfg, results_dir=str(results / "run"),
                            verbose=False, device=device)
    ctx.lap("trainer")
    policies = _policies(cfg, ctx.config["policy_agent_types"])
    env_cfg = cfg["env"]
    fc_dims = cfg["policy"][sorted(policies)[0]]["model"]["fc_dims"]
    if any(cfg["policy"][t]["model"]["fc_dims"] != fc_dims
           for t in policies):
        raise ValueError("the train driver takes one trunk for every policy")
    k = int(env_cfg["num_other_agents_observed"])
    heads = (int(env_cfg["num_acceleration_levels"]) + 1,
             int(env_cfg["num_turn_levels"]) + 1)

    # the benchmark's parameters, made on the device from the seed
    gen = torch.Generator(device=device)
    gen.manual_seed(ctx.seeds.weights)
    theta0 = {}
    with torch.no_grad():
        for tag in sorted(policies):
            shapes = a2c.param_shapes(8 * k + 1, fc_dims, heads)
            theta0[tag] = a2c.make_params(shapes, gen, device)
            for name, p in trainer.models[tag].named_parameters():
                p.copy_(theta0[tag][name])
    start = {n: v.clone() for n, v in trainer._env_state.items()}

    # the first steps, through train() itself
    steps = int(ctx.traffic["compare_steps"])
    T = trainer.training_batch_size_per_env
    rng = np.random.default_rng(ctx.seeds.sample)
    n_rows = min(int(ctx.traffic["obs_rows_per_step"]), T)
    rows = [sorted(int(r) for r in rng.choice(T, n_rows, replace=False))
            for _ in range(steps)]
    rec, unwrap = _record_steps(trainer, rows)
    trainer.num_iters = steps
    trainer.train()
    unwrap()
    theta = {tag: {n: p.detach().clone() for n, p in
                   trainer.models[tag].named_parameters()}
             for tag in policies}

    harness.sync(device)
    ctx.lap("first steps")
    setup_s = time.perf_counter() - ctx.t_start
    steps_per_iter = trainer.training_batch_size_per_env * trainer.num_envs

    def hot(units):
        for _ in range(units):
            trainer._iteration(trainer.current_timestep, full=False)
            trainer.current_timestep += steps_per_iter
            trainer.iters_completed += 1

    def chunk():
        t = time.perf_counter()
        hot(int(ctx.traffic["settle_chunk_units"]))
        harness.sync(device)
        return time.perf_counter() - t

    settled = harness.settle(ctx, chunk)
    trainer._resolve_phase_marks()

    # the window
    n = ctx.units()
    log = _MarkLog(device)
    trainer.clock = log
    trainer.num_iters = trainer.iters_completed + n
    resolved = len(trainer.phase_ms)
    harness.sync(device)
    t0 = time.perf_counter()
    trainer.train()
    end = log.mark()
    harness.sync(device)
    window_s = time.perf_counter() - t0
    if len(log.marks) != 3 * n + 1:
        raise RuntimeError(f"{len(log.marks) - 1} clock marks in {n} "
                           "iterations; the window reads three an iteration "
                           "(start, the rollout's end, the update's end)")
    starts = log.marks[0:3 * n:3] + [end]
    iter_ms = [log.ms(a, b) for a, b in zip(starts, starts[1:])]
    rows_per_iter = steps_per_iter * trainer.engine.n_agents
    print(f"portbench: {settled}; {n} iterations, ms min "
          f"{min(iter_ms):.3f} median {measure.percentile(iter_ms, 50):.3f} "
          f"p90 {measure.percentile(iter_ms, 90):.3f} max {max(iter_ms):.3f}; "
          f"window {window_s:.3f} s; ms by iteration "
          + " ".join(f"{m:.0f}" for m in iter_ms), file=sys.stderr)
    e2e = {"setup_s": setup_s,
           "train_env_steps_per_s": n * steps_per_iter / window_s,
           "train_iter_ms_p90": measure.percentile(iter_ms, 90)}
    info = {"iter_ms": iter_ms,
            "phase_ms": trainer.phase_ms[resolved:resolved + n],
            "precision": ctx.config["precision"]["matmul"],
            "row_flops": {
                "forward": measure.mlp_forward_flops(8 * k + 1, fc_dims,
                                                     sum(heads) + 1),
                "update": measure.mlp_update_flops(8 * k + 1, fc_dims,
                                                   sum(heads) + 1)},
            "rows_per_iter": rows_per_iter}

    trace = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        harness.sync(device)
        with profile(activities=activities) as prof:
            with record_function(measure.WINDOW_MARK):
                hot(int(ctx.traffic["trace_units"]))
                harness.sync(device)
        trace = measure.summarize(*measure.profile_events(prof))
        info["profile"] = trace

    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    trainer.release_programs()
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the first steps
    t_ref = time.perf_counter()
    prog = {"start": start, "theta0": theta0, "theta": theta, **rec,
            "loss": [{t: float(v) for t, v in losses.items()}
                     for losses in rec["loss"]]}
    ref = training.follow(prog, env_cfg, ctx.seeds.env, policies, fc_dims)
    numbers = training.judge(prog, ref, policies)
    print(f"portbench: reference {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    controls = None
    if ctx.control:
        controls = {kind: training.control(kind, prog, env_cfg,
                                           ctx.seeds.env, policies, fc_dims,
                                           ref)
                    for kind in training.CONTROLS}
    return Run(e2e=e2e, numbers=numbers, attempted=n, failed=0,
               memory_peak_bytes=memory, info=info, trace=trace,
               control=controls)
