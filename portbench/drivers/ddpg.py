"""
The ``ddpg`` window: the port's ``TrainerDDPG.train()`` as users run it.

Set-up builds the trainer from the configuration file (``setup_trainer``,
the CLI's builder) and puts the benchmark's parameters, made on the device
from the seed, into its nets and their targets (which start as copies).
It runs the first ``compare_steps`` iterations through ``train()`` itself,
with log points at the second and the fourth, so that they cross the
warm-up gate as a run does and call every update program: on a card the
first iteration captures the warm update (the window holds ``T`` of its
``T + n - 1`` rows, nothing moves), the second captures the full one (the
window is full), the third the hot one, and the fourth replays the full
one; the noise draw, the rollout step and the append are captured at the
first and replayed after.  Then hot iterations up to ``reset_iteration``,
whose last step ends every episode and resets every env from the reset
pool; it runs hot, replaying the hot update's graph.  For these iterations
it records what the reference needs (each iteration's OU noise, the
generator's state before each rollout step, the rows, the losses the full
and warm updates report, the nets, targets and env state after it, and
the carry before ``reset_iteration``).  That builds and captures every
program the window replays; ``setup_s`` ends there.  Then it runs hot
iterations until the pace is steady (``harness.settle``).

The window is one more ``train()`` call of a fixed number of iterations
(``--seconds`` at the traffic's nominal pace), under the configuration's
``metrics_log_freq``, ``model_params_save_freq`` and ``dispatch_sync_freq``;
the harness adds no sync and no file of its own per iteration.  Its metric
``train_env_steps_per_s`` is the env-steps of every iteration over the
window's host time, which ends with ``train()``'s own closing sync; the
trainer's phase marks (``drivers/train.py:_MarkLog``) time each iteration
and its phases.

With ``--trace 1``, ``trace_units`` more hot iterations, driven as the
settling drives them, run under ``torch.profiler`` for the device's busy
time and idle gaps; then as many again under the port's tracer
(``core/trace.py``) for the host's time outside the graph replays, the
gaps between replays and the launches an iteration.
"""

from __future__ import annotations

import copy
import gc
import sys
import time

import torch

from portbench import ddpg_ops, harness, measure
from portbench.drivers.train import _MarkLog
from portbench.harness import Run
from portbench.reference import a2c, ddpg, ddpg_training
from warpdrive_tpu_torch.utils.constants import Constants

_NETS = ("actor", "critic")


def _params(module) -> dict:
    return {n: p.detach().clone() for n, p in module.named_parameters()}


class _Recorder:
    """What the reference needs of the iterations run while ``on``: a
    wrapper of the trainer's iteration that copies its outputs after it,
    and of its rollout step (the captured program where the trainer has
    built it, else the method) that keeps the generator's state before
    each call, the state its reset draw starts from."""

    def __init__(self, trainer, tag: str):
        self.trainer, self.tag = trainer, tag
        self.on = False
        self.stretches = []
        self._undo = []
        inner_iteration = trainer._iteration

        def iteration(timestep, full=True):
            if not self.on:
                return inner_iteration(timestep, full)
            record = {"timestep": int(timestep), "gen": []}
            self.stretches[-1]["iterations"].append(record)
            metrics = inner_iteration(timestep, full)
            self._after(record, metrics)
            return metrics

        trainer._iteration = iteration
        self._undo.append(lambda: delattr(trainer, "_iteration"))
        if trainer._programmed:
            trainer._build_programs()
            owner, inner_step = trainer._programs, trainer._programs["rollout"]

            def restore():
                if trainer._programs is not None:
                    trainer._programs["rollout"] = inner_step
        else:
            owner, inner_step = None, trainer._rollout_step

            def restore():
                delattr(trainer, "_rollout_step")

        def step():
            if self.on:
                self.stretches[-1]["iterations"][-1]["gen"].append(
                    trainer.generator.get_state())
            return inner_step()

        if owner is None:
            trainer._rollout_step = step
        else:
            owner["rollout"] = step
        self._undo.append(restore)

    def begin(self, carry=None):
        """Record from here on, a new stretch of iterations."""
        self.stretches.append({"carry": carry, "iterations": []})
        self.on = True

    def unwrap(self):
        """Stop recording and take the wrappers off the trainer."""
        self.on = False
        for undo in self._undo:
            undo()
        self._undo, self.trainer = [], None

    def _after(self, record: dict, metrics: dict):
        trainer, tag = self.trainer, self.tag
        rows = trainer._rows
        state = trainer._env_state
        record.update({
            "noise": trainer._noise[tag].clone(),
            "obs": rows[f"obs_{tag}"].clone(),
            "actions": rows[f"actions_{tag}"].clone(),
            "rewards": rows[f"rewards_{tag}"].clone(),
            "done": rows["done"].clone(),
            "critic_loss": None, "actor_loss": None,
            "nets": {net: _params(trainer.nets[net][tag]) for net in _NETS},
            "targets": {net: _params(trainer.targets[net][tag])
                        for net in _NETS},
            "state": state["state"].clone(),
            "timestep_after": state[Constants.TIMESTEP].clone()})
        if metrics and tag in metrics:
            record["critic_loss"] = float(metrics[tag]["Critic loss"])
            record["actor_loss"] = float(metrics[tag]["Actor loss"])

    def carry(self) -> dict:
        """The trainer's carry as it stands: what the next iteration
        reads."""
        trainer, tag = self.trainer, self.tag
        state = trainer._env_state
        return {
            "state": state["state"].clone(),
            "timestep": state[Constants.TIMESTEP].clone(),
            "ou": trainer._ou[tag].clone(),
            "window": {key: trainer._window[f"{key}_{tag}"].clone()
                       for key in ("obs", "actions", "rewards")}
            | {"done": trainer._window["done"].clone()},
            "filled": trainer.filled,
            "nets": {net: _params(trainer.nets[net][tag]) for net in _NETS},
            "targets": {net: _params(trainer.targets[net][tag])
                        for net in _NETS},
            "adam": {net: trainer.optimizers[net][tag].state_dict()
                     for net in _NETS}}


def _tracer_slice(trainer, hot, units: int, device) -> dict:
    """``units`` hot iterations under the port's tracer: the slice's host
    ms, the rows of ``trace.summary()`` the readers take, the replays of
    each program in the slice, its graphs' kernel nodes and the host's
    scalar fills (None where the program counts none)."""
    from warpdrive_tpu_torch.core import trace

    before = dict(trace.counters()["replays"])
    trace.enable(device)
    t0 = time.perf_counter()
    hot(units)
    host_ms = 1e3 * (time.perf_counter() - t0)
    summary = trace.summary()  # waits for the card
    trace.disable()
    spans, counters = summary["spans"], summary["counters"]
    keep = {"program.replay": ("host_ms", "gap_ms", "device_span_ms"),
            "program.check_buffers": ("host_ms",),
            "ddpg.schedules": ("host_ms",)}
    return {"iterations": units, "host_ms": host_ms,
            "spans": {name: {k: spans[name][k] for k in keys}
                      for name, keys in keep.items() if name in spans},
            "replays": {name: n - before.get(name, 0)
                        for name, n in counters["replays"].items()},
            "kernel_nodes": {name: nodes["kernel"] for name, nodes
                             in counters["graph_nodes"].items()},
            "scalar_writes": counters.get("scalar_writes")}


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
    (tag,) = trainer.policies_to_train
    model = cfg["policy"][tag]["model"]
    F = int(trainer.obs_space[tag].shape[-1])
    C = int(trainer.act_space[tag].shape[-1])
    T, W = trainer.training_batch_size_per_env, trainer.buffer_capacity
    E = trainer.num_envs
    steps = int(ctx.traffic["compare_steps"])
    last = int(ctx.traffic["reset_iteration"])
    if (last * T) % trainer.episode_length or last <= steps:
        raise ValueError(f"iteration {last} of {T} steps ends no episode of "
                         f"{trainer.episode_length} after the first {steps}")

    # the benchmark's parameters, made on the device from the seed
    gen = torch.Generator(device=device)
    gen.manual_seed(ctx.seeds.weights)
    shapes = {
        "actor": ddpg.mlp_shapes(F, model["actor"]["fc_dims"], "policy_head",
                                 C),
        "critic": ddpg.mlp_shapes(F + C, model["critic"]["fc_dims"],
                                  "q_head", 1)}
    theta0 = {net: a2c.make_params(shapes[net], gen, device)
              for net in _NETS}
    with torch.no_grad():
        for net in _NETS:
            for module in (trainer.nets[net][tag], trainer.targets[net][tag]):
                for name, p in module.named_parameters():
                    p.copy_(theta0[net][name])
    state = trainer._env_state
    start = {"state": state["state"].clone(),
             "timestep": state[Constants.TIMESTEP].clone(),
             "done": state[Constants.DONE].clone()}
    pool = trainer.engine.store.pools.get("state")
    steps_per_iter = T * E

    def hot(units):
        for _ in range(units):
            trainer._iteration(trainer.current_timestep, full=False)
            trainer.current_timestep += steps_per_iter
            trainer.iters_completed += 1

    # the first steps, through train() itself: log points at the second
    # and the fourth make them warm, full, hot, full
    rec = _Recorder(trainer, tag)
    rec.begin()
    log_freq = trainer.metrics_log_freq
    trainer.metrics_log_freq = 2
    trainer.num_iters = steps
    trainer.train()
    trainer.metrics_log_freq = log_freq
    rec.on = False
    hot(last - 1 - steps)
    rec.begin(rec.carry())
    hot(1)  # its last step ends every episode
    rec.unwrap()

    harness.sync(device)
    ctx.lap("first steps")
    setup_s = time.perf_counter() - ctx.t_start

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
    print(f"portbench: {settled}; {n} iterations, ms min "
          f"{min(iter_ms):.4f} median {measure.percentile(iter_ms, 50):.4f} "
          f"p90 {measure.percentile(iter_ms, 90):.4f} max "
          f"{max(iter_ms):.4f}; window {window_s:.3f} s", file=sys.stderr)
    e2e = {"setup_s": setup_s,
           "train_env_steps_per_s": n * steps_per_iter / window_s}
    info = {"iter_ms": iter_ms,
            "phase_ms": trainer.phase_ms[resolved:resolved + n],
            "precision": ctx.config["precision"]["matmul"],
            "iteration_ops": ddpg_ops.iteration_ops(
                F, model["actor"]["fc_dims"], model["critic"]["fc_dims"], C,
                T, W, E * trainer.engine.n_agents)}

    trace = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        units = int(ctx.traffic["trace_units"])
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        harness.sync(device)
        with profile(activities=activities) as prof:
            with record_function(measure.WINDOW_MARK):
                hot(units)
                harness.sync(device)
        trace = measure.summarize(*measure.profile_events(prof))
        info["profile"] = trace
        harness.sync(device)
        info["tracer"] = tracer = _tracer_slice(trainer, hot, units, device)
        spans, nodes = tracer["spans"], tracer["kernel_nodes"]
        print("portbench: tracer slice, host ms an iteration: "
              + " ".join(f"{name} {spans[name]['host_ms'] / units:.4f}"
                         for name in spans)
              + f"; all {tracer['host_ms'] / units:.4f}; scalar fills "
              f"{tracer['scalar_writes']}; kernel nodes x replays: "
              + ", ".join(f"{name} {nodes.get(name)} x {k}"
                          for name, k in tracer["replays"].items() if k),
              file=sys.stderr)

    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    trainer.release_programs()
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the compared iterations
    t_ref = time.perf_counter()
    prog = {"start": start, "pool": pool, "theta0": theta0,
            "stretches": rec.stretches}
    ref = ddpg_training.follow(prog, cfg, ctx.seeds.env)
    numbers = ddpg_training.judge(prog, ref)
    print(f"portbench: reference {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    controls = None
    if ctx.control:
        controls = {kind: ddpg_training.control(kind, prog, cfg,
                                                ctx.seeds.env, ref)
                    for kind in ddpg_training.CONTROLS}
    return Run(e2e=e2e, numbers=numbers, attempted=n, failed=0,
               memory_peak_bytes=memory, info=info, trace=trace,
               control=controls)
