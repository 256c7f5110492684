"""Drive the PyTorch port (``warpdrive_tpu_torch``) on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failure:

1. the card: name and power limit from ``nvidia-smi``, torch and CUDA
   versions, compute capability (must be 9.0, the kernels' ``sm_90a``);
2. build every kernel in ``warpdrive_tpu_torch/csrc/`` with ``nvcc``;
3. hold each kernel against its plain PyTorch version on the card: K1
   (``knn_obs_flat_exact``) on random states and on a state rolled 100
   flagship steps (0 slot mismatches and a max abs diff <= 1e-6 required);
   K2 (``knn_obs_mxu``) in both tie-break modes on random states at four
   shapes, an exact-tie lattice and a state rolled 100 steps by the training
   env (0 mismatches and max abs diff 0 required); and the CUDA flagship
   step against the same step on the CPU from the same states;
4. drive the main paths, each with the kernels' launch counts set to 0 just
   before and read just after:
   a. the flagship rollout at 1024 envs x 105 agents with ``fc_dims=(256,
      256)``: ``env_only_step`` then ``full_loop_step``; each step must
      launch K1 exactly once;
   b. A2C training of the shipped ``tag_continuous`` run config at full
      width (100 envs x 110 agents, 250 steps per iteration, ``fc_dims=(256,
      256)``) for its 10 iterations, through ``setup_trainer`` and
      ``train()``: each rollout step must launch K2 exactly once, losses must
      be finite, parameters must move and each policy must leave a
      checkpoint; then one update on the card against the same update on
      the CPU;
5. time each kernel and its plain version at the main paths' shapes, beside
   the kernel's bound.

The last three lines are the card (``nvidia-smi``'s name and power limit),
one JSON object with a record per kernel, and the result line
``{"ok": true, "device": {...}}``.  ``--profile`` adds a ``torch.profiler``
table of device time by kernel for a few steps of each loop and for one
training iteration, with the device's idle share.
"""

from __future__ import annotations

import argparse
import copy
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM data-sheet peaks (dense): HBM bytes/s and float32 FLOP/s outside
# the tensor cores
_PEAK_BYTES_PER_S = 3.35e12
_PEAK_F32_FLOPS = 67e12

DEVICE = "cuda"
NUM_ENVS = 1024
FC_DIMS = (256, 256)
MAIN_PATH_STEPS = 200
ROLLED_STEPS = 100
MAX_ABS_TOL = 1e-6
# K2 and its plain version make the same float32 operations: bit for bit
K2_MAX_ABS_TOL = 0.0
K2_SHAPES = ((100, 110, 10), (1024, 105, 10), (8, 128, 16), (6, 15, 4))
# the card's update against the CPU's on the same batch slice and state:
# float32 GEMMs and reductions sum in other orders on the two devices
# (relative gradient differences of about 1e-6), and Adam's normalized step
# turns those into parameter differences far below the learning rate
UPDATE_PARAM_TOL = 1e-5
UPDATE_ENVS = 25  # envs of the last training batch in that comparison


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _cuda_ms(fn, repeats: int, inner: int) -> float:
    """Median over ``repeats`` of the mean device time of ``inner`` calls."""
    import torch

    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def _random_knn_inputs(E, N, k, seed, device):
    """Random kNN inputs with about 20% dead agents, via the env's own
    feature build."""
    import numpy as np
    import torch

    from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous

    n_taggers = max(2, N // 20)
    env = TorchTagContinuous(
        num_taggers=n_taggers, num_runners=N - n_taggers, grid_length=20.0,
        episode_length=500, use_full_observation=False,
        num_other_agents_observed=k, knn_algorithm="pallas_flat_exact",
        seed=seed,
    )
    rng = np.random.RandomState(seed)
    f32 = np.float32
    state = {
        "loc_x": rng.uniform(0, 20, (E, N)).astype(f32),
        "loc_y": rng.uniform(0, 20, (E, N)).astype(f32),
        "speed": rng.uniform(0, 1, (E, N)).astype(f32),
        "acceleration": rng.uniform(-0.1, 0.1, (E, N)).astype(f32),
        "direction": rng.uniform(0, 2 * np.pi, (E, N)).astype(f32),
        "still_in_the_game": (rng.uniform(size=(E, N)) > 0.2).astype(np.int32),
        "_timestep_": rng.randint(0, 500, (E,)).astype(np.int32),
    }
    state = {name: torch.from_numpy(v).to(device) for name, v in state.items()}
    return _knn_args(env, state)


def _knn_args(env, state):
    feats, still_f, t_norm = env._knn_inputs(state)
    return (
        (state["loc_x"].contiguous(), state["loc_y"].contiguous(), feats,
         env._consts(feats.device)["types_f"], still_f, t_norm),
        env.num_agents,
        env.num_other_agents_observed,
    )


def _compare_knn(label, args, n_agents, k, variant="flat_exact",
                 tol=MAX_ABS_TOL):
    """Kernel vs plain on the same inputs: (slot mismatches, max abs diff)."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs

    out = knn_obs.knn_observation(*args, n_agents=n_agents, k=k,
                                  variant=variant)
    plain = knn_obs.knn_observation_reference(*args, n_agents=n_agents, k=k,
                                              packed=variant == "mxu")
    torch.cuda.synchronize()
    E, N = args[0].shape
    slots = out[..., :-1].reshape(E, N, k, 8)
    ref = plain[..., :-1].reshape(E, N, k, 8)
    mismatches = int((slots != ref).any(dim=-1).sum()) + int(
        (out[..., -1] != plain[..., -1]).sum()
    )
    max_abs = float((out - plain).abs().max())
    print(f"kernel vs plain [{variant}, {label}] E={E} N={N} k={k}: "
          f"slot mismatches {mismatches} of {E * N * k}, max abs diff "
          f"{max_abs:.3g}, finite {bool(torch.isfinite(out).all())}")
    assert torch.isfinite(out).all(), f"{label}: non-finite kernel output"
    assert mismatches == 0, f"{label}: {mismatches} slot mismatches"
    assert max_abs <= tol, f"{label}: max abs diff {max_abs}"
    return max_abs


def _lattice_knn_inputs(E, N, k, seed, device):
    """Random inputs with the agents moved onto an integer lattice, so exact
    distance ties are everywhere."""
    import numpy as np
    import torch

    args, n, kk = _random_knn_inputs(E, N, k, seed, device)
    rng = np.random.RandomState(seed)
    side = int(np.ceil(np.sqrt(N)))
    cells = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                     -1).reshape(-1, 2)
    xy = np.stack([cells[rng.permutation(len(cells))[:N]] for _ in range(E)])
    loc_x = torch.from_numpy(xy[..., 0].astype(np.float32) * 1.5).to(device)
    loc_y = torch.from_numpy(xy[..., 1].astype(np.float32) * 1.5).to(device)
    return (loc_x, loc_y) + tuple(args[2:]), n, kk


def _training_env_state(run_config, steps, seed):
    """The training env at the config's width, rolled ``steps`` steps with
    random actions on the card."""
    import torch

    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous

    env = TorchTagContinuous(**run_config["env"])
    engine = EnvEngine(env_obj=env, num_envs=run_config["trainer"]["num_envs"],
                       seed=seed, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    state = {k: v for k, v in engine.state.items()
             if k not in ("observations", "sampled_actions")}
    shape = (engine.n_envs, engine.n_agents)
    for _ in range(steps):
        actions = torch.stack(
            [torch.randint(0, int(n), shape, generator=gen, device=DEVICE)
             for n in env.action_space[0].nvec], dim=-1)
        state = engine.auto_reset(engine.step_physics(state, actions), gen)
    return env, state


def _check_k2(run_config):
    """K2 vs plain, both modes: random states at four shapes, an exact-tie
    lattice and a state rolled 100 steps by the training env.  Returns the
    largest abs diff and the rolled state's inputs."""
    max_abs = 0.0
    cases = []
    for E, N, k in K2_SHAPES:
        cases.append(("random",) + _random_knn_inputs(E, N, k, seed=N + k,
                                                       device=DEVICE))
    for E, N, k in ((100, 110, 10), (8, 128, 16)):
        cases.append(("lattice",) + _lattice_knn_inputs(E, N, k, seed=k,
                                                         device=DEVICE))
    env, state = _training_env_state(run_config, ROLLED_STEPS, seed=1)
    rolled = _knn_args(env, state)
    cases.append((f"training env rolled {ROLLED_STEPS} steps",) + rolled)
    for label, args, n, k in cases:
        for variant in ("mxu_exact", "mxu"):
            max_abs = max(max_abs, _compare_knn(label, args, n, k, variant,
                                                tol=K2_MAX_ABS_TOL))
    return max_abs, rolled


def _check_step_against_cpu(steps: int = 60):
    """One-step parity of the CUDA flagship step (kernel observation) with
    the CPU step (plain observation) from the same states, along a CUDA
    rollout of ``steps`` steps with numpy-drawn actions."""
    import numpy as np
    import torch

    from warpdrive_tpu_torch.presets import build_flagship

    gpu = build_flagship(num_envs=4, fc_dims=(8, 8), seed=5, device=DEVICE)
    cpu = build_flagship(num_envs=4, fc_dims=(8, 8), seed=5, device="cpu")
    eg, ec = gpu["engine"], cpu["engine"]
    nvec = gpu["env"].action_space[0].nvec
    rng = np.random.RandomState(5)
    state = gpu["state"]
    worst = {"obs": 0.0, "physics": 0.0}
    for t in range(steps):
        host = {k: v.cpu() for k, v in state.items()}
        obs_g, obs_c = eg.observe(state).cpu(), ec.observe(host)
        worst["obs"] = max(worst["obs"], float((obs_g - obs_c).abs().max()))
        actions = np.stack(
            [rng.randint(0, n, (4, eg.n_agents)) for n in nvec], -1
        ).astype(np.int32)
        nxt_g = eg.step_physics(state, torch.from_numpy(actions).to(DEVICE))
        nxt_c = ec.step_physics(host, torch.from_numpy(actions))
        for name, value in nxt_c.items():
            got = nxt_g[name].cpu()
            if value.dtype == torch.float32:
                worst["physics"] = max(worst["physics"],
                                       float((got - value).abs().max()))
            else:
                assert torch.equal(got, value), f"{name} differs at t={t}"
        state = eg.auto_reset(nxt_g)
    print(f"CUDA step vs CPU step, {steps} states: max abs diff obs "
          f"{worst['obs']:.3g}, physics {worst['physics']:.3g}")
    assert worst["obs"] <= MAX_ABS_TOL, worst
    assert worst["physics"] <= 1e-5, worst  # CUDA vs CPU cos/sin/sqrt ulps


def _drive_main_path(system, generator):
    """Both loops at full width; returns per-loop timings and launches."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs

    env_only = system["env_only_step"]
    full_loop = system["full_loop_step"]
    models = system["models"]
    state = system["state"]
    checksum = torch.zeros((), device=state["loc_x"].device)

    for _ in range(5):  # warm-up: allocator, library and kernel loading
        state, checksum = env_only((state, checksum), generator)
        state = full_loop(models, state, generator)
    torch.cuda.synchronize()

    knn_obs.reset_launch_counts()
    result = {}
    for name in ("env_only_step", "full_loop_step"):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(MAIN_PATH_STEPS):
            if name == "env_only_step":
                state, checksum = env_only((state, checksum), generator)
            else:
                state = full_loop(models, state, generator)
        stop.record()
        stop.synchronize()
        host_s = time.perf_counter() - t0
        ms = start.elapsed_time(stop) / MAIN_PATH_STEPS
        result[name] = {
            "ms_per_step": ms,
            "env_steps_per_s": system["num_envs"] / (ms / 1e3),
            "host_s": host_s,
            "launches_after": dict(knn_obs.LAUNCH_COUNTS),
        }
    launches = dict(knn_obs.LAUNCH_COUNTS)

    assert torch.isfinite(checksum), "non-finite observation checksum"
    for name in ("loc_x", "loc_y", "speed", "direction", "acceleration",
                 "rewards"):
        assert torch.isfinite(state[name]).all(), f"non-finite {name}"
    assert state["loc_x"].shape == (system["num_envs"], system["num_agents"])
    assert bool(((state["_done_"] == 0) | (state["_done_"] == 1)).all())
    return result, launches, state


def _drive_training(run_config):
    """The training path at the run config's width, through the CLI's
    ``setup_trainer`` and ``train()``, with the kernels' launch counts set
    to 0 just before and read just after.  Returns the trainer, the counts
    and the per-iteration times."""
    import math

    import torch

    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.training.scripts.train import setup_trainer

    results_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        knn_obs.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = setup_trainer(run_config, results_dir=results_dir,
                                verbose=False, device=DEVICE)
        setup_s = time.perf_counter() - t0
        before = {tag: {k: v.detach().clone()
                        for k, v in m.state_dict().items()}
                  for tag, m in trainer.models.items()}
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(knn_obs.LAUNCH_COUNTS)

        with open(Path(results_dir) / "results.json", encoding="utf-8") as f:
            last = json.loads(f.read().splitlines()[-1])
        for tag, metrics in last["metrics"].items():
            bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
            assert not bad, f"{tag}: non-finite metrics {bad}"
        for tag, model in trainer.models.items():
            moved = max(float((v - before[tag][k]).abs().max())
                        for k, v in model.state_dict().items())
            assert moved > 0, f"{tag}: parameters did not move"
            ckpt = Path(trainer._ckpt_path(tag, trainer.current_timestep))
            assert ckpt.is_file(), f"no checkpoint {ckpt}"
            metrics = last["metrics"][tag]
            print(f"training {tag}: largest parameter change {moved:.4g}, "
                  f"checkpoint {ckpt.name}, last metrics: total loss "
                  f"{metrics['Total loss']:.5f}, gradient norm "
                  f"{metrics['Gradient norm']:.5f}")
    finally:
        shutil.rmtree(results_dir, ignore_errors=True)
    steps = trainer.training_batch_size_per_env * trainer.num_envs
    for it, (roll_ms, upd_ms) in enumerate(trainer.phase_ms):
        print(f"training iteration {it + 1}: rollout {roll_ms:.3f} ms, "
              f"update {upd_ms:.3f} ms, "
              f"{steps / ((roll_ms + upd_ms) / 1e3):.0f} env-steps/s")
    return trainer, launches, {"setup_s": setup_s, "train_s": train_s}


def _update_card_vs_cpu(trainer):
    """One update of each trained policy on the card and on the CPU, from
    copies of the trained parameters and optimizer state, on the first
    ``UPDATE_ENVS`` envs of the last training batch.  Returns the largest
    parameter difference."""
    import torch

    from warpdrive_tpu_torch.training.trainer_a2c import (
        ClippedAdam,
        policy_update,
    )

    worst = 0.0
    timestep = trainer.current_timestep
    for tag in trainer.policies_to_train:
        batch = {k: v[:, :UPDATE_ENVS].contiguous()
                 for k, v in trainer._policy_batch(trainer._batch, tag).items()}
        lr = trainer.lr_schedules[tag].value_at(timestep)
        params = {}
        losses = {}
        for device in (DEVICE, "cpu"):
            model = copy.deepcopy(trainer.models[tag]).to(device)
            opt = ClippedAdam(dict(model.named_parameters()),
                              max_norm=trainer.optimizers[tag].max_norm)
            opt.load_state_dict(trainer.optimizers[tag].state_dict())
            metrics = policy_update(
                model, opt, trainer.algorithms[tag],
                {k: v.to(device) for k, v in batch.items()}, timestep, lr)
            losses[device] = float(metrics["Total loss"])
            params[device] = {k: v.detach().cpu()
                              for k, v in model.state_dict().items()}
        diff = max(float((params[DEVICE][k] - params["cpu"][k]).abs().max())
                   for k in params["cpu"])
        print(f"update card vs CPU [{tag}, {UPDATE_ENVS} envs x "
              f"{trainer.training_batch_size_per_env} steps]: loss "
              f"{losses[DEVICE]:.7f} vs {losses['cpu']:.7f}, max abs "
              f"parameter diff {diff:.3g} (tolerance {UPDATE_PARAM_TOL})")
        assert diff <= UPDATE_PARAM_TOL, f"{tag}: parameters differ by {diff}"
        worst = max(worst, diff)
    return worst


def _knn_bound_ms(E, N, k, d2_pairs):
    """Least time for the kNN function on the card: each input read once and
    the output written once at the HBM rate, or the distance arithmetic
    (2 sub, 2 mul, 1 add per pair) at the float32 rate, whichever is
    larger."""
    bytes_in = 4 * (3 * E * N + 5 * E * N + N + E)
    bytes_out = 4 * E * N * (8 * k + 1)
    t_bytes = (bytes_in + bytes_out) / _PEAK_BYTES_PER_S
    t_ops = 5 * d2_pairs / _PEAK_F32_FLOPS
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), bound_by, bytes_in + bytes_out


def _device_ms(prof) -> float:
    """Device time of a profiled window: the kernels' own time, summed over
    the device-side events only (a CPU op's entry repeats its kernels')."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def _profile(system, generator, trainer, wall_ms, steps=10):
    """Kernel tables of ``steps`` steps of each flagship loop and of one
    training iteration under ``torch.profiler``, and each window's device
    idle share: 1 - device time / the wall time of the same work measured
    without the profiler (``wall_ms``: per step, or per iteration), since
    the profiler slows the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = system["state"]
    checksum = torch.zeros((), device=state["loc_x"].device)
    for loop in ("env_only_step", "full_loop_step", "training iteration"):
        n = 1 if loop == "training iteration" else steps
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if loop == "training iteration":
                    trainer._iteration(trainer.current_timestep)
                elif loop == "env_only_step":
                    state, checksum = system["env_only_step"](
                        (state, checksum), generator)
                else:
                    state = system["full_loop_step"](
                        system["models"], state, generator)
            torch.cuda.synchronize()
        device_ms = _device_ms(prof) / n
        unit = "iteration" if loop == "training iteration" else "step"
        print(f"profile {loop} ({n} {unit}s): device {device_ms:.4f} ms per "
              f"{unit}, wall without the profiler {wall_ms[loop]:.4f} ms, "
              f"device idle share {100 * (1 - device_ms / wall_ms[loop]):.1f}%"
              f"; device time by kernel:")
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=25))


def _time_knn(name, args, n_agents, k, variant, packed, label):
    """Kernel and plain times on one input (median of 21 x 50 back-to-back
    launches, so the inputs stay in L2; plain 11 x 5), beside the bound."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs

    E, N = args[0].shape
    kernel_ms = _cuda_ms(
        lambda: knn_obs.knn_observation(*args, n_agents=n_agents, k=k,
                                        variant=variant),
        repeats=21, inner=50,
    )
    plain_ms = _cuda_ms(
        lambda: knn_obs.knn_observation_reference(*args, n_agents=n_agents,
                                                  k=k, packed=packed),
        repeats=11, inner=5,
    )
    alive = (args[4] >= 0.5).sum(dim=1).to(torch.float64)
    d2_pairs = float((alive * (alive - 1)).sum())  # pairs of live agents
    bound_ms, bound_by, nbytes = _knn_bound_ms(E, N, k, d2_pairs)
    print(f"{name} [{variant}, {label}] at E={E} N={N} k={k}: kernel "
          f"{kernel_ms:.5f} ms, plain {plain_ms:.5f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}: {nbytes} bytes, {d2_pairs:.0f} "
          f"live pairs); {100 * bound_ms / kernel_ms:.1f}% of bound")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print torch.profiler kernel tables")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from warpdrive_tpu_torch.ops import cuda_build, knn_obs
    from warpdrive_tpu_torch.presets import build_flagship
    from warpdrive_tpu_torch.utils.config import load_run_config

    # 1. the card
    card = _card_line()
    cap = torch.cuda.get_device_capability(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, capability {cap}, "
          f"{torch.cuda.device_count()} device(s)")
    assert cap == (9, 0), f"the kernels are built for sm_90a, card is {cap}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build every kernel from the checkout
    t0 = time.perf_counter()
    report = cuda_build.build(cuda_build.kernel_sources())
    print(f"built {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in sorted(report.items()):
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                        "spill")):
                print(f"  {name}: {line.strip()}")

    # 3. kernels vs plain, and the CUDA step vs the CPU step
    max_abs = {"knn_obs_flat_exact": 0.0}
    for E, N, k in ((NUM_ENVS, 105, 10), (8, 1024, 10), (6, 15, 4)):
        knn_args, n, kk = _random_knn_inputs(E, N, k, seed=N, device=DEVICE)
        max_abs["knn_obs_flat_exact"] = max(
            max_abs["knn_obs_flat_exact"],
            _compare_knn("random", knn_args, n, kk))

    system = build_flagship(num_envs=NUM_ENVS, fc_dims=FC_DIMS, seed=0,
                            device=DEVICE)
    generator = torch.Generator(device=DEVICE)
    generator.manual_seed(0)
    rolled = system["state"]
    checksum = torch.zeros((), device=DEVICE)
    for _ in range(ROLLED_STEPS):
        rolled, checksum = system["env_only_step"]((rolled, checksum),
                                                   generator)
    env = system["env"]
    rolled_args, n, kk = _knn_args(env, rolled)
    max_abs["knn_obs_flat_exact"] = max(
        max_abs["knn_obs_flat_exact"],
        _compare_knn(f"rolled {ROLLED_STEPS} steps", rolled_args, n, kk))

    run_config = load_run_config("tag_continuous")
    run_config["trainer"]["seed"] = 0
    max_abs["knn_obs_mxu"], train_rolled = _check_k2(run_config)
    _check_step_against_cpu()

    # 4a. the flagship rollout, counts from 0
    system["state"] = rolled
    loops, launches, _ = _drive_main_path(system, generator)
    for name, r in loops.items():
        print(f"{name}: {r['ms_per_step']:.4f} ms/step, "
              f"{r['env_steps_per_s']:.0f} env-steps/s at {NUM_ENVS} envs "
              f"x {system['num_agents']} agents ({MAIN_PATH_STEPS} steps, "
              f"host {r['host_s']:.3f} s); launches so far "
              f"{r['launches_after']}")
    expected = {"knn_obs_flat_exact": 2 * MAIN_PATH_STEPS, "knn_obs_mxu": 0}
    assert launches == expected, f"launches {launches}, expected {expected}"
    assert loops["env_only_step"]["launches_after"] == {
        "knn_obs_flat_exact": MAIN_PATH_STEPS, "knn_obs_mxu": 0
    }

    # 4b. the training path, counts from 0
    trainer, train_launches, train_times = _drive_training(run_config)
    steps_per_iter = trainer.training_batch_size_per_env * trainer.num_envs
    expected = {"knn_obs_flat_exact": 0,
                "knn_obs_mxu": trainer.num_iters
                * trainer.training_batch_size_per_env}
    print(f"training: {trainer.num_iters} iterations of {steps_per_iter} "
          f"env-steps at {trainer.num_envs} envs x {trainer.engine.n_agents} "
          f"agents in {train_times['train_s']:.3f} s (setup "
          f"{train_times['setup_s']:.3f} s); launches {train_launches}")
    assert train_launches == expected, \
        f"launches {train_launches}, expected {expected}"
    later = trainer.phase_ms[1:]
    roll_ms = statistics.mean(r for r, _ in later)
    upd_ms = statistics.mean(u for _, u in later)
    print(f"training iterations 2-{trainer.num_iters}, mean: rollout "
          f"{roll_ms:.3f} ms, update {upd_ms:.3f} ms, iteration "
          f"{roll_ms + upd_ms:.3f} ms, "
          f"{steps_per_iter / ((roll_ms + upd_ms) / 1e3):.0f} env-steps/s")
    _update_card_vs_cpu(trainer)
    if args.profile:
        _profile(system, generator, trainer, {
            "env_only_step": loops["env_only_step"]["ms_per_step"],
            "full_loop_step": loops["full_loop_step"]["ms_per_step"],
            "training iteration": roll_ms + upd_ms,
        })

    # 5. kernel and plain times at the main paths' shapes
    timed = {
        "knn_obs_flat_exact": _time_knn(
            "knn_obs_flat_exact", rolled_args, n, kk, "flat_exact", False,
            "flagship state"),
        "knn_obs_mxu": _time_knn(
            "knn_obs_mxu", *train_rolled, "mxu_exact", False,
            "training state"),
    }
    _time_knn("knn_obs_mxu", rolled_args, n, kk, "mxu_exact", False,
              "flagship state")
    _time_knn("knn_obs_mxu", *train_rolled, "mxu", True, "training state")
    env_only_ms = loops["env_only_step"]["ms_per_step"]
    rollout_step_ms = roll_ms / trainer.training_batch_size_per_env
    print(f"knn_obs_flat_exact share of env_only_step "
          f"{100 * timed['knn_obs_flat_exact']['ms'] / env_only_ms:.1f}%; "
          f"knn_obs_mxu share of a training rollout step "
          f"{100 * timed['knn_obs_mxu']['ms'] / rollout_step_ms:.1f}%")

    all_launches = {"knn_obs_flat_exact": launches["knn_obs_flat_exact"],
                    "knn_obs_mxu": train_launches["knn_obs_mxu"]}
    kernels = []
    for name, info in knn_obs.KERNELS.items():
        kernels.append({
            "name": name,
            "route": info["route"],
            "source": info["source"],
            "replaces": info["replaces"],
            "launches": all_launches[name],
            "max_abs_err": max_abs[name],
            **timed[name],
            "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
