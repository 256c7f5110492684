"""Drive the PyTorch port (``warpdrive_tpu_torch``) on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on a failure:

1. the card: name and power limit from ``nvidia-smi``, torch and CUDA
   versions, compute capability (must be 9.0, the kernels' ``sm_90a``);
2. build every kernel in ``warpdrive_tpu_torch/csrc/`` with ``nvcc``;
3. hold each kernel against its plain PyTorch version on the card, on random
   states and on a state rolled 100 flagship steps (0 slot mismatches and a
   max abs diff <= 1e-6 required), and the CUDA flagship step against the
   same step on the CPU from the same states;
4. drive the main path, the flagship rollout at 1024 envs x 105 agents with
   ``fc_dims=(256, 256)``: ``env_only_step`` then ``full_loop_step``, with the
   kernels' launch counts set to 0 just before and read just after; each
   step must launch the kNN kernel exactly once;
5. time each kernel and its plain version at the main path's shapes, beside
   the kernel's bound.

The last three lines are the card (``nvidia-smi``'s name and power limit),
one JSON object with a record per kernel, and the result line
``{"ok": true, "device": {...}}``.  ``--profile`` adds a ``torch.profiler``
table of device time by kernel for a few steps of each loop.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
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


def _compare_knn(label, args, n_agents, k):
    """Kernel vs plain on the same inputs: (slot mismatches, max abs diff)."""
    import torch

    from warpdrive_tpu_torch.ops import knn_obs

    out = knn_obs.knn_observation(*args, n_agents=n_agents, k=k)
    plain = knn_obs.knn_observation_reference(*args, n_agents=n_agents, k=k)
    torch.cuda.synchronize()
    E, N = args[0].shape
    slots = out[..., :-1].reshape(E, N, k, 8)
    ref = plain[..., :-1].reshape(E, N, k, 8)
    mismatches = int((slots != ref).any(dim=-1).sum()) + int(
        (out[..., -1] != plain[..., -1]).sum()
    )
    max_abs = float((out - plain).abs().max())
    print(f"kernel vs plain [{label}] E={E} N={N} k={k}: "
          f"slot mismatches {mismatches} of {E * N * k}, max abs diff "
          f"{max_abs:.3g}, finite {bool(torch.isfinite(out).all())}")
    assert torch.isfinite(out).all(), f"{label}: non-finite kernel output"
    assert mismatches == 0, f"{label}: {mismatches} slot mismatches"
    assert max_abs <= MAX_ABS_TOL, f"{label}: max abs diff {max_abs}"
    return max_abs


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


def _profile(system, generator, steps=10):
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = system["state"]
    checksum = torch.zeros((), device=state["loc_x"].device)
    for loop in ("env_only_step", "full_loop_step"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                if loop == "env_only_step":
                    state, checksum = system["env_only_step"](
                        (state, checksum), generator)
                else:
                    state = system["full_loop_step"](
                        system["models"], state, generator)
            torch.cuda.synchronize()
        print(f"profile {loop} ({steps} steps, device time by kernel):")
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=25))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler kernel table")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from warpdrive_tpu_torch.ops import cuda_build, knn_obs
    from warpdrive_tpu_torch.presets import build_flagship

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
    max_abs = 0.0
    for E, N, k in ((NUM_ENVS, 105, 10), (8, 1024, 10), (6, 15, 4)):
        knn_args, n, kk = _random_knn_inputs(E, N, k, seed=N, device=DEVICE)
        max_abs = max(max_abs, _compare_knn("random", knn_args, n, kk))

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
    max_abs = max(max_abs, _compare_knn(f"rolled {ROLLED_STEPS} steps",
                                        rolled_args, n, kk))
    _check_step_against_cpu()

    # 4. the main path, counts from 0
    system["state"] = rolled
    loops, launches, _ = _drive_main_path(system, generator)
    for name, r in loops.items():
        print(f"{name}: {r['ms_per_step']:.4f} ms/step, "
              f"{r['env_steps_per_s']:.0f} env-steps/s at {NUM_ENVS} envs "
              f"x {system['num_agents']} agents ({MAIN_PATH_STEPS} steps, "
              f"host {r['host_s']:.3f} s); launches so far "
              f"{r['launches_after']}")
    expected = {"knn_obs_flat_exact": 2 * MAIN_PATH_STEPS}
    assert launches == expected, f"launches {launches}, expected {expected}"
    assert loops["env_only_step"]["launches_after"] == {
        "knn_obs_flat_exact": MAIN_PATH_STEPS
    }
    if args.profile:
        _profile(system, generator)

    # 5. kernel and plain times at the main path's shape
    E, N, k = NUM_ENVS, n, kk
    kernel_ms = _cuda_ms(
        lambda: knn_obs.knn_observation(*rolled_args, n_agents=N, k=k),
        repeats=21, inner=50,
    )
    plain_ms = _cuda_ms(
        lambda: knn_obs.knn_observation_reference(*rolled_args, n_agents=N,
                                                  k=k),
        repeats=11, inner=5,
    )
    alive = (rolled_args[4] >= 0.5).sum(dim=1).to(torch.float64)
    d2_pairs = float((alive * (alive - 1)).sum())  # pairs of live agents
    bound_ms, bound_by, nbytes = _knn_bound_ms(E, N, k, d2_pairs)
    print(f"knn_obs_flat_exact at E={E} N={N} k={k}: kernel {kernel_ms:.5f} "
          f"ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}: {nbytes} bytes, {d2_pairs:.0f} live pairs); "
          f"{100 * bound_ms / kernel_ms:.1f}% of bound; kernel share of "
          f"env_only_step "
          f"{100 * kernel_ms / loops['env_only_step']['ms_per_step']:.1f}%")

    kernels = []
    for name, info in knn_obs.KERNELS.items():
        kernels.append({
            "name": name,
            "route": info["route"],
            "source": info["source"],
            "replaces": info["replaces"],
            "launches": launches[name],
            "max_abs_err": max_abs,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
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
