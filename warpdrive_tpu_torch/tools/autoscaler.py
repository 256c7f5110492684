"""
Vertical auto-scaling: the largest env count and batch that fit on the
device, and of those the configuration that trains fastest.

The port's counterpart of ``warpdrive_tpu/tools/autoscaler.py`` (after the
reference's ``vertical_scaler.py``): trial runs in subprocesses, a
doubling-then-bisection search for the largest ``num_envs`` (then the
largest batch multiple) that neither runs out of memory nor fails to
start, a ladder of memory knobs tried before a size is declared
infeasible, and the highest measured throughput as the final choice.

On the card running out of memory surfaces as ``torch.OutOfMemoryError``
at whatever allocation crosses the limit.  Each probe therefore builds the
engine and trainer and trains one iteration in a fresh subprocess on the
caller's device, so a failed allocation cannot poison the caller's CUDA
context; the probe prints the exception's type, which tells running out of
memory from another failure (a probe that fails for any reason is
infeasible, as in the JAX package).
"""

from __future__ import annotations

import copy
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]


def best_param_search(is_valid, low: int = 1, margin: int = 1):
    """The largest valid parameter: doubling from ``low`` until failure,
    then bisection between the last success and the first failure, down to
    ``margin``."""
    assert low > 0
    if not is_valid(low):
        raise ValueError(f"even the lower bound {low} is not feasible")
    hi = low
    while is_valid(hi * 2):
        hi *= 2
        if hi > 2**24:  # safety rail
            return hi
    lo, hi = hi, hi * 2  # lo valid, hi invalid
    while hi - lo > margin:
        mid = (lo + hi) // 2
        if is_valid(mid):
            lo = mid
        else:
            hi = mid
    return lo


_PROBE_SNIPPET = r"""
import json, sys
payload = json.load(open(sys.argv[1]))
run_config = payload["run_config"]
env_setup = payload["env_setup"]
try:
    from warpdrive_tpu_torch.envs import register_all_envs
    from warpdrive_tpu_torch.training.scripts.train import (
        _ENV_SETUPS, setup_trainer_and_train)
    from warpdrive_tpu_torch.utils.env_registrar import env_registrar

    register_all_envs()
    env_name = (env_setup or _ENV_SETUPS[run_config["name"]])[0]
    episode_length = env_registrar.get(env_name, backend="cpu")(
        **run_config.get("env", {})).episode_length
    # exactly one iteration: num_episodes * episode_length just reaches
    # one train_batch_size
    batch = run_config["trainer"]["train_batch_size"]
    run_config["trainer"]["num_episodes"] = max(1, batch // episode_length
                                                + 1)
    run_config["saving"]["metrics_log_freq"] = 10**9
    run_config["saving"]["model_params_save_freq"] = 10**9
    trainer = setup_trainer_and_train(
        run_config, env_setup=env_setup, verbose=False,
        results_dir=payload["results_dir"], device=payload["device"])
    # the post-warm-up rate: the scaler picks the fastest fitting config
    try:
        rate = trainer.profile_phases(repeats=2)["steps_per_sec"]
    except Exception:  # noqa: BLE001 -- the rate is advisory
        rate = 0.0
    print(f"PROBE_OK steps_per_sec={rate:.1f}", flush=True)
except Exception as e:  # noqa: BLE001 -- any failure means "does not fit"
    print(f"PROBE_FAIL: {type(e).__name__}: {e}", flush=True)
    sys.exit(1)
"""


def run_probe(run_config: dict, env_setup=None, device="cuda",
              timeout_s: int = None) -> dict:
    """One trial config in a fresh subprocess on ``device``: one training
    iteration, then ``profile_phases(2)``.  Returns ``{"fits",
    "steps_per_sec" (None unless measured), "output" (the child's stdout
    and stderr), "seconds"}``.  A failure's output holds ``PROBE_FAIL:
    <exception type>: ...``, e.g. ``OutOfMemoryError``."""
    if timeout_s is None:
        timeout_s = int(os.environ.get("WD_PROBE_TIMEOUT_S", 900))
    workdir = tempfile.mkdtemp(prefix="wd_probe_")
    payload_path = os.path.join(workdir, "payload.json")
    with open(payload_path, "w", encoding="utf-8") as f:
        json.dump({"run_config": run_config,
                   "env_setup": None if env_setup is None else list(env_setup),
                   "device": str(device),
                   "results_dir": os.path.join(workdir, "results")}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_REPO), env.get("PYTHONPATH", "")) if p)
    trainer_cfg = run_config["trainer"]
    start = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE_SNIPPET, payload_path],
            capture_output=True, text=True, timeout=timeout_s, check=False,
            env=env,
        )
        output = proc.stdout + proc.stderr
        fits = proc.returncode == 0 and "PROBE_OK" in proc.stdout
    except subprocess.TimeoutExpired:
        output, fits = f"PROBE_FAIL: timed out after {timeout_s} s", False
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - start
    rate = None
    if fits:
        m = re.search(r"steps_per_sec=([\d.]+)", output)
        rate = float(m.group(1)) if m else None
        logging.info("autoscaler probe fits (num_envs=%s batch=%s): %s "
                     "steps/s", trainer_cfg["num_envs"],
                     trainer_cfg["train_batch_size"],
                     f"{rate:.0f}" if rate else "unmeasured")
    else:
        logging.info("autoscaler probe failed (num_envs=%s batch=%s): %s",
                     trainer_cfg["num_envs"],
                     trainer_cfg["train_batch_size"], output[-500:])
    return {"fits": fits, "steps_per_sec": rate, "output": output,
            "seconds": seconds}


# The memory-knob ladder: rung 0 is the config as given, each later rung
# trades some update speed for memory.  Policy knobs first (``remat``
# recomputes activations in the backward pass; ``num_minibatches`` slices
# the update over the env axis), then the trainer's storage knobs
# (``batch_dtype`` bfloat16 halves the stored rollout, the (T, E, N, obs)
# batch; ``update_recompute_obs`` stores the physical state instead and
# derives the observations in the update).  Every knob is exact but the
# bfloat16 batch.  Keys in _TRAINER_KNOBS go to trial["trainer"], the rest
# to each trained policy.
MEMORY_KNOB_LADDER = (
    {},
    {"remat": True},
    {"remat": True, "num_minibatches": 4},
    {"remat": True, "num_minibatches": 8, "batch_dtype": "bfloat16"},
    {"remat": True, "num_minibatches": 8, "batch_dtype": "bfloat16",
     "update_recompute_obs": True},
)

_TRAINER_KNOBS = ("batch_dtype", "update_recompute_obs")


def _effective_minibatches(num_envs: int, target: int) -> int:
    """The largest divisor of ``num_envs`` that is <= ``target`` (env-axis
    minibatches must divide the env count)."""
    mb = max(1, min(target, num_envs))
    while num_envs % mb:
        mb -= 1
    return mb


def _with_knobs(run_config: dict, knobs: dict, num_envs: int) -> dict:
    trial = copy.deepcopy(run_config)
    pol_knobs = {k: v for k, v in knobs.items() if k not in _TRAINER_KNOBS}
    for pol in trial.get("policy", {}).values():
        if pol.get("to_train", True) and pol_knobs:
            eff = dict(pol_knobs)
            if "num_minibatches" in eff:
                eff["num_minibatches"] = _effective_minibatches(
                    num_envs, eff["num_minibatches"])
            pol.update(eff)
    for k in _TRAINER_KNOBS:
        if k in knobs:
            trial["trainer"][k] = knobs[k]
    return trial


def perform_auto_vertical_scaling(
    run_config: dict,
    env_setup=None,
    use_memory_knobs: bool = True,
    probe_fn=None,
    device="cuda",
) -> dict:
    """The largest feasible ``num_envs`` (batch per env kept), then the
    largest feasible ``train_batch_size`` multiple at that env count;
    returns an updated copy of the run config.

    Where a trial does not fit, the search climbs
    :data:`MEMORY_KNOB_LADDER` before declaring the size infeasible; the
    rung is monotone over the search (a knob needed at N envs stays on
    above N) and the chosen knobs are written into the result.  Every
    fitting probe reports its rate, and the result is the fastest fitting
    configuration seen, not merely the largest.  ``num_episodes`` scales
    with the envs, so the scaled run keeps the base run's iterations.

    ``probe_fn(run_config, env_setup) -> bool | (bool, steps_per_sec)`` is
    injectable (tests); the default probes in subprocesses on
    ``device``."""
    if probe_fn is None:
        def probe_fn(trial, setup):
            result = run_probe(trial, setup, device=device)
            return result["fits"], result["steps_per_sec"]
    base = copy.deepcopy(run_config)
    base_envs = int(base["trainer"]["num_envs"])
    batch_per_env = max(
        1, int(base["trainer"]["train_batch_size"]) // base_envs)
    ladder = MEMORY_KNOB_LADDER if use_memory_knobs else ({},)
    state = {"rung": 0}
    measured = []  # (steps_per_sec, num_envs, mult, rung) of each fit

    def probe(trial, rung, mult=1):
        res = probe_fn(trial, env_setup)
        ok, rate = res if isinstance(res, tuple) else (res, None)
        if ok and rate:
            measured.append(
                (float(rate), int(trial["trainer"]["num_envs"]), mult, rung))
        return ok

    def envs_valid(num_envs: int) -> bool:
        for rung in range(state["rung"], len(ladder)):
            trial = _with_knobs(base, ladder[rung], num_envs)
            trial["trainer"]["num_envs"] = num_envs
            trial["trainer"]["train_batch_size"] = num_envs * batch_per_env
            if probe(trial, rung):
                if rung != state["rung"]:
                    logging.info("autoscaler: memory knobs %s from %d envs",
                                 ladder[rung], num_envs)
                state["rung"] = rung
                return True
        return False

    logging.info("autoscaler: searching num_envs from %d ...", base_envs)
    best_envs = best_param_search(envs_valid, low=base_envs)
    knobs = ladder[state["rung"]]

    def batch_valid(mult: int) -> bool:
        trial = _with_knobs(base, knobs, best_envs)
        trial["trainer"]["num_envs"] = best_envs
        trial["trainer"]["train_batch_size"] = best_envs * batch_per_env * mult
        return probe(trial, state["rung"], mult)

    logging.info("autoscaler: searching the batch multiple at %d envs ...",
                 best_envs)
    best_mult = best_param_search(batch_valid, low=1)

    if measured:
        rate, t_envs, t_mult, t_rung = max(measured)
        size_max = (best_envs, best_mult, state["rung"])
        if (t_envs, t_mult, t_rung) != size_max:
            logging.info(
                "autoscaler: the largest config %s measured slower than "
                "(envs=%d, mult=%d, rung=%d) at %.0f steps/s; taking the "
                "faster", size_max, t_envs, t_mult, t_rung, rate)
        best_envs, best_mult = t_envs, t_mult
        knobs = ladder[t_rung]

    out = _with_knobs(run_config, knobs, best_envs)
    out["trainer"]["num_envs"] = best_envs
    out["trainer"]["train_batch_size"] = best_envs * batch_per_env * best_mult
    if "num_episodes" in out.get("trainer", {}):
        scale = max(1, (best_envs * best_mult + base_envs - 1) // base_envs)
        out["trainer"]["num_episodes"] = int(
            out["trainer"]["num_episodes"] * scale)
    logging.info("autoscaler: num_envs=%d train_batch_size=%d "
                 "num_episodes=%s knobs=%s", out["trainer"]["num_envs"],
                 out["trainer"]["train_batch_size"],
                 out["trainer"].get("num_episodes"), knobs)
    return out
