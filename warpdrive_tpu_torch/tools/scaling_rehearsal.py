"""
Scaling rehearsal on the CPU: the port's counterpart of
``warpdrive_tpu/tools/scaling_rehearsal.py``.

The same training program over the same E envs and the same CPU budget,
run as

* 1 rank over E envs (a one-rank gloo group, 2 threads), and
* 2 gloo ranks over E/2 envs each (1 thread each),

and the ratio ``steps_per_sec(2 ranks) / steps_per_sec(1 rank)``.  What the
second adds -- the rendezvous, the gradient and denominator all-reduces,
per-rank dispatch -- shows as a ratio below 1.  The JSON keys are the JAX
tool's (``single_process_8dev_steps_per_sec`` is the one-rank run,
``two_process_4dev_steps_per_sec`` the two-rank one).  This is a rehearsal
of the coordination cost on the host's CPU cores, NOT a measurement of any
card: NCCL between cards moves its all-reduces over NVLink, and one card
runs one NCCL rank.

Three program shapes (``SHAPES``): TagGridWorld A2C, the flagship's kNN
observation (the exact ``ladder`` order, plain PyTorch on the CPU) with two
A2C policies, and Pendulum DDPG; at the env counts of ``SCALES``.

Run: ``python -m warpdrive_tpu_torch.tools.scaling_rehearsal <outdir>``;
writes ``<outdir>/scaling_rehearsal.json``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

SCALES = {"small": 32, "large": 512, "xlarge": 2048, "xxlarge": 8192}
SHAPES = ("gridworld", "flagship_knn", "ddpg")
T_STEPS = 20
TIMED_ITERS = 8
# CPU threads of the one-rank run; each of the two ranks gets half
THREADS = 2


def _saving(outdir: str) -> dict:
    return {"metrics_log_freq": 10**9, "model_params_save_freq": 10**9,
            "basedir": outdir, "name": "sr", "tag": "t"}


def _a2c_policy(fc=32) -> dict:
    return {"to_train": True, "algorithm": "A2C", "gamma": 0.98, "lr": 1e-3,
            "model": {"type": "fully_connected", "fc_dims": [fc, fc]}}


def _trainer_config(name, n_envs, policies, seed, outdir, episodes=4,
                    **extra) -> dict:
    return {"name": name, "env": {},
            "trainer": {"num_envs": n_envs, "num_episodes": episodes * n_envs,
                        "train_batch_size": n_envs * T_STEPS, "seed": seed},
            "policy": policies, "saving": _saving(outdir), **extra}


def _build_trainer(shape: str, n_envs: int, outdir: str, device):
    """The shape's trainer over ``n_envs`` global envs, cut over the
    initialized process group."""
    from warpdrive_tpu_torch.envs import register_all_envs
    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
    from warpdrive_tpu_torch.envs.tag_gridworld import TorchTagGridWorld
    from warpdrive_tpu_torch.parallel.mesh import apply_env_sharding
    from warpdrive_tpu_torch.training.trainer_a2c import TrainerA2C
    from warpdrive_tpu_torch.training.trainer_ddpg import TrainerDDPG
    from warpdrive_tpu_torch.utils.env_registrar import env_registrar

    def engine(env, seed):
        return apply_env_sharding(EnvEngine(env_obj=env, num_envs=n_envs,
                                            seed=seed, device=device))

    if shape == "gridworld":
        env = TorchTagGridWorld(num_taggers=4, grid_length=10,
                                episode_length=T_STEPS, seed=7,
                                use_full_observation=False)
        cfg = _trainer_config("scaling_rehearsal", n_envs,
                              {"shared": _a2c_policy()}, 1, outdir)
        return TrainerA2C(env_wrapper=engine(env, 7), config=cfg,
                          verbose=False)
    if shape == "flagship_knn":
        env = TorchTagContinuous(
            num_taggers=3, num_runners=12, grid_length=10.0,
            episode_length=T_STEPS, seed=7, use_full_observation=False,
            num_other_agents_observed=4, knn_algorithm="ladder")
        cfg = _trainer_config("scaling_rehearsal_knn", n_envs,
                              {"tagger": _a2c_policy(),
                               "runner": _a2c_policy()}, 1, outdir)
        pmap = {"runner": np.where(env.agent_types == 0)[0].tolist(),
                "tagger": np.where(env.agent_types == 1)[0].tolist()}
        return TrainerA2C(env_wrapper=engine(env, 7), config=cfg,
                          policy_tag_to_agent_id_map=pmap, verbose=False)
    register_all_envs()
    pendulum = env_registrar.get("ClassicControlPendulumEnv",
                                 backend="torch")
    ddpg = {"shared": {
        "to_train": True, "algorithm": "DDPG", "gamma": 0.99, "tau": 0.05,
        "lr": {"actor": 1e-3, "critic": 1e-4},
        "model": {"actor": {"type": "fully_connected_actor",
                            "fc_dims": [16, 16], "output_w": 2.0},
                  "critic": {"type": "fully_connected_action_value_critic",
                             "fc_dims": [16, 16]}}}}
    cfg = _trainer_config("scaling_rehearsal_ddpg", n_envs, ddpg, 2, outdir,
                          episodes=2, sampler={"params": {
                              "damping": 0.15, "stddev": 0.2, "scale": 1.0}})
    return TrainerDDPG(env_wrapper=engine(pendulum(episode_length=T_STEPS,
                                                   seed=3), 0),
                       config=cfg, verbose=False)


def _timed_rank(device, shape: str, n_envs: int, outdir: str) -> float:
    """One rank: a warm-up iteration, then ``TIMED_ITERS`` ones, each
    between two barriers; returns the global env-steps a second of the
    median iteration (a ratio of two runs on a shared host: the median
    leaves out the iterations another process's burst slowed)."""
    import torch.distributed as dist

    trainer = _build_trainer(shape, n_envs, outdir, device)
    trainer._iteration(0)
    seconds = []
    for i in range(TIMED_ITERS):
        dist.barrier()
        t0 = time.perf_counter()
        trainer._iteration(i + 1)
        dist.barrier()
        seconds.append(time.perf_counter() - t0)
    return n_envs * T_STEPS / float(np.median(seconds))


def _measure_scale(outdir: str, n_envs: int, timeout_s: int,
                   shape: str = "gridworld") -> dict:
    """Both runs of one shape at one env count; writes ``single.json`` and
    ``multi.json`` into ``outdir`` and returns the JAX tool's record."""
    from warpdrive_tpu_torch.parallel.launch import launch

    os.makedirs(outdir, exist_ok=True)
    rates = {}
    for label, ranks in (("single", 1), ("multi", 2)):
        with tempfile.TemporaryDirectory() as workdir:
            rate = launch(_timed_rank, ranks, args=(shape, n_envs, workdir),
                          device="cpu", timeout_s=timeout_s,
                          threads=THREADS // ranks)[0]
        rates[label] = rate
        with open(os.path.join(outdir, f"{label}.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"steps_per_sec": rate}, f)
    return {
        "num_envs": n_envs,
        "shape": shape,
        "steps_per_iter": n_envs * T_STEPS,
        "single_process_8dev_steps_per_sec": round(rates["single"]),
        "two_process_4dev_steps_per_sec": round(rates["multi"]),
        "process_scaling_efficiency": round(rates["multi"] / rates["single"],
                                            4),
    }


def orchestrate(outdir: str, timeout_s: int = 900, shapes=SHAPES) -> dict:
    """Both runs at each scale for each program shape; writes the
    ratios."""
    os.makedirs(outdir, exist_ok=True)
    result = {
        "config": {
            "shapes": {
                "gridworld": "TagGridWorld(4 taggers, 10x10) A2C",
                "flagship_knn": "TagContinuous(3+12, k=4, ladder kNN) "
                                "two-policy A2C",
                "ddpg": "Pendulum DDPG (OU noise, replay window)",
            },
            "timed_iters": TIMED_ITERS,
            "threads_total": THREADS,
        },
        "shapes": {
            shape: {"scales": {
                label: _measure_scale(outdir, n_envs, timeout_s, shape=shape)
                for label, n_envs in SCALES.items()}}
            for shape in shapes
        },
        "note": (
            "one gloo rank over E envs with 2 CPU threads against two gloo "
            "ranks over E/2 envs with 1 thread each, the same program: the "
            "ratio is the coordination cost of the process group on the "
            "CPU, a rehearsal, not a card measurement"),
    }
    with open(os.path.join(outdir, "scaling_rehearsal.json"), "w",
              encoding="utf-8") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    orchestrate(sys.argv[1] if len(sys.argv) > 1 else "scaling_rehearsal")
