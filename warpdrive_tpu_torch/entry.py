"""
The port's counterparts of ``__graft_entry__.py``:

* ``entry()``: one full loop step of the flagship system (TagContinuous, 5
  taggers + 100 runners, two MLP policies) -- the kNN observation, the
  policy forward, categorical sampling, the env step and the done-driven
  auto-reset -- with its example arguments;
* ``dryrun_multichip(n)``: ``n`` ranks (``parallel/launch.py``) over a
  process mesh -- ``(n/2 x 2)`` (env x model) when ``n`` is even and at
  least 4, else ``n`` on the env axis -- run one training iteration each of
  three program shapes on tiny sizes, the env axis cut over the mesh:
  full-observation A2C + PPO, the kNN observation's A2C (K1,
  ``pallas_flat_exact``, on a card) and DDPG on Pendulum.  By default every
  rank is a gloo rank on the first card (NCCL refuses two ranks on one GPU);
  ``device="cpu"`` runs the ranks on the CPU, and ``device="cuda"`` with
  ``backend="nccl"`` one rank a card (raising when there are fewer cards
  than ranks).
"""

from __future__ import annotations

import shutil
import tempfile

import numpy as np
import torch


def entry(device="cuda"):
    """Return ``(fn, example_args)``: ``fn(models, state, generator)`` is
    ``full_loop_step`` of ``build_flagship(num_envs=4, fc_dims=(64, 64),
    seed=0)`` on ``device``, and the arguments are its models, its rollout
    state and a ``torch.Generator`` seeded 0 (in place of JAX's PRNG
    key)."""
    from warpdrive_tpu_torch.presets import build_flagship

    system = build_flagship(num_envs=4, fc_dims=(64, 64), seed=0,
                            device=device)
    generator = torch.Generator(device=system["engine"].device)
    generator.manual_seed(0)
    return system["full_loop_step"], (system["models"], system["state"],
                                      generator)


def dryrun_multichip(n_devices: int, device="cuda:0", backend: str = "gloo",
                     timeout_s: float = 600) -> list:
    """One sharded training iteration of each of the three program shapes
    on ``n_devices`` ranks; returns each rank's ``{"mesh": (dp, tp),
    "launches": {kernel: count}, "losses": {shape: {policy: loss}}}``.
    Raises if any rank fails."""
    from warpdrive_tpu_torch.parallel.launch import launch

    results = launch(_dryrun_rank, n_devices, args=(int(n_devices),),
                     device=device, backend=backend, timeout_s=timeout_s)
    print(f"dryrun_multichip({n_devices}): OK -- mesh "
          f"{results[0]['mesh']}, losses {results[0]['losses']}")
    return results


def _dryrun_config(num_envs: int, policies: dict, basedir: str,
                   seed: int) -> dict:
    T = 4  # steps a replica an iteration
    return {
        "trainer": {"num_envs": num_envs,
                    "num_episodes": 2 * (T * num_envs) // 8,
                    "train_batch_size": T * num_envs, "seed": seed},
        "policy": policies,
        "sampler": {"params": {"damping": 0.15, "stddev": 0.2, "scale": 1.0}},
        "saving": {"basedir": basedir, "metrics_log_freq": 1},
    }


def _dryrun_rank(device, n_devices: int) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    from warpdrive_tpu_torch.envs import register_all_envs
    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
    from warpdrive_tpu_torch.ops import knn_obs
    from warpdrive_tpu_torch.parallel.mesh import (
        apply_env_sharding,
        make_mesh,
        make_mesh_2d,
        reduce_metrics,
    )
    from warpdrive_tpu_torch.training.trainer_a2c import TrainerA2C
    from warpdrive_tpu_torch.training.trainer_ddpg import TrainerDDPG
    from warpdrive_tpu_torch.utils.env_registrar import env_registrar

    if n_devices >= 4 and n_devices % 2 == 0:
        mesh = make_mesh_2d(dp=n_devices // 2, tp=2, device=device)
    else:
        mesh = make_mesh(num_devices=n_devices, device=device)
    num_envs = 2 * mesh.dp
    basedir = tempfile.mkdtemp(prefix="wdt_dryrun_")
    knn_obs.reset_launch_counts()
    losses = {}

    def one_iteration(label, trainer):
        metrics = reduce_metrics(trainer._iteration(0), mesh)
        losses[label] = {tag: m["Total loss"] for tag, m in metrics.items()}
        assert all(np.isfinite(v) for v in losses[label].values()), losses

    def policy(algo, fc=32):
        return {"to_train": True, "algorithm": algo, "gamma": 0.98,
                "lr": 1e-3,
                "model": {"type": "fully_connected", "fc_dims": [fc, fc]}}

    try:
        a2c_policies = {"tagger": policy("A2C"), "runner": policy("PPO")}
        for label, env_kwargs, seed in (
                ("full_obs_a2c_ppo",
                 dict(num_acceleration_levels=5, num_turn_levels=5,
                      use_full_observation=True, seed=0), 0),
                ("knn_a2c",
                 dict(use_full_observation=False,
                      num_other_agents_observed=4,
                      knn_algorithm="pallas_flat_exact", seed=5), 1)):
            env = TorchTagContinuous(num_taggers=2, num_runners=8,
                                     grid_length=10.0, episode_length=8,
                                     **env_kwargs)
            engine = apply_env_sharding(
                EnvEngine(env_obj=env, num_envs=num_envs, seed=seed,
                          device=device), mesh=mesh)
            policy_map = {
                "runner": np.where(env.agent_types == 0)[0].tolist(),
                "tagger": np.where(env.agent_types == 1)[0].tolist(),
            }
            one_iteration(label, TrainerA2C(
                env_wrapper=engine,
                config=_dryrun_config(num_envs, a2c_policies, basedir, 0),
                policy_tag_to_agent_id_map=policy_map,
                num_devices=n_devices, verbose=False))

        register_all_envs()
        pendulum = env_registrar.get("ClassicControlPendulumEnv",
                                     backend="torch")
        engine = apply_env_sharding(
            EnvEngine(env_obj=pendulum(episode_length=8, seed=3),
                      num_envs=num_envs, seed=0, device=device), mesh=mesh)
        ddpg = {"shared": {
            "to_train": True, "algorithm": "DDPG", "gamma": 0.99,
            "tau": 0.05, "lr": {"actor": 1e-3, "critic": 1e-4},
            "model": {
                "actor": {"type": "fully_connected_actor",
                          "fc_dims": [16, 16], "output_w": 2.0},
                "critic": {"type": "fully_connected_action_value_critic",
                           "fc_dims": [16, 16]}}}}
        one_iteration("ddpg", TrainerDDPG(
            env_wrapper=engine,
            config=_dryrun_config(num_envs, ddpg, basedir, 2),
            num_devices=n_devices, verbose=False))
    finally:
        shutil.rmtree(basedir, ignore_errors=True)
    return {"mesh": (mesh.dp, mesh.tp), "losses": losses,
            "launches": dict(knn_obs.LAUNCH_COUNTS)}


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry(): OK")
