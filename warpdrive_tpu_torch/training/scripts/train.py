"""
Training CLI: the port's counterpart of
``warpdrive_tpu/training/scripts/train.py``.

    python -m warpdrive_tpu_torch.training.scripts.train -e tag_continuous

``-e`` names a run config under the port's ``training/run_configs`` (or is
a path to one); ``--num_episodes`` and ``--num_envs`` override the config
(as in the JAX CLI, ``--num_envs`` sets ``trainer.num_envs`` alone: an
iteration keeps ``train_batch_size`` env-steps, ``train_batch_size //
num_envs`` a replica), ``--results_dir`` sets where metrics and checkpoints go, and ``--device``
(default ``cuda``) where the run happens.  Every run config of the JAX
package is ported: the A2C ones ``tag_continuous`` (two policies),
``asymmetric_pursuit`` (two policies with separate per-policy
placeholders: the pursuers' Box and the evaders' Dict observations with an
action mask), ``tag_gridworld``, ``tag_gridworld_with_reset_pool``,
``single_cartpole``, ``single_acrobot`` and ``single_mountain_car`` (one
shared policy), and the DDPG ones, ``single_pendulum`` and
``single_continuous_mountain_car``.  A config whose policies all name
``algorithm: DDPG`` trains with :class:`TrainerDDPG`, any other with
:class:`TrainerA2C`.

``trainer.env_backend`` picks the engine: ``"cpu"`` the eager host-env
backend (:class:`CpuEnvEngine` over the numpy reference envs, with the C++
steppers where they build), ``"cpp"`` the same with the C++ steppers
required; anything else (the JAX configs say ``"tpu"``) the device engine.
``-a/--auto_scale`` runs the vertical auto-scaler first
(:mod:`warpdrive_tpu_torch.tools.autoscaler`: subprocess probes of one
iteration each on ``--device``).  ``--trace_out <path>`` traces the run
(:mod:`warpdrive_tpu_torch.core.trace`: spans of the training loop, the
programs and the kernel builds, and the counters) and writes it to
``path`` as a Chrome trace when the run ends.

Several devices, one process each (``parallel/``): ``-n N`` spawns N ranks
on this host (:func:`warpdrive_tpu_torch.parallel.launch.launch`), rank
``r`` on ``cuda:r`` over NCCL, or over gloo with ``--device cpu``; more
ranks than visible cards raise before anything is spawned.  Each rank
trains its ``num_envs / N`` env rows of the one global run (``num_envs``,
``train_batch_size`` and ``num_episodes`` stay global) and only rank 0
writes results and checkpoints.  Across hosts, start one copy a device
with the same ``--coordinator host:port`` (process 0's rendezvous), the
``--num_processes`` and its own ``--process_id`` (or ``WDT_COORDINATOR``,
``WDT_NUM_PROCESSES``, ``WDT_PROCESS_ID``); without ``-n`` the mesh then
spans every process.
"""

from __future__ import annotations

import argparse
import logging
import os

from warpdrive_tpu_torch.core import trace
from warpdrive_tpu_torch.envs import register_all_envs
from warpdrive_tpu_torch.envs.cpu_engine import CpuEnvEngine
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.parallel import launch as local_launch
from warpdrive_tpu_torch.parallel import mesh as pmesh
from warpdrive_tpu_torch.training.trainer_base import _to_host
from warpdrive_tpu_torch.utils.config import load_run_config
from warpdrive_tpu_torch.utils.env_registrar import env_registrar

# run-config name -> (registered env name, policy-map kind)
_ENV_SETUPS = {
    "single_cartpole": ("ClassicControlCartPoleEnv", "shared"),
    "single_mountain_car": ("ClassicControlMountainCarEnv", "shared"),
    "single_acrobot": ("ClassicControlAcrobotEnv", "shared"),
    "single_pendulum": ("ClassicControlPendulumEnv", "shared"),
    "single_continuous_mountain_car": (
        "ClassicControlContinuousMountainCarEnv", "shared"),
    "tag_gridworld": ("TagGridWorld", "shared"),
    "tag_gridworld_with_reset_pool": ("TagGridWorldWithResetPool", "shared"),
    "tag_continuous": ("TagContinuous", "tag_continuous"),
    # separate per-policy placeholders (heterogeneous observation spaces)
    "asymmetric_pursuit": ("AsymmetricPursuit", "separate"),
}


def build_policy_map(kind: str, env) -> dict:
    if kind == "shared":
        # one policy over every agent
        return {"shared": list(range(env.num_agents))}
    if kind == "tag_continuous":
        # two policies keyed on agent type
        taggers = [i for i in range(env.num_agents) if env.agent_type[i] == 1]
        runners = [i for i in range(env.num_agents) if env.agent_type[i] == 0]
        return {"tagger": taggers, "runner": runners}
    if kind == "separate":
        return env.policy_map()
    raise NotImplementedError(kind)


def setup_trainer(
    run_config: dict,
    num_devices: int = 1,
    results_dir: str = None,
    verbose: bool = True,
    device="cuda",
    env_setup: tuple = None,
    tp: int = 1,
):
    """Build engine and trainer from a merged run config (no training).
    ``env_setup`` ``(registered env name, policy-map kind)`` overrides the
    one the config's name selects.  Inside an initialized process group
    the engine's env rows are cut over it (``parallel.mesh.
    apply_env_sharding``; ``num_devices`` must be the group's size, and
    ``tp > 1`` makes a ``(num_devices / tp) x tp`` mesh whose model axis
    cuts the parameters); outside one ``num_devices > 1`` raises."""
    num_devices = int(num_devices)
    if num_devices > 1 and not pmesh.dist.is_initialized():
        raise ValueError(
            f"num_devices={num_devices} needs an initialized process group "
            f"of {num_devices} ranks: start them with "
            "warpdrive_tpu_torch.parallel.launch.launch (the CLI's -n), or "
            "call parallel.mesh.initialize_multihost in each process")
    register_all_envs()
    name = run_config.get("name")
    env_name, policy_kind = (env_setup or _ENV_SETUPS[name])[:2]

    backend = run_config["trainer"].get("env_backend")
    eager = backend in ("cpu", "cpp")
    env_cls = env_registrar.get(env_name, backend="cpu" if eager else "torch")
    env = env_cls(**run_config.get("env", {}))
    policy_map = build_policy_map(policy_kind, env)
    separate = policy_kind == "separate"
    if eager:
        engine = CpuEnvEngine(
            env_obj=env, env_config=run_config.get("env", {}),
            num_envs=run_config["trainer"]["num_envs"],
            native=True if backend == "cpp" else "auto", device=device,
        )
    else:
        engine = EnvEngine(
            env_obj=env,
            num_envs=run_config["trainer"]["num_envs"],
            seed=int(run_config["trainer"].get("seed", 0)),
            policy_tag_to_agent_id_map=policy_map if separate else None,
            create_separate_placeholders_for_each_policy=separate,
            device=device,
        )
        if pmesh.dist.is_initialized():
            pmesh.apply_env_sharding(engine, num_devices=num_devices, tp=tp)

    algorithms = {str(p.get("algorithm", "A2C")).upper()
                  for p in run_config["policy"].values()}
    if algorithms == {"DDPG"}:
        from warpdrive_tpu_torch.training.trainer_ddpg import (
            TrainerDDPG as Trainer,
        )
    else:
        from warpdrive_tpu_torch.training.trainer_a2c import (
            TrainerA2C as Trainer,
        )
    return Trainer(
        env_wrapper=engine,
        config=run_config,
        policy_tag_to_agent_id_map=policy_map,
        create_separate_placeholders_for_each_policy=separate,
        num_devices=num_devices,
        results_dir=results_dir,
        verbose=verbose,
    )


def setup_trainer_and_train(
    run_config: dict,
    num_devices: int = 1,
    results_dir: str = None,
    verbose: bool = True,
    device="cuda",
    env_setup: tuple = None,
):
    """Build engine and trainer from a merged run config and train."""
    trainer = setup_trainer(
        run_config, num_devices=num_devices, results_dir=results_dir,
        verbose=verbose, device=device, env_setup=env_setup,
    )
    trainer.train()
    return trainer


def main(argv=None):
    parser = argparse.ArgumentParser(description="warpdrive-tpu-torch training")
    parser.add_argument("-e", "--env", required=True,
                        help="a run config's path or name: "
                             + ", ".join(sorted(_ENV_SETUPS)))
    parser.add_argument("-n", "--num_devices", type=int, default=1,
                        help="devices in the mesh: N local ranks, one a "
                             "device (with --coordinator, the world's)")
    parser.add_argument("-a", "--auto_scale", action="store_true",
                        help="search the largest num_envs and batch that "
                             "fit on --device before training")
    parser.add_argument("--num_episodes", type=int, default=None)
    parser.add_argument("--num_envs", type=int, default=None,
                        help="env replicas; train_batch_size stays, so the "
                             "steps per env are train_batch_size // "
                             "num_envs")
    parser.add_argument("--results_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "versions of the kernels)")
    # multi-host bring-up: one copy of this script a device, the same
    # coordinator, each its own process id
    parser.add_argument("--coordinator", type=str,
                        default=os.environ.get("WDT_COORDINATOR"),
                        help="host:port of process 0's rendezvous")
    parser.add_argument("--num_processes", type=int,
                        default=int(os.environ.get("WDT_NUM_PROCESSES", "0"))
                        or None)
    parser.add_argument("--process_id", type=int,
                        default=(int(os.environ["WDT_PROCESS_ID"])
                                 if "WDT_PROCESS_ID" in os.environ else None))
    parser.add_argument("--trace_out", type=str, default=None,
                        help="trace the run (core/trace.py: spans and "
                             "counters) and write it to this path as a "
                             "Chrome trace; one process only")
    args = parser.parse_args(argv)
    if args.trace_out and (args.coordinator or args.num_devices > 1):
        parser.error("--trace_out traces one process: not with -n or "
                     "--coordinator")
    if args.coordinator and (args.num_processes is None
                             or args.process_id is None):
        raise ValueError("--coordinator needs --num_processes and "
                         "--process_id (or WDT_NUM_PROCESSES and "
                         "WDT_PROCESS_ID)")

    logging.basicConfig(level=logging.INFO)
    run_config = load_run_config(args.env)
    if args.num_episodes is not None:
        run_config["trainer"]["num_episodes"] = args.num_episodes
    if args.num_envs is not None:
        run_config["trainer"]["num_envs"] = args.num_envs
    if args.auto_scale:
        from warpdrive_tpu_torch.tools.autoscaler import (
            perform_auto_vertical_scaling,
        )

        run_config = perform_auto_vertical_scaling(run_config,
                                                   device=args.device)
    if args.coordinator:
        return _train_multihost(run_config, args)
    if args.num_devices > 1:
        return local_launch.launch(
            _train_rank, args.num_devices,
            args=(run_config, args.num_devices, args.results_dir),
            device=args.device, timeout_s=None)
    if not args.trace_out:
        return setup_trainer_and_train(
            run_config, results_dir=args.results_dir, device=args.device
        )
    trace.enable(args.device, capacity=1 << 20)
    try:
        return setup_trainer_and_train(
            run_config, results_dir=args.results_dir, device=args.device
        )
    finally:
        trace.disable()
        logging.info("trace written to %s",
                     trace.export_chrome(args.trace_out))


def _train_rank(device, run_config: dict, num_devices: int,
                results_dir: str) -> dict:
    """One rank of ``-n``: its share of the run; returns its parameters
    (host copies) and iteration count."""
    trainer = setup_trainer_and_train(
        run_config, num_devices=num_devices, results_dir=results_dir,
        device=device)
    state = trainer._training_state()
    nets = state["models"] if "models" in state else state["nets"]
    return {"iters_completed": trainer.iters_completed,
            "params": _to_host(nets)}


def _train_multihost(run_config: dict, args):
    """This process's share of a run across hosts: join the group, train
    over every process (or ``-n`` of them), leave the group."""
    device = pmesh.local_device(args.device, args.process_id)
    pmesh.initialize_multihost(args.coordinator, args.num_processes,
                               args.process_id, device=device)
    try:
        num_devices = (args.num_devices if args.num_devices > 1
                       else pmesh.dist.get_world_size())
        return setup_trainer_and_train(
            run_config, num_devices=num_devices,
            results_dir=args.results_dir, device=device)
    finally:
        pmesh.dist.destroy_process_group()


if __name__ == "__main__":
    main()
