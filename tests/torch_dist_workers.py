"""Rank workers of the port's multi-rank tests (not a test module).

``warpdrive_tpu_torch.parallel.launch`` spawns each rank in a fresh
interpreter, which imports this module by name: it imports no JAX, only
the port, numpy and torch.  Every worker takes the rank's device first and
returns host tensors."""

import numpy as np
import torch

from warpdrive_tpu_torch.parallel.mesh import reduce_metrics
from warpdrive_tpu_torch.training.scripts import train as port_train


def host(tree):
    """Nested dicts of host clones."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def local_rows(batch: dict, trainer) -> dict:
    """The rank's env rows of a time-major batch ``{key: (T, E, ...)}``."""
    return {k: torch.as_tensor(np.array(v))[:, trainer.env_rows].clone()
            for k, v in batch.items()}


def a2c_update_rank(device, cfg, world, tp, results_dir, state, batch,
                    tables, uniform=None):
    """One update of the A2C/PPO trainer built from ``cfg`` over ``world``
    ranks (``tp`` of them on the model axis), from the models and Adam
    states ``state`` ``{tag: (state_dict, adam)}`` on the rank's rows of
    ``batch``; ``uniform`` (E,), when given, replaces the downsampling's
    draws.  Returns the parameters, the whole Adam moments, the global
    metrics and the optimizers' shard shapes."""
    trainer = port_train.setup_trainer(cfg, num_devices=world, tp=tp,
                                       verbose=False, device=device,
                                       results_dir=results_dir)
    for tag, (params, adam) in state.items():
        trainer.models[tag].load_state_dict(params)
        trainer.optimizers[tag].load_state_dict(adam)
    if uniform is not None:
        rows = torch.as_tensor(uniform)[trainer.env_rows]
        for algo in trainer.algorithms.values():
            plain = algo.compute_loss_and_metrics

            def injected(*args, plain=plain, **kwargs):
                return plain(*args, downsample_uniform=rows, **kwargs)

            algo.compute_loss_and_metrics = injected
    metrics = trainer._update(local_rows(batch, trainer), 0,
                              index_tables=tables)
    return {"params": {tag: host(m.state_dict())
                       for tag, m in trainer.models.items()},
            "adam": {tag: host(o.state_dict())
                     for tag, o in trainer.optimizers.items()},
            "shard_shapes": {tag: {n: tuple(m.shape) for n, m in o.mu.items()}
                             for tag, o in trainer.optimizers.items()},
            "metrics": reduce_metrics(metrics, trainer.mesh)}


def ddpg_update_rank(device, cfg, world, tp, results_dir, nets, rows):
    """The DDPG trainer built from ``cfg`` over ``world`` ranks, its nets,
    targets and Adam states from ``nets`` ``{net: (state_dict,
    target_state_dict, adam)}``; the rank's rows of ``rows`` into the
    replay window twice (not full, then full).  Returns the nets, targets,
    whole Adam states, the fill counts and the global metrics of both."""
    trainer = port_train.setup_trainer(cfg, num_devices=world, tp=tp,
                                       verbose=False, device=device,
                                       results_dir=results_dir)
    for net, (params, target, adam) in nets.items():
        trainer.nets[net]["shared"].load_state_dict(params)
        trainer.targets[net]["shared"].load_state_dict(target)
        trainer.optimizers[net]["shared"].load_state_dict(adam)
    local = local_rows(rows, trainer)
    metrics, filled = [], []
    for timestep in (0.0, 80.0):
        m = trainer._replay_update(local, timestep)
        metrics.append(reduce_metrics(m, trainer.mesh)["shared"])
        filled.append(trainer.filled)
    return {"nets": {net: host(trainer.nets[net]["shared"].state_dict())
                     for net in trainer.nets},
            "targets": {net: host(trainer.targets[net]["shared"]
                                  .state_dict()) for net in trainer.targets},
            "adam": {net: host(trainer.optimizers[net]["shared"]
                               .state_dict()) for net in trainer.optimizers},
            "filled": filled, "metrics": metrics}


def cartpole_engine(device):
    """The CartPole engine of ``tests/test_mesh_sharding.py``: 16 envs,
    the env seeded 3, the store 0."""
    from warpdrive_tpu_torch.envs import register_all_envs
    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.utils.env_registrar import env_registrar

    register_all_envs()
    env_cls = env_registrar.get("ClassicControlCartPoleEnv", backend="torch")
    return EnvEngine(env_obj=env_cls(episode_length=100, seed=3),
                     num_envs=16, seed=0, device=device)


def engine_rows_rank(device):
    """The rank's rows of the sharded CartPole engine as built, then the
    facade's (gathered) step of every env with action 1, and the rank's
    rows after it."""
    from warpdrive_tpu_torch.parallel.mesh import apply_env_sharding

    engine = apply_env_sharding(cartpole_engine(device))
    start = host(dict(engine.state))
    out = engine.step_all_envs(np.ones((16, 1), np.int32))
    return {"rows": (engine.env_rows.start, engine.env_rows.stop),
            "start": start, "step": host(out),
            "after": host(dict(engine.state))}


def to_host_rank(device):
    """``to_host`` of an env-cut tensor on dim 0 and on dim 1, and of a
    whole one."""
    from warpdrive_tpu_torch.parallel.mesh import make_mesh, to_host

    mesh = make_mesh()
    rows = mesh.env_rows(6)
    x = torch.arange(6 * 4, dtype=torch.float32).reshape(6, 4)[rows]
    window = torch.arange(3 * 6).reshape(3, 6)[:, rows]
    return {"dim0": to_host(x, mesh, 0), "dim1": to_host(window, mesh, 1),
            "local": to_host(x)}


def sharding_errors_rank(device):
    """The errors of an env count the ranks do not divide and of an env
    without a seed (each rank would draw other envs)."""
    from warpdrive_tpu_torch.envs.engine import EnvEngine
    from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
    from warpdrive_tpu_torch.parallel.mesh import apply_env_sharding

    errors = {}
    for label, build in (
            ("odd", lambda: EnvEngine(
                env_obj=TorchTagContinuous(num_taggers=1, num_runners=3,
                                           seed=1), num_envs=3,
                device=device)),
            ("unseeded", lambda: EnvEngine(
                env_obj=TorchTagContinuous(num_taggers=1, num_runners=3),
                num_envs=4, device=device))):
        try:
            apply_env_sharding(build())
        except ValueError as e:
            errors[label] = str(e)
    return errors


def cartpole_config(basedir: str) -> dict:
    """The CartPole run of ``tests/multiproc_worker.py``: 16 envs, 20-step
    episodes, 4 iterations of 320 env-steps, metrics every 2."""
    return {
        "name": "single_cartpole",
        "env": {"episode_length": 20, "reset_pool_size": 0, "seed": 4},
        "trainer": {"num_envs": 16, "num_episodes": 16 * 4,
                    "train_batch_size": 16 * 20, "seed": 7},
        "policy": {"shared": {
            "to_train": True, "algorithm": "A2C", "gamma": 0.98, "lr": 0.01,
            "model": {"type": "fully_connected", "fc_dims": [16]}}},
        "saving": {"metrics_log_freq": 2, "model_params_save_freq": 10**9,
                   "basedir": basedir, "name": "mp", "tag": "t"},
    }


def train_rank(device, cfg, results_dir, full_state_path):
    """``train()`` over the group, then a full-state file."""
    trainer = port_train.setup_trainer(cfg, num_devices=2, verbose=False,
                                       device=device, results_dir=results_dir)
    trainer.train()
    trainer.save_full_state(full_state_path)
    return {"iters": trainer.iters_completed, "lead": trainer.is_lead,
            "params": host(trainer.models["shared"].state_dict())}


def resume_rank(device, cfg, results_dir, path_in, path_out):
    """A full-state file loaded over the group and written again."""
    trainer = port_train.setup_trainer(cfg, num_devices=2, verbose=False,
                                       device=device, results_dir=results_dir)
    trainer.load_full_state(path_in)
    trainer.save_full_state(path_out)
    return trainer.iters_completed


def tag_continuous_config(basedir: str) -> dict:
    """A small TagContinuous run (2 taggers + 8 runners, k = 4, 4 envs,
    episodes of 20 steps, fc (16, 16)) whose env logs its positions."""
    from warpdrive_tpu_torch.utils.config import load_run_config

    cfg = load_run_config("tag_continuous")
    cfg["env"].update({"num_taggers": 2, "num_runners": 8,
                       "episode_length": 20, "num_other_agents_observed": 4})
    cfg["trainer"].update({"num_envs": 4, "train_batch_size": 40,
                           "num_episodes": 4, "seed": 3})
    for tag in ("runner", "tagger"):
        cfg["policy"][tag]["model"]["fc_dims"] = [16, 16]
    cfg["saving"]["basedir"] = basedir
    return cfg


def evaluation_rank(device, cfg, world, results_dir, env_id):
    """``evaluate_episodes``, ``fetch_episode_states`` and
    ``fetch_logged_episode`` of env ``env_id`` over ``world`` ranks."""
    trainer = port_train.setup_trainer(cfg, num_devices=world, verbose=False,
                                       device=device, results_dir=results_dir)
    rewards, steps = trainer.evaluate_episodes(use_argmax=True)
    states = trainer.fetch_episode_states(["loc_x", "loc_y"], env_id=env_id,
                                          include_rewards_actions=True,
                                          include_probabilities=True)
    logged = trainer.fetch_logged_episode(env_id=env_id)
    return {"rewards": rewards, "steps": steps, "states": states,
            "logged": logged}


def failing_rank(device):
    """Rank 1 raises; rank 0 waits in an all-reduce it never completes."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
