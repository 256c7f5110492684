"""The port's update over two gloo ranks against the JAX package's update
on a 2-device CPU mesh (``warpdrive_tpu.parallel.mesh``), from the same
parameters, optimizer states and recorded batch: each rank holds its half
of the envs (``apply_env_sharding``), takes global denominators and sums
its gradients with the other's.  Cases of one parametrised test: the
whole-batch A2C update, PPO over 2 epochs x 2 shuffled minibatches with
JAX's permutation table injected (each minibatch's rows fall unevenly on
the ranks), the normalized advantage and return, and DDPG (the replay
window not full, then full).  The downsampling's draws cannot be injected
into JAX's update: there the two ranks are held against the port's one
process with the same injected draws.

The JAX side runs in the pytest process; the ranks are spawned and import
no JAX (``tests/torch_dist_workers.py``)."""

import numpy as np
import pytest
import torch

from torch_dist_workers import a2c_update_rank, ddpg_update_rank
from warpdrive_tpu_torch.models.fully_connected import (
    adam_state_from_optax,
    params_from_flax,
)
from warpdrive_tpu_torch.parallel.launch import launch
from warpdrive_tpu_torch.utils import config as port_config

# as tests/test_torch_trainer_a2c.py: the two frameworks, and here the two
# ranks, sum the gradients in other orders
PARAM_ATOL = 1e-5
WORLD = 2
NUM_ENVS, T = 8, 10
# metrics that each rank holds a part of, against JAX's
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6
A2C_METRICS = ("Total loss", "Policy loss", "Value function loss",
               "Gradient norm", "Mean rewards", "Max. rewards",
               "Min. rewards", "Mean advantages", "Mean entropy",
               "Std. of action over envs")


def _config(load, policy=None, **trainer):
    cfg = load("tag_continuous")
    cfg["env"].update({"num_taggers": 2, "num_runners": 8,
                       "episode_length": 20, "num_other_agents_observed": 4})
    cfg["trainer"].update({"num_envs": NUM_ENVS,
                           "train_batch_size": T * NUM_ENVS,
                           "num_episodes": 40, "seed": 3, **trainer})
    for tag in ("runner", "tagger"):
        cfg["policy"][tag]["model"]["fc_dims"] = [16, 16]
        cfg["policy"][tag].update(policy or {})
    cfg["saving"]["metrics_log_freq"] = 100
    return cfg


def _host(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _env_sharded(tree, mesh, num_envs):
    """JAX arrays of a time-major tree placed with the env axis (dim 1)
    sharded over the mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    def place(x):
        x = jax.numpy.asarray(x)
        spec = (P(None, "env") if x.ndim >= 2 and x.shape[1] == num_envs
                else P())
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(place, tree)


@pytest.fixture(scope="module")
def jax_batch(tmp_path_factory):
    """The batch a JAX trainer's rollout records."""
    import jax

    from warpdrive_tpu.training.scripts.train import setup_trainer
    from warpdrive_tpu.utils import config as jax_config

    trainer = setup_trainer(_config(jax_config.load_run_config),
                            verbose=False,
                            results_dir=str(tmp_path_factory.mktemp("jax")))
    rollout = jax.jit(trainer._build_rollout_profile_fn())
    _, batch = rollout(trainer._carry, jax.random.PRNGKey(0))
    return _host(batch)


def _port_state(carry, policies):
    return {tag: (params_from_flax(_host(carry["params"][tag])),
                  adam_state_from_optax(_host(carry["opt"][tag])))
            for tag in policies}


def _assert_params(got: dict, want_flax: dict, label: str):
    for tag, params in got.items():
        want = params_from_flax(_host(want_flax[tag]))
        for name, p in params.items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{label} {tag} {name}")


def jax_sharded_a2c_update(policy, batch, tmp_path, mesh=None):
    """JAX's update of the config with ``policy``'s options on a mesh (2
    devices on the env axis unless ``mesh`` is given): parameters sharded
    as the mesh's trainer shards them, the batch on the env axis.  Returns
    the plain trainer's carry (the starting point), the new parameters and
    Adam states, the metrics and the injected tables."""
    import jax
    import jax.numpy as jnp

    from test_torch_update_options import jax_index_tables
    from warpdrive_tpu.parallel.mesh import make_mesh, shard_carry
    from warpdrive_tpu.training.scripts.train import setup_trainer
    from warpdrive_tpu.utils import config as jax_config

    cfg = _config(jax_config.load_run_config, policy)
    jtrainer = setup_trainer(cfg, verbose=False,
                             results_dir=str(tmp_path / "jax"))
    mesh = mesh or make_mesh(num_devices=WORLD)
    carry = jtrainer._carry
    sharded = shard_carry({"params": carry["params"], "opt": carry["opt"]},
                          mesh, NUM_ENVS)
    k_down = jax.random.PRNGKey(1)
    tables = jax_index_tables(jtrainer, k_down, NUM_ENVS)
    update = jax.jit(jtrainer._make_update(with_metrics=True))
    params, opt, metrics = update(sharded["params"], sharded["opt"],
                                  _env_sharded(batch, mesh, NUM_ENVS),
                                  jnp.float32(0), k_down)
    return jtrainer, carry, params, opt, _host(metrics), tables


A2C_CASES = {
    "a2c_whole_batch": {},
    "ppo_2_epochs_x_2_shuffled_minibatches": dict(
        algorithm="PPO", num_epochs=2, num_minibatches=2),
    "normalized_advantage_and_return": dict(normalize_advantage=True,
                                            normalize_return=True),
}


def _ddpg_config(load):
    cfg = load("single_pendulum")
    cfg["env"].update({"episode_length": 8, "reset_pool_size": 0, "seed": 3})
    cfg["trainer"].update({"num_envs": NUM_ENVS, "train_batch_size": 80,
                           "num_episodes": 40, "n_step": 3, "seed": 7})
    for net in ("actor", "critic"):
        cfg["policy"]["shared"]["model"][net]["fc_dims"] = [16, 16]
    cfg["saving"].update({"metrics_log_freq": 2,
                          "model_params_save_freq": 10_000})
    return cfg


def _check_ddpg(tmp_path):
    import jax
    import jax.numpy as jnp

    from warpdrive_tpu.training.scripts.train import setup_trainer
    from warpdrive_tpu.utils import config as jax_config

    jtrainer = setup_trainer(_ddpg_config(jax_config.load_run_config),
                             num_devices=WORLD, verbose=False,
                             results_dir=str(tmp_path / "jax"))
    assert jtrainer.engine.mesh.shape["env"] == WORLD
    carry = jtrainer._carry
    T_ = jtrainer.training_batch_size_per_env
    noise = {"shared": 0.2 * jax.random.normal(
        jax.random.PRNGKey(5), (T_,) + carry["ou"]["shared"].shape)}
    rollout = jax.jit(jtrainer._make_rollout())
    _, rows = rollout(
        carry["actor"],
        (carry["env_state"], carry["ou"], carry["ep_acc"], carry["ep_sum"],
         carry["ep_count"]),
        jax.random.split(jax.random.PRNGKey(6), T_), noise, 0.15, 0.2, 1.0)
    keys = ("actor", "critic", "target_actor", "target_critic", "opt_actor",
            "opt_critic", "buf", "done_buf", "filled")
    nets = {k: carry[k] for k in keys}
    start = {net: (params_from_flax(_host(carry[net]["shared"])),
                   params_from_flax(_host(carry[f"target_{net}"]["shared"])),
                   adam_state_from_optax(_host(carry[f"opt_{net}"]["shared"])))
             for net in ("actor", "critic")}
    replay_update = jax.jit(jtrainer._make_replay_update(with_metrics=True))
    jmetrics = []
    for timestep in (0.0, 80.0):
        nets, m = replay_update(nets, rows, jnp.float32(timestep))
        jmetrics.append(_host(m)["shared"])

    results = launch(ddpg_update_rank, WORLD,
                     args=(_ddpg_config(port_config.load_run_config), WORLD,
                           1, str(tmp_path / "port"), start, _host(rows)),
                     device="cpu", threads=1, timeout_s=300)
    for got in results:
        assert got["filled"] == [10, 12]
        for net in ("actor", "critic"):
            for kind, params in (("", got["nets"][net]),
                                 ("target_", got["targets"][net])):
                want = params_from_flax(_host(nets[f"{kind}{net}"]["shared"]))
                for name, p in params.items():
                    np.testing.assert_allclose(
                        p.numpy(), want[name].numpy(), rtol=0,
                        atol=PARAM_ATOL, err_msg=f"{kind}{net} {name}")
            adam = adam_state_from_optax(_host(nets[f"opt_{net}"]["shared"]))
            assert got["adam"][net]["count"] == adam["count"] == 1
        for step in range(2):
            for name in ("Critic loss", "Actor loss", "Total loss",
                         "Mean rewards", "Max of action", "Min of action",
                         "Mean J function", "Buffer full",
                         "Critic gradient norm", "Actor gradient norm"):
                np.testing.assert_allclose(
                    got["metrics"][step][name],
                    float(jmetrics[step][name]), rtol=METRIC_RTOL,
                    atol=METRIC_ATOL, err_msg=f"step {step} {name}")
    for a, b in zip(*(r["nets"]["actor"].values() for r in results)):
        assert torch.equal(a, b)  # the ranks' replicas stay equal


@pytest.mark.parametrize("case", sorted(A2C_CASES) + ["ddpg"])
def test_two_rank_update_matches_jax_mesh(case, jax_batch, tmp_path):
    if case == "ddpg":
        _check_ddpg(tmp_path)
        return
    policy = A2C_CASES[case]
    jtrainer, carry, params, opt, jmetrics, tables = \
        jax_sharded_a2c_update(policy, jax_batch, tmp_path)
    results = launch(
        a2c_update_rank, WORLD,
        args=(_config(port_config.load_run_config, policy), WORLD, 1,
              str(tmp_path / "port"),
              _port_state(carry, jtrainer.policies), jax_batch,
              tables or None),
        device="cpu", threads=1, timeout_s=300)
    for got in results:
        _assert_params(got["params"], params, case)
        for tag in got["params"]:
            adam = adam_state_from_optax(_host(opt[tag]))
            assert got["adam"][tag]["count"] == adam["count"]
            for name in A2C_METRICS:
                np.testing.assert_allclose(
                    got["metrics"][tag][name], float(jmetrics[tag][name]),
                    rtol=METRIC_RTOL, atol=METRIC_ATOL,
                    err_msg=f"{case} {tag} {name}")
    for tag, p in results[0]["params"].items():
        for name, value in p.items():  # replicated without a broadcast
            assert torch.equal(value, results[1]["params"][tag][name]), name


def test_downsampled_update_matches_one_rank(jax_batch, tmp_path):
    """``neg_pos_env_ratio`` with done==2 success markers on 3 of the 8
    envs and the same injected uniform draws: the two ranks' update (the
    positive count summed over them) against the port's one process."""
    batch = dict(jax_batch)
    done = batch["done"].copy()
    done[-1, [0, 3, 6]] = 2
    batch["done"] = done
    uniform = np.random.RandomState(0).uniform(size=NUM_ENVS).astype(
        np.float32)
    policy = {}
    cfg = _config(port_config.load_run_config, policy, neg_pos_env_ratio=0.4)

    import jax  # noqa: F401  (the starting parameters are JAX's)

    from warpdrive_tpu.training.scripts.train import setup_trainer
    from warpdrive_tpu.utils import config as jax_config

    jtrainer = setup_trainer(_config(jax_config.load_run_config),
                             verbose=False, results_dir=str(tmp_path / "jax"))
    state = _port_state(jtrainer._carry, jtrainer.policies)
    one = a2c_update_rank("cpu", cfg, 1, 1, str(tmp_path / "one"), state,
                          batch, None, uniform=uniform)
    two = launch(a2c_update_rank, WORLD,
                 args=(cfg, WORLD, 1, str(tmp_path / "two"), state, batch,
                       None, uniform),
                 device="cpu", threads=1, timeout_s=300)
    kept = one["metrics"]["runner"]["Num of Sampled Envs"]
    assert 3 <= kept < NUM_ENVS  # the positives and some negatives
    for got in two:
        assert got["metrics"]["runner"]["Num of Sampled Envs"] == kept
        for tag, params in got["params"].items():
            for name, p in params.items():
                np.testing.assert_allclose(
                    p.numpy(), one["params"][tag][name].numpy(), rtol=0,
                    atol=PARAM_ATOL, err_msg=f"{tag} {name}")
