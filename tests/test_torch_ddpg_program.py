"""DDPG's programs and the eager backend's update programs
(``warpdrive_tpu_torch/training/trainer_ddpg.py``, ``trainer_a2c.py``,
``core/program.py``) on the CPU, where a program calls its body directly
with the same static buffers and in-place writes that a card captures:

- the DDPG iteration (noise draw, rollout step, replay append, the full,
  hot and warm updates) with a hot update leaves the carry as a full one
  bit for bit over 3 iterations across the warm-up gate (nets, targets,
  Adam moments and counts, window, rows, OU state, env state, episodic
  sums, generator), on Pendulum and on ContinuousMountainCar with a bf16
  window and remat;
- the hot update equals the full one bit for bit;
- 3 programmed iterations with the JAX package's OU noise written into the
  noise buffer match JAX's rollout and replay update across the gate
  (1e-5, as ``tests/test_torch_ddpg.py`` holds one update);
- a resume into built programs is bit for bit against a straight run;
- a rebound window, OU or row buffer raises (``Program.check_buffers``);
- on the eager host-env backend the hot update programs (A2C and DDPG)
  leave the carry as the full ones bit for bit.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.training.scripts.train import setup_trainer as jax_setup
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.core.program import storages
from warpdrive_tpu_torch.envs.cpu_engine import CpuEnvEngine
from warpdrive_tpu_torch.models.fully_connected import (
    adam_state_from_optax,
    params_from_flax,
)
from warpdrive_tpu_torch.parallel.mesh import reduce_metrics
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.training.trainer_a2c import TrainerA2C
from warpdrive_tpu_torch.training.trainer_ddpg import TrainerDDPG
from warpdrive_tpu_torch.utils import config as port_config

# as tests/test_torch_ddpg.py: the two frameworks sum the GEMMs and the
# gradients in other orders (relative differences of about 1e-6), and
# Adam's steps are of clipped gradients
UPDATE_TOL = 1e-5
_NETS = ("actor", "critic")


def _pendulum(load, **trainer):
    """Pendulum at 8 envs, 10 steps an iteration, n_step 3 (a 12-row
    window: not full after iteration 1), episodes of 8, fc (16, 16)."""
    cfg = load("single_pendulum")
    cfg["env"].update({"episode_length": 8, "reset_pool_size": 0, "seed": 3})
    cfg["trainer"].update({"num_envs": 8, "train_batch_size": 80,
                           "num_episodes": 40, "n_step": 3, "seed": 7,
                           **trainer})
    for net in _NETS:
        cfg["policy"]["shared"]["model"][net]["fc_dims"] = [16, 16]
    cfg["saving"].update({"metrics_log_freq": 10**9,
                          "model_params_save_freq": 10**9})
    return cfg


def _mountain_car(load):
    """ContinuousMountainCar with a reset pool, a bf16 window and remat:
    6 envs x 5 steps, n_step 4 (an 8-row window)."""
    cfg = load("single_continuous_mountain_car")
    cfg["env"].update({"episode_length": 7, "reset_pool_size": 12,
                       "seed": 2})
    cfg["trainer"].update({"num_envs": 6, "train_batch_size": 30,
                           "num_episodes": 30, "n_step": 4, "seed": 5,
                           "batch_dtype": "bfloat16"})
    cfg["policy"]["shared"]["remat"] = True
    for net in _NETS:
        cfg["policy"]["shared"]["model"][net]["fc_dims"] = [8, 8]
    cfg["saving"].update({"metrics_log_freq": 10**9,
                          "model_params_save_freq": 10**9})
    return cfg


CONFIGS = {"single_pendulum": _pendulum,
           "continuous_mountain_car_bf16_remat": _mountain_car}


def _trainer(tmp_path, name, config):
    return port_train.setup_trainer(copy.deepcopy(config), verbose=False,
                                    results_dir=str(tmp_path / name),
                                    device="cpu")


def _carry(trainer) -> dict:
    """Everything a DDPG iteration reads and writes."""
    return {
        "nets": {net: {t: m.state_dict() for t, m in by_tag.items()}
                 for net, by_tag in trainer.nets.items()},
        "targets": {net: {t: m.state_dict() for t, m in by_tag.items()}
                    for net, by_tag in trainer.targets.items()},
        "optimizers": {net: {t: {"count": torch.tensor(o.count),
                                 "mu": o.mu, "nu": o.nu}
                             for t, o in by_tag.items()}
                       for net, by_tag in trainer.optimizers.items()},
        "window": trainer._window, "rows": trainer._rows,
        "ou": trainer._ou, "env_state": trainer._env_state,
        "episodes": [trainer._ep_acc, trainer._ep_sum, trainer._ep_count],
        "filled": torch.tensor(trainer.filled),
        "generator": trainer.generator.get_state(),
    }


def _leaves(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


def _assert_equal_trees(a, b):
    left, right = dict(_leaves(a)), dict(_leaves(b))
    assert left.keys() == right.keys()
    for path, x in left.items():
        assert x.dtype == right[path].dtype, path
        assert torch.equal(x, right[path]), f"{path} differs"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_programmed_ddpg_iteration_equals_the_eager_one(name, tmp_path):
    """Two trainers of one config through ``_iteration``, the scheduled
    one full, hot, full, the other full on all three.  Iteration 1 fills
    the window part way (the warm program's metrics, nothing moves), 2 runs
    the hot update against the full one, 3 the full one: every carry
    tensor equal after each, and the full iterations' metrics equal."""
    config = CONFIGS[name](port_config.load_run_config)
    scheduled = _trainer(tmp_path, "scheduled", config)
    everything = _trainer(tmp_path, "full", config)
    assert not scheduled._programmed  # the CPU: programs call their bodies
    steps = scheduled.training_batch_size_per_env * scheduled.num_envs
    for i, full in enumerate((True, False, True)):
        t = i * steps
        got = scheduled._iteration(t, full=full)
        want = everything._iteration(t)
        if full:
            np.testing.assert_equal(reduce_metrics(got),
                                    reduce_metrics(want))
            assert got["shared"]["Buffer full"] == float(i > 0)
        else:
            assert got == {}
        _assert_equal_trees(_carry(scheduled), _carry(everything))
    assert scheduled.optimizers["actor"]["shared"].count == 2
    for program in scheduled._programs.values():
        program.check_buffers()
    assert set(scheduled._programs) == {
        "noise", "rollout", "append", ("shared", "full"),
        ("shared", "hot"), ("shared", "warm")}


def test_hot_ddpg_update_equals_the_full_one(tmp_path):
    config = _pendulum(port_config.load_run_config)
    hot, full = (_trainer(tmp_path, n, config) for n in ("hot", "full"))
    for t in (0, 80):
        for trainer in (hot, full):
            trainer._rollout_programmed(t)
        assert hot._update_programmed(t, full=False) == {}
        metrics = full._update_programmed(t, full=True)
        assert "Critic gradient norm" in metrics["shared"]
    assert hot.optimizers["critic"]["shared"].count == 1
    _assert_equal_trees(_carry(hot), _carry(full))


def test_programmed_ddpg_matches_jax_across_the_gate(tmp_path):
    """The same nets, optax states and OU noise on both sides, 3 iterations
    (not full, full, full): JAX's jitted rollout and replay update against
    the port's rollout-step, append and update programs -- parameters,
    targets and Adam moments within 1e-5 after each, the gate alike."""
    jtrainer = jax_setup(_pendulum(jax_config.load_run_config),
                         verbose=False, results_dir=str(tmp_path / "jax"))
    port = _trainer(tmp_path, "port", _pendulum(port_config.load_run_config))
    carry = jtrainer._carry
    for net in _NETS:
        port.nets[net]["shared"].load_state_dict(
            params_from_flax(_host(carry[net]["shared"])))
        port.targets[net]["shared"].load_state_dict(
            params_from_flax(_host(carry[f"target_{net}"]["shared"])))
        port.optimizers[net]["shared"].load_state_dict(
            adam_state_from_optax(_host(carry[f"opt_{net}"]["shared"])))
    T = jtrainer.training_batch_size_per_env
    rollout = jax.jit(jtrainer._make_rollout())
    replay_update = jax.jit(jtrainer._make_replay_update(with_metrics=False))
    nets = {k: carry[k] for k in (
        "actor", "critic", "target_actor", "target_critic", "opt_actor",
        "opt_critic", "buf", "done_buf", "filled")}
    rs_carry = (carry["env_state"], carry["ou"], carry["ep_acc"],
                carry["ep_sum"], carry["ep_count"])
    port._build_programs()
    for i in range(3):
        timestep = float(i * T * 8)
        noise = 0.2 * jax.random.normal(jax.random.PRNGKey(10 + i),
                                        (T,) + carry["ou"]["shared"].shape)
        rs_carry, rows = rollout(nets["actor"], rs_carry,
                                 jax.random.split(jax.random.PRNGKey(i), T),
                                 {"shared": noise}, 0.15, 0.2, 1.0)
        nets, _ = replay_update(nets, rows, jnp.float32(timestep))

        port._write_schedules(timestep)
        port._noise["shared"].copy_(torch.from_numpy(np.array(noise)))
        port._row.zero_()
        for _ in range(T):
            port._programs["rollout"]()
        port._rollout_done()
        port._update_programmed(timestep, full=False)
        assert port.filled == int(nets["filled"])
        assert port.optimizers["actor"]["shared"].count == i
        for net in _NETS:
            for kind, module in (("", port.nets[net]["shared"]),
                                 ("target_", port.targets[net]["shared"])):
                want = params_from_flax(_host(nets[f"{kind}{net}"]["shared"]))
                for key, p in module.named_parameters():
                    np.testing.assert_allclose(
                        p.detach().numpy(), want[key].numpy(), rtol=0,
                        atol=UPDATE_TOL, err_msg=f"{i} {kind}{net} {key}")
            adam = adam_state_from_optax(_host(nets[f"opt_{net}"]["shared"]))
            got = port.optimizers[net]["shared"].state_dict()
            assert got["count"] == adam["count"]
            for moment in ("mu", "nu"):
                for key, m in got[moment].items():
                    np.testing.assert_allclose(
                        m.numpy(), adam[moment][key].numpy(), rtol=0,
                        atol=UPDATE_TOL, err_msg=f"{i} {net} {moment}")
    np.testing.assert_allclose(port._ou["shared"].numpy(),
                               np.asarray(rs_carry[1]["shared"]), rtol=0,
                               atol=UPDATE_TOL)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _buffers(trainer):
    return {key: storages(p.buffers) for key, p in trainer._programs.items()}


def test_resume_into_built_ddpg_programs_is_bit_for_bit(tmp_path):
    config = _pendulum(port_config.load_run_config)
    steps = 80

    def run(trainer, first, n):
        for i in range(first, first + n):
            trainer._iteration_programmed(i * steps, full=i % 2 == 0)
            trainer.current_timestep = (i + 1) * steps
            trainer.iters_completed = i + 1

    straight = _trainer(tmp_path, "straight", config)
    run(straight, 0, 4)
    first = _trainer(tmp_path, "first", config)
    run(first, 0, 2)
    path = first.save_full_state(str(tmp_path / "full.ckpt"))

    other = copy.deepcopy(config)
    other["trainer"]["seed"] = 99
    resumed = _trainer(tmp_path, "resumed", other)
    run(resumed, 0, 1)  # programs built on other states
    before = _buffers(resumed)
    resumed.load_full_state(path)
    assert _buffers(resumed) == before
    assert (resumed.iters_completed, resumed.filled) == (2, 12)
    run(resumed, 2, 2)
    assert _buffers(resumed) == before
    _assert_equal_trees(_carry(resumed), _carry(straight))


@pytest.mark.parametrize("rebound", ["window", "ou", "rows"])
def test_a_rebound_ddpg_buffer_raises(rebound, tmp_path):
    trainer = _trainer(tmp_path, "port",
                       _pendulum(port_config.load_run_config))
    trainer._iteration_programmed(0, full=True)
    if rebound == "window":  # the old append: a cat bound in its place
        trainer._window["done"] = torch.cat([trainer._window["done"][10:],
                                             trainer._rows["done"]])
    elif rebound == "ou":
        trainer._ou["shared"] = trainer._ou["shared"] * 1.0
    else:
        trainer._rows["obs_shared"] = trainer._rows["obs_shared"].clone()
    with pytest.raises(RuntimeError, match="buffers rebound"):
        trainer._iteration_programmed(80, full=True)


# ------------------------------------------------- the eager host-env backend
_TG = {"num_taggers": 1, "grid_length": 6, "episode_length": 12,
       "seed": 4}
_PEND = {"episode_length": 9, "seed": 6}


def _tag_gridworld_config():
    return {
        "name": "tag_gridworld",
        "trainer": {"num_envs": 4, "num_episodes": 20,
                    "train_batch_size": 40, "seed": 2},
        "policy": {"shared": {"to_train": True, "algorithm": "A2C",
                              "gamma": 0.98, "lr": 0.01,
                              "model": {"type": "fully_connected",
                                        "fc_dims": [16, 16]}}},
        "saving": {"metrics_log_freq": 10**9,
                   "model_params_save_freq": 10**9},
    }


def _pendulum_ddpg_config():
    cfg = _pendulum(port_config.load_run_config)
    cfg["trainer"].update({"num_envs": 4, "train_batch_size": 24,
                           "num_episodes": 30})
    return cfg


def _backend_carry(trainer, kind) -> dict:
    if kind == "a2c":
        nets = {t: m.state_dict() for t, m in trainer.models.items()}
        batch = trainer._batch
    else:
        nets = {n: {t: m.state_dict() for t, m in by_tag.items()}
                for n, by_tag in trainer.nets.items()}
        batch = trainer._window
    return {"nets": nets, "batch": batch,
            "generator": trainer.generator.get_state(),
            "engine": dict(trainer.engine.state)}


@pytest.mark.parametrize("kind", ["a2c", "ddpg"])
def test_eager_backend_update_programs_equal_the_eager_update(kind,
                                                              tmp_path):
    """Two trainers on the eager backend with identically seeded envs,
    each iteration the host-stepped rollout into the static batch or rows,
    then the update programs: full, hot, full against full on all three,
    bit for bit after each of the 3 iterations (DDPG across its gate)."""
    def build(name):
        if kind == "a2c":
            engine = CpuEnvEngine(env_name="TagGridWorld", env_config=_TG,
                                  num_envs=4, native=False, device="cpu")
            return TrainerA2C(env_wrapper=engine,
                              config=_tag_gridworld_config(), verbose=False,
                              results_dir=str(tmp_path / name))
        engine = CpuEnvEngine(env_name="ClassicControlPendulumEnv",
                              env_config=_PEND, num_envs=4, native=False,
                              device="cpu")
        return TrainerDDPG(env_wrapper=engine, config=_pendulum_ddpg_config(),
                           verbose=False, results_dir=str(tmp_path / name))

    scheduled, everything = build("scheduled"), build("full")
    for i, full in enumerate((True, False, True)):
        t = i * 24
        got = scheduled._iteration(t, full=full)
        want = everything._iteration(t)
        if full:
            np.testing.assert_equal(reduce_metrics(got),
                                    reduce_metrics(want))
        _assert_equal_trees(_backend_carry(scheduled, kind),
                            _backend_carry(everything, kind))
    assert "rollout" not in scheduled._programs
