"""The compiled iteration of the port (``warpdrive_tpu_torch/core/
program.py``, ``TrainerA2C``'s rollout-step and update-pass programs,
``presets.captured_loop``) on the CPU, where a program calls its body
directly with the same static buffers and in-place writes that a card
captures:

- a :class:`Program` keeps its buffers' storages and raises when one is
  rebound; the launch-credit arithmetic on a stub kernel;
- an iteration through ``_iteration`` with a hot (metrics-free) update
  leaves the carry as a full one bit for bit over 3 iterations
  (parameters, Adam moments and counts, env state, episodic accounting,
  batch, generator) for five configurations: the
  ``tag_continuous`` run config cut to 5 envs x 20 agents (K2's plain
  version), PPO over 2 epochs x 4 shuffled minibatches with remat and a
  bf16 model and batch, ``update_recompute_obs``, ``single_cartpole`` with
  a reset pool, and ``asymmetric_pursuit`` (Dict observations, masks);
- ``train()`` runs the programs, hot ones between log points, and logs
  the metrics of a trainer whose every iteration is full;
- the hot (metrics-free) update equals the full one bit for bit;
- two programmed updates match the JAX package's (1e-5, as
  ``test_torch_trainer_a2c.py``);
- ``ClippedAdam``'s device-side bias corrections against optax's
  ``scale_by_adam`` through JAX (1e-6 over 5 steps);
- the schedules' device scalars equal ``value_at`` bit for bit;
- ``load_full_state`` and ``load_model_checkpoint`` into built programs
  keep the storages and resume bit for bit against a straight run;
- the captured preset loops equal their eager steps bit for bit, and the
  engine's facade writes a pinned state in place;
- ``profile_trace``, ``graceful_close`` and ``dispatch_sync_freq``.
"""

import copy
import json
import logging
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.training.scripts.train import setup_trainer as jax_setup
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.core import trace
from warpdrive_tpu_torch.core.program import (
    Program,
    credit_launches,
    launches_of,
    storages,
)
from warpdrive_tpu_torch.models.fully_connected import (
    adam_state_from_optax,
    params_from_flax,
)
from warpdrive_tpu_torch.ops import knn_obs, tag_physics
from warpdrive_tpu_torch.parallel.mesh import reduce_metrics
from warpdrive_tpu_torch.presets import (
    build_env_only_loop,
    build_flagship,
    captured_loop,
)
from warpdrive_tpu_torch.training.param_scheduler import ParamScheduler
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.training.trainer_a2c import ClippedAdam
from warpdrive_tpu_torch.utils import config as port_config

# as tests/test_torch_trainer_a2c.py: two updates of the two frameworks
# agree within 1e-5 (gradients summed in other orders, Adam's normalized
# step far below the learning rate)
PARAM_ATOL = 1e-5
# the bias corrections in float32 on the device against optax's: each
# moment and parameter within a few float32 ulps of the step's size
ADAM_ATOL = 1e-6


# ----------------------------------------------------------- mechanics
def test_program_keeps_its_buffers_and_raises_on_a_rebound_one():
    carry = {"x": torch.zeros(4), "n": [torch.zeros((), dtype=torch.int32)]}
    ptrs = storages(carry)

    def body():
        carry["x"].add_(1.0)
        carry["n"][0].add_(1)
        return carry["x"].sum()

    program = Program(body, carry, "cpu", name="stub")
    trace.enable("cpu")
    try:
        for _ in range(3):
            out = program()
    finally:
        trace.disable()
    assert storages(carry) == ptrs
    assert float(out) == 12.0 and int(carry["n"][0]) == 3
    # nothing captured or replayed on the CPU: no program.capture span
    names = [s["name"] for s in trace.spans()]
    trace.reset()
    assert "program.capture" not in names and "program.replay" not in names
    assert names.count("program.call") == 3
    assert (program.graph_nodes, program.launches, program.replays) == (
        None, {}, 0)
    carry["x"] = torch.zeros(4)  # rebound, not written into
    with pytest.raises(RuntimeError, match=r"stub: buffers rebound.*'x'"):
        program()


def test_launch_credit_arithmetic_on_a_stub():
    """What a capture's wrappers count is what each replay launches: the
    capture's own count is set back, and each replay credits it."""
    knn_obs.reset_launch_counts()

    def stub_kernel_body():  # a body whose "wrappers" launch K2 twice, K1 once
        knn_obs.LAUNCH_COUNTS["knn_obs_mxu"] += 2
        knn_obs.LAUNCH_COUNTS["knn_obs_flat_exact"] += 1
        return "out"

    stub_kernel_body()  # a warm-up: real launches, counted
    result, launches = launches_of(stub_kernel_body)  # the capture
    assert result == "out"
    assert launches == {"knn_obs_mxu": 2, "knn_obs_flat_exact": 1}
    assert knn_obs.LAUNCH_COUNTS["knn_obs_mxu"] == 2
    for _ in range(4):  # four replays
        credit_launches(launches)
    for _ in range(3):
        credit_launches({"knn_obs_mxu": 1})
    want = dict.fromkeys(knn_obs.LAUNCH_COUNTS, 0)
    want.update(knn_obs_mxu=2 + 4 * 2 + 3, knn_obs_flat_exact=1 + 4)
    assert knn_obs.LAUNCH_COUNTS == want
    with pytest.raises(ValueError):
        launches_of(lambda: (stub_kernel_body(), int("x")))
    assert knn_obs.LAUNCH_COUNTS == want  # set back after a failure too
    knn_obs.reset_launch_counts()


def test_launch_counts_are_registered_by_family():
    """Each ops module registers its own launch counts, the very dicts its
    wrappers update, under one family; no kernel is counted by two."""
    from warpdrive_tpu_torch.ops import cuda_build

    assert cuda_build.LAUNCH_COUNTS["knn"] is knn_obs.LAUNCH_COUNTS
    assert cuda_build.LAUNCH_COUNTS["physics"] is tag_physics.LAUNCH_COUNTS
    with pytest.raises(ValueError, match="counted by 'knn'"):
        cuda_build.register_launch_counts("stub", {"knn_obs_mxu": 0})
    assert "stub" not in cuda_build.LAUNCH_COUNTS
    cuda_build.register_launch_counts("physics", tag_physics.LAUNCH_COUNTS)
    assert cuda_build.LAUNCH_COUNTS["physics"] is tag_physics.LAUNCH_COUNTS


def test_launch_credit_covers_the_physics_kernel_on_a_stub():
    """A capture that counts physics and kNN launches credits each to its
    own count: the physics kernel's never enters ``knn_obs.LAUNCH_COUNTS``."""
    knn_obs.reset_launch_counts()
    tag_physics.reset_launch_counts()

    def stub_step():  # one physics launch and one K1 launch
        tag_physics.LAUNCH_COUNTS["tag_physics"] += 1
        knn_obs.LAUNCH_COUNTS["knn_obs_flat_exact"] += 1

    _, launches = launches_of(stub_step)
    assert launches == {"tag_physics": 1, "knn_obs_flat_exact": 1}
    assert tag_physics.LAUNCH_COUNTS == {"tag_physics": 0}
    for _ in range(5):
        credit_launches(launches)
    assert tag_physics.LAUNCH_COUNTS == {"tag_physics": 5}
    assert knn_obs.LAUNCH_COUNTS == dict(
        dict.fromkeys(knn_obs.LAUNCH_COUNTS, 0), knn_obs_flat_exact=5)
    knn_obs.reset_launch_counts()
    tag_physics.reset_launch_counts()


# -------------------------------------------------- the five configurations
def _saving(cfg):
    cfg["saving"].update({"metrics_log_freq": 10**9,
                          "model_params_save_freq": 10**9})


def _tag_continuous_run_config(load):
    """The shipped run config cut to 5 envs x 20 agents (2 + 18), episodes
    of 12 steps, 10 steps an iteration; K2 (``pallas_mxu_exact``)."""
    cfg = load("tag_continuous")
    cfg["env"].update({"num_taggers": 2, "num_runners": 18,
                       "episode_length": 12})
    cfg["trainer"].update({"num_envs": 5, "train_batch_size": 50,
                           "num_episodes": 15, "seed": 3})
    _saving(cfg)
    return cfg


def _small_tag_continuous(load, policy=None, **trainer):
    cfg = load("tag_continuous")
    cfg["env"].update({"num_taggers": 2, "num_runners": 8,
                       "episode_length": 12, "num_other_agents_observed": 4})
    cfg["trainer"].update({"num_envs": 8, "train_batch_size": 80,
                           "num_episodes": 24, "seed": 7, **trainer})
    for tag in ("runner", "tagger"):
        cfg["policy"][tag]["model"]["fc_dims"] = [16, 16]
        cfg["policy"][tag].update(policy or {})
    _saving(cfg)
    return cfg


def _ppo_bf16(load):
    cfg = _small_tag_continuous(
        load, dict(algorithm="PPO", num_epochs=2, num_minibatches=4,
                   shuffle_minibatches=True, remat=True),
        batch_dtype="bfloat16")
    for tag in ("runner", "tagger"):
        cfg["policy"][tag]["model"]["dtype"] = "bfloat16"
    return cfg


def _recompute(load):
    return _small_tag_continuous(load, dict(num_minibatches=2),
                                 update_recompute_obs=True)


def _cartpole_pool(load):
    cfg = load("single_cartpole")
    cfg["env"].update({"episode_length": 20, "reset_pool_size": 16,
                       "seed": 5})
    cfg["trainer"].update({"num_envs": 8, "train_batch_size": 80,
                           "num_episodes": 12, "seed": 3})
    _saving(cfg)
    return cfg


def _pursuit(load):
    cfg = load("asymmetric_pursuit")
    cfg["env"].update({"episode_length": 12, "seed": 2})
    cfg["trainer"].update({"num_envs": 4, "train_batch_size": 40,
                           "num_episodes": 10, "seed": 3})
    for tag in ("pursuer", "evader"):
        cfg["policy"][tag]["model"]["fc_dims"] = [16, 16]
    _saving(cfg)
    return cfg


CONFIGS = {
    "tag_continuous": _tag_continuous_run_config,
    "ppo_bf16_shuffled_remat": _ppo_bf16,
    "update_recompute_obs": _recompute,
    "single_cartpole_pool": _cartpole_pool,
    "asymmetric_pursuit": _pursuit,
}


def _trainer(tmp_path, name, config):
    return port_train.setup_trainer(copy.deepcopy(config), verbose=False,
                                    results_dir=str(tmp_path / name),
                                    device="cpu")


def _carry(trainer) -> dict:
    """Everything an iteration reads and writes."""
    return {
        "models": {t: m.state_dict() for t, m in trainer.models.items()},
        "optimizers": {t: {"count": torch.tensor(o.count), "mu": o.mu,
                           "nu": o.nu}
                       for t, o in trainer.optimizers.items()},
        "env_state": trainer._env_state,
        "episodes": [trainer._ep_acc, trainer._ep_sum, trainer._ep_count],
        "batch": trainer._batch,
        "generator": trainer.generator.get_state(),
    }


def _assert_equal_trees(a, b):
    left, right = dict(_leaves(a)), dict(_leaves(b))
    assert left.keys() == right.keys()
    for path, x in left.items():
        assert x.dtype == right[path].dtype, path
        assert torch.equal(x, right[path]), f"{path} differs"


def _leaves(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_programmed_iteration_equals_the_eager_one(name, tmp_path):
    """Two trainers of one config through ``_iteration``: the scheduled
    one hot on iteration 2, as ``train()`` runs between log points, the
    other full on all three.  The hot iteration returns no metrics and
    leaves the carry as the full one does: bit for bit after each
    iteration, and the full iterations' metrics equal.  The programs are
    built again after a release."""
    config = CONFIGS[name](port_config.load_run_config)
    scheduled = _trainer(tmp_path, "scheduled", config)
    full = _trainer(tmp_path, "full", config)
    assert not scheduled._programmed  # the CPU: programs call their bodies
    steps = scheduled.training_batch_size_per_env * scheduled.num_envs
    for i in range(3):
        t = i * steps
        if i == 2:  # built and captured again after a release
            scheduled.release_programs()
            assert scheduled._programs is None
        got = scheduled._iteration(t, full=i != 1)
        want = full._iteration(t)
        if i != 1:  # the full iterations' metrics
            np.testing.assert_equal(reduce_metrics(got),
                                    reduce_metrics(want))
        else:
            assert got == {}
        _assert_equal_trees(_carry(scheduled), _carry(full))
    assert scheduled.iters_completed == 0  # nothing but the iterations
    # every program's buffers kept their storages through the iterations
    for program in scheduled._programs.values():
        program.check_buffers()
    expected = {("rollout",)} | {
        (tag, variant) for tag in scheduled.policies_to_train
        for variant in ("hot", "full")}
    if name == "ppo_bf16_shuffled_remat":
        expected |= {(tag, "prologue") for tag in scheduled.policies}
    assert {k if isinstance(k, tuple) else (k,)
            for k in scheduled._programs} == expected


def test_train_runs_the_programs_on_the_cpu(tmp_path):
    """``train()`` on the CPU builds and calls the programs, the hot ones
    between log points, and logs the metrics of a trainer of the same seed
    whose every iteration is full."""
    config = _small_tag_continuous(port_config.load_run_config)
    config["saving"]["metrics_log_freq"] = 2  # logs after iterations 2, 4
    config["trainer"]["num_episodes"] = 27  # 4 iterations of 80 steps
    trained, reference = (_trainer(tmp_path, n, config)
                          for n in ("trained", "reference"))
    schedule, inner = [], trained._iteration
    trained._iteration = lambda timestep, full=True: (
        schedule.append(full) or inner(timestep, full))
    trained.train()
    assert schedule == [True, True, False, True]  # as train() chose
    every = reference._iteration
    reference._iteration = lambda timestep, full=True: every(timestep)
    reference.train()
    assert trained._programs is not None
    for program in trained._programs.values():
        program.check_buffers()

    def logged(trainer):
        with open(os.path.join(trainer.save_dir, "results.json"),
                  encoding="utf-8") as f:
            return [json.loads(line)["metrics"] for line in f]

    assert logged(trained) == logged(reference)
    assert len(logged(trained)) == 2


def test_hot_update_equals_the_full_one(tmp_path):
    """The metrics-free pass takes the same steps as the full one."""
    config = _small_tag_continuous(
        port_config.load_run_config,
        dict(algorithm="PPO", num_epochs=2, num_minibatches=2),
        neg_pos_env_ratio=0.5)
    hot, full = (_trainer(tmp_path, n, config) for n in ("hot", "full"))
    for trainer in (hot, full):
        trainer._rollout_programmed(0)
    assert hot._update_programmed(0, full=False) == {}
    metrics = full._update_programmed(0, full=True)
    assert set(metrics) == set(full.policies_to_train)
    assert "Gradient norm" in metrics["runner"]
    _assert_equal_trees(_carry(hot), _carry(full))


# ------------------------------------------------------------ against JAX
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX trainer on the cut tag_continuous config, its carry and the
    batch its rollout records."""
    trainer = jax_setup(
        _tag_continuous_run_config(jax_config.load_run_config),
        verbose=False, results_dir=str(tmp_path_factory.mktemp("jax")))
    carry = trainer._carry
    rollout = jax.jit(trainer._build_rollout_profile_fn())
    _, batch = rollout(carry, jax.random.PRNGKey(0))
    return trainer, carry, jax.tree_util.tree_map(np.asarray, batch)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("full", [True, False])
def test_two_programmed_updates_match_jax(full, jax_run, tmp_path):
    """JAX's recorded batch written into the static batch, JAX's
    parameters and Adam states loaded into the live ones, then two
    programmed updates against two of JAX's (the full or the hot
    variant)."""
    jtrainer, carry, batch = jax_run
    port = _trainer(tmp_path, "port", _tag_continuous_run_config(
        port_config.load_run_config))
    port._rollout_programmed(0)  # builds the programs and the static batch
    params, opt = carry["params"], carry["opt"]
    for tag in port.policies:
        port.models[tag].load_state_dict(params_from_flax(_host(params[tag])))
        port.optimizers[tag].load_state_dict(
            adam_state_from_optax(_host(opt[tag])))
    assert batch.keys() == port._batch.keys()
    for k, v in batch.items():
        port._batch[k].copy_(torch.from_numpy(v.copy()))
    update = jax.jit(jtrainer._make_update(with_metrics=full))
    for timestep in (0, 50):
        params, opt, jmetrics = update(params, opt, batch,
                                       jnp.float32(timestep),
                                       jax.random.PRNGKey(1))
        metrics = port._update_programmed(timestep, full=full)
        if full:
            for tag in port.policies:
                for key in ("Total loss", "Gradient norm", "Learning rate",
                            "VF loss coefficient", "Entropy coefficient"):
                    np.testing.assert_allclose(
                        float(metrics[tag][key]), float(jmetrics[tag][key]),
                        rtol=1e-5, err_msg=key)
    for tag in port.policies:
        assert port.optimizers[tag].count == 2
        want = params_from_flax(_host(params[tag]))
        for name, p in port.models[tag].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{tag} {name}")


@pytest.mark.parametrize("max_norm", [None, 0.05])
def test_clipped_adam_device_bias_corrections_match_optax(max_norm):
    rng = np.random.default_rng(11)
    shapes = {"w": (6, 5), "b": (5,)}
    init = {n: rng.normal(size=s).astype(np.float32)
            for n, s in shapes.items()}
    lr = np.float32(0.003)
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in init.items()}
    adam = ClippedAdam(params, max_norm=max_norm)
    chain = ([optax.clip_by_global_norm(max_norm)] if max_norm else []) + [
        optax.scale_by_adam(), optax.scale(-1.0)]
    tx = optax.chain(*chain)
    jparams = {n: jnp.asarray(v) for n, v in init.items()}
    state = tx.init(jparams)
    lr_t = torch.tensor(lr)
    for _ in range(5):
        grads = {n: rng.normal(size=s).astype(np.float32)
                 for n, s in shapes.items()}
        adam.step({n: torch.from_numpy(g) for n, g in grads.items()}, lr_t)
        updates, state = tx.update({n: jnp.asarray(g)
                                    for n, g in grads.items()}, state)
        jparams = {n: jparams[n] + lr * updates[n] for n in jparams}
    jadam = state[-2]
    assert adam.count == int(jadam.count) == 5
    for n in shapes:
        for mine, theirs in ((adam.mu[n], jadam.mu[n]),
                             (adam.nu[n], jadam.nu[n]),
                             (params[n].detach(), jparams[n])):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       rtol=0, atol=ADAM_ATOL, err_msg=n)


def test_schedule_scalars_equal_value_at_bit_for_bit(tmp_path):
    schedule = ParamScheduler([[0, 0.01], [1000, 0.001], [3000, 0.0003]])
    scalar = torch.zeros((), dtype=torch.float32)
    for t in (0, 37, 999, 2500, 10**6):
        schedule.write_to(scalar, t)
        assert scalar.numpy().view(np.int32) == \
            schedule.value_at(t).view(np.int32), t
    # the update's scalars, filled before each iteration
    config = _small_tag_continuous(port_config.load_run_config)
    config["policy"]["runner"].update(
        lr=[[0, 0.01], [100, 0.002]], entropy_coeff=[[0, 0.5], [200, 0.05]],
        vf_loss_coeff=[[0, 1.0], [60, 0.25]])
    trainer = _trainer(tmp_path, "sched", config)
    trainer._rollout_programmed(0)
    update = trainer._update_passes["runner"]
    algo = trainer.algorithms["runner"]
    for t in (0, 10, 55, 130, 400):
        lr = trainer.lr_schedules["runner"].value_at(t)
        update.begin(t, lr)
        for got, want in ((update.lr, lr),
                          (update.vf_coeff,
                           algo.vf_loss_coeff_schedule.value_at(t)),
                          (update.ent_coeff,
                           algo.entropy_coeff_schedule.value_at(t))):
            assert got.numpy().view(np.int32) == want.view(np.int32), t


# ----------------------------------------------------------------- resume
def _buffers(trainer):
    return {key: storages(p.buffers) for key, p in trainer._programs.items()}


def test_resume_into_built_programs_is_bit_for_bit(tmp_path):
    config = _tag_continuous_run_config(port_config.load_run_config)
    steps = 50

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
    first.save_model_checkpoint()

    other = copy.deepcopy(config)
    other["trainer"]["seed"] = 99
    resumed = _trainer(tmp_path, "resumed", other)
    run(resumed, 0, 1)  # programs built on other states
    before = _buffers(resumed)
    resumed.load_full_state(path)
    assert _buffers(resumed) == before
    assert resumed.iters_completed == 2
    run(resumed, 2, 2)
    assert _buffers(resumed) == before
    _assert_equal_trees(_carry(resumed), _carry(straight))

    loaded = _trainer(tmp_path, "loaded", other)
    run(loaded, 0, 1)
    before = _buffers(loaded)
    loaded.load_model_checkpoint({
        tag: first._ckpt_path(tag, first.current_timestep)
        for tag in loaded.policies})
    assert _buffers(loaded) == before
    assert loaded.current_timestep == 2 * steps
    for tag in loaded.policies:
        _assert_equal_trees(loaded.models[tag].state_dict(),
                            first.models[tag].state_dict())
    run(loaded, 2, 1)  # the programs train the loaded parameters
    assert _buffers(loaded) == before


# ------------------------------------------------------ the preset loops
def _clone(state):
    return {k: v.clone() for k, v in state.items()}


@pytest.mark.parametrize("loop", ["env_only_step", "full_loop_step"])
def test_captured_flagship_loops_equal_the_eager_steps(loop):
    system = build_flagship(num_envs=3, fc_dims=(8, 8), seed=4,
                            device="cpu")
    start = _clone(system["state"])
    eager_gen = torch.Generator().manual_seed(5)
    state, checksum = _clone(start), torch.zeros(())
    for _ in range(6):
        if loop == "env_only_step":
            state, checksum = system[loop]((state, checksum), eager_gen)
        else:
            state = system[loop](system["models"], state, eager_gen)
    program = captured_loop(system, loop,
                            torch.Generator().manual_seed(5), state=start)
    ptrs = storages(program.buffers)
    for _ in range(6):
        program()
    assert storages(program.buffers) == ptrs
    _assert_equal_trees(program.buffers["state"], state)
    assert torch.equal(program.buffers["checksum"], checksum)


def test_engine_facade_writes_a_pinned_state_in_place():
    system = build_env_only_loop("ClassicControlCartPoleEnv", num_envs=6,
                                 seed=2, device="cpu", reset_pool_size=4)
    engine = system["engine"]
    engine.reset_all_envs()  # the first call returns the state as built
    program = captured_loop(system, "env_only_step",
                            torch.Generator().manual_seed(1))
    ptrs = storages(program.buffers)
    for _ in range(3):
        program()
    engine.reset_all_envs()
    assert storages(program.buffers) == ptrs
    for name, buf in program.buffers["state"].items():
        assert engine.state[name] is buf
    assert int(engine.state["_timestep_"].abs().sum()) == 0
    engine.step_all_envs(torch.zeros((6, 1), dtype=torch.int32))
    engine.reset_only_done_envs()
    program()
    assert storages(program.buffers) == ptrs
    assert int(program.buffers["state"]["_timestep_"].min()) >= 1


# ------------------------------------------------------- small entry points
def test_profile_trace_and_graceful_close(tmp_path, caplog):
    trainer = _trainer(tmp_path, "trace", _small_tag_continuous(
        port_config.load_run_config))
    saved = copy.deepcopy(_carry(trainer))
    path = trainer.profile_trace(str(tmp_path / "trace"), iterations=2)
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("addmm" in n or "mm" in n for n in names)
    trainer._batch = saved["batch"]  # made by the traced iterations
    _assert_equal_trees(_carry(trainer), saved)  # the state restored
    with caplog.at_level(logging.INFO):
        trainer.graceful_close()
    assert "Trainer exits gracefully" in caplog.text


@pytest.mark.parametrize("freq", [None, 0, 7])
def test_dispatch_sync_freq_parses_as_in_jax(freq, tmp_path):
    def config(load):
        cfg = _cartpole_pool(load)
        if freq is not None:
            cfg["trainer"]["dispatch_sync_freq"] = freq
        return cfg

    port = _trainer(tmp_path, "port", config(port_config.load_run_config))
    jtrainer = jax_setup(config(jax_config.load_run_config), verbose=False,
                         results_dir=str(tmp_path / "jax"))
    assert port.dispatch_sync_freq == jtrainer.dispatch_sync_freq == (
        50 if freq is None else freq)


def test_dispatch_sync_cadence_does_not_change_training(tmp_path):
    params = []
    for freq in (0, 1):
        config = _cartpole_pool(port_config.load_run_config)
        config["trainer"]["dispatch_sync_freq"] = freq
        trainer = _trainer(tmp_path, f"sync{freq}", config)
        trainer.train()
        params.append(trainer.models["shared"].state_dict())
    _assert_equal_trees(*params)
