"""The port's DDPG (``warpdrive_tpu_torch``: ``algos/ddpg.py``,
``algos/returns.py:n_step_returns``, ``sampling/samplers.py``'s OU step,
``models/fully_connected.py``'s actor and critic, ``training/ring_buffer.py``
and ``training/trainer_ddpg.py``) against the JAX package's, on the CPU at a
small size: n-step returns and the losses (1e-6), the OU step with injected
noise (1e-7), the ring buffer's reference sequence, the nets' forward from
carried flax parameters (1e-6), one replay update from carried parameters
and optax states over the same window, not yet full and then full
(parameters, targets and Adam moments within 1e-5), a rollout with JAX's
OU noise injected (1e-5), and ``tests/test_training_pendulum_ddpg.py``'s
semantics on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.algos import ddpg as jax_ddpg
from warpdrive_tpu.algos import returns as jax_returns
from warpdrive_tpu.models import fully_connected as jax_models
from warpdrive_tpu.sampling import samplers as jax_samplers
from warpdrive_tpu.training import ring_buffer as jax_ring_buffer
from warpdrive_tpu.training.scripts.train import setup_trainer as jax_setup
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.algos.ddpg import DDPG
from warpdrive_tpu_torch.algos.returns import n_step_returns
from warpdrive_tpu_torch.models.fully_connected import (
    FullyConnectedActionValueCritic,
    FullyConnectedActor,
    adam_state_from_optax,
    params_from_flax,
)
from warpdrive_tpu_torch.ops import knn_obs
from warpdrive_tpu_torch.sampling.samplers import (
    ou_stationary_std,
    sample_ou_process,
)
from warpdrive_tpu_torch.training.ring_buffer import (
    RingBuffer,
    RingBufferManager,
)
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.training.trainer_ddpg import TrainerDDPG
from warpdrive_tpu_torch.utils import config as port_config

# returns and losses: the same float32 operations in the same order
LOSS_TOL = 1e-6
# after one update the parameters, targets and Adam moments agree to 1e-5:
# the two frameworks sum the GEMMs and the gradients in other orders
# (relative differences of about 1e-6), and the moments are of the clipped
# gradients (global norm <= 3)
UPDATE_TOL = 1e-5
ROLLOUT_TOL = 1e-5


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ the pieces
def _batch(seed, T=9, E=4, A=3, C=2):
    rng = np.random.default_rng(seed)
    done = (rng.random((T, E)) < 0.25).astype(np.int32)
    done[-1, :2] = 1  # done on the final row in some envs ...
    done[-1, 2:] = 0  # ... and not in others
    done[2, 0] = 2  # a success marker counts as done
    return {
        "actions": rng.uniform(-2, 2, (T, E, A, C)).astype(np.float32),
        "rewards": rng.normal(size=(T, E, A)).astype(np.float32),
        "done": done,
        "q": rng.normal(size=(T, E, A)).astype(np.float32),
        "next_q": rng.normal(size=(T - 1, E, A)).astype(np.float32),
        "j": rng.normal(size=(T, E, A)).astype(np.float32),
    }


@pytest.mark.parametrize("next_rows", ["T-1", "T"])
@pytest.mark.parametrize("n_step", [1, 2, 3, 4, 5])
def test_n_step_returns_match_jax(n_step, next_rows):
    """Every n, with done (and a success marker) in the window and on the
    final row, with the trainer's ``T-1`` rows of ``V'`` (JAX clamps the
    final row's unused branch onto its last row) and with ``T`` rows."""
    b = _batch(n_step)
    next_v = b["next_q"]
    if next_rows == "T":
        next_v = np.concatenate([next_v, b["j"][-1:]])
    want = jax_returns.n_step_returns(
        jnp.asarray(b["rewards"]), jnp.asarray(b["done"]),
        jnp.asarray(next_v), 0.97, n_step)
    got = n_step_returns(_t(b["rewards"]), _t(b["done"]), _t(next_v), 0.97,
                         n_step)
    assert got.shape == (9 - n_step + 1, 4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOSS_TOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_ddpg_losses_and_metrics_match_jax(normalize):
    b = _batch(11)
    kwargs = dict(discount_factor_gamma=0.99, normalize_advantage=normalize,
                  normalize_return=normalize, n_step=3)
    ja, jc, jm = jax_ddpg.DDPG(**kwargs).compute_loss_and_metrics(
        0.0, jnp.asarray(b["actions"]), jnp.asarray(b["rewards"]),
        jnp.asarray(b["done"]), jnp.asarray(b["q"]), jnp.asarray(b["next_q"]),
        jnp.asarray(b["j"]))
    pa, pc, pm = DDPG(**kwargs).compute_loss_and_metrics(
        0.0, _t(b["actions"]), _t(b["rewards"]), _t(b["done"]), _t(b["q"]),
        _t(b["next_q"]), _t(b["j"]))
    # a normalized mean is 0 up to rounding: absolute and relative 1e-6
    np.testing.assert_allclose(float(pa), float(ja), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(float(pc), float(jc), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert sorted(pm) == sorted(jm)
    for name in jm:
        np.testing.assert_allclose(float(pm[name]), float(jm[name]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=name)


def test_critic_loss_gradient_reaches_q_only():
    """The returns are detached: the critic loss's gradient flows into Q
    and not into the target's ``V'``."""
    b = _batch(5)
    q = _t(b["q"]).requires_grad_(True)
    next_q = _t(b["next_q"]).requires_grad_(True)
    _, critic_loss, _ = DDPG(n_step=2).compute_loss_and_metrics(
        0.0, _t(b["actions"]), _t(b["rewards"]), _t(b["done"]), q, next_q,
        q.detach())
    gq, gn = torch.autograd.grad(critic_loss, [q, next_q], allow_unused=True)
    assert gq is not None and float(gq.abs().sum()) > 0
    assert gn is None


def test_ou_step_with_injected_noise_matches_jax():
    rng = np.random.default_rng(2)
    mu = rng.uniform(-1, 1, (6, 3, 2)).astype(np.float32)
    ou = rng.normal(size=(6, 3, 2)).astype(np.float32)
    noise = (0.2 * rng.normal(size=(6, 3, 2))).astype(np.float32)
    ja, jou = jax_samplers.sample_ou_process(
        None, jnp.asarray(mu), jnp.asarray(ou), damping=0.15, stddev=0.2,
        scale=0.7, noise=jnp.asarray(noise))
    pa, pou = sample_ou_process(_t(mu), _t(ou), damping=0.15, stddev=0.2,
                                scale=0.7, noise=_t(noise))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=0, atol=1e-7)
    np.testing.assert_allclose(pou.numpy(), np.asarray(jou), rtol=0,
                               atol=1e-7)


def test_ou_stationary_std_by_statistics():
    """20,000 independent chains run 200 steps from 0 on the generator's
    draws: their spread is the closed form's within 2% (its standard error
    is 0.5%), and their mean is 0 within 4 standard errors."""
    gen = torch.Generator().manual_seed(0)
    mu = torch.zeros((20_000, 1, 1))
    ou = torch.zeros_like(mu)
    for _ in range(200):
        _, ou = sample_ou_process(mu, ou, damping=0.15, stddev=0.2,
                                  generator=gen)
    want = ou_stationary_std(0.15, 0.2)
    assert want == pytest.approx(jax_samplers.ou_stationary_std(0.15, 0.2))
    assert float(ou.std()) == pytest.approx(want, rel=0.02)
    assert abs(float(ou.mean())) < 4 * want / np.sqrt(20_000)


def test_ou_scale_zero_returns_mu_and_keeps_the_state():
    mu = torch.linspace(-1, 1, 12).reshape(4, 3, 1)
    ou = torch.full_like(mu, 0.5)
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    action, new_ou = sample_ou_process(mu, ou, scale=0.0, generator=gen)
    assert torch.equal(action, mu) and torch.equal(new_ou, ou)
    assert torch.equal(gen.get_state(), state)  # nothing was drawn


def test_ring_buffer_reference_sequence():
    """``tests/test_ring_buffer.py``'s sequence: 3 entries, then full at
    5, then the oldest three dropped."""
    rbm = RingBufferManager()
    rbm.add("X", capacity=5, item_shape=(3,), device="cpu")
    for i in (0, 1, 2):
        rbm.enqueue("X", torch.full((3,), float(i)))
    _, state = rbm.get("X")
    assert not RingBuffer.isfull(state)
    assert rbm.unroll("X")[: state.size].tolist() == [[0] * 3, [1] * 3,
                                                       [2] * 3]
    for i in (3, 4):
        rbm.enqueue("X", torch.full((3,), float(i)))
    _, state = rbm.get("X")
    assert RingBuffer.isfull(state)
    assert rbm.unroll("X").tolist() == [[i] * 3 for i in range(5)]
    for i in (5, 6, 7):
        rbm.enqueue("X", torch.full((3,), float(i)))
    _, state = rbm.get("X")
    assert RingBuffer.isfull(state) and rbm.has("X")
    assert rbm.unroll("X").tolist() == [[i] * 3 for i in range(3, 8)]


def test_ring_buffer_matches_jax_through_wraps():
    buf = RingBuffer(capacity=4, item_shape=(2,), device="cpu")
    jbuf = jax_ring_buffer.RingBuffer(capacity=4, item_shape=(2,))
    state, jstate = buf.init(), jbuf.init()
    for row in np.arange(22, dtype=np.float32).reshape(11, 2):
        state = buf.enqueue(state, torch.from_numpy(row))
        jstate = jbuf.enqueue(jstate, jnp.asarray(row))
        np.testing.assert_array_equal(buf.unroll(state).numpy(),
                                      np.asarray(jbuf.unroll(jstate)))
        assert state.size == int(jstate.size)


def test_ring_buffer_defaults_to_the_card():
    """Like every entry point of the port, a ring buffer's storage goes on
    ``cuda`` unless the caller asks for the CPU, and that request raises
    without a GPU."""
    if torch.cuda.is_available():
        assert RingBuffer(2, (1,)).device.type == "cuda"
        assert RingBufferManager().add("X", 2, (1,)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RingBuffer(2, (1,))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RingBufferManager().add("X", 2, (1,))


def test_actor_and_critic_forward_from_flax():
    rng = np.random.default_rng(4)
    obs = rng.normal(size=(5, 3, 7)).astype(np.float32)
    act = rng.uniform(-1, 1, (5, 3, 2)).astype(np.float32)
    jactor = jax_models.FullyConnectedActor(fc_dims=(16, 16),
                                            num_action_types=2,
                                            action_scale=2.0)
    jcritic = jax_models.FullyConnectedActionValueCritic(fc_dims=(16, 16))
    pa = jactor.init(jax.random.PRNGKey(0), jnp.asarray(obs[:1]))
    pc = jcritic.init(jax.random.PRNGKey(1), jnp.asarray(obs[:1]),
                      jnp.asarray(act[:1]))
    actor = FullyConnectedActor(7, (16, 16), 2, action_scale=2.0)
    critic = FullyConnectedActionValueCritic(9, (16, 16))
    actor.load_state_dict(params_from_flax(_host(pa)))
    critic.load_state_dict(params_from_flax(_host(pc)))
    with torch.no_grad():
        np.testing.assert_allclose(
            actor(_t(obs)).numpy(),
            np.asarray(jactor.apply(pa, jnp.asarray(obs))), atol=1e-6)
        np.testing.assert_allclose(
            critic(_t(obs), _t(act)).numpy(),
            np.asarray(jcritic.apply(pc, jnp.asarray(obs), jnp.asarray(act))),
            atol=1e-6)
    names = [n for n, _ in actor.named_parameters()]
    assert names[-2:] == ["policy_head.weight", "policy_head.bias"]
    assert "q_head.weight" in dict(critic.named_parameters())


# --------------------------------------------------------------- trainers
def _config(load, **trainer):
    """Pendulum at 8 envs, 10 steps an iteration, n_step 3 (a window of 12
    rows), episodes of 8 steps (every rollout crosses a done and its
    reset), no pool (resets restore the snapshot in both frameworks),
    fc (16, 16)."""
    cfg = load("single_pendulum")
    cfg["env"].update({"episode_length": 8, "reset_pool_size": 0, "seed": 3})
    cfg["trainer"].update({"num_envs": 8, "train_batch_size": 80,
                           "num_episodes": 40, "n_step": 3, "seed": 7,
                           **trainer})
    for net in ("actor", "critic"):
        cfg["policy"]["shared"]["model"][net]["fc_dims"] = [16, 16]
    cfg["saving"].update({"metrics_log_freq": 2,
                          "model_params_save_freq": 10_000})
    return cfg


def _port(tmp_path, name="port", **trainer):
    return port_train.setup_trainer(
        _config(port_config.load_run_config, **trainer), verbose=False,
        results_dir=str(tmp_path / name), device="cpu")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX DDPG trainer, its initial carry, and a rollout of T steps with
    presampled OU noise: its rows and that noise."""
    trainer = jax_setup(_config(jax_config.load_run_config), verbose=False,
                        results_dir=str(tmp_path_factory.mktemp("jax")))
    carry = trainer._carry
    T = trainer.training_batch_size_per_env
    noise = {"shared": 0.2 * jax.random.normal(
        jax.random.PRNGKey(5), (T,) + carry["ou"]["shared"].shape)}
    rollout = jax.jit(trainer._make_rollout())
    (env_state, ou, _, _, _), rows = rollout(
        carry["actor"],
        (carry["env_state"], carry["ou"], carry["ep_acc"], carry["ep_sum"],
         carry["ep_count"]),
        jax.random.split(jax.random.PRNGKey(6), T), noise, 0.15, 0.2, 1.0)
    return trainer, carry, _host(noise), _host(rows), _host(env_state), \
        _host(ou)


def _load_nets(port, carry):
    for net in ("actor", "critic"):
        state = params_from_flax(_host(carry[net]["shared"]))
        port.nets[net]["shared"].load_state_dict(state)
        port.targets[net]["shared"].load_state_dict(
            params_from_flax(_host(carry[f"target_{net}"]["shared"])))
        port.optimizers[net]["shared"].load_state_dict(
            adam_state_from_optax(_host(carry[f"opt_{net}"]["shared"])))


def _assert_nets_match(port, nets, tol):
    for net in ("actor", "critic"):
        for kind, module in (("", port.nets[net]["shared"]),
                             ("target_", port.targets[net]["shared"])):
            want = params_from_flax(_host(nets[f"{kind}{net}"]["shared"]))
            for name, p in module.named_parameters():
                np.testing.assert_allclose(
                    p.detach().numpy(), want[name].numpy(), rtol=0,
                    atol=tol, err_msg=f"{kind}{net} {name}")
        adam = adam_state_from_optax(_host(nets[f"opt_{net}"]["shared"]))
        got = port.optimizers[net]["shared"].state_dict()
        assert got["count"] == adam["count"], net
        for moment in ("mu", "nu"):
            for name, m in got[moment].items():
                np.testing.assert_allclose(
                    m.numpy(), adam[moment][name].numpy(), rtol=0, atol=tol,
                    err_msg=f"{net} {moment} {name}")


def test_rollout_with_injected_noise_matches_jax(jax_run, tmp_path):
    """JAX's OU noise through the port's rollout from the same state and
    actor: observations, actions, rewards and done flags within 1e-5,
    across a done and its reset, the OU state too, and no kNN launch."""
    jtrainer, carry, noise, rows, env_state, ou = jax_run
    port = _port(tmp_path)
    for name, value in port._env_state.items():
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(carry["env_state"][name]),
                                      err_msg=name)
    _load_nets(port, carry)
    knn_obs.reset_launch_counts()
    got = port._rollout({"shared": _t(noise["shared"])}, 0.15, 0.2, 1.0)
    assert knn_obs.LAUNCH_COUNTS == dict.fromkeys(knn_obs.KERNELS, 0)
    assert (rows["done"] > 0).any()
    np.testing.assert_array_equal(got["done"].numpy(), rows["done"])
    for key in ("obs_shared", "actions_shared", "rewards_shared"):
        np.testing.assert_allclose(got[key].numpy(), rows[key], rtol=0,
                                   atol=ROLLOUT_TOL, err_msg=key)
    np.testing.assert_allclose(port._ou["shared"].numpy(), ou["shared"],
                               rtol=0, atol=ROLLOUT_TOL)
    np.testing.assert_allclose(port._env_state["state"].numpy(),
                               env_state["state"], rtol=0, atol=ROLLOUT_TOL)


def test_one_update_matches_jax_not_full_then_full(jax_run, tmp_path):
    """The same rows twice into a 12-row window from the same nets, targets
    and optax states.  First 10 rows: not full, and nothing moves on either
    side (Adam's count stays 0).  Then full: one update of both nets and
    both targets, within 1e-5, and the metrics alike."""
    jtrainer, carry, _, rows, _, _ = jax_run
    port = _port(tmp_path)
    _load_nets(port, carry)
    replay_update = jax.jit(jtrainer._make_replay_update(with_metrics=True))
    keys = ("actor", "critic", "target_actor", "target_critic", "opt_actor",
            "opt_critic", "buf", "done_buf", "filled")
    nets = {k: carry[k] for k in keys}
    port_rows = {k: _t(v) for k, v in rows.items()}
    before = {k: v.clone() for k, v in
              port.nets["actor"]["shared"].state_dict().items()}
    for step, timestep in enumerate((0.0, 80.0)):
        nets, jmetrics = replay_update(nets, rows, jnp.float32(timestep))
        metrics = port._replay_update(port_rows, timestep)["shared"]
        full = step == 1
        assert port.filled == int(nets["filled"]) == (12 if full else 10)
        assert float(metrics["Buffer full"]) == float(
            jmetrics["shared"]["Buffer full"]) == float(full)
        _assert_nets_match(port, nets, UPDATE_TOL)
        moved = any(not torch.equal(v, before[k]) for k, v in
                    port.nets["actor"]["shared"].state_dict().items())
        assert moved == full
        for name, want in jmetrics["shared"].items():
            np.testing.assert_allclose(float(metrics[name]), float(want),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(port._window["done"].numpy(),
                                  np.asarray(nets["done_buf"]))


def test_actor_update_sees_the_critic_before_its_step(tmp_path):
    """The actor's gradient is taken through the critic's parameters from
    before this update: recomputed from copies made before the update, it
    equals the Adam first moment's first step (0.1 g, no clipping: the
    actor's gradient norm is far below 3)."""
    port = _port(tmp_path)
    T = port.training_batch_size_per_env
    actor = {k: v.clone() for k, v in
             port.nets["actor"]["shared"].state_dict().items()}
    critic = {k: v.clone() for k, v in
              port.nets["critic"]["shared"].state_dict().items()}
    noise = port._presample_ou_noise(0.2)
    rows = port._rollout(noise, 0.15, 0.2, 1.0)
    port._replay_update(rows, 0.0)  # 10 of 12 rows: no step
    rows = port._rollout(port._presample_ou_noise(0.2), 0.15, 0.2, 1.0)
    window = {k: torch.cat([v[T:], rows[k]]) for k, v in port._window.items()}
    metrics = port._replay_update(rows, 80.0)["shared"]
    assert float(metrics["Buffer full"]) == 1.0
    assert float(metrics["Actor gradient norm"]) < 3.0

    a_ref = FullyConnectedActor(3, (16, 16), 1, action_scale=2.0)
    c_ref = FullyConnectedActionValueCritic(4, (16, 16))
    a_ref.load_state_dict(actor)
    c_ref.load_state_dict(critic)
    obs = window["obs_shared"]
    j = c_ref(obs, a_ref(obs))[: 12 - 3 + 1]
    grads = torch.autograd.grad(-j.mean(), list(a_ref.parameters()))
    mu = port.optimizers["actor"]["shared"].state_dict()["mu"]
    for (name, _), g in zip(a_ref.named_parameters(), grads):
        np.testing.assert_allclose(mu[name].numpy(), 0.1 * g.numpy(),
                                   rtol=1e-5, atol=1e-9, err_msg=name)


def _results(path):
    with open(os.path.join(path, "results.json"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _pendulum_like_jax_test(load):
    """``tests/test_training_pendulum_ddpg.py``'s configuration: 20 envs,
    T = 50, n_step 5, episodes of 100, a pool of 50, seed 7; fc (16, 16)
    and four iterations here."""
    cfg = load("single_pendulum")
    cfg["trainer"].update({"num_envs": 20, "train_batch_size": 1000,
                           "num_episodes": 40, "n_step": 5, "seed": 7})
    cfg["env"].update({"episode_length": 100, "reset_pool_size": 50,
                       "seed": 3})
    for net in ("actor", "critic"):
        cfg["policy"]["shared"]["model"][net]["fc_dims"] = [16, 16]
    cfg["saving"].update({"metrics_log_freq": 2,
                          "model_params_save_freq": 10_000})
    return cfg


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Four iterations of the Pendulum configuration above, through
    ``setup_trainer`` and ``train()``, and the nets as built."""
    res = tmp_path_factory.mktemp("pend")
    cfg = _pendulum_like_jax_test(port_config.load_run_config)
    trainer = port_train.setup_trainer(cfg, verbose=False,
                                       results_dir=str(res), device="cpu")
    snap = {kind: {net: {k: v.clone() for k, v in
                         getattr(trainer, kind)[net]["shared"]
                         .state_dict().items()}
                   for net in ("actor", "critic")}
            for kind in ("nets", "targets")}
    trainer.train()
    return trainer, res, snap


def test_pendulum_ddpg_trains(trained):
    trainer, res, snap = trained
    assert isinstance(trainer, TrainerDDPG)
    assert trainer.iters_completed == trainer.num_iters == 4
    records = _results(res)
    assert [r["iterations completed"] for r in records] == [2, 4]
    last = records[-1]["metrics"]["shared"]
    for key in ("Actor loss", "Critic loss", "Mean episodic reward"):
        assert np.isfinite(last[key]), key
    assert all(np.isfinite(v) for v in last.values())
    assert last["Buffer full"] == 1.0
    assert trainer.filled == trainer.buffer_capacity == 54
    t = trainer.current_timestep
    ckpts = os.listdir(res)
    assert f"shared_actor_{t}.state_dict" in ckpts
    assert f"shared_critic_{t}.state_dict" in ckpts
    # the online actor ran ahead of its target (tau < 1)
    online = trainer.nets["actor"]["shared"].state_dict()
    target = trainer.targets["actor"]["shared"].state_dict()
    assert any(not torch.allclose(online[k], target[k]) for k in online)
    assert any(not torch.equal(online[k], snap["nets"]["actor"][k])
               for k in online)
    # noise-free evaluation and episode fetching
    rew_sum, step_sum = trainer.evaluate_episodes()
    assert rew_sum["shared"].shape == (20, 1)
    assert np.isfinite(rew_sum["shared"]).all()
    assert (step_sum["shared"] > 0).all()
    traj = trainer.fetch_episode_states(["state"],
                                        include_rewards_actions=True)
    assert traj["state"].shape == (101, 1, 2)
    assert traj["actions"].shape == (100, 1, 1)
    assert np.isfinite(traj["rewards"]).all()
    with pytest.raises(AssertionError, match="categorical"):
        trainer.fetch_episode_states(["state"], include_probabilities=True)


def test_warm_up_gate_holds_on_iteration_one(tmp_path):
    """Iteration 1 fills 50 of the window's 54 rows: parameters, targets
    and both Adam counts stay as built; iteration 2 moves them."""
    cfg = _pendulum_like_jax_test(port_config.load_run_config)
    trainer = port_train.setup_trainer(cfg, verbose=False, device="cpu",
                                       results_dir=str(tmp_path / "res"))
    kinds = ("nets", "targets")
    before = {(kind, net): {k: v.clone() for k, v in
                            getattr(trainer, kind)[net]["shared"]
                            .state_dict().items()}
              for kind in kinds for net in ("actor", "critic")}
    metrics = trainer._iteration(0)["shared"]
    assert float(metrics["Buffer full"]) == 0.0
    for (kind, net), state in before.items():
        for k, v in getattr(trainer, kind)[net]["shared"].state_dict().items():
            assert torch.equal(v, state[k]), (kind, net, k)
    assert all(trainer.optimizers[net]["shared"].count == 0
               for net in ("actor", "critic"))
    metrics = trainer._iteration(1000)["shared"]
    assert float(metrics["Buffer full"]) == 1.0
    assert all(trainer.optimizers[net]["shared"].count == 1
               for net in ("actor", "critic"))


def test_pendulum_ddpg_checkpoint_roundtrip(trained, tmp_path):
    trainer, res, _ = trained
    t = trainer.current_timestep
    paths = {"shared": {net: str(res / f"shared_{net}_{t}.state_dict")
                        for net in ("actor", "critic")}}
    cfg = _pendulum_like_jax_test(port_config.load_run_config)
    cfg["trainer"]["seed"] = 8  # other initial nets
    fresh = port_train.setup_trainer(cfg, verbose=False, device="cpu",
                                     results_dir=str(tmp_path / "fresh"))
    fresh.load_model_checkpoint(paths)
    assert fresh.current_timestep == t
    for net in ("actor", "critic"):
        want = trainer.nets[net]["shared"].state_dict()
        for kind in ("nets", "targets"):
            got = getattr(fresh, kind)[net]["shared"].state_dict()
            for k, v in got.items():
                assert torch.equal(v, want[k]), (kind, net, k)


def test_ddpg_partial_actor_only_reload(trained, tmp_path):
    """Reloading the actor alone resets its target and leaves the critic,
    its target and the optimizers as they were; training goes on."""
    trainer, res, _ = trained
    t = trainer.current_timestep
    cfg = _pendulum_like_jax_test(port_config.load_run_config)
    cfg["trainer"]["seed"] = 9
    fresh = port_train.setup_trainer(cfg, verbose=False, device="cpu",
                                     results_dir=str(tmp_path / "fresh"))
    critic = {k: v.clone() for k, v in
              fresh.nets["critic"]["shared"].state_dict().items()}
    fresh.load_model_checkpoint(
        {"shared": {"actor": str(res / f"shared_actor_{t}.state_dict")}})
    want = trainer.nets["actor"]["shared"].state_dict()
    for kind in ("nets", "targets"):
        for k, v in getattr(fresh, kind)["actor"]["shared"].state_dict() \
                .items():
            assert torch.equal(v, want[k])
    for kind in ("nets", "targets"):
        for k, v in getattr(fresh, kind)["critic"]["shared"].state_dict() \
                .items():
            assert torch.equal(v, critic[k])
    metrics = fresh._iteration(fresh.current_timestep)["shared"]
    assert np.isfinite(float(metrics["Critic loss"]))


def test_ddpg_load_rejects_string_paths(trained):
    trainer, res, _ = trained
    with pytest.raises(TypeError, match="per net"):
        trainer.load_model_checkpoint({"shared": str(res / "x.state_dict")})


@pytest.mark.parametrize("name", ["single_pendulum",
                                  "single_continuous_mountain_car"])
def test_cli_trains_the_ddpg_configs_on_the_cpu(name, tmp_path):
    """``-e <name> --device cpu --num_envs <n> --num_episodes <m>``:
    ``--num_envs`` sets the replicas alone, as in the JAX CLI, so an
    iteration keeps the config's batch (Pendulum 50,000 env-steps, 10 a
    replica at 5000 envs; ContinuousMountainCar 10,000, 20 a replica at
    500): four iterations each, the first filling the window."""
    envs, episodes, steps = {"single_pendulum": (5000, 400, 10),
                             "single_continuous_mountain_car": (500, 40, 20)
                             }[name]
    trainer = port_train.main([
        "-e", name, "--device", "cpu", "--num_envs", str(envs),
        "--num_episodes", str(episodes), "--results_dir", str(tmp_path / "cli"),
    ])
    assert isinstance(trainer, TrainerDDPG)
    assert trainer.num_envs == envs
    assert trainer.training_batch_size_per_env == steps
    assert trainer.iters_completed == trainer.num_iters == 4
    assert trainer.optimizers["actor"]["shared"].count == 3
    t = trainer.current_timestep
    assert f"shared_critic_{t}.state_dict" in os.listdir(tmp_path / "cli")


@pytest.mark.parametrize("where,key,value,item", [
    ("trainer", "env_backend", "cpu", "eager"),
    ("trainer", "env_backend", "cpp", "eager")])
def test_ddpg_left_out_options_raise(where, key, value, item, tmp_path):
    """The eager host-env backend is ported: DDPG builds on it, and what
    it leaves out there (full-state checkpoints) raises."""
    cfg = _config(port_config.load_run_config)
    node = cfg["policy"]["shared"] if where == "policy" else cfg["trainer"]
    node[key] = value
    trainer = port_train.setup_trainer(cfg, verbose=False, device="cpu",
                                       results_dir=str(tmp_path / "x"))
    assert isinstance(trainer, TrainerDDPG) and trainer._is_eager
    with pytest.raises(NotImplementedError, match=item):
        trainer.save_full_state()
