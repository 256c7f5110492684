"""The port's update options (``warpdrive_tpu_torch/training/trainer_a2c.py``:
``num_epochs``, ``num_minibatches``, ``shuffle_minibatches``, ``env_major``,
``remat``, ``trainer.batch_dtype``; ``algos/policygradient.py``'s behaviour
log-probs; ``models/fully_connected.py``'s ``dtype``) against the JAX
package's on the CPU, on a small TagContinuous config (2 taggers + 8
runners, k = 4, 8 envs x 10 steps, fc (16, 16)).

Tolerances:
- one update from the same parameters, optimizer state and batch: the
  parameters within 1e-5 (``PARAM_ATOL``, as the whole-batch parity test
  of ``test_torch_trainer_a2c.py``: the two frameworks sum the GEMMs and
  gradients in other orders, about 1e-6 relative, and Adam's normalized
  steps keep that far below the learning rates of 0.005 and 0.001) and the
  loss and gradient norm within rtol 1e-5;
- the bf16 model: at the small widths (fc 32) bit for bit with JAX's bf16
  model (both accumulate each bf16 product in float32 and round it, then
  round the bias add); at the tuned stage's width (81 -> 256 -> 256) each
  head (each logit head and the value) within ``BF16_NORMWISE`` = 2^-7 of
  that head's largest magnitude of JAX's (normwise: one bf16 ulp of the
  head's top binade; under 0.2% of the outputs differ, by one ulp).  The
  bound is normwise because a hidden unit rounded the other way moves
  every output by its weight times that unit's ulp: an output near 0 can
  then differ by many of its own ulps, never by much of its head's scale.
  Both stay within 0.05 of float32 (``tests/test_model_dtype.py``'s
  bound) and differ from it;
- a bf16 update (bf16 model and batch) against JAX's: one pass, the loss
  within rtol 1e-5 (the forwards agree bit for bit), the gradient norm
  within rtol 2^-8 (each gradient is rounded to bf16) and each parameter's
  change within ``BF16_ONE_PASS`` = 0.05 learning rates (Adam's first step
  moves a parameter by about one learning rate, ``-lr * g / |g|``: a port
  whose update did nothing or moved the wrong way is a whole step off);
  four passes, each parameter within ``BF16_FOUR_PASSES`` = 0.1 learning
  rates while the parameters move about two, and the last pass's loss and
  gradient norm within rtol 2^-8;
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.algos import policygradient as jpg
from warpdrive_tpu.models.fully_connected import FullyConnected as JaxFC
from warpdrive_tpu.training.scripts.train import setup_trainer as jax_setup
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.algos import policygradient as pg
from warpdrive_tpu_torch.models.fully_connected import (
    FullyConnected,
    adam_state_from_optax,
    params_from_flax,
)
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.training.trainer_a2c import UpdateOptions
from warpdrive_tpu_torch.utils import config as port_config

PARAM_ATOL = 1e-5
BF16_NORMWISE = 2.0 ** -7
BF16_VS_F32 = 0.05
BF16_GRAD_RTOL = 2.0 ** -8
BF16_ONE_PASS = 0.05  # learning rates
BF16_FOUR_PASSES = 0.1  # learning rates
NUM_ENVS, T = 8, 10


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
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_batch(tmp_path_factory):
    """The batch a JAX trainer's rollout records (float32 observations)."""
    trainer = jax_setup(_config(jax_config.load_run_config), verbose=False,
                        results_dir=str(tmp_path_factory.mktemp("jax")))
    rollout = jax.jit(trainer._build_rollout_profile_fn())
    _, batch = rollout(trainer._carry, jax.random.PRNGKey(0))
    return _host(batch)


def jax_index_tables(jtrainer, k_down, num_envs):
    """The permutation tables of the JAX update's shuffled sweeps: per
    trained policy, ``permutation(fold_in(dk, epoch), E)`` for each epoch,
    cut into ``(passes, E_mb)``."""
    trained = list(jtrainer.policies_to_train)
    keys = jax.random.split(k_down, max(len(trained), 1))
    tables = {}
    for dk, tag in zip(keys, trained):
        if not jtrainer.mb_shuffle[tag]:
            continue
        epochs = jtrainer.ppo_num_epochs[tag]
        mbs = jtrainer.ppo_num_minibatches[tag]
        perms = [np.asarray(jax.random.permutation(
            jax.random.fold_in(dk, jnp.uint32(e)), num_envs))
            for e in range(epochs)]
        tables[tag] = torch.from_numpy(
            np.stack(perms).reshape(epochs * mbs, num_envs // mbs)
            .astype(np.int64))
    return tables


def _port_batch(batch, obs_dtype=torch.float32):
    out = {}
    for key, value in batch.items():
        tensor = torch.from_numpy(np.asarray(value, dtype=value.dtype).copy())
        out[key] = tensor.to(obs_dtype) if key.startswith("obs_") else tensor
    return out


def _load_from_jax(port, carry):
    for tag in port.policies:
        port.models[tag].load_state_dict(
            params_from_flax(_host(carry["params"][tag])))
        port.optimizers[tag].load_state_dict(
            adam_state_from_optax(_host(carry["opt"][tag])))


CASES = {
    # num_epochs 4 shuffles by default: JAX's table is injected
    "ppo_4_epochs": (dict(algorithm="PPO", num_epochs=4), {}),
    "shuffled_minibatches": (
        dict(num_minibatches=4, shuffle_minibatches=True), {}),
    "contiguous_env_major": (dict(num_minibatches=4, env_major=True), {}),
    "contiguous_time_major": (dict(num_minibatches=4, env_major=False), {}),
    "ppo_shuffled_2x2": (
        dict(algorithm="PPO", num_epochs=2, num_minibatches=2), {}),
    "remat": (dict(remat=True, num_minibatches=2), {}),
    "batch_bf16": (dict(num_minibatches=2), {"batch_dtype": "bfloat16"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_jax(case, jax_batch, tmp_path):
    policy, trainer = CASES[case]
    jtrainer = jax_setup(_config(jax_config.load_run_config, policy,
                                 **trainer),
                         verbose=False, results_dir=str(tmp_path / "jax"))
    port = port_train.setup_trainer(
        _config(port_config.load_run_config, policy, **trainer),
        verbose=False, results_dir=str(tmp_path / "port"), device="cpu")
    carry = jtrainer._carry
    _load_from_jax(port, carry)
    bf16 = trainer.get("batch_dtype") == "bfloat16"
    jbatch = dict(jax_batch)
    if bf16:
        jbatch = {k: (jnp.asarray(v, jnp.bfloat16) if k.startswith("obs_")
                      else v) for k, v in jbatch.items()}
    port_batch = _port_batch(jax_batch,
                             torch.bfloat16 if bf16 else torch.float32)
    k_down = jax.random.PRNGKey(1)
    tables = jax_index_tables(jtrainer, k_down, NUM_ENVS)
    assert bool(tables) == any(port.update_options[t].shuffle
                               for t in port.policies)

    update = jax.jit(jtrainer._make_update(with_metrics=True))
    params, opt, jmetrics = update(carry["params"], carry["opt"], jbatch,
                                   jnp.float32(0), k_down)
    metrics = port._update(port_batch, 0, index_tables=tables)

    for tag in port.policies:
        opts = port.update_options[tag]
        assert port.optimizers[tag].count == opts.passes == int(
            adam_state_from_optax(_host(opt[tag]))["count"])
        for name in ("Total loss", "Gradient norm", "Policy loss"):
            np.testing.assert_allclose(float(metrics[tag][name]),
                                       float(jmetrics[tag][name]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{tag} {name}")
        want = params_from_flax(_host(params[tag]))
        for name, p in port.models[tag].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{case} {tag} {name}")


def _port_trainer(tmp_path, name, policy=None, **trainer):
    return port_train.setup_trainer(
        _config(port_config.load_run_config, policy, **trainer),
        verbose=False, results_dir=str(tmp_path / name), device="cpu")


def _params(trainer):
    return {tag: {k: v.clone() for k, v in m.state_dict().items()}
            for tag, m in trainer.models.items()}


def _assert_equal_params(a, b):
    for tag in a:
        for name in a[tag]:
            torch.testing.assert_close(a[tag][name], b[tag][name], rtol=0,
                                       atol=0, msg=f"{tag} {name}")


@pytest.mark.parametrize("control,option", [
    (dict(num_minibatches=4, env_major=False),
     dict(num_minibatches=4, env_major=True)),
    (dict(num_minibatches=2), dict(num_minibatches=2, remat=True)),
    (dict(), dict(remat=True)),
])
def test_relayout_and_remat_are_exact_in_the_port(control, option, tmp_path):
    """Two iterations each: env-major against time-major, remat against
    none, bit for bit."""
    trained = []
    for name, policy in (("control", control), ("option", option)):
        trainer = _port_trainer(tmp_path, name, policy, num_episodes=8)
        assert trainer.num_iters == 2
        trainer.train()
        trained.append(_params(trainer))
    _assert_equal_params(*trained)


def test_update_options_defaults_and_divisibility(tmp_path):
    trainer = _port_trainer(tmp_path, "a", dict(num_epochs=3))
    assert trainer.update_options["runner"] == UpdateOptions(
        num_epochs=3, num_minibatches=1, shuffle=True)
    with pytest.raises(AssertionError, match="sometimes"):
        _port_trainer(tmp_path, "f", dict(env_major="sometimes"))
    trainer = _port_trainer(tmp_path, "b", dict(num_minibatches=4))
    assert trainer.update_options["runner"].shuffle is False
    trainer = _port_trainer(tmp_path, "c", dict(
        num_epochs=2, shuffle_minibatches=False))
    assert trainer.update_options["tagger"].shuffle is False
    with pytest.raises(AssertionError, match="must divide num_envs"):
        _port_trainer(tmp_path, "d", dict(num_minibatches=3))
    with pytest.raises(AssertionError, match="must divide num_envs"):
        jax_setup(_config(jax_config.load_run_config,
                          dict(num_minibatches=3)),
                  verbose=False, results_dir=str(tmp_path / "e"))


def test_one_pass_update_draws_nothing(tmp_path):
    """One epoch of one minibatch takes no new draw from the trainer's
    generator; a contiguous sweep neither; a shuffled one does."""
    for policy, draws in ((dict(), False),
                          (dict(num_minibatches=4), False),
                          (dict(num_minibatches=4, shuffle_minibatches=True),
                           True)):
        trainer = _port_trainer(tmp_path, f"g{len(policy)}", policy)
        batch = trainer._rollout()
        before = trainer.generator.get_state()
        trainer._update(batch, 0)
        assert (not torch.equal(before, trainer.generator.get_state())) \
            == draws, policy


def test_ppo_behaviour_log_probs_match_jax():
    """PPO's ratio against given behaviour log-probs: loss and gradients
    as JAX's; A2C ignores them."""
    rng = np.random.RandomState(7)
    Tn, En, An = 6, 4, 3
    logits = rng.normal(size=(Tn, En, An, 5)).astype(np.float32)
    values = rng.normal(size=(Tn, En, An)).astype(np.float32)
    actions = rng.randint(0, 5, (Tn, En, An, 1)).astype(np.int32)
    rewards = rng.normal(size=(Tn, En, An)).astype(np.float32)
    done = (rng.uniform(size=(Tn, En)) < 0.2).astype(np.int32)
    old = (rng.normal(size=(Tn, En, An)) * 0.3 - 1.6).astype(np.float32)

    def port_loss(algo, old_lp):
        lg = torch.from_numpy(logits).requires_grad_()
        loss, _ = algo.compute_loss_and_metrics(
            0, torch.from_numpy(actions), torch.from_numpy(rewards),
            torch.from_numpy(done), [lg], torch.from_numpy(values),
            old_log_prob=old_lp)
        return float(loss.detach()), torch.autograd.grad(loss, lg)[0].numpy()

    def jax_loss(algo, old_lp):
        def f(lg):
            return algo.compute_loss_and_metrics(
                0.0, jnp.asarray(actions), jnp.asarray(rewards),
                jnp.asarray(done), [lg], jnp.asarray(values),
                old_log_prob=old_lp)[0]
        loss, grad = jax.value_and_grad(f)(jnp.asarray(logits))
        return float(loss), np.asarray(grad)

    kw = dict(discount_factor_gamma=0.98, vf_loss_coeff=1.0,
              entropy_coeff=0.05)
    for port_algo, jax_algo in ((pg.PPO(clip_param=0.1, **kw),
                                 jpg.PPO(clip_param=0.1, **kw)),
                                (pg.A2C(**kw), jpg.A2C(**kw))):
        got = port_loss(port_algo, torch.from_numpy(old))
        want = jax_loss(jax_algo, jnp.asarray(old))
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)
    # the clipped ratio moves PPO's loss off the detached-ratio one; A2C's
    # does not move
    assert port_loss(pg.PPO(clip_param=0.1, **kw), torch.from_numpy(old))[0] \
        != port_loss(pg.PPO(clip_param=0.1, **kw), None)[0]
    assert port_loss(pg.A2C(**kw), torch.from_numpy(old))[0] \
        == port_loss(pg.A2C(**kw), None)[0]


@pytest.mark.parametrize("shape,fc,heads,deterministic,exact", [
    ((6, 5, 20), (32, 32), (3, 4), False, True),
    ((6, 5, 20), (32, 32), (3, 4), True, True),
    ((20, 100, 81), (256, 256), (10, 10), False, False),  # the tuned width
])
def test_bf16_model_matches_jax(shape, fc, heads, deterministic, exact):
    """The bf16 ``FullyConnected`` on weights carried from flax: outputs
    float32; bit for bit with JAX's bf16 model at the small widths, each
    head within ``BF16_NORMWISE`` of that head's largest output of JAX's at
    the tuned width; within 0.05 of float32 on both sides, and not equal to
    it; float32 gradients reach the float32 parameters."""
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    kw = dict(fc_dims=fc, output_dims=heads,
              is_deterministic=deterministic, action_scale=2.0)
    j32 = JaxFC(**kw)
    jbf = JaxFC(dtype=jnp.bfloat16, **kw)
    params = j32.init(jax.random.PRNGKey(0), jnp.asarray(x))
    state = params_from_flax(_host(params))
    p32 = FullyConnected(shape[-1], fc, heads,
                         is_deterministic=deterministic, action_scale=2.0)
    pbf = FullyConnected(shape[-1], fc, heads,
                         is_deterministic=deterministic, action_scale=2.0,
                         dtype=torch.bfloat16)
    p32.load_state_dict(state)
    pbf.load_state_dict(state)

    xt = torch.from_numpy(x)
    outs = {"jax32": j32.apply(params, jnp.asarray(x)),
            "jaxbf": jbf.apply(params, jnp.asarray(x)),
            "port32": p32(xt), "portbf": pbf(xt)}
    split = {}  # name -> [each head's outputs, the value]
    for name, (hs, value) in outs.items():
        parts = [np.asarray(h.detach().numpy() if torch.is_tensor(h) else h)
                 for h in (*hs, value)]
        assert all(p.dtype == np.float32 for p in parts), name
        split[name] = parts
    for i, (pbf_i, jbf_i, p32_i, j32_i) in enumerate(zip(
            split["portbf"], split["jaxbf"], split["port32"],
            split["jax32"])):
        if exact:
            np.testing.assert_array_equal(pbf_i, jbf_i, err_msg=f"head {i}")
        else:
            bound = BF16_NORMWISE * np.abs(jbf_i).max()
            assert np.abs(pbf_i - jbf_i).max() <= bound, i
        assert 0 < np.abs(pbf_i - p32_i).max() < BF16_VS_F32, i
        assert 0 < np.abs(jbf_i - j32_i).max() < BF16_VS_F32, i
        np.testing.assert_allclose(p32_i, j32_i, rtol=1e-5, atol=1e-5)

    # a bf16 input to the float32 model is promoted, as flax promotes it
    xb = xt.to(torch.bfloat16)
    promoted = p32(xb)
    assert promoted[1].dtype == torch.float32
    want = p32(xb.to(torch.float32))
    torch.testing.assert_close(promoted[1], want[1], rtol=0, atol=0)

    heads_out, value = pbf(xt)
    loss = sum(h.sum() for h in heads_out) + value.sum()
    grads = torch.autograd.grad(loss, list(pbf.parameters()))
    assert all(g.dtype == torch.float32 for g in grads)
    assert all(p.dtype == torch.float32 for p in pbf.parameters())


@pytest.mark.parametrize("num_minibatches,num_envs,bound,loss_rtol", [
    # one pass: the first contiguous minibatch (envs 0-1) of the
    # four-minibatch sweep, as a whole-batch update of a 2-env trainer
    (1, NUM_ENVS // 4, BF16_ONE_PASS, 1e-5),
    (4, NUM_ENVS, BF16_FOUR_PASSES, BF16_GRAD_RTOL),
])
def test_bf16_tuned_miniature_update_matches_jax(
        num_minibatches, num_envs, bound, loss_rtol, jax_batch, tmp_path):
    """The tuned stage's knobs together (bf16 model and batch, contiguous
    minibatches of at most 31 envs, which the JAX trainer relays out
    env-major): the loss, the gradient norm and each parameter's change
    against JAX's, per pass and over four passes, each parameter within a
    small share of a learning rate (the module docstring's bounds)."""
    policy = dict(num_minibatches=num_minibatches, shuffle_minibatches=False,
                  model={"type": "fully_connected", "fc_dims": [16, 16],
                         "dtype": "bfloat16"})
    trainer = {"batch_dtype": "bfloat16", "num_envs": num_envs,
               "train_batch_size": T * num_envs}
    jtrainer = jax_setup(_config(jax_config.load_run_config, policy,
                                 **trainer),
                         verbose=False, results_dir=str(tmp_path / "jax"))
    port = port_train.setup_trainer(
        _config(port_config.load_run_config, policy, **trainer),
        verbose=False, results_dir=str(tmp_path / "port"), device="cpu")
    assert port.models["runner"].dtype == torch.bfloat16
    carry = jtrainer._carry
    _load_from_jax(port, carry)
    before = {tag: params_from_flax(_host(carry["params"][tag]))
              for tag in port.policies}
    batch = {k: v[:, :num_envs] for k, v in jax_batch.items()}
    jbatch = {k: (jnp.asarray(v, jnp.bfloat16) if k.startswith("obs_")
                  else v) for k, v in batch.items()}
    update = jax.jit(jtrainer._make_update(with_metrics=True))
    params, _, jmetrics = update(carry["params"], carry["opt"], jbatch,
                                 jnp.float32(0), jax.random.PRNGKey(1))
    metrics = port._update(_port_batch(batch, torch.bfloat16), 0)
    for tag in port.policies:
        assert port.optimizers[tag].count == num_minibatches
        for name, rtol in (("Total loss", loss_rtol),
                           ("Gradient norm", BF16_GRAD_RTOL)):
            np.testing.assert_allclose(float(metrics[tag][name]),
                                       float(jmetrics[tag][name]),
                                       rtol=rtol, err_msg=f"{tag} {name}")
        lr = port.lr_schedules[tag].value_at(0)
        want = params_from_flax(_host(params[tag]))
        for name, p in port.models[tag].named_parameters():
            got = p.detach().numpy() - before[tag][name].numpy()
            ref = want[name].numpy() - before[tag][name].numpy()
            assert np.abs(ref).mean() > 0.5 * lr, (tag, name)
            diff = np.abs(got - ref).max()
            assert diff <= bound * lr, (tag, name, diff / lr)
