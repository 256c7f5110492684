"""The port's returns, schedules and policy-gradient losses
(``warpdrive_tpu_torch/algos``, ``training/param_scheduler.py``) against the
JAX package on the same numpy inputs.

Tolerance: rtol 1e-5, atol 1e-6 (float32 sums taken in other orders by XLA
and by PyTorch); integer and {0, 1} results are equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.algos import policygradient as jpg
from warpdrive_tpu.algos import returns as jreturns
from warpdrive_tpu.models.fully_connected import FullyConnected as JaxFC
from warpdrive_tpu.training.param_scheduler import (
    ParamScheduler as JaxParamScheduler,
)
from warpdrive_tpu_torch.algos import policygradient as pg
from warpdrive_tpu_torch.algos import returns
from warpdrive_tpu_torch.models.fully_connected import (
    FullyConnected,
    params_from_flax,
)
from warpdrive_tpu_torch.training.param_scheduler import ParamScheduler

RTOL, ATOL = 1e-5, 1e-6
T, E, A, F = 7, 5, 3, 12
HEADS = (4, 6)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _done_flags(rng, last_done):
    done = (rng.uniform(size=(T, E)) < 0.15).astype(np.int32)
    done[rng.uniform(size=(T, E)) < 0.05] = 2
    done[-1] = 1 if last_done else 0
    return done


@pytest.mark.parametrize("last_done", [False, True])
def test_discounted_returns_match_jax(last_done):
    rng = np.random.RandomState(4)
    rew = rng.normal(size=(T, E, A)).astype(np.float32)
    val = rng.normal(size=(T, E, A)).astype(np.float32)
    done = _done_flags(rng, last_done)
    got = returns.discounted_returns(
        torch.from_numpy(rew), torch.from_numpy(done), torch.from_numpy(val),
        0.98)
    want = jreturns.discounted_returns(jnp.asarray(rew), jnp.asarray(done),
                                       jnp.asarray(val), 0.98)
    _close(got, want)
    if not last_done:
        # the reference quirk: the bootstrap replaces the last reward
        np.testing.assert_array_equal(got[-1].numpy(), val[-1])


@pytest.mark.parametrize("enabled", [False, True])
def test_normalize_across_env_agents_matches_jax(enabled):
    x = np.random.RandomState(5).normal(3.0, 2.0, (T, E, A)).astype(np.float32)
    got = returns.normalize_across_env_agents(torch.from_numpy(x), enabled)
    want = jreturns.normalize_across_env_agents(jnp.asarray(x), enabled)
    _close(got, want)


@pytest.mark.parametrize("schedule", [0.005, [[0, 0.01], [1000, 0.001],
                                              [5000, 0.0005]]])
def test_param_scheduler_matches_jax(schedule):
    ours, ref = ParamScheduler(schedule), JaxParamScheduler(schedule)
    for t in (0, 1, 250, 999, 1000, 3000, 5000, 10_000):
        assert ours.get_param_value(t) == ref.get_param_value(t)
        got = ours.value_at(t)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(ref.value_at(t)),
                                   rtol=1e-6)


@pytest.mark.parametrize("ratio", [0.5, 3.0])
def test_env_selection_weights_with_injected_draws(ratio):
    rng = np.random.RandomState(6)
    done = _done_flags(rng, last_done=True)
    key = jax.random.PRNGKey(9)
    want = jpg.env_selection_weights(jnp.asarray(done), ratio, key)
    uniform = np.array(jax.random.uniform(key, (E,)))
    got = pg.env_selection_weights(torch.from_numpy(done), ratio,
                                   uniform=torch.from_numpy(uniform))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # no success marker: every env is kept
    no_pos = np.minimum(done, 1)
    got = pg.env_selection_weights(torch.from_numpy(no_pos), ratio,
                                   uniform=torch.from_numpy(uniform))
    np.testing.assert_array_equal(got.numpy(), np.ones(E, np.float32))


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {
        "obs": rng.normal(size=(T, E, A, F)).astype(np.float32),
        "actions": np.stack([rng.randint(0, n, (T, E, A)) for n in HEADS],
                            -1).astype(np.int32),
        "rewards": rng.normal(size=(T, E, A)).astype(np.float32),
        "done": _done_flags(rng, last_done=False),
    }


@pytest.mark.parametrize(
    "algo_name,normalize,ratio",
    [("A2C", False, -1.0), ("A2C", True, 1.0), ("PPO", False, -1.0),
     ("PPO", True, 0.5)],
)
def test_loss_and_gradients_match_jax(algo_name, normalize, ratio):
    """The same batch and parameters through both models and losses: the
    loss, every metric and every parameter's gradient agree."""
    batch = _batch(7)
    common = dict(discount_factor_gamma=0.95, normalize_advantage=normalize,
                  normalize_return=normalize, vf_loss_coeff=0.5,
                  entropy_coeff=0.05)
    if algo_name == "PPO":
        common["clip_param"] = 0.2
    jalgo = getattr(jpg, algo_name)(**common)
    algo = getattr(pg, algo_name)(**common)

    jmodel = JaxFC(fc_dims=(16, 16), output_dims=HEADS)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(batch["obs"][0]))
    model = FullyConnected(F, (16, 16), HEADS)
    model.load_state_dict(
        params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    key = jax.random.PRNGKey(3)
    uniform = torch.from_numpy(np.array(jax.random.uniform(key, (E,))))

    def jax_loss(p):
        logits, values = jmodel.apply(p, jnp.asarray(batch["obs"]))
        return jalgo.compute_loss_and_metrics(
            jnp.float32(100.0), jnp.asarray(batch["actions"]),
            jnp.asarray(batch["rewards"]), jnp.asarray(batch["done"]),
            logits, values, negative_positive_ratio=ratio,
            downsample_key=key,
        )

    jgrads, jmetrics = jax.grad(jax_loss, has_aux=True)(params)
    jloss = jax_loss(params)[0]

    logits, values = model(torch.from_numpy(batch["obs"]))
    loss, metrics = algo.compute_loss_and_metrics(
        100.0, torch.from_numpy(batch["actions"]),
        torch.from_numpy(batch["rewards"]), torch.from_numpy(batch["done"]),
        logits, values, negative_positive_ratio=ratio,
        downsample_uniform=uniform,
    )
    loss.backward()

    _close(loss.detach(), jloss)
    assert set(metrics) == set(jmetrics)
    for name, value in metrics.items():
        _close(float(value), jmetrics[name])
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        _close(p.grad, want[name])
