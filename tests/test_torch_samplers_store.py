"""``sampling/samplers.py``'s ``sample_categorical`` and the OU step with
device-scalar schedules, and ``core/state.py``'s queries, against the JAX
package on the CPU:

- ``sample_categorical``: the most likely action exactly (JAX's argmax),
  draws within 5 standard errors of the probabilities, zero-probability
  actions never drawn, and the same draw as ``sample_from_logits`` of
  ``log(probs + 1e-30)`` on one noise;
- ``sample_ou_process`` with 0-dim tensors for ``damping``, ``stddev`` and
  ``scale`` bit for bit with float arguments, both within 1e-7 of JAX's,
  and ``scale`` below 1e-8 a device select of ``mu`` and the old state;
- ``StateStore``'s ``is_on_device``, ``get_shape``, ``get_dtype``,
  ``reset_pool``, ``pull`` and ``names`` against the JAX store's answers on
  one built engine (TagGridWorld with a reset pool).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.envs import register_all_envs as jax_register_all_envs
from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.sampling import samplers as jax_samplers
from warpdrive_tpu.utils.env_registrar import env_registrar as jax_registrar
from warpdrive_tpu_torch.envs import register_all_envs
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.sampling.samplers import (
    sample_categorical,
    sample_from_logits,
    sample_ou_process,
)
from warpdrive_tpu_torch.utils.env_registrar import env_registrar


def _probs(seed, shape=(6, 5)):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    p[:, 1] = 0.0  # never drawn
    return p / p.sum(-1, keepdims=True)


def test_sample_categorical_argmax_equals_jax():
    probs = _probs(1, (40, 7))
    got = sample_categorical(torch.from_numpy(probs), use_argmax=True)
    want = jax_samplers.sample_categorical(jax.random.PRNGKey(0),
                                           jnp.asarray(probs),
                                           use_argmax=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_categorical_draws_by_statistics():
    """20,000 draws of each of 6 rows: each action's frequency within 5
    standard errors of its probability on both sides; the zero column
    never drawn."""
    probs = _probs(2)
    n = 20_000
    batch = np.broadcast_to(probs, (n,) + probs.shape).copy()
    got = sample_categorical(torch.from_numpy(batch),
                             torch.Generator().manual_seed(3)).numpy()
    jgot = np.asarray(jax_samplers.sample_categorical(
        jax.random.PRNGKey(4), jnp.asarray(batch)))
    for draws in (got, jgot):
        assert not (draws == 1).any()
        freq = np.stack([(draws == a).mean(0) for a in range(5)], -1)
        se = np.sqrt(probs * (1 - probs) / n)
        assert (np.abs(freq - probs) <= 5 * se + 1e-12).all()


def test_sample_categorical_is_the_logits_draw_of_log_probs():
    probs = torch.from_numpy(_probs(5))
    gumbel = -torch.log(-torch.log(
        torch.rand(probs.shape, generator=torch.Generator().manual_seed(6))
        .clamp_(min=torch.finfo(torch.float32).tiny)))
    assert torch.equal(
        sample_categorical(probs, gumbel=gumbel),
        sample_from_logits(torch.log(probs + 1e-30), gumbel=gumbel))


@pytest.mark.parametrize("scale", [0.7, 0.0])
def test_ou_step_with_device_scalars_equals_floats_and_jax(scale):
    rng = np.random.default_rng(8)
    mu, ou = (rng.uniform(-1, 1, (7, 3, 2)).astype(np.float32)
              for _ in range(2))
    noise = (0.2 * rng.normal(size=(7, 3, 2))).astype(np.float32)
    t = torch.from_numpy
    floats = sample_ou_process(t(mu), t(ou), damping=0.15, stddev=0.2,
                               scale=scale, noise=t(noise))
    scalars = sample_ou_process(
        t(mu), t(ou), damping=torch.tensor(np.float32(0.15)),
        stddev=torch.tensor(np.float32(0.2)),
        scale=torch.tensor(np.float32(scale)), noise=t(noise))
    jax_out = jax_samplers.sample_ou_process(
        None, jnp.asarray(mu), jnp.asarray(ou), damping=0.15, stddev=0.2,
        scale=scale, noise=jnp.asarray(noise))
    for a, b, c in zip(floats, scalars, jax_out):
        assert torch.equal(a, b)
        np.testing.assert_allclose(b.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-7)
    if scale == 0.0:  # the no-noise mode: mu and the state as they were
        assert torch.equal(scalars[0], t(mu))
        assert torch.equal(scalars[1], t(ou))


def test_state_store_queries_match_jax():
    register_all_envs()
    jax_register_all_envs()
    config = {"episode_length": 6, "seed": 1, "reset_pool_size": 5}
    jeng = JaxEnvEngine(
        env_obj=jax_registrar.get("TagGridWorldWithResetPool",
                                  backend="tpu")(**config),
        num_envs=3, seed=0)
    peng = EnvEngine(
        env_obj=env_registrar.get("TagGridWorldWithResetPool",
                                  backend="torch")(**config),
        num_envs=3, seed=0, device="cpu")
    jstore, store = jeng.store, peng.store
    # the JAX store's per-env PRNG keys are the port store's generator
    assert store.names() == [n for n in jstore.names() if n != "_rng_"]
    assert jstore.is_on_device("_rng_") and not store.is_on_device("_rng_")
    for name in store.names():
        assert store.is_on_device(name) and jstore.is_on_device(name)
        assert store.get_shape(name) == jstore.get_shape(name), name
        assert isinstance(store.get_dtype(name), torch.dtype)
        assert str(store.get_dtype(name)).split(".")[-1] == \
            str(jstore.get_dtype(name)), name
        host = store.pull(name)
        assert isinstance(host, np.ndarray)
        np.testing.assert_array_equal(host, jstore.pull(name), name)
        host[...] = 0  # a copy: the store keeps its values
        np.testing.assert_array_equal(store.pull(name), jstore.pull(name))
    for missing in ("no_such_array", "n_envs"):
        assert not store.is_on_device(missing)
        assert not jstore.is_on_device(missing)
    assert sorted(store.pools) == sorted(jstore.pools)
    for target in store.pools:
        np.testing.assert_array_equal(store.reset_pool(target).numpy(),
                                      np.asarray(jstore.reset_pool(target)))
