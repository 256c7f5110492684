"""``sampling/samplers.py``'s ``sample_categorical`` and the OU step with
device-scalar schedules, and ``core/state.py``'s queries, against the JAX
package on the CPU:

- ``sample_categorical``: the most likely action exactly (JAX's argmax),
  draws within 5 standard errors of the probabilities, zero-probability
  actions never drawn, and the same draw as ``sample_from_logits`` of
  ``log(probs + 1e-30)`` on one noise;
- ``sample_heads`` on the CPU: the stacked ``sample_from_logits`` of its
  heads from a generator seeded alike, bit for bit, with no kernel library
  loaded; its draws by the same statistics; and the categorical-draw
  kernel's input checks (``ops/gumbel_sample.check_inputs``), each refused
  input raising;
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
from warpdrive_tpu_torch.ops import cuda_build, gumbel_sample
from warpdrive_tpu_torch.sampling.samplers import (
    draw_heads_plain,
    sample_categorical,
    sample_from_logits,
    sample_heads,
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


def _fused_heads(lead, widths, seed, scale=3.0):
    """Head slices of one fused ``lead + (sum(widths) + 1,)`` output, as
    the model returns them."""
    fused = scale * torch.randn(lead + (sum(widths) + 1,),
                                generator=torch.Generator().manual_seed(seed))
    starts = np.cumsum((0,) + tuple(widths))
    return [fused[..., a:b] for a, b in zip(starts[:-1], starts[1:])]


@pytest.mark.parametrize("lead,widths", [((6, 7), (21, 21)), ((50,), (5,)),
                                         ((3, 4, 5), (2, 9, 1))])
def test_sample_heads_on_cpu_equals_the_stacked_draws(monkeypatch, lead,
                                                      widths):
    """On the CPU ``sample_heads`` is the stacked ``sample_from_logits`` of
    its heads from a generator seeded alike, bit for bit, and leaves the
    generator where they leave it; no kernel library is loaded and no
    launch counted.  ``draw_heads_plain`` on given uniforms is each head's
    ``sample_from_logits`` with their Gumbel noise and leaves them as they
    were; ``use_argmax`` takes each head's most likely action."""
    def no_library(name):
        raise AssertionError(f"loaded {name} for CPU tensors")

    monkeypatch.setattr(cuda_build, "load", no_library)
    launches = dict(gumbel_sample.LAUNCH_COUNTS)
    for seed in range(4):
        heads = _fused_heads(lead, widths, seed)
        ours = torch.Generator().manual_seed(seed)
        theirs = torch.Generator().manual_seed(seed)
        got = sample_heads(heads, ours)
        want = torch.stack([sample_from_logits(h, theirs) for h in heads],
                           dim=-1)
        assert got.dtype == torch.int32 and got.shape == lead + (
            len(widths),)
        assert torch.equal(got, want)
        assert torch.equal(torch.rand(5, generator=ours),
                           torch.rand(5, generator=theirs))
        uniforms = [torch.rand(h.shape, generator=ours) for h in heads]
        uniforms[0].view(-1)[0] = 0.0  # clamped to the least normal number
        kept = [u.clone() for u in uniforms]
        tiny = torch.finfo(torch.float32).tiny
        assert torch.equal(
            draw_heads_plain(heads, uniforms),
            torch.stack([sample_from_logits(
                h, gumbel=-torch.log(-torch.log(u.clamp(min=tiny))))
                for h, u in zip(heads, kept)], dim=-1))
        for u, k in zip(uniforms, kept):
            assert torch.equal(u, k)
        assert torch.equal(
            sample_heads(heads, use_argmax=True),
            torch.stack([sample_from_logits(h, use_argmax=True)
                         for h in heads], dim=-1))
    assert gumbel_sample.LAUNCH_COUNTS == launches


def test_sample_heads_draws_by_statistics():
    """20,000 draws of each of 6 rows from two heads, the log-probabilities
    of two tables: each action's frequency within 5 standard errors of its
    probability on both sides; the zero columns never drawn."""
    tables = [_probs(2), _probs(7)]
    n = 20_000
    heads = [torch.log(torch.from_numpy(np.broadcast_to(
        p, (n,) + p.shape).copy()) + 1e-30) for p in tables]
    draws = sample_heads(heads, torch.Generator().manual_seed(3)).numpy()
    for c, probs in enumerate(tables):
        got = draws[..., c]
        assert not (got == 1).any()
        freq = np.stack([(got == a).mean(0) for a in range(5)], -1)
        se = np.sqrt(probs * (1 - probs) / n)
        assert (np.abs(freq - probs) <= 5 * se + 1e-12).all()


def _two_heads():
    heads = _fused_heads((4, 3), (21, 21), 0)
    return heads, [torch.rand(h.shape) for h in heads]


_BAD_DRAW_INPUTS = {
    "no head": (lambda h, u: ([], []), "0 heads"),
    "a uniform short": (lambda h, u: (h, u[:1]), "1 uniform tensors"),
    "float64 logits": (lambda h, u: ([h[0].double(), h[1]], u),
                       "logits 0: dtype torch.float64"),
    "bfloat16 logits": (lambda h, u: ([h[0], h[1].bfloat16()], u),
                        "logits 1: dtype torch.bfloat16"),
    "0-dim logits": (lambda h, u: ([h[0][0, 0, 0]], [u[0][0, 0, 0]]),
                     "0-dim"),
    "two row counts": (lambda h, u: ([h[0], h[1][:2]], [u[0], u[1][:2]]),
                       "logits 1: shape"),
    "width 0": (lambda h, u: ([h[0][..., :0]], [u[0][..., :0]]),
                "width 0"),
    "a column stride": (lambda h, u: ([h[0].transpose(1, 2)],
                                      [u[0].transpose(1, 2).contiguous()]),
                        "column stride 43"),
    "no single row stride": (lambda h, u: (
        [h[0].transpose(0, 1)], [u[0].transpose(0, 1).contiguous()]),
        "do not give one row stride"),
    "float64 uniforms": (lambda h, u: (h, [u[0].double(), u[1]]),
                         "uniforms 0: dtype"),
    "uniforms of another shape": (lambda h, u: (h, [u[0], u[1][..., :20]]),
                                  "uniforms 1: shape"),
    "strided uniforms": (lambda h, u: (h, [u[0], u[1].transpose(0, 1)
                                           .contiguous().transpose(0, 1)]),
                         "uniforms 1 is not contiguous"),
    "uniforms on another device": (lambda h, u: (h, [u[0], u[1].to("meta")]),
                                   "uniforms 1 lies on meta"),
    "logits on another device": (lambda h, u: ([h[0], h[1].to("meta")], u),
                                 "logits 1 lies on meta"),
}


@pytest.mark.parametrize("case", sorted(_BAD_DRAW_INPUTS))
def test_draw_kernel_checks_refuse_what_it_does_not_take(case):
    """The checks ``sample_heads`` makes on a card before the launch, run on
    CPU tensors: every refused input raises."""
    heads, uniforms = _two_heads()
    gumbel_sample.check_inputs(heads, uniforms)
    make, match = _BAD_DRAW_INPUTS[case]
    bad_heads, bad_uniforms = make(heads, uniforms)
    with pytest.raises(ValueError, match=match):
        gumbel_sample.check_inputs(bad_heads, bad_uniforms)


@pytest.mark.parametrize("heads", [1, 8, 9, 16])
def test_draw_kernel_checks_take_any_number_of_heads(heads):
    """The kernel takes any number of heads, ``HEADS_A_LAUNCH`` a launch:
    the checks pass 1, 8, 9 and 16 heads of mixed widths."""
    logits = _fused_heads((4, 3), tuple(range(1, heads + 1)), heads)
    gumbel_sample.check_inputs(logits, [torch.rand(h.shape) for h in logits])


def test_sample_heads_refuses_a_device_without_a_kernel():
    heads, _ = _two_heads()
    with pytest.raises(ValueError, match="unsupported device meta"):
        sample_heads([h.to("meta") for h in heads])


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
