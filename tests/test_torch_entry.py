"""The port's ``entry()`` (``warpdrive_tpu_torch/entry.py``) against the JAX
package's (``__graft_entry__.py:entry``): the same flagship system (4 envs
x 105 agents, fc (64, 64)), the same rollout state as built, and from the
same parameters and state one full loop step observes what JAX observes --
against JAX's plain path (the env's exact ``observe_fn``) the K1 class,
1e-6; against JAX's kernel in interpret mode, which picks features through
bf16 hi/lo pairs, 8e-6 with the slots' type, liveness, valid bits and time
equal -- and draws actions that agree with JAX's by statistics."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from warpdrive_tpu.presets import build_flagship as jax_build_flagship
from warpdrive_tpu_torch.entry import entry
from warpdrive_tpu_torch.models.fully_connected import params_from_flax

OBS_TOL = 1e-6
BF16_PAIR_TOL = 8e-6
K = 10
DRAWS = 200


def _port_from_jax():
    """The port's entry with JAX's entry's parameters and state."""
    fn, (models, state, generator) = entry(device="cpu")
    jfn, (jparams, jstate, key) = graft.entry()
    for tag, model in models.items():
        model.load_state_dict(params_from_flax(
            jax.tree_util.tree_map(np.asarray, jparams[tag])))
    state = {k: torch.from_numpy(np.array(jstate[k])).to(v.dtype)
             for k, v in state.items()}
    return fn, models, state, generator, jfn, jparams, jstate, key


def test_entry_is_the_flagship_full_loop_step():
    fn, (models, state, generator) = entry(device="cpu")
    jfn, (jparams, jstate, _) = graft.entry()
    assert fn.__name__ == jfn.__name__ == "full_loop_step"
    assert isinstance(generator, torch.Generator)
    assert sorted(models) == sorted(jparams) == ["runner", "tagger"]
    for tag, model in models.items():
        want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                       jparams[tag]))
        got = model.state_dict()
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
    # the same rollout state as built: the seeded env draws the same
    # taggers and starting layout (JAX carries its PRNG key in the state,
    # the port a torch.Generator beside it)
    assert sorted(state) == sorted(k for k in jstate if k != "_rng_")
    for name, value in state.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jstate[name]),
                                      err_msg=name)
    assert state["loc_x"].shape == (4, 105)


def test_entry_step_observes_as_jax():
    fn, models, state, generator, _, _, jstate, _ = _port_from_jax()
    seen = {}
    hooks = [model.register_forward_pre_hook(
        lambda module, args, tag=tag: seen.__setitem__(tag, args[0].clone()))
        for tag, model in models.items()]
    try:
        out = fn(models, state, generator)
    finally:
        for hook in hooks:
            hook.remove()
    # JAX's observations of the same state through the engine its entry()
    # builds: the kernel (interpret mode) and the env's plain path
    jsys = jax_build_flagship(num_envs=4, fc_dims=(64, 64), seed=0)
    kernel = np.asarray(jsys["engine"].observe(jstate))
    plain = np.asarray(jax.vmap(jsys["env"].observe_fn)(jstate))
    for tag, ids in jsys["policy_ids"].items():
        got = seen[tag].numpy()
        np.testing.assert_allclose(got, plain[:, ids], rtol=1e-5,
                                   atol=OBS_TOL, err_msg=tag)
        np.testing.assert_allclose(got, kernel[:, ids], rtol=0,
                                   atol=BF16_PAIR_TOL, err_msg=tag)
        slots = got[..., :-1].reshape(got.shape[:2] + (K, 8))
        ref = kernel[:, ids][..., :-1].reshape(slots.shape)
        np.testing.assert_array_equal(slots[..., 5:], ref[..., 5:])
        np.testing.assert_array_equal(got[..., -1], kernel[:, ids][..., -1])
    assert sorted(out) == sorted(state)
    assert all(torch.isfinite(v.float()).all() for v in out.values())


def test_entry_step_actions_agree_with_jax_by_statistics():
    """{DRAWS} steps from the one state on each side, each with its own
    draw: the post-step acceleration and direction of every agent (each a
    function of that agent's sampled action pair) have the same means
    within 5 sigma of the two-sample spread."""
    fn, models, state, _, jfn, jparams, jstate, _ = _port_from_jax()
    jstep = jax.jit(jfn)
    names = ("acceleration", "direction")
    port_draws = {n: [] for n in names}
    jax_draws = {n: [] for n in names}
    for i in range(DRAWS):
        gen = torch.Generator().manual_seed(1000 + i)
        out = fn(models, state, gen)
        jout = jstep(jparams, jstate, jax.random.PRNGKey(1000 + i))
        for n in names:
            port_draws[n].append(out[n].numpy())
            jax_draws[n].append(np.asarray(jout[n]))
    for n in names:
        a = np.stack(port_draws[n]).astype(np.float64)
        b = np.stack(jax_draws[n]).astype(np.float64)
        spread = np.sqrt((a.var(0) + b.var(0)) / DRAWS)
        gap = np.abs(a.mean(0) - b.mean(0))
        assert (gap <= 5 * spread + 1e-6).all(), (n, float(gap.max()))
        # the draws vary: the step samples, it does not take the argmax
        assert (a.std(0) > 0).mean() > 0.5


test_entry_step_actions_agree_with_jax_by_statistics.__doc__ = (
    test_entry_step_actions_agree_with_jax_by_statistics.__doc__.format(
        DRAWS=DRAWS))


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        entry()
