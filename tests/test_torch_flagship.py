"""The port's flagship slice as a whole against the JAX package: a two-episode
engine lockstep, the policy network through ``params_from_flax``, the
sampler, ``build_flagship`` on the CPU, and the rule that the port imports
nothing of JAX."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.envs.tag_continuous import TpuTagContinuous
from warpdrive_tpu.models.fully_connected import FullyConnected as JaxFC
from warpdrive_tpu.sampling.samplers import sample_from_logits as jax_sample
from warpdrive_tpu.tools.consistency import _assert_all_close
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.models.fully_connected import (
    FullyConnected,
    params_from_flax,
)
from warpdrive_tpu_torch.ops import knn_obs
from warpdrive_tpu_torch.presets import FLAGSHIP_ENV_KWARGS, build_flagship
from warpdrive_tpu_torch.sampling.samplers import sample_from_logits
from warpdrive_tpu_torch.utils.constants import Constants

_REPO = pathlib.Path(__file__).resolve().parent.parent


def test_two_episode_lockstep_with_jax_engine():
    """Port engine (the flagship's kNN path, plain on the CPU) vs the JAX
    engine with ``ladder`` (same selection semantics), same actions, across
    an auto-reset: obs and rewards within the oracle's 1%, done equal."""
    cfg = dict(FLAGSHIP_ENV_KWARGS, episode_length=60, seed=274880)
    E = 2
    jeng = JaxEnvEngine(
        env_obj=TpuTagContinuous(**cfg, knn_algorithm="ladder"),
        num_envs=E, seed=41,
    )
    peng = EnvEngine(
        env_obj=TorchTagContinuous(**cfg, knn_algorithm="pallas_flat_exact"),
        num_envs=E, seed=41, device="cpu",
    )
    jeng.reset_all_envs()
    peng.reset_all_envs()
    obs_name, rew_name = Constants.OBSERVATIONS, Constants.REWARDS
    _assert_all_close(peng.state[obs_name].numpy(),
                      np.asarray(jeng.state[obs_name]), 1.0, "obs at reset")
    nvec = jeng.action_space[0].nvec
    rng = np.random.RandomState(41)
    n_resets = 0
    for t in range(2 * 60):
        actions = np.stack(
            [rng.randint(0, n, (E, jeng.n_agents)) for n in nvec], -1
        ).astype(np.int32)
        jeng.step_all_envs(actions)
        out = peng.step_all_envs(torch.from_numpy(actions))
        _assert_all_close(out[obs_name].numpy(),
                          np.asarray(jeng.state[obs_name]), 1.0,
                          f"obs at t={t}")
        _assert_all_close(out[rew_name].numpy(),
                          np.asarray(jeng.state[rew_name]), 1.0,
                          f"rewards at t={t}")
        done = np.asarray(jeng.state[Constants.DONE])
        np.testing.assert_array_equal(out[Constants.DONE].numpy(), done,
                                      err_msg=f"done at t={t}")
        if done.any():
            n_resets += 1
            jeng.reset_only_done_envs()
            peng.reset_only_done_envs()
            for name in ("loc_x", "still_in_the_game", obs_name,
                         Constants.TIMESTEP):
                np.testing.assert_array_equal(
                    peng.state[name].numpy(), np.asarray(jeng.state[name]),
                    err_msg=f"{name} after reset at t={t}",
                )
    assert n_resets >= 1


@pytest.mark.parametrize("deterministic", [False, True])
def test_params_from_flax_forward_parity(deterministic):
    rng = np.random.RandomState(0)
    obs = rng.normal(size=(3, 7, 81)).astype(np.float32)
    mask = (rng.uniform(size=(3, 7, 22)) > 0.3).astype(np.float32)
    jmodel = JaxFC(fc_dims=(64, 64), output_dims=(11, 11),
                   is_deterministic=deterministic, action_scale=2.0,
                   action_bias=0.5)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(obs[:1]))
    model = FullyConnected(81, (64, 64), (11, 11),
                           is_deterministic=deterministic, action_scale=2.0,
                           action_bias=0.5)
    model.load_state_dict(
        params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    )
    kwargs = {} if deterministic else {"action_mask": mask}
    ref_heads, ref_value = jmodel.apply(params, jnp.asarray(obs), **kwargs)
    with torch.no_grad():
        heads, value = model(
            torch.from_numpy(obs),
            **{k: torch.from_numpy(v) for k, v in kwargs.items()},
        )
    assert len(heads) == len(ref_heads) == 2
    for h, rh in zip(heads, ref_heads):
        np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(ref_value),
                               rtol=1e-5, atol=1e-5)


def test_sampler_argmax_and_injected_noise():
    rng = np.random.RandomState(1)
    logits = rng.normal(size=(50, 11)).astype(np.float32)
    arg = sample_from_logits(torch.from_numpy(logits), use_argmax=True)
    ref = jax_sample(jax.random.PRNGKey(0), jnp.asarray(logits),
                     use_argmax=True)
    assert arg.dtype == torch.int32
    np.testing.assert_array_equal(arg.numpy(), np.asarray(ref))

    g = rng.gumbel(size=logits.shape).astype(np.float32)
    drawn = sample_from_logits(torch.from_numpy(logits),
                               gumbel=torch.from_numpy(g))
    np.testing.assert_array_equal(drawn.numpy(),
                                  np.argmax(logits + g, axis=-1))


def test_sampler_statistics_match_softmax():
    logits = np.array([1.0, -0.5, 0.3, 2.0, -1e20, 0.0], dtype=np.float32)
    n = 20000
    gen = torch.Generator().manual_seed(5)
    draws = sample_from_logits(
        torch.from_numpy(np.tile(logits, (n, 1))), generator=gen
    ).numpy()
    freq = np.bincount(draws, minlength=len(logits)) / n
    p = np.exp(logits - logits.max())
    p /= p.sum()
    np.testing.assert_allclose(freq, p, atol=0.01)
    assert freq[4] == 0.0  # a masked action is never drawn


def test_build_flagship_runs_both_loops_on_cpu():
    knn_obs.reset_launch_counts()
    system = build_flagship(num_envs=4, fc_dims=(64, 64), seed=3,
                            device="cpu")
    state = system["state"]
    N = system["num_agents"]
    assert N == 105
    gen = torch.Generator().manual_seed(0)
    state, checksum = system["env_only_step"]((state, torch.zeros(())), gen)
    assert checksum.dtype == torch.float32 and torch.isfinite(checksum)
    state = system["full_loop_step"](system["models"], state, gen)
    for name in ("loc_x", "loc_y", "speed", "direction", "acceleration",
                 Constants.REWARDS):
        assert state[name].shape == (4, N) and state[name].dtype == torch.float32
        assert torch.isfinite(state[name]).all()
    assert state["still_in_the_game"].dtype == torch.int32
    assert state[Constants.DONE].shape == (4,)
    assert (state[Constants.TIMESTEP] == 2).all()
    obs = system["engine"].observe(state)
    assert obs.shape == (4, N, 81) and obs.dtype == torch.float32
    assert knn_obs.LAUNCH_COUNTS["knn_obs_flat_exact"] == 0


def test_build_flagship_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        build_flagship(num_envs=2, fc_dims=(8, 8))


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((_REPO / "warpdrive_tpu_torch").rglob("*.py"))
    files.append(_REPO / "chip_smoke.py")
    assert len(files) > 15
    banned = ("jax", "jaxlib", "flax", "optax", "warpdrive_tpu")
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in banned, f"{path.relative_to(_REPO)} imports {mod}"
