"""The port's serving path (``warpdrive_tpu_torch/serving.py``) against the
JAX package's (``warpdrive_tpu/serving.py``), after ``tests/test_serving.py``:
a JAX-trained CartPole (A2C) and Pendulum (DDPG) exported by JAX serve in
the port, and the same parameters exported by the port serve in JAX's
``load_policy``, on observations from the trainers' own state: argmax
actions equal, DDPG actions within 1e-6, manifests equal key for key.
Stochastic ``act`` draws in range and, on one state, at the softmax's
frequencies within 5 sigma."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpdrive_tpu.serving import export_policy as jax_export
from warpdrive_tpu.serving import load_policy as jax_load
from warpdrive_tpu.training.scripts.train import (
    setup_trainer_and_train as jax_train,
)
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.models.fully_connected import (
    FullyConnected,
    params_from_flax,
    params_to_flax,
)
from warpdrive_tpu_torch.serving import MANIFEST, PARAMS, export_policy
from warpdrive_tpu_torch.serving import load_policy
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.utils import config as port_config
from warpdrive_tpu_torch.utils import flax_msgpack

DDPG_TOL = 1e-6


def _config(load, name):
    cfg = load(name)
    if name == "single_cartpole":
        cfg["trainer"].update({"num_envs": 8, "train_batch_size": 160,
                               "num_episodes": 16, "seed": 3})
        cfg["env"].update({"episode_length": 50, "reset_pool_size": 0})
        cfg["policy"]["shared"]["model"]["fc_dims"] = [16, 16]
    else:
        cfg["trainer"].update({"num_envs": 8, "train_batch_size": 400,
                               "num_episodes": 24, "seed": 7, "n_step": 3})
        cfg["env"].update({"episode_length": 50, "reset_pool_size": 0,
                           "seed": 3})
        for net in ("actor", "critic"):
            cfg["policy"]["shared"]["model"][net]["fc_dims"] = [16, 16]
    cfg["saving"]["metrics_log_freq"] = 10**9
    cfg["saving"]["model_params_save_freq"] = 10**9
    return cfg


@pytest.fixture(scope="module", params=["single_cartpole", "single_pendulum"])
def trained(request, tmp_path_factory):
    """A JAX-trained policy, a port trainer holding its parameters, and
    observations from the JAX trainer's own state."""
    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    jtrainer = jax_train(_config(jax_config.load_run_config, name),
                         verbose=False, results_dir=str(tmp / "jax"))
    port = port_train.setup_trainer(
        _config(port_config.load_run_config, name), verbose=False,
        device="cpu", results_dir=str(tmp / "port"))
    carry = jax.tree_util.tree_map(np.asarray, jtrainer._carry)
    if "actor" in carry:
        port.nets["actor"]["shared"].load_state_dict(
            params_from_flax(carry["actor"]["shared"]))
    else:
        port.models["shared"].load_state_dict(
            params_from_flax(carry["params"]["shared"]))
    state = {k: jnp.asarray(v) for k, v in jtrainer.engine.state.items()}
    obs, _ = jtrainer._policy_obs_and_mask(state, None, "shared")
    return name, tmp, jtrainer, port, np.asarray(obs)


def _assert_served_alike(name, got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    if name == "single_cartpole":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=DDPG_TOL, atol=DDPG_TOL)


def test_jax_bundle_serves_in_the_port(trained):
    name, tmp, jtrainer, _, obs = trained
    bundle = jax_export(jtrainer, "shared", str(tmp / "jax_bundle"))
    jact, jmanifest = jax_load(bundle)
    act, manifest = load_policy(bundle, device="cpu")
    assert manifest == jmanifest
    served = act(obs)
    assert isinstance(served, torch.Tensor) and served.device.type == "cpu"
    _assert_served_alike(name, served, jact(obs))
    # the trainer's own actions on that state
    if name == "single_cartpole":
        want = jtrainer._act_fn(jtrainer._act_params(),
                                {k: jnp.asarray(v) for k, v in
                                 jtrainer.engine.state.items()},
                                jax.random.PRNGKey(0), use_argmax=True)
    else:
        want = jtrainer.actor_models["shared"].apply(
            jtrainer._carry["actor"]["shared"], obs)
    _assert_served_alike(name, served, want)
    # any leading axes; a tensor is taken as it is
    _assert_served_alike(name, act(torch.from_numpy(obs[None])),
                         jact(obs[None]))


def test_port_bundle_serves_in_jax(trained):
    name, tmp, jtrainer, port, obs = trained
    bundle = export_policy(port, "shared", str(tmp / "port_bundle"))
    jact, jmanifest = jax_load(bundle)
    act, manifest = load_policy(bundle, device="cpu")
    jax_export(jtrainer, "shared", str(tmp / "jax_ref"))
    want_manifest = json.loads((tmp / "jax_ref" / MANIFEST).read_text())
    assert manifest == jmanifest == want_manifest
    assert list(manifest) == list(want_manifest)  # key for key, in order
    _assert_served_alike(name, act(obs), jact(obs))


def test_port_serves_what_the_port_trainer_acts(trained):
    name, tmp, _, port, obs = trained
    bundle = export_policy(port, "shared", str(tmp / "port_bundle2"))
    act, _ = load_policy(bundle, device="cpu")
    if name == "single_cartpole":
        want = port._act_fn(port.engine.state)
        obs_p, _ = port._policy_obs_and_mask(port.engine.state, None,
                                             "shared")
    else:
        obs_p, _ = port._policy_obs_and_mask(port.engine.state, None,
                                             "shared")
        with torch.no_grad():
            want = port.nets["actor"]["shared"](obs_p)
    assert torch.equal(act(obs_p), want)


def test_load_policy_defaults_to_the_card(trained, tmp_path):
    name, tmp, _, port, _ = trained
    bundle = export_policy(port, "shared", str(tmp_path / "b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            load_policy(bundle)


def _multi_head_bundle(tmp_path, heads=(5, 3), obs_size=7):
    gen = torch.Generator().manual_seed(4)
    model = FullyConnected(obs_size, (16,), heads, generator=gen)
    manifest = {"kind": "categorical", "policy": "p",
                "model_type": "fully_connected", "fc_dims": [16],
                "output_dims": list(heads), "dtype": "float32",
                "obs_size": obs_size}
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / MANIFEST).write_text(json.dumps(manifest))
    flax_msgpack.write_file(str(tmp_path / PARAMS),
                            params_to_flax(model.state_dict()))
    return model


def test_stochastic_act_draws_in_range_at_the_softmax(tmp_path):
    """20,000 draws on one state: every action in range, and each head's
    frequencies within 5 sigma of its softmax; JAX reads the same bundle
    to the same argmax."""
    heads = (5, 3)
    model = _multi_head_bundle(tmp_path, heads)
    act, _ = load_policy(str(tmp_path), device="cpu")
    rng = np.random.default_rng(0)
    one = rng.standard_normal((1, 7)).astype(np.float32)
    n = 20_000
    draws = act(np.repeat(one, n, axis=0), generator=torch.Generator()
                .manual_seed(1), argmax=False).numpy()
    assert draws.shape == (n, 2) and draws.dtype == np.int32
    with torch.no_grad():
        logits_list, _ = model(torch.from_numpy(one))
    for h, (size, logits) in enumerate(zip(heads, logits_list)):
        assert ((draws[:, h] >= 0) & (draws[:, h] < size)).all()
        p = torch.softmax(logits[0], -1).numpy().astype(np.float64)
        freq = np.bincount(draws[:, h], minlength=size) / n
        sigma = np.sqrt(p * (1 - p) / n)
        assert (np.abs(freq - p) <= 5 * sigma + 1e-12).all(), (freq, p)
    # argmax needs no generator, and JAX serves the same bundle alike
    jact, _ = jax_load(str(tmp_path))
    obs = rng.standard_normal((6, 4, 7)).astype(np.float32)
    np.testing.assert_array_equal(act(obs).numpy(), np.asarray(jact(obs)))
    # an action mask drives the masked actions out of every draw
    mask = np.ones((n, 8), np.float32)
    mask[:, 0] = 0.0  # first head's action 0
    masked = act(np.repeat(one, n, axis=0), generator=torch.Generator()
                 .manual_seed(2), argmax=False, action_mask=mask).numpy()
    assert (masked[:, 0] != 0).all()
    with pytest.raises(AssertionError, match="Generator"):
        act(one, argmax=False)
    with pytest.raises(AssertionError, match="trailing"):
        act(np.zeros((2, 6), np.float32))
