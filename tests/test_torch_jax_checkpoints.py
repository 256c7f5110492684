"""The JAX package's checkpoints (flax msgpack ``*.state_dict`` files) loaded
into the port's trainers through ``model_ckpt_filepath``, against the JAX
trainers loading the same files: ``artifacts/cartpole_a2c_cpu`` (A2C),
``pendulum_ddpg_cpu`` (DDPG, actor and critic) and ``tag_continuous_cpu``
(two A2C policies, 3 taggers + 20 runners, k = 10), each trainer built on
the CPU from the artifact's own ``run_config.json`` (``env_backend:
"tpu"``, ``num_devices: 1``; TagContinuous observes with ``passes``, as it
trained).  The loaded parameters equal the files' bit for bit; one
``evaluate_episodes`` of each agrees within the consistency oracle's 1% in
episodic reward and steps, from the same start states; and on the states of
the JAX trainer's fetched episode the port's most likely actions equal
JAX's except where JAX's top two logits lie within 1e-5 (counted), DDPG's
actions within 1e-5."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warpdrive_tpu.tools.consistency import _assert_all_close
from warpdrive_tpu.training.scripts.train import setup_trainer as jax_setup
from warpdrive_tpu_torch.models.fully_connected import params_from_flax
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.utils import flax_msgpack
from warpdrive_tpu_torch.utils.constants import Constants

_REPO = pathlib.Path(__file__).resolve().parent.parent
_OBS = Constants.OBSERVATIONS
ORACLE_PCT = 1.0
NEAR_TIE = 1e-5
DDPG_ACTION_TOL = 1e-5
ARTIFACTS = ("cartpole_a2c_cpu", "pendulum_ddpg_cpu", "tag_continuous_cpu")


def _run_config(artifact: str) -> dict:
    """The artifact's run config as given, its checkpoints named in each
    policy's ``model_ckpt_filepath``."""
    folder = _REPO / "artifacts" / artifact
    cfg = json.loads((folder / "run_config.json").read_text())
    for tag, policy in cfg["policy"].items():
        model = policy["model"]
        if policy.get("algorithm") == "DDPG":
            model["model_ckpt_filepath"] = {
                net: str(next(folder.glob(f"{tag}_{net}_*.state_dict")))
                for net in ("actor", "critic")}
        else:
            model["model_ckpt_filepath"] = str(
                next(folder.glob(f"{tag}_[0-9]*.state_dict")))
    return cfg


@pytest.fixture(scope="module", params=ARTIFACTS)
def both(request, tmp_path_factory):
    artifact = request.param
    tmp = tmp_path_factory.mktemp(artifact)
    jtrainer = jax_setup(_run_config(artifact), verbose=False,
                         results_dir=str(tmp / "jax"))
    port = port_train.setup_trainer(_run_config(artifact), verbose=False,
                                    device="cpu",
                                    results_dir=str(tmp / "port"))
    return artifact, jtrainer, port


def _nets(port):
    if hasattr(port, "nets"):
        return {(tag, net): port.nets[net][tag] for net in ("actor", "critic")
                for tag in port.policies}
    return {(tag, None): port.models[tag] for tag in port.policies}


def test_loaded_parameters_equal_the_files(both):
    artifact, jtrainer, port = both
    cfg = _run_config(artifact)
    for (tag, net), module in _nets(port).items():
        path = cfg["policy"][tag]["model"]["model_ckpt_filepath"]
        path = path[net] if net else path
        want = params_from_flax(flax_msgpack.read_file(path))
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (tag, net, key)
        if net is not None:  # the targets start at the loaded nets
            for key, value in port.targets[net][tag].state_dict().items():
                assert torch.equal(value, want[key])
    # the schedules resume from the files' timestep, as in JAX
    assert port.current_timestep == jtrainer.current_timestep > 0


def _same_start(jtrainer, port):
    """Where the env draws reset-pool rows (Pendulum), both engines start
    from the same rows, as a state as built that the next reset keeps."""
    eng = port.engine
    if "state" not in eng.store.pools:
        return
    rows = np.random.default_rng(0).choice(
        eng.store.pools["state"].shape[0], eng.n_envs, replace=False)
    state = dict(eng.state)
    state["state"] = eng.store.pools["state"][torch.from_numpy(rows)]
    state[_OBS] = eng.env.observe_fn(state).to(state[_OBS].dtype)
    eng.state = state
    eng._first_reset_done = False
    jeng = jtrainer.engine
    jeng.state = {**jeng.state, "state": jnp.asarray(state["state"].numpy()),
                  _OBS: jnp.asarray(state[_OBS].numpy())}
    jeng._first_reset_done = False


def test_evaluations_agree_within_the_oracle(both):
    artifact, jtrainer, port = both
    _same_start(jtrainer, port)
    jrew, jsteps = jtrainer.evaluate_episodes(use_argmax=True)
    _same_start(jtrainer, port)
    rew, steps = port.evaluate_episodes(use_argmax=True)
    assert sorted(rew) == sorted(jrew) == sorted(port.policies)
    for tag in port.policies:
        _assert_all_close(rew[tag], np.asarray(jrew[tag]), ORACLE_PCT,
                          f"{artifact} {tag} episodic rewards")
        _assert_all_close(steps[tag], np.asarray(jsteps[tag]), ORACLE_PCT,
                          f"{artifact} {tag} episodic steps")
    # a trained policy: the episodes earn something
    assert any(np.abs(np.asarray(jrew[t])).sum() > 0 for t in jrew)


def test_port_acts_as_jax_on_the_jax_episode(both):
    artifact, jtrainer, port = both
    episode = jtrainer.fetch_episode_states([_OBS])[_OBS]  # (T + 1, N, F)
    assert episode.shape[0] >= 2
    obs = torch.from_numpy(np.asarray(episode))
    params = jax.tree_util.tree_map(np.asarray, jtrainer._act_params())
    near_ties = compared = 0
    for tag, ids in port.policy_tag_to_agent_id_map.items():
        obs_p = obs[:, ids]
        if hasattr(port, "nets"):
            with torch.no_grad():
                got = port.nets["actor"][tag](obs_p).numpy()
            want = np.asarray(jtrainer.actor_models[tag].apply(
                params[tag], jnp.asarray(obs_p.numpy())))
            np.testing.assert_allclose(got, want, rtol=DDPG_ACTION_TOL,
                                       atol=DDPG_ACTION_TOL)
            compared += got.size
            continue
        with torch.no_grad():
            logits_list, _ = port.models[tag](obs_p)
        jlogits_list, _ = jtrainer._policy_forward(
            tag, params[tag], jnp.asarray(obs_p.numpy()))
        for logits, jlogits in zip(logits_list, jlogits_list):
            jl = np.asarray(jlogits)
            top2 = np.sort(jl, axis=-1)[..., -2:]
            tie = (top2[..., 1] - top2[..., 0]) <= NEAR_TIE
            differ = logits.argmax(-1).numpy() != jl.argmax(-1)
            assert not (differ & ~tie).any(), (
                f"{artifact} {tag}: {int((differ & ~tie).sum())} actions "
                "differ outside near-ties")
            near_ties += int(tie.sum())
            compared += tie.size
    print(f"{artifact}: {compared} actions compared, {near_ties} near-ties")
    assert compared > 0
