"""The port's AsymmetricPursuit (``warpdrive_tpu_torch/envs/
asymmetric_pursuit.py``: separate per-policy placeholders, the evaders'
Dict observations with an ``action_mask`` key) against its numpy reference
and against the JAX package: the lockstep checker, the step beside JAX's
over 20 seeded steps, the placeholders, one A2C update of both policies
from JAX's weights and batch, the masked draws, and the CLI.  Small sizes:
2 pursuers and 3 evaders on an 8 x 8 grid, fc (16, 16)."""

import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from warpdrive_tpu.envs.asymmetric_pursuit import TpuAsymmetricPursuit
from warpdrive_tpu.envs.engine import EnvEngine as JaxEnvEngine
from warpdrive_tpu.training.scripts import train as jax_train
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.envs.asymmetric_pursuit import (
    AsymmetricPursuit,
    TorchAsymmetricPursuit,
)
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.models.fully_connected import (
    adam_state_from_optax,
    params_from_flax,
)
from warpdrive_tpu_torch.tools.consistency import (
    EnvironmentCPUvsDevice,
    draw_actions,
    pack_actions,
)
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.utils import config as port_config
from warpdrive_tpu_torch.utils.constants import Constants

ENV_CFG = {"num_pursuers": 2, "num_evaders": 3, "grid_length": 8.0,
           "catch_radius": 1.5, "episode_length": 8}
# observations, rewards: float32 arithmetic in another order (a mean of
# three, a division) is within 1e-6 of JAX's; positions are exact
OBS_ATOL = 1e-6
# parameters after one update: as in test_torch_trainer_a2c.py, far below
# the learning rate (2e-3), since the frameworks sum gradients in other
# orders
PARAM_ATOL = 1e-5


def _engines(num_envs=4, **overrides):
    cfg = {**ENV_CFG, **overrides}
    jenv, penv = TpuAsymmetricPursuit(**cfg), TorchAsymmetricPursuit(**cfg)
    jeng = JaxEnvEngine(env_obj=jenv, num_envs=num_envs, seed=0,
                        policy_tag_to_agent_id_map=jenv.policy_map(),
                        create_separate_placeholders_for_each_policy=True)
    peng = EnvEngine(env_obj=penv, num_envs=num_envs, seed=0, device="cpu",
                     policy_tag_to_agent_id_map=penv.policy_map(),
                     create_separate_placeholders_for_each_policy=True)
    return jeng, peng


@pytest.mark.parametrize("overrides", [{}, {"evader_step": 0.5},
                                       {"grid_length": 3.0}])
def test_numpy_vs_torch_through_the_checker(overrides):
    EnvironmentCPUvsDevice(
        cpu_env_class=AsymmetricPursuit,
        device_env_class=TorchAsymmetricPursuit,
        env_configs={"case": {**ENV_CFG, **overrides}},
        num_envs=3, num_episodes=2, device="cpu",
        create_separate_placeholders_for_each_policy=True,
    ).test_env_reset_and_step(threshold_pct=0.1, seed=21)


@pytest.mark.parametrize("grid_length", [8.0, 3.0])
def test_step_matches_jax_over_20_steps(grid_length):
    """20 seeded steps, across two done-driven resets: ``loc`` and the
    integer arrays equal, every observation and reward within 1e-6."""
    jeng, peng = _engines(num_envs=5, grid_length=grid_length)
    jstep = jax.jit(jeng.step)
    jstate = dict(jeng.state)
    pstate = dict(peng.state)
    rng = np.random.RandomState(7)
    for t in range(20):
        actions = pack_actions(draw_actions(rng, peng), peng)
        jstate = jstep(jstate, {k: jnp.asarray(v.numpy())
                                for k, v in actions.items()})
        pstate = peng.step(pstate, actions)
        for name, value in pstate.items():
            want = np.asarray(jstate[name])
            got = value.numpy()
            assert got.dtype == want.dtype, name
            if name == "loc" or not np.issubdtype(want.dtype, np.floating):
                np.testing.assert_array_equal(got, want, err_msg=f"{name} t={t}")
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=OBS_ATOL,
                                           err_msg=f"{name} t={t}")
        np.testing.assert_allclose(peng.rewards_of(pstate).numpy(),
                                   np.asarray(jeng.rewards_of(jstate)),
                                   rtol=0, atol=OBS_ATOL)
        jstate = jeng.auto_reset(jstate, jax.random.PRNGKey(t))
        pstate = peng.auto_reset(pstate)


def test_placeholders_match_jax():
    jeng, peng = _engines(num_envs=4)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jeng.state.items()
            if k != Constants.RNG}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in peng.state.items()}
    assert got == want
    assert list(got) == list(want)  # the same order, Dict keys as the env's
    assert "observations" not in got
    assert {tag: (g["mode"], g["keys"]) for tag, g in
            peng.placeholder_groups.items()} == \
        {tag: (g["mode"], g["keys"]) for tag, g in
         jeng.placeholder_groups.items()}
    for tag in ("pursuer", "evader"):
        assert peng.obs_entry_names(tag) == jeng.obs_entry_names(tag)
    assert peng.reward_entry_names() == jeng.reward_entry_names() == \
        ["rewards_evader", "rewards_pursuer"]
    jat, pat = jeng.obs_at_reset(), peng.obs_at_reset()
    assert list(pat) == list(jat)
    for name in jat:
        np.testing.assert_array_equal(pat[name], jat[name])


def _train_cfg(load, num_envs=4, T=10, iters=2):
    cfg = load("asymmetric_pursuit")
    cfg["env"].update(ENV_CFG)
    cfg["trainer"].update({
        "num_envs": num_envs, "train_batch_size": T * num_envs,
        "num_episodes": iters * T * num_envs // ENV_CFG["episode_length"],
        "seed": 11})
    for tag in ("pursuer", "evader"):
        cfg["policy"][tag]["model"]["fc_dims"] = [16, 16]
    cfg["saving"].update({"metrics_log_freq": 1,
                          "model_params_save_freq": 10_000})
    return cfg


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_one_update_of_both_policies_matches_jax(tmp_path):
    """JAX's weights, optimizer state and recorded batch (masks included)
    through one update on each side: losses within 1e-5 relative,
    parameters within 1e-5."""
    jtrainer = jax_train.setup_trainer(
        _train_cfg(jax_config.load_run_config), verbose=False,
        results_dir=str(tmp_path / "jax"))
    carry = jtrainer._carry
    _, batch = jax.jit(jtrainer._build_rollout_profile_fn())(
        carry, jax.random.PRNGKey(0))
    batch = _host(batch)
    assert batch["mask_evader"].shape == (10, 4, 3, 5)
    assert (batch["mask_evader"] == 0).any()  # the mask bites

    port = port_train.setup_trainer(
        _train_cfg(port_config.load_run_config), verbose=False,
        results_dir=str(tmp_path / "port"), device="cpu")
    params, opt = carry["params"], carry["opt"]
    for tag in port.policies:
        port.models[tag].load_state_dict(params_from_flax(_host(params[tag])))
        port.optimizers[tag].load_state_dict(
            adam_state_from_optax(_host(opt[tag])))
    assert port.models["evader"].Dense_0.weight.shape[1] == 4
    assert port.models["pursuer"].Dense_0.weight.shape[1] == 5

    update = jax.jit(jtrainer._make_update(with_metrics=True))
    params, opt, jmetrics = update(params, opt, batch, jnp.float32(0),
                                   jax.random.PRNGKey(1))
    metrics = port._update({k: torch.from_numpy(v.copy())
                            for k, v in batch.items()}, 0)
    for tag in ("pursuer", "evader"):
        for name in ("Total loss", "Mean entropy", "Gradient norm"):
            np.testing.assert_allclose(float(metrics[tag][name]),
                                       float(jmetrics[tag][name]), rtol=1e-5)
        want = params_from_flax(_host(params[tag]))
        for name, p in port.models[tag].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{tag} {name}")


def test_evaders_never_draw_a_masked_move(tmp_path):
    """On a 3 x 3 grid most evaders stand at an edge; over every rollout
    step no evader action falls on a 0 of its mask, and the Gumbel-max
    draw of the evaluation generator obeys it too."""
    cfg = _train_cfg(port_config.load_run_config, num_envs=16, T=40)
    cfg["env"]["grid_length"] = 3.0
    trainer = port_train.setup_trainer(cfg, verbose=False, device="cpu",
                                       results_dir=str(tmp_path / "r"))
    batch = trainer._rollout()
    mask = batch["mask_evader"]
    chosen = mask.gather(3, batch["actions_evader"].long())
    assert (mask == 0).sum() > 0
    assert int((chosen == 0).sum()) == 0
    state = dict(trainer.engine.state)
    for _ in range(20):
        acts = trainer._act_fn(state, use_argmax=False,
                               generator=trainer.eval_generator)
        mask_e = state["observations_evader_action_mask"]
        assert int((mask_e.gather(2, acts["evader"].long()) == 0).sum()) == 0
        state = trainer.engine.step(state, acts)


def test_training_and_evaluation_on_the_cpu(tmp_path):
    trainer = port_train.setup_trainer(
        _train_cfg(port_config.load_run_config), verbose=False,
        device="cpu", results_dir=str(tmp_path / "r"))
    before = {t: m.Dense_0.weight.detach().clone()
              for t, m in trainer.models.items()}
    trainer.train()
    assert trainer.iters_completed == 2
    for tag, model in trainer.models.items():
        assert not torch.equal(model.Dense_0.weight, before[tag])
    rew, steps = trainer.evaluate_episodes()
    assert rew["pursuer"].shape == (4, 2) and rew["evader"].shape == (4, 3)
    # the step that sets the done flag is not counted, as in JAX's
    assert np.isfinite(rew["pursuer"]).all() and (steps["evader"] == 7).all()
    traj = trainer.fetch_episode_states(["loc"], include_rewards_actions=True)
    assert traj["loc"].shape == (9, 5, 2) and traj["actions"].shape == (8, 5, 1)


def _small_config_file(tmp_path):
    cfg = _train_cfg(jax_config.load_run_config)
    path = tmp_path / "small_asymmetric_pursuit.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_trains_asymmetric_pursuit(tmp_path):
    trainer = port_train.main([
        "-e", _small_config_file(tmp_path), "--device", "cpu",
        "--results_dir", str(tmp_path / "cli")])
    assert trainer.engine.separate_placeholders
    assert trainer.iters_completed == trainer.num_iters == 2
    assert trainer.config["name"] == "asymmetric_pursuit"  # the shipped one


def test_both_clis_build_the_same_trainer(tmp_path, monkeypatch):
    """One command line through both CLIs up to a built trainer: the same
    batch algebra, policies, placeholders and model input sizes."""
    argv = ["-e", _small_config_file(tmp_path), "--num_envs", "8",
            "--results_dir", str(tmp_path / "out")]
    seen = {}

    def recorder(key, **kw):
        def build(run_config, *args, results_dir=None, **_):
            module = port_train if key == "port" else jax_train
            trainer = module.setup_trainer(run_config, verbose=False,
                                           results_dir=results_dir, **kw)
            sizes = ({t: m.Dense_0.weight.shape[1]
                      for t, m in trainer.models.items()} if key == "port"
                     else {t: p["params"]["Dense_0"]["kernel"].shape[0]
                           for t, p in trainer.params.items()})
            seen[key] = (trainer.num_envs, trainer.num_iters,
                         trainer.training_batch_size_per_env,
                         trainer.policies, sizes,
                         sorted(trainer.engine.placeholder_groups))
        return build

    monkeypatch.setattr(port_train, "setup_trainer_and_train",
                        recorder("port", device="cpu"))
    port_train.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(jax_train, "setup_trainer_and_train",
                        recorder("jax"))
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    jax_train.main()
    assert seen["port"] == seen["jax"]
    assert seen["port"][4] == {"pursuer": 5, "evader": 4}
