"""DDPG's ``trainer.batch_dtype`` and ``remat`` in the port
(``warpdrive_tpu_torch/training/trainer_ddpg.py``) against the JAX
package's, on ``tests/test_torch_ddpg.py``'s small Pendulum (8 envs x 10
steps, n_step 3: a 12-row window, fc (16, 16)), on the CPU; the cases of
``tests/test_training_pendulum_ddpg.py``'s
``test_ddpg_remat_update_is_numerically_exact`` and
``test_ddpg_batch_dtype_halves_replay_obs``:

- one replay update, not full and then full, from the same nets, targets
  and optax states over the same rows, with a bf16 window and with remat:
  nets, targets and Adam moments within 1e-5 (``UPDATE_TOL``, as
  ``tests/test_torch_ddpg.py``'s float32 case: the bf16 window is the same
  rounding of the same rows on both sides, and each side then promotes it
  to float32);
- remat against none in the port over four iterations: bit for bit;
- a bf16 window holds bf16 observations and float32 actions and rewards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ddpg import (
    UPDATE_TOL,
    _assert_nets_match,
    _config,
    _host,
    _load_nets,
    _t,
)
from warpdrive_tpu.training.scripts.train import setup_trainer as jax_setup
from warpdrive_tpu.utils import config as jax_config
from warpdrive_tpu_torch.training.scripts import train as port_train
from warpdrive_tpu_torch.utils import config as port_config


def _with(cfg, option):
    if option == "remat":
        cfg["policy"]["shared"]["remat"] = True
    else:
        cfg["trainer"]["batch_dtype"] = "bfloat16"
    return cfg


@pytest.mark.parametrize("option", ["batch_bf16", "remat"])
def test_replay_update_matches_jax(option, tmp_path):
    jtrainer = jax_setup(_with(_config(jax_config.load_run_config), option),
                         verbose=False, results_dir=str(tmp_path / "jax"))
    carry = jtrainer._carry
    T = jtrainer.training_batch_size_per_env
    noise = {"shared": 0.2 * jax.random.normal(
        jax.random.PRNGKey(5), (T,) + carry["ou"]["shared"].shape)}
    rollout = jax.jit(jtrainer._make_rollout())
    _, rows = rollout(
        carry["actor"],
        (carry["env_state"], carry["ou"], carry["ep_acc"], carry["ep_sum"],
         carry["ep_count"]),
        jax.random.split(jax.random.PRNGKey(6), T), noise, 0.15, 0.2, 1.0)
    rows = _host(rows)

    port = port_train.setup_trainer(
        _with(_config(port_config.load_run_config), option), verbose=False,
        results_dir=str(tmp_path / "port"), device="cpu")
    bf16 = option == "batch_bf16"
    assert port._window["obs_shared"].dtype == (
        torch.bfloat16 if bf16 else torch.float32)
    assert port.remat["shared"] == (not bf16)
    _load_nets(port, carry)
    replay_update = jax.jit(jtrainer._make_replay_update(with_metrics=True))
    keys = ("actor", "critic", "target_actor", "target_critic", "opt_actor",
            "opt_critic", "buf", "done_buf", "filled")
    nets = {k: carry[k] for k in keys}
    assert nets["buf"]["shared"]["obs"].dtype == (
        jnp.bfloat16 if bf16 else jnp.float32)
    # in the dtypes the port's rows store (JAX rounds its float32 rows
    # into the window's dtype as it appends them)
    port_rows = {k: _t(v).to(port._rows[k].dtype) for k, v in rows.items()}
    for step, timestep in enumerate((0.0, 80.0)):
        nets, jmetrics = replay_update(nets, rows, jnp.float32(timestep))
        metrics = port._replay_update(port_rows, timestep)["shared"]
        assert float(metrics["Buffer full"]) == float(step)
        _assert_nets_match(port, nets, UPDATE_TOL)
        for name in ("Critic loss", "Actor loss"):
            np.testing.assert_allclose(float(metrics[name]),
                                       float(jmetrics["shared"][name]),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    window = port._window["obs_shared"]
    want = np.asarray(jnp.asarray(nets["buf"]["shared"]["obs"], jnp.float32))
    np.testing.assert_array_equal(window.to(torch.float32).numpy(), want)


def test_remat_and_bf16_window_in_training(tmp_path):
    """Four iterations through ``train()``: remat equal to none bit for
    bit; a bf16 window stores bf16 observations beside float32 actions and
    rewards, and trains to finite nets."""
    nets = {}
    for name in ("none", "remat", "batch_bf16"):
        cfg = _config(port_config.load_run_config)
        if name != "none":
            cfg = _with(cfg, name)
        trainer = port_train.setup_trainer(
            cfg, verbose=False, results_dir=str(tmp_path / name),
            device="cpu")
        trainer.train()
        assert trainer.iters_completed == 4
        nets[name] = {net: {k: v.clone() for k, v in
                            trainer.nets[net]["shared"].state_dict().items()}
                      for net in ("actor", "critic")}
        if name == "batch_bf16":
            window = trainer._window
            assert window["obs_shared"].dtype == torch.bfloat16
            assert window["actions_shared"].dtype == torch.float32
            assert window["rewards_shared"].dtype == torch.float32
    for net, state in nets["none"].items():
        for key, value in state.items():
            torch.testing.assert_close(nets["remat"][net][key], value,
                                       rtol=0, atol=0, msg=f"{net} {key}")
            assert torch.isfinite(nets["batch_bf16"][net][key]).all()
