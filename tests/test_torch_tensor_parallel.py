"""The port's (env x model) mesh against the JAX package's 2-D mesh
(``warpdrive_tpu.parallel.mesh.make_mesh_2d``, ``shard_params_tp``): the
same update from the same parameters, Adam states and recorded batch on a
dp1 x tp2 mesh (two gloo ranks holding every env, each weight cut between
them) and a dp2 x tp2 mesh (four ranks), within 1e-5 of JAX's, with Adam's
moments cut on each weight's largest axis that tp divides and the
parameters whole and equal on every rank after the step.  The JAX
parameters start from the tp-sharded placement and reach the port
gathered (``np.asarray``), through ``params_from_flax``."""

import numpy as np
import pytest
import torch

from test_torch_distributed_update import (  # noqa: F401  (the fixture)
    A2C_METRICS,
    METRIC_ATOL,
    METRIC_RTOL,
    _assert_params,
    _config,
    _host,
    _port_state,
    jax_batch,
    jax_sharded_a2c_update,
)
from torch_dist_workers import a2c_update_rank
from warpdrive_tpu_torch.models.fully_connected import adam_state_from_optax
from warpdrive_tpu_torch.parallel.launch import launch
from warpdrive_tpu_torch.parallel.mesh import tp_axis
from warpdrive_tpu_torch.utils import config as port_config

CASES = {
    # (dp, tp, the policies' options)
    "dp1_x_tp2_a2c": (1, 2, {}),
    "dp2_x_tp2_ppo_shuffled": (2, 2, dict(algorithm="PPO", num_epochs=2,
                                          num_minibatches=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_parallel_update_matches_jax_2d_mesh(case, jax_batch,
                                                     tmp_path):
    from warpdrive_tpu.parallel.mesh import MODEL_AXIS, make_mesh_2d

    dp, tp, policy = CASES[case]
    mesh = make_mesh_2d(dp=dp, tp=tp)
    jtrainer, carry, params, opt, jmetrics, tables = \
        jax_sharded_a2c_update(policy, jax_batch, tmp_path, mesh=mesh)
    # JAX really cut parameters over its model axis
    assert any(MODEL_AXIS in str(leaf.sharding)
               for leaf in jax_leaves(params))

    results = launch(
        a2c_update_rank, dp * tp,
        args=(_config(port_config.load_run_config, policy), dp * tp, tp,
              str(tmp_path / "port"), _port_state(carry, jtrainer.policies),
              jax_batch, tables or None),
        device="cpu", threads=1, timeout_s=300)
    for rank, got in enumerate(results):
        _assert_params(got["params"], params, f"{case} rank {rank}")
        cut = 0
        for tag, moments in got["shard_shapes"].items():
            adam = adam_state_from_optax(_host(opt[tag]))
            assert got["adam"][tag]["count"] == adam["count"]
            for name, whole in adam["mu"].items():
                ax = tp_axis(whole.shape, tp)
                want = list(whole.shape)
                if ax is not None:
                    want[ax] //= tp
                    cut += 1
                assert moments[name] == tuple(want), (tag, name)
                np.testing.assert_allclose(
                    got["adam"][tag]["mu"][name].numpy(), whole.numpy(),
                    rtol=0, atol=1e-6, err_msg=f"mu {tag} {name}")
            for name in A2C_METRICS:
                np.testing.assert_allclose(
                    got["metrics"][tag][name], float(jmetrics[tag][name]),
                    rtol=METRIC_RTOL, atol=METRIC_ATOL,
                    err_msg=f"{case} {tag} {name}")
        assert cut > 0, "no parameter was cut over the model axis"
    for got in results[1:]:  # whole and equal on every rank
        for tag, p in got["params"].items():
            for name, value in p.items():
                assert torch.equal(value, results[0]["params"][tag][name])


def jax_leaves(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


def test_jax_tp_sharded_params_carry_into_port_shards(tmp_path):
    """JAX's parameters placed tensor-parallel on its 2-D mesh
    (``shard_params_tp``), gathered to the host and mapped by
    ``params_from_flax``, cut by the port's ``shard_params_tp``: each model
    rank's shards put back together on their axis are the whole tensors,
    and at least one weight is cut."""
    from types import SimpleNamespace

    from warpdrive_tpu.parallel.mesh import make_mesh_2d
    from warpdrive_tpu.parallel.mesh import shard_params_tp as jax_shard
    from warpdrive_tpu.training.scripts.train import setup_trainer
    from warpdrive_tpu.utils import config as jax_config
    from warpdrive_tpu_torch.models.fully_connected import params_from_flax
    from warpdrive_tpu_torch.parallel.mesh import shard_params_tp

    jtrainer = setup_trainer(_config(jax_config.load_run_config),
                             verbose=False, results_dir=str(tmp_path))
    sharded = jax_shard(jtrainer._carry["params"]["runner"],
                        make_mesh_2d(dp=1, tp=2))
    whole = params_from_flax(_host(sharded))
    shards = [shard_params_tp(whole, SimpleNamespace(tp=2, model_rank=m))
              for m in range(2)]
    cut = 0
    for name, value in whole.items():
        ax = tp_axis(value.shape, 2)
        if ax is None:
            assert shards[0][name] is value
            continue
        cut += 1
        assert shards[0][name].shape[ax] == value.shape[ax] // 2
        assert torch.equal(torch.cat([s[name] for s in shards], dim=ax),
                           value)
    assert cut > 0
