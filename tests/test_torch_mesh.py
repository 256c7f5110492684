"""The port's env-axis cut (``warpdrive_tpu_torch/parallel/mesh.py``): the
cut rule on dim 0, the replay window's dim 1 and the tensors it leaves
whole; ``to_host``'s gathers; two gloo ranks starting bit for bit at their
rows of one engine; and a sharded step equal to the unsharded one (the
counterpart of ``tests/test_mesh_sharding.py``'s first two tests, and
within JAX's rtol of the JAX engine's step)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_dist_workers import (
    cartpole_engine,
    engine_rows_rank,
    failing_rank,
    sharding_errors_rank,
    to_host_rank,
)
from warpdrive_tpu_torch.parallel.launch import launch
from warpdrive_tpu_torch.parallel.mesh import (
    carry_env_dims,
    env_cut_dim,
    gather_carry,
    shard_carry,
    shard_state,
    tp_axis,
)

E = 4


def _stub_mesh(env_rank, dp=2):
    """What the cut reads of a mesh: its env rows."""
    size = E // dp
    return SimpleNamespace(
        env_rows=lambda n: slice(env_rank * size, (env_rank + 1) * size))


def test_cut_rule_dim0_replay_dim1_and_whole():
    weight = torch.randn(E, 7)  # a net's weight of E rows stays whole
    carry = {
        "models": {"runner": {"Dense_0.weight": weight}},
        "optimizers": {"runner": {"mu": {"Dense_0.weight": weight}}},
        "env_state": {"loc_x": torch.arange(E * 3.0).reshape(E, 3),
                      "_done_": torch.arange(E),
                      # per-agent, with as many agents as a rank has envs
                      "agent_x": torch.arange(E // 2 * 1.0)},
        "episodes": {"acc": torch.randn(E, 5), "sum": torch.tensor(2.0)},
        "window": {"obs_shared": torch.randn(6, E, 3, 2),
                   "done": torch.arange(6 * E).reshape(6, E)},
        "ou": {"shared": torch.randn(E, 1, 1)},
        "filled": 6,
    }
    for env_rank in (0, 1):
        rows = slice(2 * env_rank, 2 * env_rank + 2)
        got = shard_carry(carry, _stub_mesh(env_rank), E)
        assert got["models"]["runner"]["Dense_0.weight"] is weight
        assert got["optimizers"] is carry["optimizers"]
        assert torch.equal(got["env_state"]["loc_x"],
                           carry["env_state"]["loc_x"][rows])
        assert torch.equal(got["env_state"]["_done_"],
                           carry["env_state"]["_done_"][rows])
        assert got["env_state"]["agent_x"] is carry["env_state"]["agent_x"]
        assert torch.equal(got["episodes"]["acc"],
                           carry["episodes"]["acc"][rows])
        assert got["episodes"]["sum"] is carry["episodes"]["sum"]
        for key in ("obs_shared", "done"):  # time-major: dim 1
            assert torch.equal(got["window"][key],
                               carry["window"][key][:, rows])
        assert torch.equal(got["ou"]["shared"], carry["ou"]["shared"][rows])
        assert got["filled"] == 6
        state = shard_state({"a": torch.arange(E), "pool": torch.ones(9, E),
                             "scalar": torch.tensor(1.0)},
                            _stub_mesh(env_rank), E)
        assert torch.equal(state["a"], torch.arange(E)[rows])
        assert state["pool"].shape == (9, E) and state["scalar"].ndim == 0
    assert env_cut_dim("x", torch.ones(E, 2), E) == 0
    assert env_cut_dim("x", torch.ones(2, E), E) is None
    assert env_cut_dim("x", torch.ones(2, E), E, time_major=True) == 1
    assert env_cut_dim("x", 3, E) is None
    # the model axis: the largest axis tp divides, the lower of equal ones
    assert tp_axis((16, 32), 2) == 1 and tp_axis((16, 16), 2) == 0
    assert tp_axis((3, 5), 2) is None and tp_axis((1,), 2) is None


def test_gather_carry_is_the_inverse_of_the_cut():
    """Gathered by the dims it was cut by, two ranks' cuts give back the
    whole state; a tensor left whole stays so, also one of E/2 rows."""
    carry = {
        "env_state": {"x": torch.arange(E * 3.0).reshape(E, 3),
                      "agent_x": torch.arange(E // 2 * 1.0)},
        "window": {"d": torch.arange(5.0 * E).reshape(5, E)},
        "ou": {"shared": torch.arange(E * 2.0 * 2).reshape(E, 2, 2)},
        "episodes": {"acc": torch.arange(E * 2.0).reshape(E, 2),
                     "sum": torch.tensor(3.0)},
        "models": {"w": torch.zeros(E // 2, 2)},
    }
    dims = carry_env_dims(carry, E)
    cuts = [shard_carry(carry, _stub_mesh(r), E, dims) for r in (0, 1)]

    class Recording:
        """Records rank 1's cut tensors in the order they are gathered."""

        def __init__(self):
            self.seen = []

        def all_gather(self, x, dim):
            self.seen.append(x)
            return x

    class Gathering:
        """The env group's all_gather: rank 0's cut, then rank 1's."""

        def __init__(self, other):
            self.other = iter(other)
            self.gathered = 0

        def all_gather(self, x, dim):
            self.gathered += 1
            return torch.cat([x, next(self.other)], dim=dim)

    rank1 = Recording()
    gather_carry(cuts[1], rank1, dims)
    gathering = Gathering(rank1.seen)
    got = gather_carry(cuts[0], gathering, dims)
    assert gathering.gathered == 4  # x, d, shared, acc
    for part in ("env_state", "window", "ou", "episodes"):
        for key, want in carry[part].items():
            assert torch.equal(got[part][key], want), (part, key)
    assert got["env_state"]["agent_x"] is carry["env_state"]["agent_x"]
    assert got["models"] is carry["models"]


def test_to_host_gathers_env_rows_over_two_ranks():
    got = launch(to_host_rank, 2, device="cpu", threads=1, timeout_s=120)
    full = np.arange(24, dtype=np.float32).reshape(6, 4)
    window = np.arange(18).reshape(3, 6)
    for rank, r in enumerate(got):
        np.testing.assert_array_equal(r["dim0"], full)
        np.testing.assert_array_equal(r["dim1"], window)
        np.testing.assert_array_equal(r["local"],
                                      full[3 * rank:3 * rank + 3])


def test_two_ranks_start_at_their_rows_and_step_as_one():
    """Each rank's state as built is its rows of the one-process engine,
    bit for bit; the facade's step of every env, gathered, equals the
    one-process step bit for bit (and JAX's within its rtol), and each
    rank's rows after it are its rows of that step."""
    single = cartpole_engine("cpu")
    start = {k: v.clone() for k, v in single.state.items()}
    out = single.step_all_envs(np.ones((16, 1), np.int32))
    got = launch(engine_rows_rank, 2, device="cpu", threads=1, timeout_s=120)
    assert [r["rows"] for r in got] == [(0, 8), (8, 16)]
    for r in got:
        rows = slice(*r["rows"])
        assert r["start"].keys() == start.keys()
        for name, value in start.items():
            assert torch.equal(r["start"][name], value[rows]), name
            assert torch.equal(r["after"][name], single.state[name][rows]), \
                name
        for name, value in out.items():
            assert torch.equal(r["step"][name], value), name

    import jax  # noqa: F401

    from warpdrive_tpu.envs import register_all_envs
    from warpdrive_tpu.envs.engine import EnvEngine
    from warpdrive_tpu.utils.env_registrar import env_registrar

    register_all_envs()
    env_cls = env_registrar.get("ClassicControlCartPoleEnv", backend="tpu")
    jengine = EnvEngine(env_obj=env_cls(episode_length=100, seed=3),
                        num_envs=16, seed=0)
    jout = jengine.step_all_envs(np.ones((16, 1), dtype=np.int32))
    for key in ("observations", "rewards"):
        np.testing.assert_allclose(got[0]["step"][key].numpy(),
                                   np.asarray(jout[key]), rtol=1e-6)


def test_sharding_refuses_uneven_envs_and_unseeded_envs():
    for errors in launch(sharding_errors_rank, 2, device="cpu", threads=1,
                         timeout_s=120):
        assert "must divide evenly over 2" in errors["odd"]
        assert "give the env a seed" in errors["unseeded"]


def test_a_bare_cuda_device_is_the_process_s_card(monkeypatch):
    from warpdrive_tpu_torch.parallel.mesh import local_device

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    assert local_device("cpu", 3) == torch.device("cpu")
    assert local_device("cuda:3", 0) == torch.device("cuda", 3)
    assert local_device("cuda", 5) == torch.device("cuda", 1)
    assert local_device("cuda") == torch.device("cuda", 0)
    monkeypatch.setenv("RANK", "6")
    assert local_device("cuda") == torch.device("cuda", 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert local_device("cuda", 5) == torch.device("cuda", 3)


def test_a_mesh_needs_a_process_group():
    from warpdrive_tpu_torch.parallel.mesh import make_mesh_2d

    with pytest.raises(ValueError, match="initialized process group"):
        make_mesh_2d(1, 1)


def test_a_failed_rank_fails_the_launch_and_stops_the_others():
    """No rank carries on alone: one rank's exception fails the launch with
    its traceback, and the rank left waiting in a collective is killed."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2") as err:
        launch(failing_rank, 2, device="cpu", threads=1, timeout_s=120)
    assert "rank 1 fails on purpose" in str(err.value)
    assert time.monotonic() - t0 < 60


def test_the_rank_that_failed_first_is_reported(tmp_path):
    """When a failure has broken its peers' collectives too, the launch
    reports the rank whose traceback was written first, whatever the
    ranks' order."""
    import os

    from warpdrive_tpu_torch.parallel.launch import _failure

    for rank, text, at in ((0, "Connection reset by peer", 2_000),
                           (1, "rank 1 fails on purpose", 1_000)):
        path = tmp_path / f"rank{rank}.err"
        path.write_text(text, encoding="utf-8")
        os.utime(path, ns=(at, at))
    procs = [SimpleNamespace(exitcode=1), SimpleNamespace(exitcode=1)]
    report = _failure(str(tmp_path), procs, [0, 1])
    assert report.startswith("rank 1 of 2") and "on purpose" in report
