"""The done-driven reset written into a destination (``core/reset.py``'s
``out``, ``ops/reset.py``), on the CPU.

``auto_reset(state, out=static)`` equals ``assign_state(static,
auto_reset(state))`` bit for bit and returns ``static``'s own tensors, for
TagContinuous (the split path: the flagship's and the ``tag_continuous``
run config's), Pendulum with its reset pool, and
TagGridWorld with and without one; it leaves the generator where the
functional reset leaves it.  The reset kernel's plan (``ops/reset.plan``)
takes those states, with the kinds of the plain reset's order, and refuses
what the kernel does not take.  The kernel itself runs on a card only
(``tests/test_torch_cuda_kernels.py``, which holds it to the plain reset
bit for bit on these states and on :func:`mixed_case`).
"""

import pytest
import torch

from warpdrive_tpu_torch.core.program import assign_state
from warpdrive_tpu_torch.envs.classic_control.pendulum import (
    TorchClassicControlPendulumEnv,
)
from warpdrive_tpu_torch.envs.engine import EnvEngine
from warpdrive_tpu_torch.envs.tag_continuous import TorchTagContinuous
from warpdrive_tpu_torch.envs.tag_gridworld import (
    TorchTagGridWorld,
    TorchTagGridWorldWithResetPool,
)
from warpdrive_tpu_torch.ops import reset as reset_kernel
from warpdrive_tpu_torch.presets import build_flagship, random_actions_fn
from warpdrive_tpu_torch.utils.config import load_run_config
from warpdrive_tpu_torch.utils.constants import Constants

_DONE, _TIMESTEP = Constants.DONE, Constants.TIMESTEP
_ENVS = 7


def _engine(env: str, envs: int = _ENVS, device="cpu") -> EnvEngine:
    """``envs`` replicas of ``env`` on ``device``: the flagship's
    TagContinuous, the ``tag_continuous`` run config's, Pendulum with a
    reset pool (16 rows, or one a replica from 16 replicas on), and
    TagGridWorld without and with a reset pool."""
    if env == "flagship":
        return build_flagship(num_envs=envs, fc_dims=(8, 8), seed=3,
                              device=device)["engine"]
    make = {
        "tag_continuous": lambda: TorchTagContinuous(
            **dict(load_run_config("tag_continuous")["env"], seed=3)),
        "pendulum": lambda: TorchClassicControlPendulumEnv(
            episode_length=20, reset_pool_size=max(envs, 16), seed=3),
        "tag_gridworld": lambda: TorchTagGridWorld(
            num_taggers=2, grid_length=6, episode_length=20, seed=3),
        "tag_gridworld_pool": lambda: TorchTagGridWorldWithResetPool(
            num_taggers=2, grid_length=6, episode_length=20, seed=3),
    }[env]
    return EnvEngine(env_obj=make(), num_envs=envs, seed=3, device=device)


def stepped(env: str, envs: int = _ENVS, device="cpu"):
    """The engine and a state as a rollout step hands it to the reset:
    after a step (the split path's physics, else the whole step) from the
    rollout's carried state, with a done flag on every third env."""
    engine = _engine(env, envs, device)
    actions = random_actions_fn(engine, device)(
        torch.Generator(device=device).manual_seed(5))
    if engine.has_split_step:
        carried = {k: v.clone() for k, v in engine.state.items()
                   if k not in (Constants.OBSERVATIONS, Constants.ACTIONS)}
        state = engine.step_physics(carried, actions)
    else:
        carried = {k: v.clone() for k, v in engine.state.items()}
        state = engine.step(carried, actions)
    state[_DONE] = (torch.arange(envs, device=device) % 3 == 0).to(
        torch.int32)
    state[_TIMESTEP] = torch.arange(1, envs + 1, dtype=torch.int32,
                                    device=device)
    return engine, carried, state


_ENV_NAMES = ["flagship", "tag_continuous", "pendulum", "tag_gridworld",
              "tag_gridworld_pool"]


@pytest.mark.parametrize("mode", ["done", "force", "pool_idx", "none_done"])
@pytest.mark.parametrize("env", _ENV_NAMES)
def test_reset_into_a_destination_equals_the_write_back(env, mode):
    """``engine.auto_reset`` into the static state equals the functional
    reset written back by ``assign_state``, bit for bit; it returns the
    static state's own tensors (so a write-back after it copies nothing)
    and draws as many pool rows from the generator."""
    engine, carried, state = stepped(env)
    if mode == "none_done":
        state[_DONE] = torch.zeros_like(state[_DONE])
    kwargs = {"force": mode == "force"}
    if mode == "pool_idx":
        kwargs["pool_idx"] = {
            target: torch.arange(_ENVS) % pool.shape[0]
            for target, pool in engine.store.pools.items()}
    ours, theirs = (torch.Generator().manual_seed(11) for _ in range(2))
    static = {k: v.clone() for k, v in carried.items()}
    want = {k: v.clone() for k, v in carried.items()}
    got = engine.auto_reset(state, ours, out=static, **kwargs)
    assign_state(want, engine.auto_reset(state, theirs, **kwargs))
    assert got.keys() == static.keys()
    for name, value in got.items():
        assert value is static[name], name
        assert torch.equal(value, want[name]), name
    assert torch.equal(torch.rand(4, generator=ours),
                       torch.rand(4, generator=theirs))
    # the write-back finds every entry in place
    assign_state(static, got)


# ------------------------------------------------------- the kernel's plan
@pytest.mark.parametrize("env", _ENV_NAMES)
def test_reset_kernel_plan_takes_each_envs_state(env):
    """The plan of each env's state after a step, written into its static
    state: every entry the step wrote, the kinds in the plain order
    (timestep and done zeroed, pool targets, snapshot names, the rest
    kept)."""
    engine, carried, state = stepped(env)
    store = engine.store
    static = {k: v.clone() for k, v in carried.items()}
    rows = {t: torch.zeros(_ENVS, dtype=torch.long) for t in store.pools}
    entries = reset_kernel.plan(static, state, store.snapshot, store.pools,
                                rows)
    kinds = {name: kind for name, kind, *_ in entries}
    assert kinds.keys() == static.keys()
    assert kinds[_DONE] == kinds[_TIMESTEP] == reset_kernel.ZERO
    for name, kind in kinds.items():
        if name in (_DONE, _TIMESTEP):
            continue
        assert kind == (reset_kernel.POOL if name in store.pools
                        else reset_kernel.SNAPSHOT if name in store.snapshot
                        else reset_kernel.KEEP), name


def mixed_case(envs=10, misaligned=False, device="cpu"):
    """Entries of int32, float32, bool and bfloat16 with odd row widths, a
    pool of each of two dtypes, and the static buffers cut from one byte
    buffer, each on a 16-byte boundary or, ``misaligned``, one element
    past it (a bool buffer at an odd address)."""
    gen = torch.Generator().manual_seed(7)
    shapes = {"a_int": ((3,), torch.int32), "b_float": ((5, 2), torch.float32),
              "c_bool": ((3,), torch.bool), "d_bf16": ((7,), torch.bfloat16),
              "e_kept": ((1,), torch.float32), "p_float": ((3,), torch.float32),
              "q_bf16": ((5,), torch.bfloat16)}

    def fill(shape, dtype):
        x = torch.randint(-1000, 1000, shape, generator=gen)
        return (x > 0) if dtype == torch.bool else x.to(dtype)

    snapshot = {n: fill(s, d) for n, (s, d) in shapes.items()
                if n[0] in "abcd"}
    pools = {n: fill((6,) + s, d) for n, (s, d) in shapes.items()
             if n[0] in "pq"}
    state = {n: fill((envs,) + s, d) for n, (s, d) in shapes.items()}
    state[_TIMESTEP] = torch.arange(envs, dtype=torch.int32) + 3
    state[_DONE] = (torch.arange(envs) % 4 == 1).to(torch.int32)
    state = {n: v.to(device) for n, v in state.items()}
    snapshot = {n: v.to(device) for n, v in snapshot.items()}
    pools = {n: v.to(device) for n, v in pools.items()}
    arena = torch.zeros(64 * 1024, dtype=torch.uint8, device=device)
    base = -arena.data_ptr() % 16
    out = {}
    for name, value in state.items():
        size = value.element_size()
        at = base + (size if misaligned else 0)
        nbytes = value.numel() * size
        out[name] = arena[at:at + nbytes].view(value.dtype).view(value.shape)
        base += -(-(nbytes + 16) // 16) * 16
    return snapshot, pools, state, out


def test_reset_plan_refuses_what_the_kernel_does_not_take():
    """Keys unlike the static state's, a non-contiguous value, a tensor on
    another device, another dtype, an int64 timestep, a snapshot row of
    another shape, a static buffer that overlaps another entry's value
    and more entries than one launch takes raise before any launch."""
    snapshot, pools, state, out = mixed_case()
    rows = {t: torch.zeros(10, dtype=torch.long) for t in pools}

    def plan(**changes):
        s = dict(state, **changes.pop("state", {}))
        o = dict(out, **changes.pop("out", {}))
        reset_kernel.plan(o, s, changes.get("snapshot", snapshot), pools,
                          rows)

    plan()  # the case itself is taken
    with pytest.raises(ValueError, match="the static state holds"):
        reset_kernel.plan({k: v for k, v in out.items() if k != "a_int"},
                          state, snapshot, pools, rows)
    wide = torch.zeros((10, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="a_int is not contiguous"):
        plan(state={"a_int": wide[:, ::2]})
    with pytest.raises(ValueError, match="lies on meta"):
        plan(state={"b_float": torch.empty((10, 5, 2), device="meta")})
    with pytest.raises(ValueError, match="b_float: torch.float64"):
        plan(state={"b_float": state["b_float"].double()})
    with pytest.raises(ValueError, match="_timestep_"):
        plan(state={_TIMESTEP: state[_TIMESTEP].long()},
             out={_TIMESTEP: out[_TIMESTEP].long()})
    with pytest.raises(ValueError, match="a_int snapshot"):
        plan(snapshot=dict(snapshot, a_int=torch.zeros(4, dtype=torch.int32)))
    # a static buffer on the first 40 bytes of another entry's value
    over = state["a_int"].reshape(-1)[:10].view(torch.float32).view(10, 1)
    with pytest.raises(ValueError, match="e_kept: .* overlaps the src of "
                                         "a_int"):
        plan(out={"e_kept": over})
    with pytest.raises(ValueError, match="_done_: torch.int64"):
        plan(state={_DONE: state[_DONE].long()},
             out={_DONE: out[_DONE].long()})
    many = {f"z{i:02d}": torch.zeros((10, 1)) for i in range(
        reset_kernel.MAX_ENTRIES)}
    with pytest.raises(ValueError, match="entries to write, one launch "
                                         "takes 32"):
        plan(state=many, out={k: v.clone() for k, v in many.items()})
