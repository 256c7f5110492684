"""
Launch the TagContinuous physics kernel (``csrc/tag_physics.cu``).

One launch does what ``TorchTagContinuous.physics_plain`` does op by op:
dynamics, tagging, rewards, the still-in-the-game update, the timestep and
the done flag of every env replica.  It replaces no TPU kernel: the JAX
package leaves this code to XLA's fusion.  The env's
``TorchTagContinuous.physics_fn`` calls :func:`tag_physics` for CUDA tensors
and the plain version for CPU tensors; :func:`check_inputs` raises before
any launch on what the kernel does not take, on any device.

``LAUNCH_COUNTS`` counts launches, one a call, registered as the family
``physics`` (``ops/cuda_build.py``), apart from the kNN kernels'
``ops/knn_obs.py:LAUNCH_COUNTS`` (the benchmark sums every key of that one
as kNN launches); a captured program credits the launches its graph
replays (``core/program.py``).
"""

from __future__ import annotations

import ctypes

import torch

from warpdrive_tpu_torch.ops import cuda_build
from warpdrive_tpu_torch.utils.constants import Constants

LAUNCH_COUNTS = {"tag_physics": 0}
cuda_build.register_launch_counts("physics", LAUNCH_COUNTS)

# what chip_smoke.py reports for the kernel
KERNEL = {
    "route": "cuda",
    "source": "warpdrive_tpu_torch/csrc/tag_physics.cu",
    "replaces": "none: XLA's fusion of "
                "warpdrive_tpu/envs/tag_continuous.py:physics_fn",
}

_TIMESTEP = Constants.TIMESTEP
_FIELDS = ("loc_x", "loc_y", "speed", "direction", "acceleration")
# a block keeps each tagger's position and credit, 12 bytes, in the 48 KB
# of shared memory a launch takes without an opt-in
_MAX_TAGGERS = 48 * 1024 // 12


def reset_launch_counts():
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def check_inputs(state: dict, actions: torch.Tensor, consts: dict,
                 num_agents: int):
    """Raise ``ValueError`` unless the kernel takes these inputs: the five
    float32 fields and the int32 ``still_in_the_game`` ``(E, N)``, the int32
    timestep ``(E,)``, int32 ``actions (E, N, 2)`` and the float32 and int32
    constant tables, all contiguous on one device, with N = ``num_agents``
    and at most ``_MAX_TAGGERS`` taggers."""
    loc_x = state["loc_x"]
    if loc_x.dim() != 2 or loc_x.shape[1] != num_agents:
        raise ValueError(f"loc_x: shape {tuple(loc_x.shape)}, expected "
                         f"(envs, {num_agents})")
    E, N = loc_x.shape
    n_taggers = consts["tagger_ids"].shape[0]
    expected = {name: (state[name], (E, N), torch.float32)
                for name in _FIELDS}
    expected.update({
        "still_in_the_game": (state["still_in_the_game"], (E, N),
                              torch.int32),
        _TIMESTEP: (state[_TIMESTEP], (E,), torch.int32),
        "actions": (actions, (E, N, 2), torch.int32),
        "max_speed": (consts["max_speed"], (N,), torch.float32),
        "step_rewards": (consts["step_rewards"], (N,), torch.float32),
        "acc_table": (consts["acc_table"], (consts["acc_table"].numel(),),
                      torch.float32),
        "turn_table": (consts["turn_table"], (consts["turn_table"].numel(),),
                       torch.float32),
        "tagger_slot": (consts["tagger_slot"], (N,), torch.int32),
    })
    for name, (t, shape, dtype) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if t.device != loc_x.device:
            raise ValueError(f"{name} lies on {t.device}, loc_x on "
                             f"{loc_x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if not 1 <= n_taggers <= _MAX_TAGGERS:
        raise ValueError(f"{n_taggers} taggers: the kernel takes 1 to "
                         f"{_MAX_TAGGERS}")


def tag_physics(state: dict, actions: torch.Tensor, consts: dict,
                params: dict) -> dict:
    """One launch of the kernel on CUDA tensors: ``{name: new tensor}`` for
    the five fields, ``still_in_the_game``, the rewards, the timestep and
    the done flags.  An action outside its table (``[-size, size)``, a
    negative one counting from the end) is a device-side assert, as the
    plain version's indexing is on the card.  ``params`` holds the env's
    scalars: ``grid``,
    ``two_pi``, ``edge_hit_penalty``, ``margin``, ``tag_penalty``,
    ``tag_reward``, ``end_reward``, ``episode_length`` and
    ``runner_exits``.  Call :func:`check_inputs` first."""
    loc_x = state["loc_x"]
    E, N = loc_x.shape
    out = {name: torch.empty_like(state[name]) for name in _FIELDS}
    out["still_in_the_game"] = torch.empty_like(state["still_in_the_game"])
    rewards = torch.empty_like(loc_x)
    timestep = torch.empty_like(state[_TIMESTEP])
    done = torch.empty_like(timestep)
    ptr, num, real = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    with torch.cuda.device(loc_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        call = (
            [(state[name].data_ptr(), ptr) for name in _FIELDS]
            + [(t.data_ptr(), ptr) for t in (
                state["still_in_the_game"], state[_TIMESTEP], actions,
                consts["max_speed"], consts["step_rewards"],
                consts["acc_table"], consts["turn_table"],
                consts["tagger_slot"])]
            + [(consts["acc_table"].numel(), num),
               (consts["turn_table"].numel(), num)]
            + [(out[name].data_ptr(), ptr) for name in _FIELDS]
            + [(t.data_ptr(), ptr) for t in (
                out["still_in_the_game"], rewards, timestep, done)]
            + [(E, num), (N, num), (consts["tagger_ids"].shape[0], num)]
            + [(params[name], real) for name in (
                "grid", "two_pi", "edge_hit_penalty", "margin",
                "tag_penalty", "tag_reward", "end_reward")]
            + [(params["episode_length"], num),
               (int(params["runner_exits"]), num), (stream, ptr)]
        )
        fn = cuda_build.load("tag_physics").tag_physics
        fn.argtypes = [ctype for _, ctype in call]
        fn.restype = ctypes.c_int
        err = fn(*(value for value, _ in call))
    if err != 0:
        raise RuntimeError(f"tag_physics launch failed: cudaError {err}")
    LAUNCH_COUNTS["tag_physics"] += 1
    out[Constants.REWARDS] = rewards
    out[_TIMESTEP] = timestep
    out[Constants.DONE] = done
    return out
