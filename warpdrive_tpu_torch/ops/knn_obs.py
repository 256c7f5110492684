"""
Batched k-nearest-neighbour observation (TagContinuous kNN mode).

The port's counterpart of ``warpdrive_tpu/ops/knn_obs.py:knn_observation``
for the variants the port runs: ``"flat_exact"`` (the flagship system's
``knn_algorithm="pallas_flat_exact"``) and the single-tile ``"mxu_exact"``
and ``"mxu"`` (``"pallas_mxu_exact"``, the shipped training config, and
``"pallas_mxu"``).  Contract:

    knn_observation(loc_x, loc_y, feats, types_f, still_f, t_norm,
                    n_agents, k) -> (E, N, 8k+1) float32

with ``loc_x``, ``loc_y``, ``still_f`` ``(E, N)``, ``feats`` ``(E, 5, N)``,
``types_f`` ``(N,)`` and ``t_norm`` ``(E,)``, all float32.  For each observer,
the k nearest live others in ascending squared distance (lowest index first
among equal distances) fill slots
``[rel_x, rel_y, rel_speed, rel_acc, rel_dir, type, 1, 1]``; the row ends
with ``t_norm``.  Missing slots and dead observers are zeros.  ``"mxu"``
orders by the TPU kernel's packed key instead, ``(bits(d2) & ~127) | j``:
distances that differ only in their low 7 mantissa bits order by index.

On a CUDA tensor the wrapper launches a hand-written kernel or raises:
``knn_obs_flat_exact`` (``csrc/knn_obs.cu``) for ``"flat_exact"``,
``knn_obs_mxu`` (``csrc/knn_obs_mxu.cu``, N <= 128, k <= 16) for the two
``mxu`` variants; each source's header gives its design and bound.  On a
CPU tensor it runs the plain PyTorch version,
:func:`knn_observation_reference`.  Unlike the TPU kernels, the port
gathers exact float32 features (no bf16 hi/lo pairs) and emits the contract
layout directly.

``LAUNCH_COUNTS`` counts kernel launches, one per call that launched it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from warpdrive_tpu_torch.ops import cuda_build

# the TPU kernel's valid-candidate limit (_VALID_MAX): d2 >= 1e18 is invalid
_VALID_MAX = 1e18
# its packed-key constants (warpdrive_tpu/ops/knn_obs.py:51-54): the low 7
# mantissa bits of a squared distance give way to the candidate index
_BIG = np.float32(1e20)
_CLEAR_MASK = np.int32(~127)
_VALID_MAX_PACKED = int(np.float32(_VALID_MAX).view(np.int32))

LAUNCH_COUNTS = {"knn_obs_flat_exact": 0, "knn_obs_mxu": 0}

# what chip_smoke.py reports for each kernel of this module
KERNELS = {
    "knn_obs_flat_exact": {
        "route": "cuda",
        "source": "warpdrive_tpu_torch/csrc/knn_obs.cu",
        "replaces": "warpdrive_tpu/ops/knn_obs.py:711",
    },
    "knn_obs_mxu": {
        "route": "cuda",
        "source": "warpdrive_tpu_torch/csrc/knn_obs_mxu.cu",
        "replaces": "warpdrive_tpu/ops/knn_obs.py:217",
    },
}

# the variants the port runs, and the kernel each launches on the card
_PORTED = {
    "flat_exact": "knn_obs_flat_exact",
    "mxu": "knn_obs_mxu",
    "mxu_exact": "knn_obs_mxu",
}

# the JAX variants not ported yet, with the ROADMAP queue 2 row of each
_UNPORTED = {
    "flat": "K3",
    "flat_mxudist": "K4", "flat_mxudist_exact": "K4",
    "tiled": "K5", "tiled_exact": "K5",
    "tiled_mxudist": "K5", "tiled_mxudist_exact": "K5",
    "packed": "K6",
    "onehot": "K7",
    "twolevel": "K8", "twolevel_exact": "K8",
    "envlanes": "K9", "envlanes_exact": "K9",
}

_K_LIMIT = 32  # knn_obs_flat_exact's largest K_MAX instantiation
# the single-tile kernel's limits, as the TPU kernel asserts them
# (warpdrive_tpu/ops/knn_obs.py:980, :1042)
_MXU_MAX_AGENTS = 128
_MXU_MAX_K = 16


def reset_launch_counts():
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _check_inputs(loc_x, loc_y, feats, types_f, still_f, t_norm, n_agents, k):
    E, N = loc_x.shape
    if N != n_agents:
        raise ValueError(f"loc_x has {N} agents, n_agents={n_agents}")
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must lie in [1, n_agents={N}]")
    expected = {
        "loc_x": (loc_x, (E, N)),
        "loc_y": (loc_y, (E, N)),
        "feats": (feats, (E, 5, N)),
        "types_f": (types_f, (N,)),
        "still_f": (still_f, (E, N)),
        "t_norm": (t_norm, (E,)),
    }
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, expected float32")
        if t.device != loc_x.device:
            raise ValueError(
                f"{name} lies on {t.device}, loc_x on {loc_x.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def check_variant(variant: str):
    """Raise unless the port runs kNN ``variant``: ``NotImplementedError``
    naming the ROADMAP queue 2 kernel row of a JAX variant not ported yet,
    ``ValueError`` for an unknown name."""
    if variant in _PORTED:
        return
    row = _UNPORTED.get(variant)
    if row is None:
        raise ValueError(f"unknown kNN variant {variant!r}")
    raise NotImplementedError(
        f"kNN variant {variant!r} is not ported yet: ROADMAP queue 2, "
        f"kernel {row}"
    )


def knn_observation(loc_x, loc_y, feats, types_f, still_f, t_norm,
                    n_agents: int, k: int, variant: str = "flat_exact"):
    """Batched fused kNN observation: returns (E, N, 8*k + 1) float32.

    CUDA tensors go through the variant's kernel; CPU tensors through
    :func:`knn_observation_reference`.  The ``mxu`` variants take at most
    128 agents and k <= 16 on every device, as the single-tile TPU kernel
    does.
    """
    check_variant(variant)
    _check_inputs(loc_x, loc_y, feats, types_f, still_f, t_norm, n_agents, k)
    packed = variant == "mxu"
    if _PORTED[variant] == "knn_obs_mxu" and (
        n_agents > _MXU_MAX_AGENTS or k > _MXU_MAX_K
    ):
        raise ValueError(
            f"variant {variant!r} is the single-tile kernel: it takes at "
            f"most {_MXU_MAX_AGENTS} agents and k <= {_MXU_MAX_K}, got "
            f"n_agents={n_agents}, k={k}"
        )
    if loc_x.device.type == "cpu":
        return knn_observation_reference(
            loc_x, loc_y, feats, types_f, still_f, t_norm, n_agents, k,
            packed=packed,
        )
    if loc_x.device.type != "cuda":
        raise ValueError(f"unsupported device {loc_x.device}")
    if variant != "flat_exact":
        return _launch_mxu(loc_x, loc_y, feats, types_f, still_f, t_norm, k,
                           packed)
    if k > _K_LIMIT:
        raise ValueError(f"the kernel takes k <= {_K_LIMIT}, got k={k}")
    return _launch_flat_exact(loc_x, loc_y, feats, types_f, still_f, t_norm, k)


def _launch_flat_exact(loc_x, loc_y, feats, types_f, still_f, t_norm, k):
    lib = cuda_build.load("knn_obs")
    fn = lib.knn_obs_flat_exact
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    E, N = loc_x.shape
    out = torch.empty((E, N, 8 * k + 1), dtype=torch.float32,
                      device=loc_x.device)
    with torch.cuda.device(loc_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            loc_x.data_ptr(), loc_y.data_ptr(), feats.data_ptr(),
            types_f.data_ptr(), still_f.data_ptr(), t_norm.data_ptr(),
            out.data_ptr(), E, N, k, stream,
        )
    if err != 0:
        raise RuntimeError(f"knn_obs_flat_exact launch failed: cudaError {err}")
    LAUNCH_COUNTS["knn_obs_flat_exact"] += 1
    return out


def _launch_mxu(loc_x, loc_y, feats, types_f, still_f, t_norm, k, packed):
    lib = cuda_build.load("knn_obs_mxu")
    fn = lib.knn_obs_mxu
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    E, N = loc_x.shape
    out = torch.empty((E, N, 8 * k + 1), dtype=torch.float32,
                      device=loc_x.device)
    with torch.cuda.device(loc_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            loc_x.data_ptr(), loc_y.data_ptr(), feats.data_ptr(),
            types_f.data_ptr(), still_f.data_ptr(), t_norm.data_ptr(),
            out.data_ptr(), E, N, k, int(packed), stream,
        )
    if err != 0:
        raise RuntimeError(f"knn_obs_mxu launch failed: cudaError {err}")
    LAUNCH_COUNTS["knn_obs_mxu"] += 1
    return out


def knn_observation_reference(loc_x, loc_y, feats, types_f, still_f, t_norm,
                              n_agents: int, k: int, packed: bool = False):
    """Plain PyTorch version of the kernels: the same selection and the
    same float32 operations for every emitted value, so kernel and plain
    agree bit for bit.  The selection is a stable sort of the masked squared
    distances, or with ``packed`` (variant ``"mxu"``) a sort of the TPU
    kernel's packed int32 keys."""
    E, N = loc_x.shape
    dx = loc_x[:, None, :] - loc_x[:, :, None]  # [e, i, j] = x_j - x_i
    dy = loc_y[:, None, :] - loc_y[:, :, None]
    d2 = dx * dx + dy * dy
    alive = still_f >= 0.5  # (E, N)
    not_self = ~torch.eye(N, dtype=torch.bool, device=loc_x.device)
    candidate = alive[:, None, :] & not_self  # (E, i, j)
    if packed:
        # self and dead candidates carry 1e20, as in the TPU kernel, so
        # their packed keys lie above the valid limit
        col_j = torch.arange(N, dtype=torch.int32, device=loc_x.device)
        bits = torch.where(candidate, d2, float(_BIG)).view(torch.int32)
        key = (bits & int(_CLEAR_MASK)) | col_j
        valid = key < _VALID_MAX_PACKED
    else:
        valid = candidate & (d2 < _VALID_MAX)
        key = torch.where(valid, d2, torch.inf)
    order = torch.sort(key, dim=2, stable=True).indices[:, :, :k]  # (E, N, k)
    n_valid = valid.sum(dim=2)  # (E, N)

    slot = torch.arange(k, device=loc_x.device)
    gate = ((n_valid[:, :, None] > slot) & alive[:, :, None])[..., None]
    src6 = torch.cat([feats, types_f.expand(E, 1, N)], dim=1)  # (E, 6, N)
    nbr = src6.gather(2, order.reshape(E, 1, N * k).expand(E, 6, N * k))
    nbr = nbr.reshape(E, 6, N, k).permute(0, 2, 3, 1)  # (E, N, k, 6)
    rel = nbr[..., :5] - feats.transpose(1, 2)[:, :, None, :]
    gate_f = gate.to(torch.float32)
    slots = torch.cat(
        [
            torch.where(gate, rel, 0.0),
            torch.where(gate, nbr[..., 5:6], 0.0),
            gate_f,
            gate_f,
        ],
        dim=3,
    )  # (E, N, k, 8)
    t_col = torch.where(alive, t_norm[:, None], 0.0)[..., None]
    return torch.cat([slots.reshape(E, N, 8 * k), t_col], dim=2)
