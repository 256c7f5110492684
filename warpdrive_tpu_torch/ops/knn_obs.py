"""
Batched k-nearest-neighbour observation (TagContinuous kNN mode).

The port's counterpart of ``warpdrive_tpu/ops/knn_obs.py:knn_observation``,
for every variant of it.  Contract:

    knn_observation(loc_x, loc_y, feats, types_f, still_f, t_norm,
                    n_agents, k, variant) -> (E, N, 8k+1) float32

with ``loc_x``, ``loc_y``, ``still_f`` ``(E, N)``, ``feats`` ``(E, 5, N)``,
``types_f`` ``(N,)`` and ``t_norm`` ``(E,)``, all float32.  For each observer,
the k nearest live others fill slots
``[rel_x, rel_y, rel_speed, rel_acc, rel_dir, type, 1, 1]``; the row ends
with ``t_norm``.  Missing slots and dead observers are zeros.

Each variant is a distance and an order:

* distance: the difference form ``dx*dx + dy*dy`` on raw coordinates, or
  for the ``mxudist`` variants the TPU's MXU expansion, the 12-term bf16
  hi/lo product ``amat . bmat`` (:func:`expansion_operands`) on per-env
  centred coordinates (:func:`centred_coords`), clamped at 0;
* order: ``_exact`` variants (and ``flat_exact`` and ``onehot``) ascending
  d2, lowest index first among equal distances; the others the TPU
  kernels' packed key ``(bits(d2) & ~(2^b - 1)) | j`` (:func:`packed_keys`),
  so distances that differ only in their low b mantissa bits order by
  index.  ``b`` is 7 for ``mxu``, ``packed`` and ``twolevel`` (the v2, v3
  and v6 kernels' ``_CLEAR_MASK``) and ``bit_length(SUBn - 1)``, ``SUBn =
  ceil(N/8)*8``, for ``flat``, ``tiled`` and ``envlanes`` (v7, v8, v9): 4
  at N = 15, 7 at N = 105, 10 at N = 1024 (:func:`packed_bits`).

| variant | kernel (``LAUNCH_COUNTS`` key) | source | limits |
|---|---|---|---|
| ``flat_exact`` | ``knn_obs_flat_exact`` (K1) | ``csrc/knn_obs.cu`` | k <= 32 |
| ``flat`` | ``knn_obs_flat`` (K3) | ``csrc/knn_obs.cu`` | k <= 32 |
| ``flat_mxudist[_exact]`` | ``knn_obs_flat_mxudist`` (K4) | ``csrc/knn_obs.cu`` | k <= 32, swap class |
| ``tiled[_exact]``, ``tiled_mxudist[_exact]`` | ``knn_obs_tiled`` (K5) | ``csrc/knn_obs_tiled.cu`` | k <= 16 |
| ``mxu[_exact]`` | ``knn_obs_mxu`` (K2) | ``csrc/knn_obs_mxu.cu`` | N <= 128, k <= 16 |
| ``packed`` | ``knn_obs_packed`` (K6) | ``csrc/knn_obs_ladder.cu`` | N <= 128 |
| ``onehot`` | ``knn_obs_onehot`` (K7) | ``csrc/knn_obs_ladder.cu`` | N <= 128 |
| ``twolevel[_exact]`` | ``knn_obs_twolevel`` (K8) | ``csrc/knn_obs_ladder.cu`` | N <= 128, k <= 16 |
| ``envlanes[_exact]`` | ``knn_obs_envlanes`` (K9) | ``csrc/knn_obs_envlanes.cu`` | k <= 32 |

The limits of the single-tile kernels (``mxu``, ``packed``, ``onehot``,
``twolevel``) and of ``tiled`` are the TPU kernels' own and hold on every
device.  K1-K5 and K9 run one warp scan (``csrc/knn_common.cuh``): a
warp takes an observer's candidates 32 at a time, one a lane, and holds
its k-list one entry a lane, so they take k <= 32; K1, K3, K4 and K5 also
refuse an N whose staged operands exceed the card's 227 KB of shared
memory, while K9 stages candidates in chunks of 1024 and takes any N.  On
a CUDA tensor the wrapper launches the variant's hand-written kernel or
raises; each source's header gives its design and bound.  On a CPU tensor
it runs the plain PyTorch version, :func:`knn_observation_plain`.  Unlike
the TPU kernels, the port gathers exact float32 features (no bf16 hi/lo
pairs) and emits the contract layout directly.

Every kernel equals its plain version bit for bit on the card, except K4:
from 1024 agents on it forms the MXU distance on the tensor cores, which
sum the 12 terms in their own order, so it is held to the swap class
instead, as the JAX MXU kernel is held to its oracle
(:func:`check_swap_class`).

``LAUNCH_COUNTS`` counts kernel launches, one per call that launched it;
a captured program (``core/program.py``) credits the launches its graph
replays (:func:`credit_launches`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from warpdrive_tpu_torch.ops import cuda_build

# the TPU kernel's valid-candidate limit (_VALID_MAX): d2 >= 1e18 is invalid
_VALID_MAX = 1e18
_BIG = np.float32(1e20)
_VALID_MAX_PACKED = int(np.float32(_VALID_MAX).view(np.int32))
# the packed index bits of the v2, v3 and v6 kernels, whose _CLEAR_MASK
# clears 7 bits whatever N (warpdrive_tpu/ops/knn_obs.py:51-54)
_SEVEN_BIT_PACKED = ("mxu", "packed", "twolevel")
_CLEAR_MASK_BITS = 7

LAUNCH_COUNTS = {
    "knn_obs_flat_exact": 0,
    "knn_obs_mxu": 0,
    "knn_obs_flat": 0,
    "knn_obs_flat_mxudist": 0,
    "knn_obs_tiled": 0,
    "knn_obs_packed": 0,
    "knn_obs_onehot": 0,
    "knn_obs_twolevel": 0,
    "knn_obs_envlanes": 0,
}

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
    "knn_obs_flat": {
        "route": "cuda",
        "source": "warpdrive_tpu_torch/csrc/knn_obs.cu",
        "replaces": "warpdrive_tpu/ops/knn_obs.py:731",
    },
    "knn_obs_flat_mxudist": {
        "route": "cuda",
        "source": "warpdrive_tpu_torch/csrc/knn_obs.cu",
        "replaces": "warpdrive_tpu/ops/knn_obs.py:720",
    },
    "knn_obs_tiled": {
        "route": "cuda",
        "source": "warpdrive_tpu_torch/csrc/knn_obs_tiled.cu",
        "replaces": "warpdrive_tpu/ops/knn_obs.py:536",
    },
    "knn_obs_packed": {
        "route": "cuda",
        "source": "warpdrive_tpu_torch/csrc/knn_obs_ladder.cu",
        "replaces": "warpdrive_tpu/ops/knn_obs.py:137",
    },
    "knn_obs_onehot": {
        "route": "cuda",
        "source": "warpdrive_tpu_torch/csrc/knn_obs_ladder.cu",
        "replaces": "warpdrive_tpu/ops/knn_obs.py:57",
    },
    "knn_obs_twolevel": {
        "route": "cuda",
        "source": "warpdrive_tpu_torch/csrc/knn_obs_ladder.cu",
        "replaces": "warpdrive_tpu/ops/knn_obs.py:359",
    },
    "knn_obs_envlanes": {
        "route": "cuda",
        "source": "warpdrive_tpu_torch/csrc/knn_obs_envlanes.cu",
        "replaces": "warpdrive_tpu/ops/knn_obs.py:1440",
    },
}

# the variants the port runs, and the kernel each launches on the card
_PORTED = {
    "flat_exact": "knn_obs_flat_exact",
    "flat": "knn_obs_flat",
    "flat_mxudist": "knn_obs_flat_mxudist",
    "flat_mxudist_exact": "knn_obs_flat_mxudist",
    "tiled": "knn_obs_tiled",
    "tiled_exact": "knn_obs_tiled",
    "tiled_mxudist": "knn_obs_tiled",
    "tiled_mxudist_exact": "knn_obs_tiled",
    "mxu": "knn_obs_mxu",
    "mxu_exact": "knn_obs_mxu",
    "packed": "knn_obs_packed",
    "onehot": "knn_obs_onehot",
    "twolevel": "knn_obs_twolevel",
    "twolevel_exact": "knn_obs_twolevel",
    "envlanes": "knn_obs_envlanes",
    "envlanes_exact": "knn_obs_envlanes",
}

_K_LIMIT = 32  # the warp scan's k-list: one entry a lane of a warp
# the TPU kernels' limits (warpdrive_tpu/ops/knn_obs.py:980, :1025, :1042,
# :1314): the single-tile kernels take one 128-agent tile, and those with a
# 16-row slot bookkeeping (v3, v6, v7) k <= 16
_SINGLE_TILE = ("knn_obs_mxu", "knn_obs_packed", "knn_obs_onehot",
                "knn_obs_twolevel")
_SMALL_K = ("knn_obs_mxu", "knn_obs_twolevel", "knn_obs_tiled")
_TILE_AGENTS = 128
_SMALL_K_LIMIT = 16
# the card's dynamic shared memory per block, and what the scan kernels
# stage per agent: x, y, alive and six channels, plus 12 expansion terms
# for the MXU distance (csrc/knn_common.cuh)
_MAX_SHARED_BYTES = 232448
_EXPANSION_TERMS = 12
# K4's tensor-core tile (csrc/knn_common.cuh:tile_kernel, the constants
# of its geometry copied here), which K4 takes from _TILE_MIN_AGENTS on
# (csrc/knn_obs.cu:kTileMinAgents): an alive flag, a live observer's index
# and a bf16 row of 16 terms a candidate, the rows padded to a round of
# 32, and for a group of 16 observers their distance rows of a chunk of at
# most 512 candidates (4 floats longer) and their 16 x 16 bf16 A operand
_TILE_DEPTH = 16
_TILE_ROWS = 16
_TILE_CHUNK = 512
_TILE_MIN_AGENTS = 1024
# the swap class (tests/test_knn_obs_kernel.py): entries off by more than
# SWAP_ATOL (beside a relative 1e-5) are swaps; their share stays below
# SWAP_SHARE
SWAP_ATOL = 8e-6
SWAP_SHARE = 2e-3


def reset_launch_counts():
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def launches_since(before: dict) -> dict:
    """``{kernel: launches}`` counted since the snapshot ``before`` (a copy
    of ``LAUNCH_COUNTS``), kernels with none left out."""
    return {name: LAUNCH_COUNTS[name] - before[name]
            for name in LAUNCH_COUNTS if LAUNCH_COUNTS[name] != before[name]}


def credit_launches(launches: dict, times: int = 1):
    """Add ``times`` x ``launches`` (``{kernel: launches}``) to
    ``LAUNCH_COUNTS``.  A replayed CUDA graph launches the kernels it
    captured without running their wrappers, so whoever replays it credits
    the launches that the wrappers counted during the capture
    (``core/program.py``)."""
    for name, n in launches.items():
        LAUNCH_COUNTS[name] += times * n


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
    """Raise ``ValueError`` unless ``variant`` is a kNN variant of the JAX
    package's ``knn_observation``: the port runs every one of them."""
    if variant not in _PORTED:
        raise ValueError(f"unknown kNN variant {variant!r}")


def _check_limits(variant: str, n_agents: int, k: int):
    """The TPU kernels' own limits, on every device."""
    kernel = _PORTED[variant]
    if kernel in _SINGLE_TILE and n_agents > _TILE_AGENTS:
        raise ValueError(
            f"variant {variant!r} is a single-tile kernel: it takes at most "
            f"{_TILE_AGENTS} agents, got n_agents={n_agents}"
        )
    if kernel in _SMALL_K and k > _SMALL_K_LIMIT:
        raise ValueError(
            f"variant {variant!r} keeps 16 slot rows: it takes "
            f"k <= {_SMALL_K_LIMIT}, got k={k}"
        )


def staged_bytes(variant: str, n_agents: int) -> int:
    """Shared memory one block of the variant's scan kernel stages: 36 B
    per agent (x, y, alive, six channels, rounded to 16 B), plus for K5's
    MXU modes, and K4's (the ``flat_mxudist`` variants) below 1024 agents,
    48 B per agent of float32 candidate terms.  From 1024 agents on K4's
    tensor-core tile stages per agent, padded to a multiple of 32, an
    alive flag, a live observer's index and 16 bf16 terms (40 B), and for
    its group of 16 observers their distance rows of a chunk of candidates
    and their A operand (33,536 B at a chunk of 512)."""
    if variant.startswith("flat_mxudist") and n_agents >= _TILE_MIN_AGENTS:
        rows = -(-n_agents // 32) * 32
        chunk = min(rows, _TILE_CHUNK)
        floats = (2 * rows + rows * _TILE_DEPTH // 2
                  + _TILE_ROWS * (chunk + 4) + _TILE_ROWS * _TILE_DEPTH // 2)
        return 4 * floats
    floats = ((9 * n_agents) + 3) & ~3
    if "mxudist" in variant:
        floats += _EXPANSION_TERMS * n_agents
    return 4 * floats


def check_kernel_limits(variant: str, n_agents: int, k: int):
    """Raise ``ValueError`` for a shape the variant's CUDA kernel does not
    take: k above its list size, or staged operands above the card's
    shared memory."""
    _check_limits(variant, n_agents, k)
    kernel = _PORTED[variant]
    if kernel in _SINGLE_TILE:
        return
    if k > _K_LIMIT:
        raise ValueError(f"the kernel takes k <= {_K_LIMIT}, got k={k}")
    if kernel == "knn_obs_envlanes":
        # it stages 1024 candidates a pass and reads the winners' features
        # from global memory, so shared memory sets no agent limit
        return
    need = staged_bytes(variant, n_agents)
    if need > _MAX_SHARED_BYTES:
        raise ValueError(
            f"variant {variant!r} at n_agents={n_agents} stages {need} bytes "
            f"per block, above the card's {_MAX_SHARED_BYTES} bytes of shared "
            "memory"
        )


def packed_bits(variant: str, n_agents: int) -> int:
    """Index bits of the variant's packed key, 0 for an exact order."""
    if variant.endswith("_exact") or variant == "onehot":
        return 0
    if variant in _SEVEN_BIT_PACKED:
        return _CLEAR_MASK_BITS
    sub_n = ((n_agents + 7) // 8) * 8  # the TPU kernels' candidate sublanes
    return max((sub_n - 1).bit_length(), 1)


def packed_keys(d2: torch.Tensor, bits: int) -> torch.Tensor:
    """The packed int32 keys ``(bits(d2) & ~(2^bits - 1)) | j`` of
    non-negative float32 distances ``d2`` ``(..., N)``, candidate j on the
    last axis: unique, and in float order up to the low ``bits`` bits."""
    col = torch.arange(d2.shape[-1], dtype=torch.int32, device=d2.device)
    return (d2.contiguous().view(torch.int32) & ~((1 << bits) - 1)) | col


def centred_coords(loc_x: torch.Tensor, loc_y: torch.Tensor) -> torch.Tensor:
    """``(E, 2, N)`` float32: ``loc_x`` and ``loc_y`` centred on each env's
    mean over its N agents, as the TPU centres them for the MXU distance
    (the centring bounds the expansion's cancellation error).  The K5
    kernel forms the observer-side terms from these in its body."""
    return torch.stack([loc_x - loc_x.mean(dim=1, keepdim=True),
                        loc_y - loc_y.mean(dim=1, keepdim=True)], dim=1)


def expansion_operands(xc: torch.Tensor, yc: torch.Tensor,
                       with_bmat: bool = True):
    """The MXU distance operands of centred coordinates ``xc``, ``yc``
    ``(E, N)``, as ``warpdrive_tpu/ops/knn_obs.py:1181-1205`` builds them:
    ``amat (E, N, 12)`` = ``[xh, xh, xl, xl, yh, yh, yl, yl, nh, nl, 1, 1]``
    and ``bmat (E, 12, N)`` = ``[-2xh, -2xl, -2xh, -2xl, -2yh, -2yl, -2yh,
    -2yl, 1, 1, nh, nl]`` (None unless ``with_bmat``), bfloat16, where ``(h,
    l)`` is the bf16 hi/lo pair of a value and ``n = xc*xc + yc*yc``
    (separate multiplies and an add: no fused multiply-add)."""
    def pair(v):
        hi = v.to(torch.bfloat16)
        return hi, (v - hi.to(torch.float32)).to(torch.bfloat16)

    xh, xl = pair(xc)
    yh, yl = pair(yc)
    xx = xc * xc
    yy = yc * yc
    nh, nl = pair(xx + yy)
    ones = torch.ones_like(nh)
    amat = torch.stack([xh, xh, xl, xl, yh, yh, yl, yl, nh, nl, ones, ones],
                       dim=2).contiguous()
    if not with_bmat:
        return amat, None
    two = -2.0
    bmat = torch.stack(
        [xh * two, xl * two, xh * two, xl * two,
         yh * two, yl * two, yh * two, yl * two,
         ones, ones, nh, nl],
        dim=1,
    )
    return amat, bmat.contiguous()


def knn_observation(loc_x, loc_y, feats, types_f, still_f, t_norm,
                    n_agents: int, k: int, variant: str = "flat_exact"):
    """Batched fused kNN observation: returns (E, N, 8*k + 1) float32.

    CUDA tensors go through the variant's kernel; CPU tensors through
    :func:`knn_observation_plain`.  The ``mxu``, ``packed``, ``onehot`` and
    ``twolevel`` variants take at most 128 agents, and ``mxu``,
    ``twolevel`` and ``tiled`` k <= 16, on every device, as the TPU kernels
    do.
    """
    check_variant(variant)
    _check_inputs(loc_x, loc_y, feats, types_f, still_f, t_norm, n_agents, k)
    _check_limits(variant, n_agents, k)
    if loc_x.device.type == "cpu":
        return knn_observation_plain(loc_x, loc_y, feats, types_f, still_f,
                                     t_norm, n_agents, k, variant)
    if loc_x.device.type != "cuda":
        raise ValueError(f"unsupported device {loc_x.device}")
    check_kernel_limits(variant, n_agents, k)
    name = _PORTED[variant]
    mxu_dist = "mxudist" in variant
    amat = aux = None
    if mxu_dist:
        centred = centred_coords(loc_x, loc_y)
        tiled = name == "knn_obs_tiled"  # v7 forms bmat in its body
        amat, bmat = expansion_operands(centred[:, 0], centred[:, 1],
                                        with_bmat=not tiled)
        aux = centred if tiled else bmat
    E, N = loc_x.shape
    out = torch.empty((E, N, 8 * k + 1), dtype=torch.float32,
                      device=loc_x.device)
    ptr, num = ctypes.c_void_p, ctypes.c_int
    with torch.cuda.device(loc_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        # the common signature of every entry point (knn_common.cuh)
        call = (
            [(t.data_ptr(), ptr)
             for t in (loc_x, loc_y, feats, types_f, still_f, t_norm)]
            + [(None if t is None else t.data_ptr(), ptr)
               for t in (amat, aux)]
            + [(out.data_ptr(), ptr), (E, num), (N, num), (k, num),
               (packed_bits(variant, n_agents), num), (int(mxu_dist), num),
               (stream, ptr)]
        )
        lib = cuda_build.load(Path(KERNELS[name]["source"]).stem)
        fn = getattr(lib, name)
        fn.argtypes = [ctype for _, ctype in call]
        fn.restype = ctypes.c_int
        err = fn(*(value for value, _ in call))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCH_COUNTS[name] += 1
    return out


def expansion_sq_dist(amat: torch.Tensor, bmat: torch.Tensor) -> torch.Tensor:
    """``d2[e, i, j] = max(sum_t amat[e, j, t] * bmat[e, t, i], 0) + 0.0``
    in float32, summed in the order t = 0..11 (each bf16 x bf16 product is
    exact in float32); the ``+ 0.0`` is the v9 kernel's mask add for a valid
    candidate, which also turns a -0 into +0."""
    a = amat.to(torch.float32)
    b = bmat.to(torch.float32)
    d2 = a[:, None, :, 0] * b[:, 0, :, None]
    for t in range(1, _EXPANSION_TERMS):
        d2 = d2 + a[:, None, :, t] * b[:, t, :, None]
    return torch.clamp(d2, min=0.0) + 0.0


def knn_observation_plain(loc_x, loc_y, feats, types_f, still_f, t_norm,
                          n_agents: int, k: int, variant: str = "flat_exact"):
    """The plain PyTorch version of ``variant`` on any device: the same
    selection and the same float32 operations for every emitted value as
    its kernel, so the two agree bit for bit on one device.  The distance
    is the difference form, or for the ``mxudist`` variants the MXU
    expansion (:func:`expansion_sq_dist`) of the same operands.  The
    selection is a stable sort of the masked squared distances, or for a
    packed variant a sort of the TPU kernels' packed int32 keys with
    :func:`packed_bits` index bits.  A valid candidate is a live other
    agent with d2 below 1e18 (v1, ``onehot``, tests d2 below 1e20: the two
    agree on any grid narrower than 1e9)."""
    check_variant(variant)
    E, N = loc_x.shape
    if "mxudist" in variant:
        centred = centred_coords(loc_x, loc_y)
        d2 = expansion_sq_dist(*expansion_operands(centred[:, 0],
                                                   centred[:, 1]))
    else:
        dx = loc_x[:, None, :] - loc_x[:, :, None]  # [e, i, j] = x_j - x_i
        dy = loc_y[:, None, :] - loc_y[:, :, None]
        d2 = dx * dx + dy * dy
    alive = still_f >= 0.5  # (E, N)
    not_self = ~torch.eye(N, dtype=torch.bool, device=loc_x.device)
    candidate = alive[:, None, :] & not_self  # (E, i, j)
    bits = packed_bits(variant, n_agents)
    if bits:
        # self and dead candidates carry 1e20, as in the TPU kernels, so
        # their packed keys lie above the valid limit
        key = packed_keys(torch.where(candidate, d2, float(_BIG)), bits)
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


def summation_window(terms: torch.Tensor) -> torch.Tensor:
    """``e = 16 * 2^-23 * sum_t |term_t|`` over the last axis: how far a
    float32 sum of the 12 terms (16 with the padding zeros) in any order,
    with rounded or truncated adds, can lie from the exact sum -- at most
    15 adds, each off by less than one ulp of a partial sum, which is at
    most ``2^-23 * sum_t |term_t|``."""
    return 16.0 * 2.0 ** -23 * terms.abs().sum(dim=-1)


def check_swap_class(out, ref, args, k: int, variant: str,
                     bound_share: bool = True, chunk: int = 1024) -> dict:
    """Hold a K4 output ``out`` to the plain version's ``ref`` on the same
    inputs ``args`` (``loc_x, loc_y, feats, types_f, still_f, t_norm``) by
    the swap class of the tensor-core MXU distance
    (``csrc/knn_common.cuh:tile_kernel`` derives it):

    1. the slot-valid pattern (entry 7 of each slot), the last entry and
       the zero rows of dead observers are equal bit for bit;
    2. a slot that picks the same candidate as the plain version is equal
       bit for bit to it;
    3. a slot that picks another candidate, j_k where the plain version
       picks j_p, holds a near-tie: ``|d2(i, j_k) - d2(i, j_p)| <= W`` in
       the plain version's distance, with ``W = 4 e`` (e from
       :func:`summation_window`, the larger over the two candidates), and
       in a packed order also one packed bucket, ``2^b`` ulps of the larger
       d2; and j_k is in no other slot of the row (no candidate is picked
       twice);
    4. with ``bound_share``, the share of entries off by more than
       ``SWAP_ATOL`` (beside a relative 1e-5) is below ``SWAP_SHARE``.

    A slot's candidate is the live other agent whose row entries
    ``feat_j - feat_i`` and ``type_j`` it equals bit for bit (the first
    such agent); a slot that equals none has a changed feature and fails
    condition 2.  A slot picks j_k twice when more slots of its row hold
    its entries than there are candidates with them.  Raises
    ``ValueError`` naming the condition that fails; returns ``{"slots",
    "swaps", "share", "worst_ratio", "max_abs"}``: the valid slots, those
    that pick another candidate, the share of condition 4, the largest
    ``|d2(j_k) - d2(j_p)| / W`` and the largest abs difference of any
    entry."""
    loc_x, loc_y, feats, types_f, still_f, _ = args
    E, N = loc_x.shape
    o_slots = out[..., :-1].reshape(E, N, k, 8)
    r_slots = ref[..., :-1].reshape(E, N, k, 8)
    bits_o = o_slots.contiguous().view(torch.int32)
    bits_r = r_slots.contiguous().view(torch.int32)
    alive = still_f >= 0.5
    if not (torch.equal(bits_o[..., 7], bits_r[..., 7])
            and torch.equal(out[..., -1].contiguous().view(torch.int32),
                            ref[..., -1].contiguous().view(torch.int32))
            and bool((out[~alive].contiguous().view(torch.int32) == 0)
                     .all())):
        raise ValueError("condition 1: the valid slots, the last entry or "
                         "a dead observer's zero row differ")
    differ = (bits_o != bits_r).any(dim=-1)  # (E, N, k)
    e_idx, i_idx, s_idx = differ.nonzero(as_tuple=True)
    share = float((~torch.isclose(out, ref, rtol=1e-5, atol=SWAP_ATOL))
                  .float().mean())
    report = {"slots": int((o_slots[..., 7] != 0).sum()),
              "swaps": int(e_idx.numel()), "share": share,
              "worst_ratio": 0.0,
              "max_abs": float((out - ref).abs().max())}
    if e_idx.numel():
        centred = centred_coords(loc_x, loc_y)
        amat, bmat = expansion_operands(centred[:, 0], centred[:, 1])
        src6 = torch.cat([feats, types_f.expand(E, 1, N)], dim=1)
        bits = packed_bits(variant, N)
        cols = torch.arange(N, device=loc_x.device)
        for lo in range(0, e_idx.numel(), chunk):
            e, i, s = (t[lo:lo + chunk] for t in (e_idx, i_idx, s_idx))
            # every candidate's slot entries for observer i: (D, 6, N)
            own = torch.cat([feats[e, :, i],
                             torch.zeros_like(feats[e, :1, i])], dim=1)
            rows = src6[e] - own[:, :, None]
            ok = alive[e] & (cols[None] != i[:, None])  # (D, N)

            def matches(slots):  # (D, N): the candidates a slot could be
                return (rows == slots[e, i, s, :6, None]).all(dim=1) & ok

            match_k, match_p = matches(o_slots), matches(r_slots)
            j_k = match_k.float().argmax(dim=1)
            j_p = match_p.float().argmax(dim=1)
            if not bool(match_k.any(dim=1).all()):
                raise ValueError("condition 2: a slot's entries match no "
                                 "candidate (a changed feature)")
            if bool((j_k == j_p).any()) or not bool(match_p.any(dim=1).all()):
                raise ValueError("condition 2: a slot that picks the plain "
                                 "version's candidate differs from it")
            # the valid slots of the row that hold this slot's entries,
            # against the candidates that have them
            held = ((bits_o[e, i, :, :6] == bits_o[e, i, s, None, :6])
                    .all(dim=-1) & (o_slots[e, i, :, 7] != 0)).sum(dim=1)
            if bool((held > match_k.sum(dim=1)).any()):
                raise ValueError("condition 3: a candidate is picked twice "
                                 "in one row")
            b_cols = bmat[e, :, i]  # (D, 12)
            both = torch.stack([j_k, j_p], dim=1)  # (D, 2)
            a_rows = amat[e[:, None], both]  # (D, 2, 12)
            terms = a_rows.to(torch.float32) * b_cols.to(
                torch.float32)[:, None]
            d2 = terms[..., 0]  # the plain version's order, t = 0..11
            for t in range(1, _EXPANSION_TERMS):
                d2 = d2 + terms[..., t]
            d2 = torch.clamp(d2, min=0.0) + 0.0
            window = 4.0 * summation_window(terms).max(dim=1).values
            if bits:
                top = d2.max(dim=1).values
                ulp = torch.nextafter(top, torch.full_like(top, np.inf)) - top
                window = window + (1 << bits) * ulp
            gap = (d2[:, 0] - d2[:, 1]).abs()
            if bool((gap > window).any()):
                raise ValueError("condition 3: a swap outside the window W")
            ratio = gap / torch.where(window > 0, window, 1.0)
            report["worst_ratio"] = max(report["worst_ratio"],
                                        float(ratio.max()))
    if bound_share and not share < SWAP_SHARE:
        raise ValueError(f"condition 4: swap share {share} is not below "
                         f"{SWAP_SHARE}")
    return report
