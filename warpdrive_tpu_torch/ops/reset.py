"""
Launch the done-driven reset kernel (``csrc/reset.cu``).

One launch does what ``core/reset.py``'s plain reset and
``core/program.py:assign_state`` do op by op: it writes every entry of a
step's new state straight into the static buffer that holds it, each env
row from the at-reset snapshot, a reset-pool row, zero (the timestep and
the done flag) or the step's own value, as the env's done flag (or
``force``) says.  It replaces no TPU kernel: the JAX package leaves the
reset to XLA's fusion.  ``core/reset.py``'s ``auto_reset`` calls
:func:`reset_into` for CUDA tensors given a destination; :func:`plan`
raises before any launch on what the kernel does not take, on any device.

``LAUNCH_COUNTS`` counts launches, one a reset, registered as the family
``reset`` (``ops/cuda_build.py``), apart from the kNN kernels' counts; a
captured program credits the launches its graph replays
(``core/program.py``).
"""

from __future__ import annotations

import ctypes

import torch

from warpdrive_tpu_torch.ops import cuda_build
from warpdrive_tpu_torch.utils.constants import Constants

LAUNCH_COUNTS = {"reset_when_done": 0}
cuda_build.register_launch_counts("reset", LAUNCH_COUNTS)

# what chip_smoke.py reports for the kernel
KERNEL = {
    "route": "cuda",
    "source": "warpdrive_tpu_torch/csrc/reset.cu",
    "replaces": "none: XLA's fusion of "
                "warpdrive_tpu/core/reset.py:auto_reset",
}

# the entries one launch takes (csrc/reset.cu: kMaxEntries)
MAX_ENTRIES = 32
# csrc/reset.cu's Kind
KEEP, SNAPSHOT, POOL, ZERO = range(4)


def reset_launch_counts():
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _span(t: torch.Tensor):
    """The bytes ``t`` covers, as ``[start, end)`` addresses."""
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def plan(out: dict, state: dict, snapshot: dict, pools: dict,
         rows: dict) -> list:
    """The kernel's entries for writing the reset of ``state`` into
    ``out``: ``[(name, kind, dst, src, from, rows)]`` for every entry of
    ``out`` whose new value is not already in place (``from`` the snapshot
    row or the pool, ``rows`` the pool rows of each env; else None).  The
    kinds follow the plain reset's order: the timestep and the done flag
    are zeroed, a pool target takes a pool row, a snapshot name its
    snapshot row, every other entry the step's value.

    :param rows: pool target -> int64 ``(envs,)`` pool rows.
    :raises ValueError: unless ``out`` and ``state`` have the same entries;
        every tensor (the snapshot rows, pools and pool rows among them)
        lies contiguous on the done flags' device; the done flags and the
        timestep are int32 ``(envs,)``; each entry's value has its buffer's
        dtype and shape, ``(envs, ...)``, a snapshot row or a pool row its
        row's; and no buffer overlaps another entry's tensors, or anything
        it is written from but its own value at the same address; or
        more than ``MAX_ENTRIES`` entries are left to write.
    """
    if out.keys() != state.keys():
        raise ValueError(f"the step returned {sorted(state)}, the static "
                         f"state holds {sorted(out)}")
    done = state[Constants.DONE]

    def check(what, t, shape, dtype):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{what}: a {type(t).__name__}, expected a "
                             "tensor")
        if t.device != done.device:
            raise ValueError(f"{what} lies on {t.device}, "
                             f"{Constants.DONE} on {done.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} is not contiguous")
        if shape is not None and (tuple(t.shape) != tuple(shape)
                                  or t.dtype != dtype):
            raise ValueError(f"{what}: {t.dtype} {tuple(t.shape)}, expected "
                             f"{dtype} {tuple(shape)}")

    check(Constants.DONE, done, None, None)
    envs = done.shape[0] if done.dim() == 1 else -1
    check(Constants.DONE, done, (envs,), torch.int32)
    entries = []
    for name, dst in out.items():
        src = state[name]
        check(f"{name} (static)", dst, None, None)
        check(name, src, dst.shape, dst.dtype)
        if dst.dim() < 1 or dst.shape[0] != envs:
            raise ValueError(f"{name}: shape {tuple(dst.shape)}, expected "
                             f"({envs}, ...)")
        source = rows_of = None
        if name in (Constants.TIMESTEP, Constants.DONE):
            kind = ZERO
            check(name, dst, (envs,), torch.int32)
        elif name in pools:
            kind, source = POOL, pools[name]
            check(f"{name} pool", source,
                  (max(source.shape[0], 1),) + dst.shape[1:], dst.dtype)
            rows_of = rows[name]
            check(f"{name} pool rows", rows_of, (envs,), torch.int64)
        elif name in snapshot:
            kind, source = SNAPSHOT, snapshot[name]
            check(f"{name} snapshot", source, dst.shape[1:], dst.dtype)
        else:
            kind = KEEP
            if dst.data_ptr() == src.data_ptr():
                continue  # in place already
        if dst.numel():
            entries.append((name, kind, dst, src, source, rows_of))
    if len(entries) > MAX_ENTRIES:
        raise ValueError(f"{len(entries)} entries to write, one launch "
                         f"takes {MAX_ENTRIES}")
    # every tensor of each entry as its span of bytes: a buffer may meet
    # only its own value, at the same address
    spans = [(name, role, t.data_ptr(), *_span(t))
             for name, _, *tensors in entries
             for role, t in zip(("dst", "src", "from", "rows"), tensors)
             if t is not None and t.numel()]
    for name, role, at, start, end in spans:
        if role != "dst":
            continue
        for other, role2, at2, start2, end2 in spans:
            if (start < end2 and start2 < end
                    and (other, role2) != (name, "dst")
                    and not (other == name and role2 == "src"
                             and at2 == at)):
                raise ValueError(f"{name}: its static buffer overlaps "
                                 f"the {role2} of {other}")
    return entries


def reset_into(out: dict, state: dict, snapshot: dict, pools: dict,
               rows: dict, force: bool = False):
    """The kernel on CUDA tensors: the reset of ``state`` written into the
    static ``out`` (:func:`plan`, which raises first), in one launch.  A
    done flag that a buffer overlaps is read from a copy made first."""
    entries = plan(out, state, snapshot, pools, rows)
    if not entries:
        return
    done = state[Constants.DONE]
    d0, d1 = _span(done)
    if not force and any(s0 < d1 and d0 < s1 for s0, s1 in (
            _span(dst) for _, _, dst, *_ in entries)):
        done = done.clone()
    n = len(entries)
    ptrs = ctypes.c_void_p * n

    def address(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(done.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = cuda_build.load("reset").reset_when_done
        fn.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(
            ptrs(*(dst.data_ptr() for _, _, dst, *_ in entries)),
            ptrs(*(src.data_ptr() for _, _, _, src, *_ in entries)),
            ptrs(*(address(e[4]) for e in entries)),
            ptrs(*(address(e[5]) for e in entries)),
            (ctypes.c_longlong * n)(*(
                dst[0].numel() * dst.element_size()
                for _, _, dst, *_ in entries)),
            (ctypes.c_longlong * n)(*(
                e[4].shape[0] if e[1] == POOL else 0 for e in entries)),
            (ctypes.c_int * n)(*(kind for _, kind, *_ in entries)),
            n, done.shape[0], done.data_ptr(), int(force), stream)
    if err != 0:
        raise RuntimeError(f"reset_when_done launch failed: cudaError {err}")
    LAUNCH_COUNTS["reset_when_done"] += 1
