"""
Launch the categorical-draw kernel (``csrc/gumbel_sample.cu``).

One launch draws up to ``HEADS_A_LAUNCH`` heads of a policy, and a call
launches once for each such group, every launch writing its columns of one
output: per row and head the Gumbel-max draw ``argmax(logits + -log(-log(max(u, tiny))))`` from the uniforms ``u``,
what ``sampling/samplers.py:draw_heads_plain`` computes op by op.  It
replaces no TPU kernel: the JAX package leaves the draw to XLA's fusion.
``samplers.sample_heads`` draws the uniforms and calls :func:`gumbel_sample`
for CUDA tensors; :func:`check_inputs` raises before any launch on what the
kernel does not take, on any device.

``LAUNCH_COUNTS`` counts launches, one a group of heads, registered as the family
``sampler`` (``ops/cuda_build.py``), apart from the kNN kernels' counts; a
captured program credits the launches its graph replays
(``core/program.py``).
"""

from __future__ import annotations

import ctypes

import torch

from warpdrive_tpu_torch.ops import cuda_build

LAUNCH_COUNTS = {"gumbel_sample": 0}
cuda_build.register_launch_counts("sampler", LAUNCH_COUNTS)

# what chip_smoke.py reports for the kernel
KERNEL = {
    "route": "cuda",
    "source": "warpdrive_tpu_torch/csrc/gumbel_sample.cu",
    "replaces": "none: XLA's fusion of "
                "warpdrive_tpu/sampling/samplers.py:sample_from_logits",
}

# the heads one launch takes (csrc/gumbel_sample.cu: kMaxHeads)
HEADS_A_LAUNCH = 8
_MAX_ROWS = 2**31 - 1


def reset_launch_counts():
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _rows_of(name: str, logits: torch.Tensor) -> torch.Tensor:
    """``logits`` as a ``(rows, width)`` view of the same storage."""
    try:
        return logits.view(-1, logits.shape[-1])
    except RuntimeError:
        raise ValueError(f"{name}: strides {logits.stride()} do not give "
                         f"one row stride") from None


def check_inputs(logits_list, uniforms):
    """Raise ``ValueError`` unless the kernel takes these inputs: one or
    more float32 logit tensors of at least one axis, each with a
    unit column stride, leading axes that flatten to one row stride (a
    slice of a wider head output is taken as it is) and a width of at
    least 1, all with the same leading shape; one contiguous float32
    uniform tensor a head, shaped like its logits; all on one device."""
    if not logits_list:
        raise ValueError("0 heads: the kernel takes 1 or more")
    if len(uniforms) != len(logits_list):
        raise ValueError(f"{len(uniforms)} uniform tensors for "
                         f"{len(logits_list)} heads")
    first = logits_list[0]
    if first.dim() < 1:
        raise ValueError("logits 0: a 0-dim tensor, expected (..., width)")
    lead = tuple(first.shape[:-1])
    for h, (logits, u) in enumerate(zip(logits_list, uniforms)):
        name = f"logits {h}"
        if logits.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {logits.dtype}, expected "
                             f"torch.float32")
        if logits.dim() < 1 or tuple(logits.shape[:-1]) != lead:
            raise ValueError(f"{name}: shape {tuple(logits.shape)}, expected "
                             f"{lead} + (width,)")
        if logits.shape[-1] < 1:
            raise ValueError(f"{name}: width 0")
        if logits.shape[-1] > 1 and logits.stride(-1) != 1:
            raise ValueError(f"{name}: column stride {logits.stride(-1)}, "
                             f"expected 1")
        _rows_of(name, logits)
        if u.dtype != torch.float32:
            raise ValueError(f"uniforms {h}: dtype {u.dtype}, expected "
                             f"torch.float32")
        if u.shape != logits.shape:
            raise ValueError(f"uniforms {h}: shape {tuple(u.shape)}, "
                             f"expected {tuple(logits.shape)}")
        if not u.is_contiguous():
            raise ValueError(f"uniforms {h} is not contiguous")
        for t, what in ((logits, name), (u, f"uniforms {h}")):
            if t.device != first.device:
                raise ValueError(f"{what} lies on {t.device}, logits 0 on "
                                 f"{first.device}")
    rows = first[..., 0].numel()
    if rows > _MAX_ROWS:
        raise ValueError(f"{rows} rows: the kernel takes at most "
                         f"{_MAX_ROWS}")


def gumbel_sample(logits_list, uniforms) -> torch.Tensor:
    """The kernel on CUDA tensors, one launch a group of
    ``HEADS_A_LAUNCH`` heads: int32 ``(..., heads)`` draws, head h's from
    ``logits_list[h]`` and ``uniforms[h]``; the inputs are left as they
    are.  Call :func:`check_inputs` first."""
    first = logits_list[0]
    heads = len(logits_list)
    out = torch.empty(first.shape[:-1] + (heads,), dtype=torch.int32,
                      device=first.device)
    rows = out.numel() // heads
    if rows == 0:
        return out
    views = [_rows_of(f"logits {h}", logits)
             for h, logits in enumerate(logits_list)]
    ptrs = ctypes.c_void_p * heads
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = cuda_build.load("gumbel_sample").gumbel_sample
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(ptrs(*(v.data_ptr() for v in views)),
                 (ctypes.c_longlong * heads)(*(v.stride(0) for v in views)),
                 ptrs(*(u.data_ptr() for u in uniforms)),
                 (ctypes.c_int * heads)(*(v.shape[1] for v in views)),
                 heads, rows, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gumbel_sample launch failed: cudaError {err}")
    LAUNCH_COUNTS["gumbel_sample"] += -(-heads // HEADS_A_LAUNCH)
    return out
