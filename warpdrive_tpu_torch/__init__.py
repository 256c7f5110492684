"""WarpDrive-TPU ported to PyTorch and CUDA for one NVIDIA H100.

The package mirrors ``warpdrive_tpu``'s module layout and imports nothing of
it, nor of JAX.  Entry points run on ``device="cuda"`` unless the caller
asks for ``"cpu"``; kernels live in ``csrc/`` and are built at first use
(``ops/cuda_build.py``).
"""
