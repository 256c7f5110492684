"""
Build and load the port's CUDA kernels.

Every kernel source lives in ``warpdrive_tpu_torch/csrc/<name>.cu`` and
exports a plain C interface.  At first use, ``nvcc`` compiles it for Hopper
(``sm_90a``) into ``warpdrive_tpu_torch/_build/lib<name>-<digest>.so``, where
the digest covers the source, every shared header ``csrc/*.cuh`` and the
flags, so an edited source or header is rebuilt; ``ctypes`` loads the
library.  Nothing is compiled when a module is imported.

``LAUNCH_COUNTS`` holds every kernel's launch count, by family: each ops
module that launches a kernel registers its own ``{kernel: launches}`` dict
here on import (:func:`register_launch_counts`).  A captured program
credits them (``core/program.py``) and the tracer reads them as
``<family>_launches`` (``core/trace.py``), without naming the modules.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from warpdrive_tpu_torch.core import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -fmad=false: no a*b + c is contracted into an FMA, so the exact-class
# distances round as the plain PyTorch versions round them.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict = {}

# family -> the registering module's {kernel: launches}, updated in place
LAUNCH_COUNTS: dict = {}


def register_launch_counts(family: str, counts: dict):
    """Make ``counts`` the launch counts of ``family``.  A kernel's name
    belongs to one family: the kNN kernels' stay apart from every other
    kernel's, since the benchmark reads theirs alone."""
    for other, known in LAUNCH_COUNTS.items():
        shared = set(known) & set(counts)
        if other != family and shared:
            raise ValueError(f"kernels {sorted(shared)} of {family!r} are "
                             f"counted by {other!r} already")
    LAUNCH_COUNTS[family] = counts


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built from "
            f"{CSRC_DIR} at first use and need the CUDA toolkit"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile every named kernel source whose library is missing, with one
    ``nvcc`` process per source, all started together.

    :returns: ``{name: (seconds, ptxas report)}`` for the sources built now.
    :raises RuntimeError: if ``nvcc`` fails on any source.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    start = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    report = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = (time.perf_counter() - start, log)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing
    (the tracer's span ``cuda_build.load``, which says which)."""
    lib = _LOADED.get(name)
    if lib is None:
        span = trace.begin("cuda_build.load") if trace.ON else 0
        built = bool(build([name]))
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
        if span:
            trace.end(span, args={"kernel": name, "built": built})
    return lib


def kernel_sources() -> list:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
