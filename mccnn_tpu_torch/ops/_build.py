"""Build, load and count the port's CUDA kernels and its host code.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by
``nvcc`` for sm_90a into ``build/lib<name>-<hash>.so`` at the root of
the repository (a git-ignored directory) the first time one of its
kernels launches, and loaded with ctypes. The hash covers the source,
the headers the sources share (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one is reused. No PyTorch header is compiled, so a build takes seconds;
:func:`build` compiles several sources at once, one compiler each. The
host sources, ``csrc/<name>.cpp`` (``HOST_SOURCES``: the training's
window gather), are built the same way by ``g++``. A failed build
raises with the compiler's output; nothing falls back.

``LAUNCHES`` counts the calls of each kernel entry and
``KERNEL_LAUNCHES`` the kernel launches they made. Each wrapper calls
:func:`count` where it launches its kernel and nowhere else. Every
entry but one launches its kernel once a call, so the two agree there;
``join`` launches once per slab of 64 channels (more than one only for
more than 64 channels), which its wrapper counts, so the second counter
stays for it. A CUDA graph's capture launches nothing, so it is counted
by its replays instead (:func:`uncounted`, :func:`add_counts`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("join", "sgm_sweep", "outlier", "blur", "slow_head", "refine",
           "cross", "costs", "sgm_tables", "sgm_layout", "tower", "warp",
           "conv")
KERNELS = ("join", "sgm_vertical", "sgm_horizontal", "outlier", "blur",
           "slow_head", "sgm_hslab", "sgm_scan", "sgm_step",
           "occlusion_fill", "mismatch_fill", "subpixel", "median5", "cbca",
           "cross_arms", "cbca_pack", "census_signatures", "census_volume",
           "ad_volume", "sgm_tables", "sgm_layout", "sgm_generic_tables",
           "sgm_combine", "wta_dhw", "tower_bias_act", "tower_normalize_pack",
           "slow_volumes_epilogue", "warp_patches", "tower_conv")
HOST_SOURCES = ("host_gather",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")

# the most shared memory a block can take on the H100, in bytes
MAX_SMEM = 232448

LAUNCHES: collections.Counter = collections.Counter()
KERNEL_LAUNCHES: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}


def count(entry: str, kernel_launches: int = 1) -> None:
    """Record one call of ``entry`` that made ``kernel_launches`` kernel
    launches."""
    LAUNCHES[entry] += 1
    KERNEL_LAUNCHES[entry] += kernel_launches


@contextlib.contextmanager
def uncounted():
    """Leave the counts as they were across the block (a CUDA graph's
    capture, which launches no kernel). Yields a list that receives the
    (launches, kernel launches) Counters the block's wrappers counted:
    what one replay of the captured graph launches."""
    before = collections.Counter(LAUNCHES), collections.Counter(KERNEL_LAUNCHES)
    counted = []
    try:
        yield counted
    finally:
        counted.append((LAUNCHES - before[0], KERNEL_LAUNCHES - before[1]))
        for now, then in zip((LAUNCHES, KERNEL_LAUNCHES), before):
            now.clear()
            now.update(then)


def add_counts(launches: collections.Counter,
               kernel_launches: collections.Counter) -> None:
    """Record the launches of one replay of a captured graph."""
    LAUNCHES.update(launches)
    KERNEL_LAUNCHES.update(kernel_launches)


def reset_launches() -> None:
    LAUNCHES.clear()
    KERNEL_LAUNCHES.clear()


def launches() -> dict[str, int]:
    return {k: LAUNCHES[k] for k in KERNELS}


def kernel_launches() -> dict[str, int]:
    return {k: KERNEL_LAUNCHES[k] for k in KERNELS}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (set CUDA_HOME)")
    return found


def _gxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: building the host sources needs a "
                           "C++ compiler (set CXX)")
    return found


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _flags(name: str) -> tuple:
    return GXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS


def lib_path(name: str) -> Path:
    src = _source(name).read_bytes()
    if name not in HOST_SOURCES:  # and the headers the sources share
        src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output of the last build of ``name`` (ptxas -v:
    registers, shared memory and spills per kernel)."""
    return BUILD / f"{name}.log"


def build(names=SOURCES + HOST_SOURCES) -> float:
    """Compile the named sources that are not built yet, all at once,
    and wait for every compiler. Returns the seconds taken; raises
    RuntimeError with the compiler's output if a build fails."""
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name in names:
            out = lib_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log = open(log_path(name), "w")
            cc = _gxx() if name in HOST_SOURCES else _nvcc()
            jobs.append((name, tmp, out, log, subprocess.Popen(
                [cc, *_flags(name), "-o", str(tmp), str(_source(name))],
                stdout=log, stderr=subprocess.STDOUT)))
    finally:
        failed = []
        for name, tmp, out, log, proc in jobs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"{_source(name).name} (exit {rc}):\n"
                              + log_path(name).read_text())
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built on
    first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def check_cuda(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    """Refuse a tensor the kernels do not take: they read contiguous
    memory of one dtype on the card."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def check_cuda_f32(t: torch.Tensor, what: str) -> None:
    """:func:`check_cuda` for the float32 operands of most kernels."""
    check_cuda(t, what, torch.float32)


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as an address."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(rc: int, what: str) -> None:
    """Raise on the ``cudaGetLastError()`` a C entry returned."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
