"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into a shared library, which the wrappers load with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go
to ``build/kernels/`` at the repository root, named by a digest of the
source and the flags, so an edited source can never load a stale build.
A library is built at its kernel's first use; :func:`build` compiles
several sources in parallel, one ``nvcc`` each (``chip_smoke.py`` builds
all of them up front that way).

Nothing here runs at import: this module, like the wrappers, imports on
a host with no CUDA toolkit, where the wrappers take the plain versions
for CPU tensors and never reach :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

#: Kernel sources, one library each.
KERNEL_SOURCES = ("dequant", "cross_entropy", "sgd")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
_BOUND: dict[str, object] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, dict]:
    """Compile each named source that has no current library, all at once
    (one ``nvcc`` process per source).  Returns per-source ``{"seconds",
    "ptxas"}`` (``ptxas`` is the compiler's register/spill report; both
    are None for a library that was already built).  Raises
    :class:`KernelBuildError` naming every source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs, report = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": None, "ptxas": None}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": seconds, "ptxas": log}
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` with its ``argtypes``
    set (every pointer and the stream as ``c_void_p``, so ctypes never
    truncates them) and an int ``cudaError_t`` return."""
    fn = _BOUND.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _BOUND[symbol] = fn
    return fn


def on_cuda(kernel: str, *tensors) -> bool:
    """True when the wrapper must launch its kernel (every tensor on the
    same CUDA card), False when it takes the plain version (every tensor
    on the CPU).  Anything else — mixed devices, another device type, a
    card other than the current one (the launch targets the current
    device) — raises: a wrapper never moves data or falls back."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: tensors on different devices "
                         f"{sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"{kernel}: tensors on {dev} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    return True


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s card: every
    kernel launches there, ordered with the surrounding PyTorch work."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize`` would not report it)."""
    if code != 0:
        err = getattr(load(name), f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({err(code).decode()})")
