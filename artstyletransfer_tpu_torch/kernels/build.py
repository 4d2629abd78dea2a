"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into
its own shared library with a plain C interface, ``build/lib<name>.so``,
and loaded with ctypes. All sources compile in parallel (one nvcc process
each). A library newer than its source is reused. Nothing is built when a
module is imported: the first kernel launch (or an explicit
``build_all()``) does it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "build")
SOURCES = ("gram", "gram_bwd", "tv", "conv_relu", "lbfgs", "vgg_glue")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): under CUDA_HOME
    (default /usr/local/cuda), else on PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", name),
                 shutil.which(name)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found (set CUDA_HOME or put it on PATH); "
                       "the port's CUDA kernels are built at first use")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _fresh(name: str) -> bool:
    so = lib_path(name)
    src = os.path.join(SRC_DIR, f"{name}.cu")
    return os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src)


def build_all(force: bool = False) -> Dict[str, float]:
    """Compile every stale kernel source, all nvcc processes at once.

    Returns {name: seconds} for the sources it compiled. The ptxas report
    (registers, shared memory, spills) of each is kept in
    build/<name>.log. Raises with the compiler's output on a failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in SOURCES if force or not _fresh(n)]
    if not todo:
        return {}
    nvcc = cuda_tool("nvcc")
    procs = {}
    t0 = time.time()
    for name in todo:
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
               os.path.join(SRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    seconds, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.time() - t0
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as fh:
            fh.write(out)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, lib_path(name))  # atomic: no half-written library
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source `name`, built if needed."""
    with _lock:
        lib: Optional[ctypes.CDLL] = _libs.get(name)
        if lib is None:
            if not _fresh(name):
                build_all()
            lib = ctypes.CDLL(lib_path(name))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
