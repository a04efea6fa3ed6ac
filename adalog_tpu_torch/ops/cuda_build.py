"""Build the hand-written CUDA kernels of ``csrc/`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface. ``build`` compiles it with
nvcc for sm_90a into ``csrc/build/lib<name>_<hash>.so``, keyed by the hash
of the source, of every header (``csrc/*.cuh``) and of the preprocessor
definitions it is given, at first use;
``library`` loads it with ctypes. Nothing is built or loaded when a module
is imported, so the CPU tests import every module without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME): the kernels are "
                       "built from csrc/ at first use")


def _lib_path(name: str, defines=()) -> str:
    """Where the library of ``csrc/<name>.cu`` is built: the name carries
    the hash of the source, of all headers of ``csrc/`` and of ``defines``,
    so an edit to a shared header rebuilds every kernel; the compiler's
    report (registers, shared memory, spills) goes to ``<path>.log``."""
    h = hashlib.sha256("\0".join(defines).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(name: str, defines=()) -> str:
    """Compile ``csrc/<name>.cu``, with ``-D`` for each of ``defines``,
    unless its library exists; returns the library's path."""
    lib = _lib_path(name, defines)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           *(f"-D{d}" for d in defines), "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{name}.cu: nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    with open(f"{lib}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(name))
