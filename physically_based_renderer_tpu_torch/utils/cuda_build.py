"""Build a CUDA source of this package into a shared library and load it.

Each kernel lives in ``csrc/<name>.cu`` behind a plain C entry point that
returns its ``cudaError_t``. At first use the source is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the repository
root, under a name keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, and loaded
with ``ctypes``. A build failure raises with nvcc's output; nothing falls
back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas=-v",  # each kernel's registers, shared memory and spills in the build log
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def library_path(name: str) -> str:
    """Path of the library built from ``csrc/<name>.cu``, keyed by a hash of
    that source, every header in ``csrc/`` (a source may include any of
    them) and the flags, so an edited header never loads a stale build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_libraries(names) -> dict[str, str]:
    """Compile every library of ``names`` whose hashed file is missing: one
    nvcc process per source, all started together, then waited for. Returns
    nvcc's output (ptxas's resource report) of each library it built."""
    jobs = []
    for name in dict.fromkeys(names):
        out = library_path(name)
        if os.path.isfile(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, cmd, proc))
    logs = {}
    for name, out, tmp, cmd, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name}.cu (exit {proc.returncode}):\n{' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, out)
        logs[name] = log
    return logs


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, then load it."""
    build_libraries([name])
    return ctypes.CDLL(library_path(name))
