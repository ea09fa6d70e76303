"""Build the native OBJ parser (``native/objparse.cpp``) and bind it with
ctypes — the counterpart of ``physically_based_renderer_tpu/utils/native.py``.

The source is read in place and compiled with ``g++ -O2 -std=c++17 -fPIC
-shared`` into ``build/native/`` at the repository root, under a name keyed
by a hash of the source and the flags, so an edited source never loads a
stale build; ``native/`` itself is never written. A build is serialised
across threads and processes by a lock, written to a temporary name and
moved into place. A failed build raises with the compiler's log: nothing
falls back to the Python parser quietly (``parse_obj_python`` is there for
callers that ask for it).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(REPO_DIR, "native")
BUILD_DIR = os.path.join(REPO_DIR, "build", "native")
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


def library_path(source: str) -> str:
    """Path of the library built from ``native/<source>``, keyed by a hash of
    the source and the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(os.path.join(NATIVE_DIR, source), "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_library(source: str) -> str:
    """Compile ``native/<source>`` if its hashed library is missing; returns
    its path. Raises ``RuntimeError`` with g++'s output on failure."""
    out = library_path(source)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # flock locks an open file description: it serialises other threads' and processes' builds alike
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if os.path.isfile(out):  # built while this one waited
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", *GXX_FLAGS, "-o", tmp, os.path.join(NATIVE_DIR, source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"g++ could not run to build {source}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {source} (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


@functools.cache
def load_objparse() -> ctypes.CDLL:
    """The OBJ parser library, built at first use, with the argument and
    result types of its 16 C entry points (those the JAX package binds)."""
    lib = ctypes.CDLL(build_library("objparse.cpp"))
    lib.obj_parse_file.restype = ctypes.c_void_p
    lib.obj_parse_file.argtypes = [ctypes.c_char_p]
    for fn in ("obj_vertex_count", "obj_tri_count", "obj_material_count", "obj_mtllib_count",
               "obj_has_normals", "obj_has_uvs"):
        getattr(lib, fn).restype = ctypes.c_int32
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("obj_copy_positions", "obj_copy_normals", "obj_copy_uvs"):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    for fn in ("obj_copy_tris", "obj_copy_face_material"):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    for fn in ("obj_material_name", "obj_mtllib_name"):
        getattr(lib, fn).restype = ctypes.c_char_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.obj_error.restype = ctypes.c_char_p
    lib.obj_error.argtypes = [ctypes.c_void_p]
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.c_void_p]
    return lib
