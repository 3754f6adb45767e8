"""Builds and loads the port's compiled code with ctypes.

Two shared libraries, each built from one source file of this package into
fermi_tpu_torch/build/ at first use (the directory is not committed):

  * the RLD\\2 codec (native/rld_codec.cpp), plain g++, no torch headers;
  * the CUDA kernels (csrc/*.cu), nvcc for sm_90a, plain C interface
    (ops/rank_cuda.py loads it).

A library's file name carries a hash of its source and build command, so an
edited source never loads a stale build, and each build lands under a
temporary name that is renamed into place: concurrent processes (test
workers) may build the same library at once and still load a whole file.
`build_all` starts every missing build at once so the compilers overlap.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")


@dataclass(frozen=True)
class Job:
    """One shared library: its source, and the compiler command without
    the output path (`-o <path>` is appended)."""
    name: str
    source: str
    command: tuple

    @property
    def path(self) -> str:
        h = hashlib.sha1()
        with open(self.source, "rb") as f:
            h.update(f.read())
        h.update("\0".join(self.command).encode())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:12]}.so")


def build_all(jobs) -> None:
    """Build every job whose library is missing, all compilers running at
    once; raises with the compiler's output if one fails."""
    todo = [j for j in jobs if not os.path.exists(j.path)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for j in todo:
        tmp = f"{j.path}.{os.getpid()}.{threading.get_ident()}.tmp"
        p = subprocess.Popen([*j.command, "-o", tmp], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        procs.append((j, tmp, p))
    errors = []
    for j, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(j.command)}\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, j.path)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def codec_job() -> Job:
    src = os.path.join(_PKG, "native", "rld_codec.cpp")
    cxx = shutil.which("g++") or "g++"
    return Job("rld_codec", src,
               (cxx, "-O2", "-std=c++17", "-fPIC", "-shared", src,
                "-lpthread"))


_lock = threading.Lock()
_lib = None


def get_lib() -> ctypes.CDLL:
    """The RLD codec, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            job = codec_job()
            build_all([job])
            lib = ctypes.CDLL(job.path)
            lib.frld_encode_file.restype = ctypes.c_int
            lib.frld_encode_file.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_char_p,
            ]
            lib.frld_decode_file.restype = ctypes.c_int
            lib.frld_decode_file.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.frld_free.restype = None
            lib.frld_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib
