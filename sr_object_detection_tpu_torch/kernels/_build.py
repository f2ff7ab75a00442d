"""Build the CUDA kernels under ``csrc/`` and load them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc``, all started at once,
and the objects are linked into ONE shared library with a plain C
interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o     (one per source)
    nvcc -shared -o build/torch_kernels/<hash>/libsrod_kernels.so *.o

The library lands under ``build/torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``), keyed by a hash of the sources and
flags, and is built at first use: a fresh checkout builds it once, and
every later process that finds it only loads it. The build writes into a
temporary directory and renames, so two processes building at once
cannot load a half-written file.

Each C entry point takes device pointers and the CUDA stream as
``c_void_p`` and ints as ``c_int``, launches on that stream, allocates
nothing, and returns ``cudaGetLastError()``; :func:`check` raises when
that is not 0. Nothing here is imported or built when the package is
imported, and nothing falls back: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parent.parent.parent
              / "build" / "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "libsrod_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> (argtypes, restype); launches return cudaError_t as int
SIGNATURES = {
    # boxes (C,k,4) f32, probs (C,k) f32, out (C,k) f32, C, k, thresh, stream
    "srod_nms_per_class": ([_P, _P, _P, _I, _I, _F, _P], _I),
    "srod_nms_max_k": ([], _I),
    # x (1,H,W,Cin) bf16, w (3,3,Cin,Cout) bf16, bias (Cout,) f32,
    # out (1,H/2,W/2,Cout) bf16, H, W, Cin, Cout, stream
    "srod_stem_pair": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    # x (B,H,W,Cin) int8 / uint8 / f32 (x_dtype 0 / 1 / 2), x_dtype,
    # w (3,3,Cin,Cout) int8, dq (Cout,) f32, bias (Cout,) f32, inv_in,
    # inv_out, out (B,H/2,W/2,Cout) int8, B, H, W, Cin, Cout, stream
    "srod_phase_pair": ([_P, _I, _P, _P, _P, _F, _F, _P, _I, _I, _I, _I,
                         _I, _P], _I),
    "srod_error_string": ([_I], ctypes.c_char_p),
}

_lib = None
build_seconds = None      # wall time of the build this process ran, if any


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> pathlib.Path:
    """Compile the library unless it already exists; return its path."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=path.parent) as tmpdir:
        objs, procs = [], []
        for src in _sources():
            obj = str(pathlib.Path(tmpdir) / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = str(pathlib.Path(tmpdir) / LIB_NAME)
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    return path


def load():
    """The loaded ctypes library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load().srod_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


__all__ = ["build", "load", "check", "library_path", "stream_ptr"]
