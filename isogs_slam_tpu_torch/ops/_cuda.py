"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface, at first use, into `isogs_slam_tpu_torch/_build/`
(git-ignored); the library name carries a hash of the source, so an edited
kernel is rebuilt. Libraries are loaded with ctypes: pointers and the
stream are passed as c_void_p, and every C entry returns the
cudaGetLastError() of its launch, which `check` turns into an exception.

Each wrapper counts its launches in `LAUNCHES` (kernel name, with the tile
count T and the slot count K for the compositing kernels -> count), so a
run can show that its path went through the kernels. Pointers that a C
entry takes as optional are passed as None (NULL).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
SOURCES = ("composite", "segreduce", "project", "bin", "knn")

LAUNCHES: dict = {}
_LIBS: dict = {}
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
SIGNATURES = {
    "composite": {
        "composite_fwd": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
        "composite_bwd": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                          _P, _P],
    },
    "segreduce": {
        "segreduce": [_P, _I, _P, _I, _I, _P, _P],
    },
    "project": {
        "project_fwd": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _F,
                        _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P],
        "project_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F,
                        _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "bin": {
        "bin_count": [_P, _P, _I, _P, _P, _I, _F, _I, _I, _P, _P],
        "bin_expand": [_P, _P, _I, _P, _P, _P, _P, _I, _F, _I, _I, _I, _L,
                       _L, _P, _P, _P],
    },
    "knn": {
        "knn_hash": [_P, _I, _P, _P, _L, _P, _P, _P, _P, _L, _I, _I, _P,
                     _P, _P],
    },
}


def reset_launches():
    with _LOCK:
        LAUNCHES.clear()


def count_launch(name: str):
    # the dataset prefetch thread launches kernels too
    with _LOCK:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", "/usr/local/cuda") + "/bin/nvcc",
             shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile every missing library among `names`, one nvcc process per
    source, all started together. Returns {name: nvcc/ptxas output} for
    the ones built here (empty string for ones already present)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            logs[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc()] + NVCC_FLAGS + ["-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, args in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: error {err} "
                           f"({torch.cuda.get_device_name()})")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()
