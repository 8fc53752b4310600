"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface, ``build/kernels/lib<name>-<hash>.so`` under the
repository root.  The hash covers the source and the headers it includes, so an edited kernel is
rebuilt.  ``build_all`` starts one ``nvcc`` per source, all at once.
Nothing here runs at import time; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

from repro_torch.obs.trace import phase

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("batched_gemm", "coupling_mv", "batched_qr", "batched_svd",
           "halo_pack")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha1()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library in parallel; returns nvcc's output
    (register and shared-memory use from ``-Xptxas -v``) per kernel.  The
    check and the build run in the span ``kernels/build``."""
    with phase("kernels/build"):
        todo = [(n, _target(n)) for n in names if not _target(n).exists()]
        if not todo:
            return {}
        build_dir().mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, out in todo:
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failed.append(name)
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) +
                               ":\n" + "\n".join(logs[n] for n in failed))
        return logs


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use), with
    ``argtypes``/``restype`` declared from ``{function: (argtypes,
    restype)}``."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        sigs = {"repro_error_string": ([ctypes.c_int], ctypes.c_char_p),
                "repro_max_dynamic_smem": ([], ctypes.c_int), **signatures}
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")


# argument helpers for the C entry points
P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong


SM_SMEM = 233472          # H100: shared memory of one SM (228 KB)
BLOCK_SMEM_RESERVED = 1024  # reserved by the system for each resident block
MAX_WARPS_PER_BLOCK = 4


def warps_per_block(bytes_per_warp: int, limit: int) -> int:
    """Warps (one matrix each) per block for a warp-per-matrix kernel: the
    count up to ``MAX_WARPS_PER_BLOCK`` that keeps the most warps resident
    on an SM by shared memory (the largest such count on a tie), within
    the ``limit`` one block may use."""
    best, best_w = 0, 1
    for w in range(1, MAX_WARPS_PER_BLOCK + 1):
        if w * bytes_per_warp > limit:
            break
        resident = w * (SM_SMEM // (w * bytes_per_warp + BLOCK_SMEM_RESERVED))
        if resident >= best:
            best, best_w = resident, w
    return best_w


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raw_stream(t) -> int:
    """The current CUDA stream of ``t``'s device as an int, by PyTorch's
    cheap raw-stream query where this build has it (the hot wrappers'
    host time is a few microseconds)."""
    import torch
    query = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if query is not None:
        return query(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream
