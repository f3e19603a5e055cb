"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source under ``repro_torch/kernels`` is compiled with
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, loaded with ``ctypes``; the sources include the shared
``*.cuh`` headers beside them.  The build runs at the first call that
needs a kernel -- never at import, so the CPU-only tests import every
module -- into ``build/repro_torch_kernels/<hash of the sources and
headers>/`` at the root of the checkout, and is reused while they are
unchanged.  One
``nvcc`` per source runs in parallel, then a link step; a failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_ROOT = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> argtypes (every one returns a cudaError_t)
SIGNATURES = {
    # q, k, v, o, B, Sq, Skv, H, KV, hd, dtype, causal, q_offset, stream
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P),
    # q, k, v, o, lse, B, Sq, Skv, H, KV, hd, dtype, causal, q_offset,
    # stream
    "repro_flash_attention_fwd_lse": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _P),
    # q, k, v, o, lse, do, dsum, dq, dk, dv, B, S, H, KV, hd, dtype, stream
    "repro_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, kv_len, o, B, S, H, KV, hd, dtype, stream
    "repro_decode_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P),
    # q, k, v, k_scale, v_scale, kv_len, o, B, S, H, KV, hd, dtype, stream
    "repro_decode_attention_int8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _P),
    # xc, dt, b, c, a_log, d, y, h_final, B, S, di, ds, xc/dt/b/c dtype,
    # stream
    "repro_mamba_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P),
    # the same, with h_chunks after h_final
    "repro_mamba_scan_fwd_states": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _P),
    # xc, dt, b, c, a_log, d, dy, h_chunks, dh_final, dxc, ddt, db, dc,
    # da_log, dd, scratch, B, S, di, ds, xc/dt/b/c dtype, stream
    "repro_mamba_scan_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P),
    # f64 block, i64 block, host offsets table, L, S, Q, E, W, threads,
    # stream
    "repro_sim_rounds": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, offsets, w_up, w_gate, w_down, h, y, P, d, f, E, the weights'
    # strides (int64[6]), gated, activation, dtype, stream
    "repro_grouped_ffn": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                          _I, _I, _I, _P),
    # x, offsets, w_up, w_gate, w_down, dy, u, g, h, dx, dw_up, dw_gate,
    # dw_down, P, d, f, E, strides, gated, activation, dtype, stream
    "repro_grouped_ffn_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, _I, _I, _I, _I, _P, _I, _I, _I, _P),
}


def sources() -> List[Path]:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def headers() -> List[Path]:
    return sorted(KERNELS_DIR.rglob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit's nvcc")
    return found


def _digest() -> str:
    """The hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources() + headers():
        h.update(str(p.relative_to(KERNELS_DIR)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Build the shared library if this checkout's sources have not been
    built yet, and return its path."""
    srcs = sources()
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # a private directory per build: concurrent builders never share
    # objects, and the finished library is renamed into place
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs, procs = [], []
        for src in srcs:
            obj = work / (src.stem + ".o")
            log = open(work / (src.stem + ".log"), "w+")
            procs.append((src, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=log, stderr=subprocess.STDOUT)))
            objs.append(obj)
        failed = []
        for src, log, proc in procs:
            rc = proc.wait()
            log.seek(0)
            text = log.read()
            log.close()
            if rc != 0:
                failed.append(f"{src.name} (exit {rc}):\n{text}")
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        tmp_lib = work / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("CUDA kernel link failed:\n" + link.stdout
                               + link.stderr)
        logs = "".join((work / (s.stem + ".log")).read_text() for s in srcs)
        (out_dir / "build.log").write_text(logs)
        os.replace(tmp_lib, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def build_log() -> str:
    """The compiler's output (registers, shared memory, spills) of the
    library :func:`library` loads, or '' if it was not built yet."""
    log = BUILD_ROOT / _digest() / "build.log"
    return log.read_text() if log.exists() else ""


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
