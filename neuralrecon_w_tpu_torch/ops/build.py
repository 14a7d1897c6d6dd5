"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and linked
into one shared library with a plain C interface, on first use, into
``build/neuralrecon_w_tpu_torch/`` under the checkout root. The
library's name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale build is never loaded. It is loaded with
ctypes; each entry returns a ``cudaError_t`` (or -1 for arguments the
kernel does not take), which ``check`` turns into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "neuralrecon_w_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "nw_sdf_mlp": [_P, _LL, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "nw_up_sample": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _F, _I, _LL, _P, _P, _P, _P],
    "nw_sdf_vjp_fwd": [_P, _LL, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P,
                       _P, _LL, _P, _P, _P],
    "nw_sdf_vjp_bwd": [_P, _LL, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P,
                       _P, _P, _LL, _P, _P],
    "nw_sdf_vjp_reduce": [_P, _LL, _I, _I, _I, _I, _LL, _I, _P, _P, _P],
    "nw_dw_reduce": [_P, _P, _I, _I, _LL, _I, _P, _I, _P, _P],
    "nw_field_fwd": [_P, _P, _P, _LL, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _LL, _I, _P, _P, _P, _P],
    "nw_field_bwd": [_P, _P, _P, _P, _LL, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _P, _P,
                     _P, _P],
    "nw_bg_fwd": [_P, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _P],
    "nw_bg_bwd": [_P, _P, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                  _LL, _I, _P, _P, _P, _P],
    "nw_coarse_mask": [_P, _I, _P, _P],
    "nw_dda": [_P, _P, _I, _P, _P, _LL, _I, _I, _P, _P, _P, _P, _P],
    "nw_sampled_hit": [_P, _I, _P, _P, _P, _P, _P, _I, _LL, _P, _P, _P, _P],
    "nw_hier_mask": [_P, _I, _P, _P],
    "nw_dda_hier": [_P, _P, _P, _LL, _I, _P, _P, _LL, _I, _I, _F, _P, _P, _P, _P, _P],
    "nw_span_mark": [_P, _I, _I, _P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    """The library's path, named by a hash of the flags, sources and headers."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnw_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple:
    """Compile the kernels unless this exact build exists. Returns
    (library path, seconds spent compiling, compiler log)."""
    path = library_path()
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return path, 0.0, log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    outs, done = [""] * len(procs), [0.0] * len(procs)

    def drain(i):
        outs[i] = procs[i].communicate()[0]
        done[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=drain, args=(i,)) for i in range(len(procs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    # each source's compile wall closes its part of the log
    log = "".join(f"{out}nvcc {os.path.basename(src)}: {secs:.1f} s\n"
                  for src, out, secs in zip(_sources(), outs, done))
    if any(proc.returncode for proc in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    link = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs], capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    seconds = time.perf_counter() - t0
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, path)
    return path, seconds, log


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(name: str, err: int) -> None:
    if err == -1:
        raise ValueError(f"{name}: arguments the kernel does not take")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
