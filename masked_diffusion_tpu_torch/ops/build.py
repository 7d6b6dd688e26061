"""Build and load the package's CUDA kernels.

At first use, every csrc/*.cu compiles with nvcc, one process per source,
all started together, and the objects link into one shared library with a
plain C interface, which ctypes loads. The library lands in build/kernels/
at the root of the checkout, named by a hash of the sources, the headers
(csrc/*.cuh) and the flags, so an edited source rebuilds and an unchanged
one loads from the cache. No PyTorch header is included, so a build takes
seconds.

A failed build raises: nothing falls back to a plain version.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
KERNEL_DIR = os.path.join(BUILD_DIR, "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the build that produced the loaded library


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for src in _sources() + headers:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(KERNEL_DIR, f"libmdt_kernels_{h.hexdigest()[:16]}.so")


def declare_exact_k(lib: ctypes.CDLL) -> None:
    """argtypes of the exact-k kernels' entry points (csrc/fused_degrade.cu,
    csrc/kmask.cu) and of mdt_error_string."""
    vp, i32, u64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_float
    plan = [i32, i32, i32, i32]  # exact-k plan: cs, threads, per_thread, vec
    fn = lib.mdt_fused_degrade
    fn.argtypes = [
        vp, vp, vp, vp, vp,      # xt, x0, amount_t, amount_next, bits (nullable)
        u64, u64,                # philox seed, offset
        vp, vp,                  # out, mask_next
        i32, i32, i32,           # batch, channels, hw
        i32, i32, f32, i32,      # select, mean_mode, mean_value, rule
        *plan,
        vp,                      # cudaStream_t
    ]
    fn.restype = i32
    fn = lib.mdt_kmask
    fn.argtypes = [
        vp, vp,                  # counts (int32), bits (nullable)
        u64, u64,                # philox seed, offset
        vp,                      # out
        i32, i32,                # batch, hw
        *plan,
        vp,                      # cudaStream_t
    ]
    fn.restype = i32
    for fn in (lib.mdt_fused_degrade_max_clusters, lib.mdt_kmask_max_clusters):
        fn.argtypes = [*plan, ctypes.POINTER(i32)]
        fn.restype = i32
    lib.mdt_error_string.argtypes = [i32]
    lib.mdt_error_string.restype = ctypes.c_char_p


def declare_tinyhead_bwd(lib: ctypes.CDLL) -> None:
    """argtypes of the tiny-head backward's entry point
    (csrc/tinyhead_attention_bwd.cu)."""
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.mdt_tinyhead_attention_bwd
    fn.argtypes = [
        vp, vp, vp, vp, vp, vp,  # q, k, v, out, lse, dout
        vp, vp, vp,              # dq, dk, dv
        vp,                      # (slices, B*heads, S, 8) fp32 dQ workspace (nullable)
        i32, i32, i32,           # batch * heads, sequence, head_dim
        f32, i32,                # scale, dtype (0 fp32, 1 bf16)
        i32, i32, i32,           # bf16 plan: keys a CTA, slices a head, warps a CTA
        vp,                      # cudaStream_t
    ]
    fn.restype = i32


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    declare_exact_k(lib)
    fn = lib.mdt_kmask_seeded
    fn.argtypes = [
        vp, vp,                  # counts (int32), seeds: {seed, offset} uint64 on the device
        vp,                      # out
        i32, i32,                # batch, hw
        i32, i32, i32, i32,      # exact-k plan: cs, threads, per_thread, vec
        vp,                      # cudaStream_t
    ]
    fn.restype = i32
    fn = lib.mdt_tinyhead_attention
    fn.argtypes = [
        vp, vp, vp, vp,          # q, k, v, out
        vp,                      # lse (nullable: not written)
        i32, i32, i32,           # batch * heads, sequence, head_dim
        f32, i32,                # scale, dtype (0 fp32, 1 bf16)
        vp,                      # cudaStream_t
    ]
    fn.restype = i32
    declare_tinyhead_bwd(lib)
    i64 = ctypes.c_longlong
    fn = lib.mdt_group_norm_fwd
    fn.argtypes = [
        vp, vp, vp, vp,          # x, scale, bias, y
        vp, vp,                  # mean, rstd (nullable: not written)
        i32, i32, i32, i32,      # batch, channels, hw, groups
        i64, i64, i64,           # x strides: image, channel, pixel
        f32, i32, i32, i32,      # eps, silu, dtype, scale/bias dtype
        i32, i32, i32, i32, i32,  # plan: ctas, per_lane, threads, smem bytes, staged
        i32, vp, f32,            # mode (0 whole, 1 split sums, 2 split apply), sums, count
        vp,                      # cudaStream_t
    ]
    fn.restype = i32
    fn = lib.mdt_group_norm_bwd
    fn.argtypes = [
        vp, vp, vp, vp, vp, vp,  # x, grad_out, scale, bias, mean, rstd
        vp, vp, vp,              # dx, dscale, dbias
        vp, vp,                  # (2, B, C) fp32 parts, (groups,) int32 counters
        i32, i32, i32, i32,      # batch, channels, hw, groups
        i64, i64, i64,           # x strides: image, channel, pixel
        i64, i64, i64,           # grad_out strides
        i32, i32, i32,           # silu, dtype, scale/bias dtype
        i32, i32, i32, i32, i32,  # plan: ctas, per_lane, threads, smem bytes, staged
        i32, vp, f32,            # mode, (2, B*G) fp32 sums of m1 and m2, count
        vp,                      # cudaStream_t
    ]
    fn.restype = i32
    fn = lib.mdt_group_norm_max_clusters
    fn.argtypes = [i32, i32, i32, i32, i32, ctypes.POINTER(i32)]
    fn.restype = i32


def _compile(cmd) -> tuple:
    """(returncode, output, seconds) of one nvcc -c."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def _compile_and_link(path: str) -> str:
    """nvcc -c for every source at once, then one link; returns nvcc's
    output, with each source's compile seconds. Raises on any failure."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs, cmds = [], []
    for src in _sources():
        obj = os.path.join(KERNEL_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src])
        objs.append(obj)
    with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
        results = list(pool.map(_compile, cmds))  # every compile, then report
    log, failed = [], []
    for cmd, (code, out, seconds) in zip(cmds, results):
        log.append(out + f"nvcc {os.path.basename(cmd[-1])}: {seconds:.1f} s\n")
        if code != 0:
            failed.append(f"nvcc failed ({code}): {' '.join(cmd)}\n{out}")
    tmp = f"{path}.{tag}"
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{log[-1]}")
        os.replace(tmp, path)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(log)


def load_library() -> ctypes.CDLL:
    """Compile csrc/*.cu (once per source hash) and load the library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(KERNEL_DIR, exist_ok=True)
            build_log = _compile_and_link(path)
        lib = ctypes.CDLL(path)
        _declare(lib)
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        msg = lib.mdt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")

