"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``tpuseg_torch/csrc/*.cu`` into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds): one ``nvcc -c`` per source, all started together,
then one link.  The library lives in ``tpuseg_torch/_build/`` under a
name keyed by a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags; it is built to a temporary
name and moved into place with ``os.replace``, so concurrent builds (test
workers, several processes on one host) never load a half-written file.

A missing ``nvcc`` or a failed build raises ``RuntimeError`` with the
compiler's output; there is no fallback.

    python -m tpuseg_torch.ops._build     # build now, print the ptxas report
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc`` (default
    ``/usr/local/cuda``); raises ``RuntimeError`` when neither exists."""
    path = shutil.which("nvcc")
    if path:
        return path
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path) and os.access(path, os.X_OK):
        return path
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME "
        f"({cuda_home}); the CUDA kernels need the CUDA toolkit to build")


def _sources(src_dir: str) -> list[str]:
    srcs = sorted(glob.glob(os.path.join(src_dir, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {src_dir}")
    return srcs


def library_path(src_dir: str = SRC_DIR, build_dir: str = BUILD_DIR) -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(src_dir) + sorted(glob.glob(os.path.join(src_dir, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(build_dir, f"libtpuseg_torch_{h.hexdigest()[:16]}.so")


def build_library(src_dir: str = SRC_DIR, build_dir: str = BUILD_DIR) -> tuple[str, str]:
    """Compile the sources unless the keyed library exists.

    Returns ``(path, log)``: ``log`` is nvcc's output (the ptxas register
    and shared-memory report) when this call built, else ``""``."""
    out = library_path(src_dir, build_dir)
    if os.path.exists(out):
        return out, ""
    nvcc = find_nvcc()
    os.makedirs(build_dir, exist_ok=True)
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    log = []
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp_dir:
        objs, procs = [], []
        for src in _sources(src_dir):
            obj = os.path.join(tmp_dir, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *compile_flags, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for src, proc in zip(_sources(src_dir), procs):
            text, _ = proc.communicate()
            log.append(text)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{text}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(tmp_dir, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *objs],
                              capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log[-1]}")
        os.replace(tmp, out)
    return out, "".join(log)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernel library, with every C entry
    point's argument and result types declared (pointers and the stream as
    ``c_void_p``, so no 64-bit value is cut to 32)."""
    path, _ = build_library()
    lib = ctypes.CDLL(path)
    lib.tpuseg_upsample_argmax.argtypes = [
        ctypes.c_void_p,                  # seg (N, h, w, C) f32|bf16
        ctypes.c_void_p,                  # out (N, 8h, 8w) uint8
        ctypes.POINTER(ctypes.c_float),   # host phase weights a[8], b[8]
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n h w c
        ctypes.c_int,                     # dtype: 0 f32, 1 bf16
        ctypes.c_void_p,                  # cudaStream_t
    ]
    lib.tpuseg_upsample_argmax.restype = ctypes.c_int
    lib.tpuseg_sparse_conv.argtypes = [
        ctypes.c_void_p,                  # x (N, H, W, Cin) f32|bf16, NHWC
        ctypes.c_void_p,                  # vals (nmb, T*S*128, 128), x's dtype
        ctypes.c_void_p,                  # rows (nmb, S) int32
        ctypes.c_void_p,                  # steps (nmb, T*S) int32: live step ids
        ctypes.c_void_p,                  # nsteps (nmb,) int32
        ctypes.c_void_p,                  # bias (Cout,) bf16 or null (bf16 out only)
        ctypes.c_void_p,                  # out (N, H, W, Cout) f32, or bf16
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n h w
        ctypes.c_int, ctypes.c_int,       # cin cout
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # s kernel dilation
        ctypes.c_int,                     # dtype: 0 f32, 1 bf16
        ctypes.c_int,                     # out_bf16: 1 writes bf16(bf16(y) + bias)
        ctypes.c_void_p,                  # cudaStream_t
    ]
    lib.tpuseg_sparse_conv.restype = ctypes.c_int
    lib.tpuseg_sparse_conv_q.argtypes = [
        ctypes.c_void_p,                  # xq (N, H, W, Cin) int8, NHWC
        ctypes.c_void_p,                  # vals_k (nmb, T*S, 128, 128) int8, K-major
        ctypes.c_void_p,                  # rows (nmb, S) int32
        ctypes.c_void_p,                  # steps (nmb, T*S) int32: live step ids
        ctypes.c_void_p,                  # nsteps (nmb,) int32
        ctypes.c_void_p,                  # w_scale (nmb, 1, 128) f32
        ctypes.c_void_p,                  # x_scale (N,) f32, per frame
        ctypes.c_void_p,                  # bias (Cout,): none (mode 0), bf16|none (1), f32 (2, 3)
        ctypes.c_void_p,                  # out (N, H, W, Cout) f32 (modes 0, 2), or bf16 (1, 3)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n h w
        ctypes.c_int, ctypes.c_int,       # cin cout
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # s kernel dilation
        ctypes.c_int,                     # mode: 0 y, 1 bf16(bf16(y) + bias), 2/3 relu(y + bias)
        ctypes.c_void_p,                  # cudaStream_t
    ]
    lib.tpuseg_sparse_conv_q.restype = ctypes.c_int
    quantize_shape = [
        ctypes.c_int, ctypes.c_longlong,  # n, pixels per frame
        ctypes.c_int, ctypes.c_int,       # cx (x's channels), cq (quantized channels)
        ctypes.c_int,                     # dtype: 0 f32, 1 bf16
        ctypes.c_void_p,                  # cudaStream_t
    ]
    lib.tpuseg_absmax.argtypes = [
        ctypes.c_void_p,                  # x (N, P, Cx) f32|bf16
        ctypes.c_void_p,                  # chan (Cq,) int32 or null
        ctypes.c_void_p,                  # absmax (N,) uint32, zeroed
        *quantize_shape,
    ]
    lib.tpuseg_absmax.restype = ctypes.c_int
    lib.tpuseg_quantize.argtypes = [
        ctypes.c_void_p,                  # x (N, P, Cx) f32|bf16
        ctypes.c_void_p,                  # chan (Cq,) int32 or null
        ctypes.c_void_p,                  # absmax (N,) uint32, or null: static scale
        ctypes.c_float,                   # the static scale
        ctypes.c_void_p,                  # xq (N, P, Cq) int8
        ctypes.c_void_p,                  # xs (N,) f32
        *quantize_shape,
    ]
    lib.tpuseg_quantize.restype = ctypes.c_int
    lib.tpuseg_bsr_matmul.argtypes = [
        ctypes.c_void_p,                  # vals (nnzb, 128, 128) f32|bf16
        ctypes.c_void_p,                  # rowptr (M/128 + 1,) int32
        ctypes.c_void_p,                  # colidx (nnzb,) int32
        ctypes.c_void_p,                  # x (K, N), vals' dtype
        ctypes.c_void_p,                  # y (M, N) f32
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # m k n
        ctypes.c_int,                     # nnzb
        ctypes.c_int,                     # dtype: 0 f32, 1 bf16
        ctypes.c_void_p,                  # cudaStream_t
    ]
    lib.tpuseg_bsr_matmul.restype = ctypes.c_int
    lib.tpuseg_frame_deltas.argtypes = [
        ctypes.c_void_p,                  # frames (B, H, W*3) uint8
        ctypes.c_void_p,                  # prev (H, W*3) uint8
        ctypes.c_void_p,                  # sums (B + 1,) uint64, zeroed: per-frame sums, a counter
        ctypes.c_void_p,                  # d (B,) f32
        ctypes.c_int, ctypes.c_longlong,  # B, bytes per frame
        ctypes.c_void_p,                  # cudaStream_t
    ]
    lib.tpuseg_frame_deltas.restype = ctypes.c_int
    lib.tpuseg_budget_select.argtypes = [
        ctypes.c_void_p,                  # d (B,) f32
        ctypes.c_void_p,                  # acc_in (1,) f32
        ctypes.c_void_p,                  # n_in (1,) int32
        ctypes.c_float, ctypes.c_int, ctypes.c_int,  # thresh, K, B
        ctypes.c_void_p,                  # flags (B,) bool
        ctypes.c_void_p,                  # fwd_idx (K,) int32
        ctypes.c_void_p,                  # keyslot (B,) int32
        ctypes.c_void_p,                  # acc_out (1,) f32
        ctypes.c_void_p,                  # n_out (1,) int32
        ctypes.c_void_p,                  # cudaStream_t
    ]
    lib.tpuseg_budget_select.restype = ctypes.c_int
    lib.tpuseg_keyframe_select.argtypes = [
        ctypes.c_void_p,                  # frames (B, H, W*3) uint8
        ctypes.c_void_p,                  # carried keyframe (H, W*3) uint8
        ctypes.c_void_p,                  # n_in (1,) int32
        ctypes.c_void_p,                  # state (3,) int32: keyframe index, n, promotions
        ctypes.c_void_p,                  # sums (B,) uint64, zeroed
        ctypes.c_void_p,                  # done (B,) uint32, zeroed
        ctypes.c_float, ctypes.c_int,     # thresh, B
        ctypes.c_longlong,                # bytes per frame
        ctypes.c_void_p,                  # flags (B,) bool
        ctypes.c_void_p,                  # keyslot (B,) int32
        ctypes.c_void_p,                  # fwd_idx (B,) int32
        ctypes.c_void_p,                  # diffs (B,) f32
        ctypes.c_void_p,                  # out: the new carried keyframe (H, W*3) uint8
        ctypes.c_void_p,                  # cudaStream_t
    ]
    lib.tpuseg_keyframe_select.restype = ctypes.c_int
    lib.tpuseg_block_shifts.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # key, cur luma (B, hs, ws) f32
        ctypes.c_void_p, ctypes.c_void_p,  # dy, dx (B, hs/block, ws/block) int32
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B hs ws
        ctypes.c_int, ctypes.c_int,       # radius, block
        ctypes.c_float,                   # accept_frac
        ctypes.c_void_p,                  # cudaStream_t
    ]
    lib.tpuseg_block_shifts.restype = ctypes.c_int
    lib.tpuseg_warp_ids.argtypes = [
        ctypes.c_void_p,                  # key ids (B, H, W) uint8
        ctypes.c_void_p, ctypes.c_void_p,  # dy, dx (B, H/up, W/up) int32
        ctypes.c_void_p,                  # out (B, H, W) uint8
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H W
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # scale block radius
        ctypes.c_void_p,                  # cudaStream_t
    ]
    lib.tpuseg_warp_ids.restype = ctypes.c_int
    lib.tpuseg_i420_to_rgb.argtypes = [
        ctypes.c_void_p,                  # in (B, H*3/2, W) uint8
        ctypes.c_void_p,                  # out (B, H, W*3) uint8
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H W
        ctypes.c_void_p,                  # cudaStream_t
    ]
    lib.tpuseg_i420_to_rgb.restype = ctypes.c_int
    lib.tpuseg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpuseg_cuda_error_string.restype = ctypes.c_char_p
    return lib


if __name__ == "__main__":
    path, log = build_library()
    print(path)
    print(log)
