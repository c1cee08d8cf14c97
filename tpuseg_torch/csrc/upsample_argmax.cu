// Fused x8 bilinear upsample + argmax over classes, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpuseg/ops/upsample.py::upsample_argmax_pallas.
// Same function: for every output pixel, the argmax over classes of the x8
// bilinear transposed-conv upsample of NHWC logits, computed by the 2-tap
// phase decomposition per axis in f32, with a running (max, argmax) over
// classes, so the full-resolution C-class logits never exist in memory.
//
//   out[8m + r] = a[r] * xp[m + d(r)] + b[r] * xp[m + d(r) + 1]
//
// with d(r) = (r >= 4) and xp the input zero-padded by one pixel on each
// side.  a[8], b[8] come from the host (tpuseg_torch/ops/upsample.py
// _phase_weights), so the kernel's flip/index map is the host's and
// asymmetric kernels are exact too.  Rows are interpolated first, then
// columns, as the plain version does; every multiply and add is a separate
// round-to-nearest f32 operation (__fmul_rn / __fadd_rn are never contracted
// into an FMA), so the ids are bit-equal to upsample_argmax_reference on the
// card.  Ties go to the lowest class index (strict '>' in class order).
//
// What bounds it on the H100.  At the serving shape, logits (32,128,256,19)
// bf16 -> ids (32,1024,2048) uint8:
//   memory: 40 MB read + 64 MB written, ~31 us at 3.35 TB/s;
//   arithmetic: per class and per 8-pixel output strip, 3 row-pass values
//   (3 ops each) + 8 column-pass values (3 ops each) + 8 compare/selects,
//   about 7 f32 ops per output pixel per class: ~9 GFLOP per batch, well
//   over 100 us even at the card's full non-tensor f32 rate.
// So the kernel is ALU-bound.  What the design does about it: each thread
// owns one input column n and one output row 8m+r and produces that row's
// 8 output phases (8 contiguous pixels), so one row-pass triple is shared
// by 8 column phases; the class loop keeps the 8 running (max, id) pairs in
// registers; the 8 ids leave as one 8-byte store, and a warp writes 256
// contiguous bytes.  Inputs are read straight from global memory (the
// 2x3 neighbourhood per class; neighbours are reused from L1/L2 — the whole
// input fits in L2).  Not done yet (later work): sharing the row pass
// across the 8 row phases (3x fewer row-pass ops), and vectorized
// class loads.
//
// C interface (ctypes): tpuseg_upsample_argmax returns the cudaError_t of
// the launch (0 on success); it launches on the given stream, does not
// synchronize and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStride = 8;
constexpr int kThreads = 128;

struct PhaseWeights {
  float a[kStride];
  float b[kStride];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Zero outside the image: the one-pixel zero padding of the phase formula.
template <typename T>
__device__ __forceinline__ float load(const T* __restrict__ p, bool ok) {
  return ok ? to_f32(*p) : 0.0f;
}

__device__ __forceinline__ float lerp2(float a, float x0, float b, float x1) {
  return __fadd_rn(__fmul_rn(a, x0), __fmul_rn(b, x1));
}

// grid (ceil(w / kThreads), 8 * h, n); thread -> (frame z, output row
// 8m + r, input column col) -> output pixels [8*col, 8*col + 8) of that row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_argmax_kernel(const T* __restrict__ seg, uint8_t* __restrict__ out,
                       PhaseWeights pw, int h, int w, int c) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= w) return;
  const int orow = blockIdx.y;
  const int m = orow >> 3;
  const int r = orow & 7;
  const int frame = blockIdx.z;

  // Row pass inputs: r < 4 reads rows (m-1, m), r >= 4 rows (m, m+1).
  const int row0 = m - 1 + (r >> 2);
  const int row1 = row0 + 1;
  const bool ok0 = row0 >= 0;
  const bool ok1 = row1 < h;
  const bool okl = col > 0;
  const bool okr = col + 1 < w;
  const float ar = pw.a[r];
  const float br = pw.b[r];

  // Pixel offsets in elements (64-bit; a row index of -1 or h is never
  // dereferenced because its ok flag is false).
  const long long img = (long long)frame * h;
  const long long p0 = ((img + row0) * w + col) * c;
  const long long p1 = ((img + row1) * w + col) * c;

  float best[kStride];
  int ids[kStride];
#pragma unroll
  for (int q = 0; q < kStride; ++q) {
    best[q] = 0.0f;
    ids[q] = 0;
  }

  for (int ch = 0; ch < c; ++ch) {
    const T* s0 = seg + p0 + ch;
    const T* s1 = seg + p1 + ch;
    // row pass at input columns col-1, col, col+1 (zero outside)
    const float yl = (okl) ? lerp2(ar, load(s0 - c, ok0), br, load(s1 - c, ok1)) : 0.0f;
    const float ym = lerp2(ar, load(s0, ok0), br, load(s1, ok1));
    const float yr = (okr) ? lerp2(ar, load(s0 + c, ok0), br, load(s1 + c, ok1)) : 0.0f;
    // column pass: phase q < 4 reads (col-1, col), q >= 4 reads (col, col+1)
#pragma unroll
    for (int q = 0; q < kStride; ++q) {
      const float u = q < 4 ? yl : ym;
      const float v = q < 4 ? ym : yr;
      const float val = lerp2(pw.a[q], u, pw.b[q], v);
      if (ch == 0 || val > best[q]) {
        best[q] = val;
        ids[q] = ch;
      }
    }
  }

  unsigned long long packed = 0ull;
#pragma unroll
  for (int q = 0; q < kStride; ++q) {
    packed |= (unsigned long long)(ids[q] & 0xff) << (8 * q);
  }
  // row stride 8w bytes and column offset 8*col: the store is 8-aligned
  const long long o = ((long long)frame * kStride * h + orow) * (long long)(kStride * w) +
                      (long long)kStride * col;
  *reinterpret_cast<unsigned long long*>(out + o) = packed;
}

}  // namespace

extern "C" int tpuseg_upsample_argmax(const void* seg, void* out, const float* ab,
                                      int n, int h, int w, int c, int dtype,
                                      void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c > 255 || n > 65535 ||
      h > 65535 / kStride || ((uintptr_t)out & 7u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  PhaseWeights pw;
  for (int i = 0; i < kStride; ++i) {
    pw.a[i] = ab[i];
    pw.b[i] = ab[kStride + i];
  }
  const dim3 block(kThreads);
  const dim3 grid((w + kThreads - 1) / kThreads, kStride * h, n);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    upsample_argmax_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(seg), static_cast<uint8_t*>(out), pw, h, w, c);
  } else if (dtype == 1) {
    upsample_argmax_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(seg), static_cast<uint8_t*>(out), pw, h, w, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tpuseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
