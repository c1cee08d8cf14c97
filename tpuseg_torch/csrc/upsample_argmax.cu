// Fused x8 bilinear upsample + argmax over classes, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpuseg/ops/upsample.py:91 upsample_argmax_pallas.
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
// bf16 -> ids (32,1024,2048) uint8, the function moves 40 MB in and 67 MB out
// (~0.032 ms at 3.35 TB/s).  No multiply and add may fuse, so its work is f32
// instructions per output pixel and class:
//   column pass: 1 FMUL + 1 FADD.  An input value meets the 16 weights
//     a[0..7], b[0..7] across the 3 columns it feeds; the bilinear kernel
//     has a[q] == b[7-q], so 8 distinct products (2 FMUL + 1 FADD for
//     weights without that symmetry)                                   2
//   row pass: the same, shared by the 8 output columns of an input column 0.25
//   argmax: compare + select value + select id                          3
// An SM issues one warp instruction a clock on each of its 4 sub-partitions,
// 128 lanes a clock: 132 SMs x 128 x 1.98 GHz = 33.5e12/s, so the 5.25 issue
// in 0.200 ms.  The argmax's 3 run on the compare/select (ALU) pipe at half
// that rate: 0.229 ms.  That pipe bounds the kernel, not memory.
//
// What the design does about it:
// - A CTA (256 threads) takes one frame, one input row m (8 output rows) and
//   a chunk of kColChunk = 128 input columns.  It stages input rows m-1..m+1
//   of the chunk and one column on each side, all classes, into shared memory
//   once: f32, class-major, with the one-pixel zero border written in, so the
//   inner loops have no bounds tests and no conversions.  A thread stages
//   whole pixels: it loads the C contiguous classes of each (any alignment:
//   a row of (2,17,33,19) bf16 is 1,254 bytes and takes the same path as the
//   9,728 of the serving shape), all of its loads in flight at once, and
//   stores them down the class-major column (consecutive lanes, consecutive
//   columns: no bank conflicts).
// - Warp r computes output row 8m + r; lane t owns input columns 4t..4t+3 of
//   the chunk (32 output pixels).  Per class it reads the 6 staged columns it
//   needs of its two input rows as four conflict-free 16-byte shared loads,
//   computes their 6 row-pass values once (0.5625 instructions per output
//   pixel: only the 2 halo columns repeat), then the 32 column-pass values
//   against 32 running (max, id) pairs in registers.
// - C = 19, the served count, has its own instance: a compile-time class
//   count and staging, class 0 peeled (it sets the pairs), and a loop of 218
//   instructions a class (6.8 per pixel and class, 96 of them the argmax's
//   FSETP/FSEL/SEL: 192 clocks of the half-rate pipe).  It computes all 64
//   column products; sharing them (about 40 when a[q] == b[7-q]) is
//   untried.  The loop is not unrolled: fully unrolled it spills 996 bytes
//   and unrolled by 2, 56.  80 registers keep 3 CTAs on an SM.  Any other
//   count (1..255) runs the generic instance over groups of up to 19
//   classes, staged in turn; at 80 registers it spills 196-256 bytes.
// - The 32 ids leave as two 16-byte stores (a warp writes 1,024 contiguous
//   bytes of its output row) when output rows are 16-byte aligned (w even),
//   else as 8-byte stores.
// - Row bands go on gridDim.x (n*h of them) and column chunks on gridDim.y,
//   so 8h may exceed 65,535.  The grid is known here alone: the C entry
//   rejects shapes past CUDA's grid limits.
//
// C interface (ctypes): tpuseg_upsample_argmax returns the cudaError_t of
// the launch (0 on success); it launches on the given stream, does not
// synchronize and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kStride = 8;
constexpr int kColChunk = 128;   // input columns per CTA
constexpr int kColsPerLane = 4;  // input columns per thread
constexpr int kPixels = kColsPerLane * kStride;  // output pixels per thread
constexpr int kThreads = kStride * 32;           // one warp per output row phase
constexpr int kStaged = kColChunk + 2;           // staged columns, border included
constexpr int kPitch = kColChunk + 8;            // each lane reads p = 4t .. 4t+7
constexpr int kServedClasses = 19;
constexpr int kGroup = kServedClasses;           // classes staged at a time
// staged pixels (3 rows x kStaged columns) per thread
constexpr int kTasks = (3 * kStaged + kThreads - 1) / kThreads;

static_assert(kColChunk == 32 * kColsPerLane, "a warp spans the chunk");
static_assert(kPitch % 4 == 0, "16-byte shared loads");

struct PhaseWeights {
  float a[kStride];
  float b[kStride];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float lerp2(float a, float x0, float b, float x1) {
  return __fadd_rn(__fmul_rn(a, x0), __fmul_rn(b, x1));
}

// One class for one thread: the row pass over its 6 staged columns, then the
// column pass and the running argmax of its 32 output pixels.
__device__ __forceinline__ void one_class(const float* s0, const float* s1, float ar,
                                          float br, const PhaseWeights& pw, int id,
                                          bool first, float (&best)[kPixels],
                                          int (&ids)[kPixels]) {
  const float4 x00 = *reinterpret_cast<const float4*>(s0);
  const float4 x01 = *reinterpret_cast<const float4*>(s0 + 4);
  const float4 x10 = *reinterpret_cast<const float4*>(s1);
  const float4 x11 = *reinterpret_cast<const float4*>(s1 + 4);
  // row pass at staged columns 4t .. 4t+5 (input columns 4t-1 .. 4t+4)
  const float y[6] = {lerp2(ar, x00.x, br, x10.x), lerp2(ar, x00.y, br, x10.y),
                      lerp2(ar, x00.z, br, x10.z), lerp2(ar, x00.w, br, x10.w),
                      lerp2(ar, x01.x, br, x11.x), lerp2(ar, x01.y, br, x11.y)};
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    // column pass: phase q < 4 reads columns (j-1, j), q >= 4 reads (j, j+1)
#pragma unroll
    for (int q = 0; q < kStride; ++q) {
      const float u = q < 4 ? y[j] : y[j + 1];
      const float v = q < 4 ? y[j + 1] : y[j + 2];
      const float val = lerp2(pw.a[q], u, pw.b[q], v);
      const int i = j * kStride + q;
      if (first || val > best[i]) {
        best[i] = val;
        ids[i] = id;
      }
    }
  }
}

// grid (n * h, ceil(w / kColChunk)); block kThreads.  CTA -> (frame, input
// row m, column chunk n0); warp -> output row 8m + r; lane -> input columns
// n0 + 4t .. n0 + 4t + 3 -> output pixels [8(n0 + 4t), 8(n0 + 4t) + 32).
template <typename T, bool kFixed>
__global__ void __launch_bounds__(kThreads, 3)
upsample_argmax_kernel(const T* __restrict__ seg, uint8_t* __restrict__ out,
                       PhaseWeights pw, int h, int w, int c, int wide) {
  // staged input rows m-1, m, m+1; column p is input column n0 - 1 + p
  __shared__ __align__(16) float stage[3][kGroup][kPitch];
  const int frame = blockIdx.x / h;
  const int m = blockIdx.x - frame * h;
  const int n0 = blockIdx.y * kColChunk;
  const int tid = threadIdx.x;
  const int r = tid >> 5;
  const int lane = tid & 31;

  const long long frame_px = (long long)frame * h * w;

  float ar = pw.a[0], br = pw.b[0];
#pragma unroll
  for (int q = 1; q < kStride; ++q) {
    if (r == q) {
      ar = pw.a[q];
      br = pw.b[q];
    }
  }
  // row pass inputs: r < 4 reads rows (m-1, m), r >= 4 rows (m, m+1)
  const float* s0 = &stage[r >> 2][0][kColsPerLane * lane];
  const float* s1 = &stage[(r >> 2) + 1][0][kColsPerLane * lane];

  float best[kPixels];
  int ids[kPixels];
#pragma unroll
  for (int i = 0; i < kPixels; ++i) {
    best[i] = 0.0f;
    ids[i] = 0;
  }

  const int groups = kFixed ? 1 : (c + kGroup - 1) / kGroup;
  for (int g = 0; g < groups; ++g) {
    const int g0 = g * kGroup;
    const int cnt = kFixed ? kServedClasses : min(kGroup, c - g0);
    if (g > 0) __syncthreads();  // every warp is done with the last group
    // stage: task (i, p) is staged pixel (row m-1+i, column n0-1+p); its
    // thread loads the group's classes of that pixel (contiguous in NHWC),
    // zeros outside the image, and stores them down the class-major column
    float v[kTasks][kGroup];
#pragma unroll
    for (int j = 0; j < kTasks; ++j) {
      const int task = j * kThreads + tid;
      const int i = task / kStaged;
      const int row = m - 1 + i;
      const int col = n0 - 1 + (task - i * kStaged);
      const bool ok = task < 3 * kStaged && row >= 0 && row < h && col >= 0 && col < w;
      const T* src = seg + (frame_px + (long long)(ok ? row : 0) * w + (ok ? col : 0)) * c + g0;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) v[j][k] = (ok && k < cnt) ? to_f32(src[k]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kTasks; ++j) {
      const int task = j * kThreads + tid;
      if (task < 3 * kStaged) {
        float* dst = &stage[0][0][0] + (task / kStaged) * kGroup * kPitch + task % kStaged;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (k < cnt) dst[k * kPitch] = v[j][k];
        }
      }
    }
    __syncthreads();

    // class 0 sets the pairs; the rest keep the strict '>' in class order
    int k = 0;
    if (g0 == 0) {
      one_class(s0, s1, ar, br, pw, 0, true, best, ids);
      k = 1;
    }
    if (kFixed) {
#pragma unroll 1
      for (k = 1; k < kServedClasses; ++k) {
        one_class(s0 + k * kPitch, s1 + k * kPitch, ar, br, pw, k, false, best, ids);
      }
    } else {
#pragma unroll 1
      for (; k < cnt; ++k) {
        one_class(s0 + k * kPitch, s1 + k * kPitch, ar, br, pw, g0 + k, false, best, ids);
      }
    }
  }

  const int col0 = n0 + kColsPerLane * lane;
  if (col0 >= w) return;
  uint32_t word[kPixels / 4];
#pragma unroll
  for (int i = 0; i < kPixels / 4; ++i) {
    word[i] = (uint32_t)ids[4 * i] | ((uint32_t)ids[4 * i + 1] << 8) |
              ((uint32_t)ids[4 * i + 2] << 16) | ((uint32_t)ids[4 * i + 3] << 24);
  }
  // output row 8m + r of the frame: 8w bytes, 8-aligned (16-aligned if wide)
  uint8_t* dst = out + ((long long)frame * kStride * h + kStride * m + r) * (long long)(kStride * w) +
                 (long long)kStride * col0;
  if (wide && col0 + kColsPerLane <= w) {
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(word[0], word[1], word[2], word[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(word[4], word[5], word[6], word[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      if (col0 + j < w) {
        reinterpret_cast<uint2*>(dst)[j] = make_uint2(word[2 * j], word[2 * j + 1]);
      }
    }
  }
}

template <typename T>
void launch(const void* seg, void* out, const PhaseWeights& pw, int h, int w, int c,
            int wide, dim3 grid, cudaStream_t s) {
  if (c == kServedClasses) {
    upsample_argmax_kernel<T, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(seg), static_cast<uint8_t*>(out), pw, h, w, c, wide);
  } else {
    upsample_argmax_kernel<T, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(seg), static_cast<uint8_t*>(out), pw, h, w, c, wide);
  }
}

}  // namespace

extern "C" int tpuseg_upsample_argmax(const void* seg, void* out, const float* ab,
                                      int n, int h, int w, int c, int dtype,
                                      void* stream) {
  const long long bands = (long long)n * h;
  const long long chunks = ((long long)w + kColChunk - 1) / kColChunk;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c > 255 || bands > INT_MAX ||
      chunks > 65535 || ((uintptr_t)out & 7u) != 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  PhaseWeights pw;
  for (int i = 0; i < kStride; ++i) {
    pw.a[i] = ab[i];
    pw.b[i] = ab[kStride + i];
  }
  const int wide = (w % 2 == 0) && (((uintptr_t)out & 15u) == 0);
  const dim3 grid((unsigned)bands, (unsigned)chunks);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(seg, out, pw, h, w, c, wide, grid, s);
  } else {
    launch<__nv_bfloat16>(seg, out, pw, h, w, c, wide, grid, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tpuseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
