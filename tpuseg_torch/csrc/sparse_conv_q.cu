// Int8 fused block-sparse dilated convolution, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpuseg/ops/sparse_conv.py::fused_sparse_conv_apply_q.
// Same function: the conv of sparse_conv.cu (a stride-1 "same" k x k conv with
// dilation d, weights packed per 128-channel output block jb) on int8
// operands, with an int32 sum and a float epilogue:
//
//   acc[n,i,j,o] = sum_t sum_s sum_c
//       xq[n, i+dy_t-pad, j+dx_t-pad, rows[jb,s]*128 + c] * vals[jb, (t*S+s)*128 + c, o%128]
//   y[n,i,j,o] = float(acc) * (x_scale[n] * w_scale[o])        (f32, rounded in this order)
//
// xq is zero outside the image (exact: symmetric quantization maps 0 to 0).
// The wrapper quantizes x first (quantize.cu, a pass of its own: B3 loads
// each element of x once per tap and out-block, 36 times at a dense 3x3
// 512->512 conv, so quantizing in the load would repeat the IEEE divisions
// and the bf16 bytes that often) and passes the N per-frame scales as a
// device array.  |acc| <= 127^2 * k*k*S*128, below 2^31 for every packing the
// wrapper admits, so the int32 sum is exact and y is bit-equal to an exact
// plain version.  The epilogue has four modes: 0 writes the f32 y; 1, for the
// served bf16 path, bf16(float(bf16(y)) + float(bias[o])) with a bf16 bias,
// each step rounded to nearest even (the cast-then-bias order of tpuseg's
// served convs); 2 and 3, for the int8 stem (tpuseg/ops/polyphase.py:357-359),
// relu(y + bias[o]) with an f32 bias, the add rounded on its own and relu as
// tpuseg's jnp.maximum(v, 0) (-0.0 becomes +0.0, a NaN stays), written as f32
// (2) or rounded once to bf16 (3).
//
// Zero tiles are skipped, as in sparse_conv.cu: each packing carries, per
// out-block, its live (tap, slot) steps t*S + s (`steps`, the nonzero int8
// tiles of `vals`) and their count (`nsteps`); a step whose kernel row falls
// outside the image is skipped too.  Skipping adds nothing an integer sum
// would not: the skipped products are exact zeros.  An out-block with no live
// step reads nothing and writes its epilogue of a zero sum.
//
// Design: sparse_conv.cu's bf16 kernel on int8 wgmma.  One CTA computes one
// row segment of 256 output pixels (n, i, j0 .. j0+255) for one out-block jb:
// M = 256 pixels, N = 128 channels, K = the live (tap, slot) steps of 128
// channels each.  Per step, one TMA load of a 4-D tensor map over xq (C, W,
// H, N) with a box of (128 channels, 256 pixels, 1, 1) at (rows[jb,s]*128,
// j0 + q*d - pad, i + p*d - pad, n) brings the tap-shifted A tile (TMA's zero
// fill outside xq is the "same" padding); one TMA load of a 2-D map over
// vals_k brings B, the 128 x 128 tile of (t, s) with each output channel's
// 128 input channels contiguous.  8-bit wgmma takes both operands K-major,
// and both are: a 128-channel block is exactly one 128-byte swizzle row.
// Both land 128-byte swizzled in a 4-stage mbarrier ring (48 KB a stage).
// One producer thread starts the TMA loads; two consumer warpgroups
// (setmaxnreg moves registers to them) each own 128 pixels x 128 channels,
// two wgmma m64n128k32 s8 accumulators of 64 int32 registers a thread, four
// k32 steps per stage, and release a stage as soon as wgmma.wait_group says
// the MMAs reading it are done.  The epilogue writes f32 (or bf16 + bias)
// straight from the accumulators; pixels past the row end are not written.
// The grid is every (row segment, out-block) pair, out-block fastest.
//
// What bounds it on the H100.  At the serving shape of layer.6.1.conv2 (x
// (32,128,256,512), d=4, S=1, four live out-blocks, 9 taps): 1.24 T int8 MMA
// operations, 0.63 ms at the 1979 TOP/s int8 peak; the bf16 y of the served
// route (1.07 GB) takes 0.32 ms at 3.35 TB/s, the f32 y twice that, and the
// int8 x 0.16 ms.  Per step a CTA pulls 48 KB through L2 for 8.4 M
// operations, twice the operations per byte of the bf16 kernel.  The kernel
// runs it in about 1.5 ms with the bf16 epilogue (~830 TOP/s), and the
// 36-step dense 512->512 convs at ~1,280 TOP/s (PERF.md): each CTA fills its
// ring and writes its epilogue with no other tile to overlap them, which
// costs most where a tile has few steps.
//
// C interface (ctypes): tpuseg_sparse_conv_q returns the cudaError_t of the
// launch (0 on success); it launches on the given stream, does not
// synchronize and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace tpuseg_hopper;

constexpr int kBN = 128;        // output channels per CTA (one out-block)
constexpr int kBlockK = 128;    // channels per support block: bytes per swizzle row
constexpr int kTileM = 256;     // output pixels per CTA (one row segment)
constexpr int kStages = 4;
constexpr int kConsumers = 2;   // warpgroups, 128 pixels each
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int kABytes = kTileM * kBlockK;         // 32 KB
constexpr int kBBytes = kBN * kBlockK;            // 16 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
// wgmma descriptors, both operands K-major: 128-byte rows, 8-row groups 1024 B
// apart (stride); the leading offset is unused in a swizzled K-major layout
constexpr uint32_t kSbo = 1024;
static_assert(kSmem <= kMaxSmem, "the int8 ring does not fit shared memory");

struct Geom {
  int h, w, cin, cout, s, k, dil, pad;
};

#define TPUSEG_R8(i)                                                                     \
  "+r"(d[(i)]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]), "+r"(d[(i) + 4]), \
      "+r"(d[(i) + 5]), "+r"(d[(i) + 6]), "+r"(d[(i) + 7])

// d (64 x 128, int32) += A (64 x 32, K-major s8) * B (32 x 128, K-major s8),
// both in shared memory
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : TPUSEG_R8(0), TPUSEG_R8(8), TPUSEG_R8(16), TPUSEG_R8(24), TPUSEG_R8(32),
        TPUSEG_R8(40), TPUSEG_R8(48), TPUSEG_R8(56)
      : "l"(da), "l"(db), "r"(1));
}
#undef TPUSEG_R8

// epilogue modes (the C entry's `mode`)
constexpr int kF32 = 0;        // float(acc) * sc
constexpr int kBf16Bias = 1;   // bf16(float(bf16(y)) + bias), bias bf16 or none
constexpr int kReluF32 = 2;    // relu(y + bias), bias f32
constexpr int kReluBf16 = 3;   // bf16(relu(y + bias)), bias f32

// tpuseg's relu(v) = jnp.maximum(v, 0) on v = y + b: -0.0 gives +0.0, a NaN
// stays a NaN (fmaxf would return 0 for it)
__device__ __forceinline__ float relu_add(float y, float b) {
  const float v = __fadd_rn(y, b);
  return v <= 0.0f ? 0.0f : v;
}

// Write one m64 accumulator (rows r, r + 8 of the warp's 16) of a tile in
// epilogue mode kMode (no add without a bias in mode 1: +0.0 would turn -0.0
// into +0.0).  sc[2j + e] and bv[2j + e] belong to column col + 8j + e.
template <int kMode>
__device__ __forceinline__ void store_acc(const int (&d)[64], int r, int valid, long long pix0,
                                          int cout, int col, const float (&sc)[32],
                                          const float (&bv)[32], void* out, bool has_bias) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = r + 8 * half;
    if (rr >= valid) continue;
    const long long base = (pix0 + rr) * cout + col;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float y0 = __fmul_rn(__int2float_rn(d[j * 4 + 2 * half]), sc[2 * j]);
      float y1 = __fmul_rn(__int2float_rn(d[j * 4 + 2 * half + 1]), sc[2 * j + 1]);
      if (kMode == kReluF32 || kMode == kReluBf16) {
        y0 = relu_add(y0, bv[2 * j]);
        y1 = relu_add(y1, bv[2 * j + 1]);
      }
      if (kMode == kBf16Bias) {
        __nv_bfloat16 b0 = __float2bfloat16_rn(y0);
        __nv_bfloat16 b1 = __float2bfloat16_rn(y1);
        if (has_bias) {
          b0 = __float2bfloat16_rn(__bfloat162float(b0) + bv[2 * j]);
          b1 = __float2bfloat16_rn(__bfloat162float(b1) + bv[2 * j + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + base + j * 8) =
            __halves2bfloat162(b0, b1);
      } else if (kMode == kReluBf16) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + base + j * 8) =
            __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + base + j * 8) =
            make_float2(y0, y1);
      }
    }
  }
}

// Both m64 accumulators of a consumer warpgroup's 128 pixels
template <int kMode>
__device__ __forceinline__ void store_tile(const int (&acc0)[64], const int (&acc1)[64], int r,
                                           int valid, long long pix0, int cout, int col,
                                           const float (&sc)[32], const float (&bv)[32],
                                           void* out, bool has_bias) {
  store_acc<kMode>(acc0, r, valid, pix0, cout, col, sc, bv, out, has_bias);
  store_acc<kMode>(acc1, r + 64, valid, pix0, cout, col, sc, bv, out, has_bias);
}

// one instance per epilogue mode, so each carries only its own epilogue code
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
sparse_conv_q_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap vmap, const int* __restrict__ rows,
                     const int* __restrict__ steps, const int* __restrict__ nsteps,
                     const float* __restrict__ w_scale, const float* __restrict__ x_scale,
                     const void* __restrict__ bias, void* __restrict__ out, Geom g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int nmb = g.cout / kBN;
  const int segs = (g.w + kTileM - 1) / kTileM;
  const int ts_len = g.k * g.k * g.s;
  const int jb = static_cast<int>(blockIdx.x % nmb);
  const long long tile = blockIdx.x / nmb;
  const long long row = tile / segs;  // n * h + i
  const int j0 = static_cast<int>(tile % segs) * kTileM;
  const int i = static_cast<int>(row % g.h);
  const int n = static_cast<int>(row / g.h);
  const int live = __ldg(nsteps + jb);
  const int* jsteps = steps + static_cast<long long>(jb) * ts_len;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer warpgroup: one thread starts every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int e = 0; e < live; ++e) {
        const int ts = __ldg(jsteps + e);
        const int t = ts / g.s;
        const int s = ts - t * g.s;
        const int p = t / g.k;
        const int ii = i + p * g.dil - g.pad;
        if (ii < 0 || ii >= g.h) continue;  // the whole x tile is zero padding
        const int jj = j0 + (t - p * g.k) * g.dil - g.pad;
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* a = smem + stage * kStageBytes;
        mbar_expect_tx(&full[stage], kStageBytes);
        tma_load_4d(a, &xmap, &full[stage], __ldg(rows + jb * g.s + s) * kBlockK, jj, ii, n);
        tma_load_2d(a + kABytes, &vmap, &full[stage], 0, (jb * ts_len + ts) * kBN);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups: pixels wg*128 .. +127 of the tile, all 128 channels
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    int acc0[64], acc1[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) acc0[r] = acc1[r] = 0;
    const int lane = threadIdx.x & 31;
    int stage = 0, held = -1;
    uint32_t phase = 0;
    for (int e = 0; e < live; ++e) {
      const int t = __ldg(jsteps + e) / g.s;
      const int ii = i + (t / g.k) * g.dil - g.pad;
      if (ii < 0 || ii >= g.h) continue;
      mbar_wait(&full[stage], phase);
      const uint32_t a = smem_u32(smem + stage * kStageBytes) + wg * 128 * kBlockK;
      const uint32_t b = smem_u32(smem + stage * kStageBytes + kABytes);
      fence_acc(acc0);
      fence_acc(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 32; ++kk) {
        const uint64_t db = sw128_desc(b + kk * 32, 16, kSbo);
        wgmma_m64n128k32_s8(acc0, sw128_desc(a + kk * 32, 16, kSbo), db);
        wgmma_m64n128k32_s8(acc1, sw128_desc(a + 64 * kBlockK + kk * 32, 16, kSbo), db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's MMAs are done: release its stage
      fence_acc(acc0);
      fence_acc(acc1);
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);

    const int r = wg * 128 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    const int col = jb * kBN + (lane & 3) * 2;
    const float xs = __ldg(x_scale + n);
    float sc[32], bv[32];  // this thread's 32 columns: x_scale * w_scale, and the bias
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int o = col + (j >> 1) * 8 + (j & 1);
      sc[j] = __fmul_rn(xs, __ldg(w_scale + o));
      bv[j] = bias == nullptr ? 0.0f
              : kMode == kBf16Bias ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[o])
                                  : static_cast<const float*>(bias)[o];
    }
    const int valid = min(kTileM, g.w - j0);
    const long long pix0 = row * g.w + j0;
    const bool has_bias = bias != nullptr;
    store_tile<kMode>(acc0, acc1, r, valid, pix0, g.cout, col, sc, bv, out, has_bias);
  }
}

}  // namespace

// xq (n, h, w, cin) int8 NHWC; vals_k (nmb, k*k*s, 128 out, 128 in) int8;
// rows (nmb, s), steps (nmb, k*k*s), nsteps (nmb,) int32; w_scale (cout,)
// and x_scale (n,) f32; out (n, h, w, cout) and bias by the epilogue mode:
// 0 f32 out, no bias; 1 bf16 out, bias (cout,) bf16 or null; 2 f32 out and
// 3 bf16 out, bias (cout,) f32.
extern "C" int tpuseg_sparse_conv_q(const void* xq, const void* vals_k, const void* rows,
                                    const void* steps, const void* nsteps, const void* w_scale,
                                    const void* x_scale, const void* bias, void* out, int n,
                                    int h, int w, int cin, int cout, int s, int k, int dil,
                                    int mode, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || s <= 0 || k <= 0 || (k & 1) == 0 || dil <= 0 ||
      cin <= 0 || cin % kBlockK != 0 || cout <= 0 || cout % kBN != 0 ||
      ((uintptr_t)xq & 15u) != 0 || ((uintptr_t)vals_k & 15u) != 0 ||
      ((uintptr_t)out & 15u) != 0 || ((uintptr_t)rows & 3u) != 0 ||
      ((uintptr_t)steps & 3u) != 0 || ((uintptr_t)nsteps & 3u) != 0 ||
      ((uintptr_t)w_scale & 3u) != 0 || ((uintptr_t)x_scale & 3u) != 0 ||
      ((uintptr_t)bias & 3u) != 0 || steps == nullptr || nsteps == nullptr || mode < kF32 ||
      mode > kReluBf16 || (mode == kF32 && bias != nullptr) ||
      (mode >= kReluF32 && bias == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Geom g;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cout = cout;
  g.s = s;
  g.k = k;
  g.dil = dil;
  g.pad = dil * (k - 1) / 2;
  const long long nmb = cout / kBN;
  const long long ctas = static_cast<long long>(n) * h * ((w + kTileM - 1) / kTileM) * nmb;
  const long long vrows = nmb * k * k * s * kBN;
  if (ctas > 0x7fffffffLL || vrows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, vmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t xstrides[3] = {(cuuint64_t)cin, (cuuint64_t)w * cin,
                                  (cuuint64_t)h * w * cin};
  const cuuint32_t xbox[4] = {kBlockK, kTileM, 1, 1};
  const cuuint64_t vdims[2] = {kBlockK, (cuuint64_t)vrows};
  const cuuint64_t vstrides[1] = {kBlockK};
  const cuuint32_t vbox[2] = {kBlockK, kBN};
  if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, xq, xdims, xstrides, xbox,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&vmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, vals_k, vdims, vstrides, vbox,
                  CU_TENSOR_MAP_SWIZZLE_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  decltype(&sparse_conv_q_kernel<kF32>) kernel =
      mode == kF32         ? sparse_conv_q_kernel<kF32>
      : mode == kBf16Bias  ? sparse_conv_q_kernel<kBf16Bias>
      : mode == kReluF32   ? sparse_conv_q_kernel<kReluF32>
                           : sparse_conv_q_kernel<kReluBf16>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(static_cast<unsigned>(ctas)), dim3(kThreads), kSmem,
           reinterpret_cast<cudaStream_t>(stream)>>>(
      xmap, vmap, static_cast<const int*>(rows), static_cast<const int*>(steps),
      static_cast<const int*>(nsteps), static_cast<const float*>(w_scale),
      static_cast<const float*>(x_scale), bias, out, g);
  return (int)cudaGetLastError();
}
