// Fused block-sparse dilated convolution, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpuseg/ops/sparse_conv.py::fused_sparse_conv_apply,
// and with it the TPU kernels that compute the same function on other
// packings (tpuseg_torch/ops/sparse_conv.py launches it for each): B4
// bsr_matmul_xw (y = x @ W, a 1x1 conv of x viewed as one image row of P
// pixels) and B7a-f shared_sparse_conv_apply, fused_phase_, imcol_phase_,
// cphase_, phase_ and shared_concat_sparse_conv_apply.  Same function: a
// stride-1 "same" k x k conv with dilation d whose weights are packed per
// 128-channel output block jb (tpuseg_torch/ops/sparse_conv.py
// plan_fused_sparse_conv):
//
//   y[n,i,j, jb*128+m] = sum_t sum_s sum_c
//       x[n, i+dy_t-pad, j+dx_t-pad, rows[jb,s]*128 + c] * vals[jb, (t*S+s)*128 + c, m]
//
// pad = d*(k-1)/2, (dy_t, dx_t) = (p*d, q*d) for t = p*k + q, x zero outside
// the image; x and vals share one dtype (the wrapper casts x), products
// accumulate in f32 and y is f32 (N, H, W, Cout), NHWC.  The bf16 path can
// instead write the served layer's bf16 output with its bias,
// bf16(float(bf16(y)) + float(bias[o])), rounded to nearest even at both
// steps: the cast-then-bias order of tpuseg's served convs.
//
// Zero tiles are skipped.  Each packing carries, per out-block, the list of
// its live (tap, slot) steps t*S + s (`steps`, built with the plan from the
// nonzero mask that filled `vals`) and their count (`nsteps`); the bf16 path
// walks only those, and a step whose kernel row falls outside the image
// (its x tile is all zero padding) is skipped too.  An out-block with no
// live step reads nothing and writes zeros.  On finite x this is the
// function exactly (a skipped tile adds only +0 products); an Inf or NaN
// in x would not propagate through a skipped tile.  Served activations are
// finite.
//
// bf16 design: an implicit GEMM on wgmma, fed by TMA.  One CTA computes one
// row segment of 256 output pixels (n, i, j0 .. j0+255) for one out-block jb:
// M = 256 pixels, N = 128 channels, K = the live (tap, slot, 64-channel
// slice) steps.  Per step, one TMA load of a 4-D tensor map over x (C, W, H,
// N) with a box of (64 channels, 256 pixels, 1, 1) at (c0, j0 + q*d - pad,
// i + p*d - pad, n) brings the tap-shifted A tile; TMA fills coordinates
// outside x with zeros, which is the "same" padding, so there is no halo
// logic and no padded copy of x.  Two TMA loads of a 2-D map over vals
// bring B, the 64 x 128 slice of vals[jb] for (t, s), N-contiguous, which
// wgmma takes as its MN-major operand.  Both land 128-byte swizzled in a
// 4-stage mbarrier ring (48 KB a stage).  Warp specialisation: one producer
// thread starts the TMA loads; two consumer warpgroups (setmaxnreg moves
// registers to them) each own 128 pixels x 128 channels, two m64n128k16
// accumulators of 64 f32 registers a thread, and release a stage as soon as
// wgmma.wait_group says the MMAs reading it are done (one group in flight),
// with no block-wide barrier in the loop.  The epilogue writes the f32 (or
// bf16 + bias) tile straight from the accumulators; pixels past the row end
// are not written.  The grid is every (row segment, out-block) pair,
// out-block fastest, so an out-block with few or no steps finishes early
// and the hardware scheduler fills its SM with the next CTA.
//
// What bounds it on the H100.  At the serving shape of layer.6.1.conv2 (x
// (32,128,256,512) bf16, d=4, S=1, four live out-blocks, 9 taps): 1.24 TFLOP
// of MMA, 1.25 ms at the bf16 peak; the f32 y (2.15 GB) takes 0.64 ms at
// 3.35 TB/s, the bf16 y of the served route half that.  The kernel runs it
// in about 2.2 ms, ~560 TFLOP/s (PERF.md, measured with
// tpuseg_torch/ab_sparse_conv.py).  Per 64-channel step a CTA pulls 32 KB of
// x and 16 KB of weights through L2 for 4.2 MFLOP, but L2 is not what holds
// it: a variant that loaded one halo window of x per kernel row and let the
// k taps read it at row offsets q*d (the descriptor's start moved by whole
// 128-byte rows, which works with the base offset left 0) read x a third
// as often and ran 16 % slower here; a variant with 128-pixel tiles and two
// CTAs per SM, whose epilogues overlap the other's main loop, ran 15 %
// slower.  What remains is the shared-memory traffic of m64n128k16 (6 KB
// read per 262 KFLOP, plus the TMA writes) and the epilogue, which is not
// overlapped with MMAs.  An N of 256 would read each A tile once for twice
// the columns, but an out-block is 128 channels and its neighbours read
// other in-blocks.
//
// f32 path (the plan is f32 only for exact parity checks): CUDA cores, 128
// consecutive pixels of the flattened (n, i, j) index per block, 16-channel
// chunks loaded synchronously into shared memory, 8 x 8 outputs per thread,
// fmaf in K order, every step (zero tiles included).
//
// C interface (ctypes): tpuseg_sparse_conv returns the cudaError_t of the
// launch (0 on success); it launches on the given stream, does not
// synchronize and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace tpuseg_hopper;

constexpr int kBN = 128;       // output channels per CUDA block (one out-block)
constexpr int kBlockK = 128;   // channels per support block
constexpr int kThreads = 256;  // f32 path

// bf16 wgmma path
constexpr int kTileM = 256;                       // output pixels per CTA (one row segment)
constexpr int kBK = 64;                           // channels per step: one 128-byte swizzle row
constexpr int kChunks = kBlockK / kBK;            // steps per (tap, slot)
constexpr int kStages = 4;
constexpr int kConsumers = 2;                     // warpgroups, 128 pixels each
constexpr int kWsThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
constexpr int kABytes = kTileM * kBK * 2;         // 32 KB
constexpr int kBBytes = kBK * kBN * 2;            // 16 KB: two 64-column TMA boxes
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kWsSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
// wgmma shared-memory descriptors (byte offsets): A K-major, 128-byte rows,
// 8-row groups 1024 B apart; B MN-major, 64-column halves 8 KB apart
// (leading), 8-row K groups 1024 B apart (stride)
constexpr uint32_t kASbo = 1024;
constexpr uint32_t kBLbo = 8192;
constexpr uint32_t kBSbo = 1024;

// f32 CUDA-core path
constexpr int kBM = 128;           // output pixels per CUDA block (flattened)
constexpr int kFK = 16;            // K chunk (channels)
constexpr int kFChunksPerBlock = kBlockK / kFK;

struct Geom {
  int h, w, cin, cout, s, k, dil, pad;
  long long pixels;  // n * h * w
};

// Write one m64 accumulator (rows r, r + 8 of the warp's 16) of a tile: f32,
// or bf16 with the bias added after the cast (no add without a bias: +0.0
// would turn -0.0 into +0.0).
__device__ __forceinline__ void store_acc(const float (&d)[64], int r, int valid,
                                          long long pix0, int cout, int col, void* out,
                                          bool bf16_out, bool has_bias, const float (&bias)[32]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = r + 8 * half;
    if (rr >= valid) continue;
    const long long base = (pix0 + rr) * cout + col;
    if (bf16_out) {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + base;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        __nv_bfloat16 b0 = __float2bfloat16_rn(d[j * 4 + 2 * half]);
        __nv_bfloat16 b1 = __float2bfloat16_rn(d[j * 4 + 2 * half + 1]);
        if (has_bias) {
          b0 = __float2bfloat16_rn(__bfloat162float(b0) + bias[2 * j]);
          b1 = __float2bfloat16_rn(__bfloat162float(b1) + bias[2 * j + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(o + j * 8) = __halves2bfloat162(b0, b1);
      }
    } else {
      float* o = static_cast<float*>(out) + base;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(o + j * 8) =
            make_float2(d[j * 4 + 2 * half], d[j * 4 + 2 * half + 1]);
    }
  }
}

__global__ void __launch_bounds__(kWsThreads, 1)
sparse_conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap vmap, const int* __restrict__ rows,
                         const int* __restrict__ steps, const int* __restrict__ nsteps,
                         const __nv_bfloat16* __restrict__ bias, void* __restrict__ out,
                         int bf16_out, Geom g) {
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
        const int c0 = __ldg(rows + jb * g.s + s) * kBlockK;
        const int vrow = (jb * ts_len + ts) * kBlockK;
        for (int c = 0; c < kChunks; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = smem + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load_4d(a, &xmap, &full[stage], c0 + c * kBK, jj, ii, n);
          tma_load_2d(a + kABytes, &vmap, &full[stage], 0, vrow + c * kBK);
          tma_load_2d(a + kABytes + kBBytes / 2, &vmap, &full[stage], kBN / 2, vrow + c * kBK);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups: pixels wg*128 .. +127 of the tile, all 128 channels
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc0[64], acc1[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) acc0[r] = acc1[r] = 0.0f;
    const int lane = threadIdx.x & 31;
    int stage = 0, held = -1;
    uint32_t phase = 0;
    for (int e = 0; e < live; ++e) {
      const int t = __ldg(jsteps + e) / g.s;
      const int ii = i + (t / g.k) * g.dil - g.pad;
      if (ii < 0 || ii >= g.h) continue;
      for (int c = 0; c < kChunks; ++c) {
        mbar_wait(&full[stage], phase);
        const uint32_t a = smem_u32(smem + stage * kStageBytes) + wg * 128 * (kBK * 2);
        const uint32_t b = smem_u32(smem + stage * kStageBytes + kABytes);
        fence_acc(acc0);
        fence_acc(acc1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t db = sw128_desc(b + kk * 16 * (kBN / 2) * 2, kBLbo, kBSbo);
          wgmma_m64n128k16(acc0, sw128_desc(a + kk * 32, 16, kASbo), db);
          wgmma_m64n128k16(acc1, sw128_desc(a + 64 * (kBK * 2) + kk * 32, 16, kASbo), db);
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
    }
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);

    const int r = wg * 128 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    const int col = jb * kBN + (lane & 3) * 2;
    float bv[32];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      bv[2 * j] = bias != nullptr ? __bfloat162float(bias[col + j * 8]) : 0.0f;
      bv[2 * j + 1] = bias != nullptr ? __bfloat162float(bias[col + j * 8 + 1]) : 0.0f;
    }
    const int valid = min(kTileM, g.w - j0);
    const long long pix0 = row * g.w + j0;
    const bool bf16 = bf16_out != 0, has_bias = bias != nullptr;
    store_acc(acc0, r, valid, pix0, g.cout, col, out, bf16, has_bias, bv);
    store_acc(acc1, r + 64, valid, pix0, g.cout, col, out, bf16, has_bias, bv);
  }
}

// Decompose a flattened pixel index; ok is false past the last pixel.
struct Pixel {
  int n, i, j;
  bool ok;
};
__device__ __forceinline__ Pixel pixel_at(long long p, const Geom& g) {
  Pixel px;
  px.ok = p < g.pixels;
  if (!px.ok) p = 0;
  px.j = static_cast<int>(p % g.w);
  const long long r = p / g.w;
  px.i = static_cast<int>(r % g.h);
  px.n = static_cast<int>(r / g.h);
  return px;
}

// Element offset of x[n, i+dy, j+dx, c], or -1 when the pixel lies outside.
__device__ __forceinline__ long long x_offset(const Pixel& px, int dy, int dx, int c,
                                              const Geom& g) {
  const int i = px.i + dy;
  const int j = px.j + dx;
  if (!px.ok || i < 0 || i >= g.h || j < 0 || j >= g.w) return -1;
  return ((static_cast<long long>(px.n) * g.h + i) * g.w + j) * g.cin + c;
}

__global__ void __launch_bounds__(kThreads)
sparse_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ vals,
                       const int* __restrict__ rows, float* __restrict__ out, Geom g) {
  __shared__ float sA[kFK][kBM + 4];  // [channel][pixel]
  __shared__ __align__(16) float sB[kFK][kBN];

  const int nmb = g.cout / kBN;
  const long long tile = blockIdx.x / nmb;
  const int jb = blockIdx.x % nmb;
  const long long p0 = tile * kBM;
  const int tid = threadIdx.x;
  const int taps = g.k * g.k;
  const int kt_total = taps * g.s * kFChunksPerBlock;

  // A loader: 128 pixels x 4 float4 (16 channels); thread -> pixels ar + 64*r, float4 ac
  const int ac = tid & 3;
  const int ar = tid >> 2;
  Pixel apx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) apx[r] = pixel_at(p0 + ar + 64 * r, g);
  // B loader: 16 K rows x 32 float4; thread -> row br + 8*r, float4 bc
  const int bc = tid & 31;
  const int br = tid >> 5;
  const long long vals_jb = static_cast<long long>(jb) * taps * g.s * kBlockK * kBN;

  const int ty = tid >> 4;  // pixels ty + 16*i
  const int tx = tid & 15;  // channels tx + 16*j
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < kt_total; ++kt) {
    const int t = kt / (g.s * kFChunksPerBlock);
    const int rem = kt - t * (g.s * kFChunksPerBlock);
    const int s = rem / kFChunksPerBlock;
    const int part = rem - s * kFChunksPerBlock;
    const int dy = (t / g.k) * g.dil - g.pad;
    const int dx = (t % g.k) * g.dil - g.pad;
    const int c = __ldg(rows + jb * g.s + s) * kBlockK + part * kFK + ac * 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long off = x_offset(apx[r], dy, dx, c, g);
      const float4 v = off < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                               : __ldg(reinterpret_cast<const float4*>(x + off));
      const int pr = ar + 64 * r;
      sA[ac * 4 + 0][pr] = v.x;
      sA[ac * 4 + 1][pr] = v.y;
      sA[ac * 4 + 2][pr] = v.z;
      sA[ac * 4 + 3][pr] = v.w;
    }
    const float* vb =
        vals + vals_jb + (static_cast<long long>(t * g.s + s) * kBlockK + part * kFK) * kBN;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = br + 8 * r;
      *reinterpret_cast<float4*>(&sB[row][bc * 4]) =
          __ldg(reinterpret_cast<const float4*>(vb + row * kBN + bc * 4));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sA[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long p = p0 + ty + 16 * i;
    if (p >= g.pixels) continue;
    float* o = out + p * g.cout + jb * kBN + tx;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[16 * j] = acc[i][j];
  }
}

static_assert(kWsSmem <= kMaxSmem, "the bf16 ring does not fit shared memory");

}  // namespace

// dtype: 0 f32 (x, vals, out f32; steps, nsteps, bias unused), 1 bf16 (x,
// vals bf16; out f32, or bf16 with out_bf16 = 1, then bias (cout,) bf16 or
// null).
extern "C" int tpuseg_sparse_conv(const void* x, const void* vals, const void* rows,
                                  const void* steps, const void* nsteps, const void* bias,
                                  void* out, int n, int h, int w, int cin, int cout, int s, int k,
                                  int dil, int dtype, int out_bf16, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || s <= 0 || k <= 0 || (k & 1) == 0 || dil <= 0 ||
      cin <= 0 || cin % kBlockK != 0 || cout <= 0 || cout % kBN != 0 ||
      ((uintptr_t)x & 15u) != 0 || ((uintptr_t)vals & 15u) != 0 || ((uintptr_t)out & 15u) != 0 ||
      ((uintptr_t)rows & 3u) != 0 || (out_bf16 != 0 && out_bf16 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Geom g = {};
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cout = cout;
  g.s = s;
  g.k = k;
  g.dil = dil;
  g.pad = dil * (k - 1) / 2;
  g.pixels = static_cast<long long>(n) * h * w;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const long long nmb = cout / kBN;
    const long long ctas = static_cast<long long>(n) * h * ((w + kTileM - 1) / kTileM) * nmb;
    const long long vrows = nmb * k * k * s * kBlockK;
    if (steps == nullptr || nsteps == nullptr || ((uintptr_t)steps & 3u) != 0 ||
        ((uintptr_t)nsteps & 3u) != 0 || ((uintptr_t)bias & 3u) != 0 ||
        (bias != nullptr && out_bf16 == 0) || ctas > 0x7fffffffLL || vrows > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    CUtensorMap xmap, vmap;
    const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
    const cuuint64_t xstrides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)w * cin * 2,
                                    (cuuint64_t)h * w * cin * 2};
    const cuuint32_t xbox[4] = {kBK, kTileM, 1, 1};
    const cuuint64_t vdims[2] = {kBN, (cuuint64_t)vrows};
    const cuuint64_t vstrides[1] = {kBN * 2};
    const cuuint32_t vbox[2] = {kBN / 2, kBK};
    if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, xdims, xstrides, xbox,
                    CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tensor_map(&vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, vals, vdims, vstrides, vbox,
                    CU_TENSOR_MAP_SWIZZLE_128B)) {
      return (int)cudaErrorInvalidValue;
    }
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_conv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWsSmem);
    if (e != cudaSuccess) return (int)e;
    sparse_conv_wgmma_kernel<<<dim3(static_cast<unsigned>(ctas)), dim3(kWsThreads), kWsSmem,
                               st>>>(xmap, vmap, static_cast<const int*>(rows),
                                     static_cast<const int*>(steps),
                                     static_cast<const int*>(nsteps),
                                     static_cast<const __nv_bfloat16*>(bias), out, out_bf16, g);
  } else if (dtype == 0) {
    const long long ctas = (g.pixels + kBM - 1) / kBM * (cout / kBN);
    if (ctas > 0x7fffffffLL || out_bf16 != 0) return (int)cudaErrorInvalidValue;
    sparse_conv_f32_kernel<<<dim3(static_cast<unsigned>(ctas)), dim3(kThreads), 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(vals),
        static_cast<const int*>(rows), static_cast<float*>(out), g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
