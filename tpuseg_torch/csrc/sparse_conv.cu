// Fused block-sparse dilated convolution, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpuseg/ops/sparse_conv.py::fused_sparse_conv_apply,
// and with it the TPU kernels that compute the same function on other
// packings (tpuseg_torch/ops/sparse_conv.py launches it for each): B4
// bsr_matmul_xw (y = x @ W, a 1x1 conv of x viewed as one image row of P
// pixels) and B7a-f shared_sparse_conv_apply, fused_phase_, imcol_phase_,
// cphase_, phase_ and shared_concat_sparse_conv_apply.  Same function: a stride-1 "same" k x k conv with dilation d whose weights
// are packed per 128-channel output block jb (tpuseg_torch/ops/sparse_conv.py
// plan_fused_sparse_conv):
//
//   y[n,i,j, jb*128+m] = sum_t sum_s sum_c
//       x[n, i+dy_t-pad, j+dx_t-pad, rows[jb,s]*128 + c] * vals[jb, (t*S+s)*128 + c, m]
//
// pad = d*(k-1)/2, (dy_t, dx_t) = (p*d, q*d) for t = p*k + q, x zero outside
// the image; x and vals share one dtype (the wrapper casts x), products
// accumulate in f32 and y is f32 (N, H, W, Cout), NHWC.
//
// Design: an implicit GEMM.  One CUDA block computes the output of one row
// segment of up to 256 pixels (n, i, j0 .. j0+255) for one out-block jb, 256
// pixels x 128 channels.  The reduction runs over (kernel row p, support slot
// s, 64-channel slice): for each, the block stages ONE halo slab of x, the
// 256 + 2*pad pixels (n, i + p*d - pad, j0 - pad ..) of that slice, zero-
// filled outside the image by cp.async's src-size operand (which replaces the
// TPU version's padded copy of x), and the k weight slices of taps (p, 0..k-1).
// Tap q then reads the slab shifted by q*d rows, so one load of x serves all
// k taps of a kernel row.  None of the TPU kernel's Mosaic workarounds (W
// padded to 8, the tap-concatenated xmat in VMEM, rows_per_tile) carry over.
//
// - bf16: 8 warps in a 4 (pixels) x 2 (channels) grid, each owning a 64 x 64
//   accumulator tile of 4 x 4 wmma 16x16x16 fragments (tensor-core mma.sync,
//   f32 accumulate).  Stages flow through a 2-deep cp.async ring in shared
//   memory, so the loads of step c+1 overlap the MMAs of step c; slab rows are
//   80 bf16 (160 bytes) apart, so any row shift keeps the 32-byte alignment
//   wmma needs.  The f32 tile is staged through shared memory and leaves as
//   coalesced float4 stores (a warp writes one pixel's 512 contiguous bytes).
// - f32: a CUDA-core path (the plan is f32 only for exact parity checks): 128
//   consecutive pixels of the flattened (n, i, j) index per block, 16-channel
//   chunks loaded synchronously into shared memory, 8 x 8 outputs per
//   thread, fmaf in K order.
//
// What bounds it on the H100.  At the serving shape of layer.6.1.conv2
// (x (32,128,256,512) bf16, d=4, S=1, nmb=4): 1.24 TFLOP of MMA, ~1.3 ms at
// the bf16 peak; 2.1 GB of f32 y written once, ~0.6 ms at 3.35 TB/s.  What
// each block pulls through L2 is the rest: per out-block, all of vals[jb]
// (T*S*32 KB) and, per kernel row, one slab of x.  A first version (128-pixel
// tiles, one shifted x window per tap) moved 4.6 KB per output pixel and
// out-block through L2 and ran at 166 TFLOP/s; this one moves ~1.9 KB.  The
// warp-level mma.sync path is kept; wgmma + TMA (Hopper's full tensor-core
// rate) are left for a later change.
//
// C interface (ctypes): tpuseg_sparse_conv returns the cudaError_t of the
// launch (0 on success); it launches on the given stream, does not
// synchronize and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBN = 128;       // output channels per CUDA block (one out-block)
constexpr int kBlockK = 128;   // channels per support block
constexpr int kThreads = 256;

// bf16 tensor-core path
constexpr int kRowBM = 256;    // output pixels per CUDA block (one row segment)
constexpr int kBK = 64;        // channels per pipeline step
constexpr int kChunksPerBlock = kBlockK / kBK;
constexpr int kAPitch = kBK + 16;  // bf16 per slab row: 160 bytes, a multiple of 32
constexpr int kBPitch = kBN + 8;   // bf16 per weight row
constexpr int kCPitch = kBN + 4;   // f32 per staged output row

// f32 CUDA-core path
constexpr int kBM = 128;           // output pixels per CUDA block (flattened)
constexpr int kFK = 16;            // K chunk (channels)
constexpr int kFChunksPerBlock = kBlockK / kFK;

struct Geom {
  int h, w, cin, cout, s, k, dil, pad;
  long long pixels;  // n * h * w
};

// Shared memory of the bf16 kernel: two stages of (slab + k weight slices),
// at least the staged f32 output tile.
struct Bf16Smem {
  int a_rows, a_stage, b_stage, stage, bytes;  // elements, except bytes
};
__host__ __device__ inline Bf16Smem bf16_smem(int k, int pad) {
  Bf16Smem m;
  m.a_rows = (kRowBM + 2 * pad + 15) / 16 * 16;
  m.a_stage = m.a_rows * kAPitch;
  m.b_stage = k * kBK * kBPitch;
  m.stage = m.a_stage + m.b_stage;
  const int ring = 2 * m.stage * 2;
  const int ctile = kRowBM * kCPitch * 4;
  m.bytes = ring > ctile ? ring : ctile;
  return m;
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int src_bytes) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__global__ void __launch_bounds__(kThreads, 1)
sparse_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ vals,
                        const int* __restrict__ rows, float* __restrict__ out, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const Bf16Smem sm = bf16_smem(g.k, g.pad);

  const int nmb = g.cout / kBN;
  const int segs = (g.w + kRowBM - 1) / kRowBM;  // row segments per image row
  const long long tile = blockIdx.x / nmb;
  const int jb = blockIdx.x % nmb;
  const long long row = tile / segs;             // n * h + i
  const int j0 = static_cast<int>(tile % segs) * kRowBM;
  const int i = static_cast<int>(row % g.h);
  const long long img_row0 = row - i;            // n * h
  const int tid = threadIdx.x;
  const int steps = g.k * g.s * kChunksPerBlock;
  const int slab = kRowBM + 2 * g.pad;           // slab pixels actually read
  const long long vals_jb = static_cast<long long>(jb) * g.k * g.k * g.s * kBlockK * kBN;

  // stage `step` = (kernel row p, support slot s, 64-channel slice) into `slot`
  auto load_stage = [&](int slot, int step) {
    const int p = step / (g.s * kChunksPerBlock);
    const int rem = step - p * (g.s * kChunksPerBlock);
    const int s = rem / kChunksPerBlock;
    const int chunk = rem - s * kChunksPerBlock;
    __nv_bfloat16* a = ring + slot * sm.stage;
    __nv_bfloat16* b = a + sm.a_stage;
    const int ii = i + p * g.dil - g.pad;
    const bool row_ok = ii >= 0 && ii < g.h;
    const long long xrow = ((img_row0 + ii) * g.w) * g.cin +
                           __ldg(rows + jb * g.s + s) * kBlockK + chunk * kBK;
    for (int idx = tid; idx < slab * 8; idx += kThreads) {
      const int r = idx >> 3;
      const int c = idx & 7;
      const int j = j0 - g.pad + r;
      const bool ok = row_ok && j >= 0 && j < g.w;
      const __nv_bfloat16* src = ok ? x + xrow + static_cast<long long>(j) * g.cin + c * 8 : x;
      cp_async_16(a + r * kAPitch + c * 8, src, ok ? 16 : 0);
    }
    for (int idx = tid; idx < g.k * kBK * 16; idx += kThreads) {
      const int q = idx / (kBK * 16);
      const int r = (idx / 16) % kBK;
      const int c = idx & 15;
      const long long vrow =
          static_cast<long long>((p * g.k + q) * g.s + s) * kBlockK + chunk * kBK + r;
      cp_async_16(b + (q * kBK + r) * kBPitch + c * 8, vals + vals_jb + vrow * kBN + c * 8, 16);
    }
  };

  const int warp = tid >> 5;
  const int wm = warp >> 1;  // pixels wm*64 .. +64
  const int wn = warp & 1;   // channels wn*64 .. +64
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][4];
#pragma unroll
  for (int i2 = 0; i2 < 4; ++i2)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i2][j], 0.0f);

  load_stage(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    cp_async_wait_all();
    __syncthreads();  // step landed for all threads; the other slot is free
    if (step + 1 < steps) load_stage((step + 1) & 1, step + 1);
    cp_async_commit();
    const __nv_bfloat16* a = ring + (step & 1) * sm.stage;
    const __nv_bfloat16* b = a + sm.a_stage;
    for (int q = 0; q < g.k; ++q) {
      const __nv_bfloat16* aq = a + (wm * 64 + q * g.dil) * kAPitch;
      const __nv_bfloat16* bq = b + q * kBK * kBPitch + wn * 64;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2)
          wmma::load_matrix_sync(fa[i2], aq + i2 * 16 * kAPitch + kk, kAPitch);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], bq + kk * kBPitch + j * 16, kBPitch);
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i2][j], fa[i2], fb[j], acc[i2][j]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the ring before it becomes the C tile

  float* sC = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i2 = 0; i2 < 4; ++i2)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sC + (wm * 64 + i2 * 16) * kCPitch + wn * 64 + j * 16,
                              acc[i2][j], kCPitch, wmma::mem_row_major);
  __syncthreads();
  const int valid = min(kRowBM, g.w - j0);
  float* orow = out + (row * g.w + j0) * g.cout + jb * kBN;
  for (int idx = tid; idx < valid * (kBN / 4); idx += kThreads) {
    const int r = idx / (kBN / 4);
    const int c4 = idx % (kBN / 4);
    *reinterpret_cast<float4*>(orow + static_cast<long long>(r) * g.cout + c4 * 4) =
        *reinterpret_cast<const float4*>(sC + r * kCPitch + c4 * 4);
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

constexpr int kMaxSmem = 232448;  // opt-in shared memory per block on sm_90

}  // namespace

extern "C" int tpuseg_sparse_conv(const void* x, const void* vals, const void* rows, void* out,
                                  int n, int h, int w, int cin, int cout, int s, int k, int dil,
                                  int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || s <= 0 || k <= 0 || (k & 1) == 0 || dil <= 0 ||
      cin <= 0 || cin % kBlockK != 0 || cout <= 0 || cout % kBN != 0 ||
      ((uintptr_t)x & 15u) != 0 || ((uintptr_t)vals & 15u) != 0 || ((uintptr_t)out & 15u) != 0 ||
      ((uintptr_t)rows & 3u) != 0) {
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
  g.pixels = static_cast<long long>(n) * h * w;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  if (dtype == 1) {
    const long long ctas = static_cast<long long>(n) * h * ((w + kRowBM - 1) / kRowBM) *
                           (cout / kBN);
    const Bf16Smem sm = bf16_smem(k, g.pad);
    if (ctas > 0x7fffffffLL || sm.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm.bytes);
    if (e != cudaSuccess) return (int)e;
    sparse_conv_bf16_kernel<<<dim3(static_cast<unsigned>(ctas)), block, sm.bytes, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(vals),
        static_cast<const int*>(rows), static_cast<float*>(out), g);
  } else if (dtype == 0) {
    const long long ctas = (g.pixels + kBM - 1) / kBM * (cout / kBN);
    if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    sparse_conv_f32_kernel<<<dim3(static_cast<unsigned>(ctas)), block, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(vals),
        static_cast<const int*>(rows), static_cast<float*>(out), g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
