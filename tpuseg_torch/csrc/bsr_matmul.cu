// Block-sparse (BSR) matrix product, for Hopper (sm_90a).
//
// Replaces the TPU kernels tpuseg/ops/bsr.py::bsr_matmul and
// ::bsr_matmul_gathered, which compute one function:
//
//   y[i*128 + r, c] = sum_{b in rowptr[i] .. rowptr[i+1]} sum_k
//       vals[b, r, k] * x[colidx[b]*128 + k, c]
//
// W (M, K) is packed as 128x128 value tiles vals (nnzb, 128, 128), one per
// nonzero block, row-major by row block, with CSR rowptr (M/128 + 1) and
// colidx (nnzb) (tpuseg_torch/ops/bsr.py pack_bsr); x is (K, N) and y
// (M, N), both row-major (N fastest).  vals and x share one dtype (the
// wrapper casts x), products accumulate in f32 and y is f32.  A row block
// with no nonzero block writes zeros.
//
// Design.  The TPU kernels differ only in how a TPU grid walks a row's
// blocks (B5: one sequential grid step per block with the padded steps
// masked; B6: the row's support gathered into one dot).  Here one CUDA
// block computes one 128-row block of y by one 128-column tile and loops
// over its row's blocks itself, so neither padding nor the repack carries
// over.  Consecutive CUDA blocks take the row blocks of one column tile, so
// the x tiles they share are read from device memory about once.
//
// - bf16: 8 warps in a 4 (rows) x 2 (columns) grid, each owning a 32 x 64
//   accumulator tile of 2 x 4 wmma 16x16x16 fragments (tensor-core
//   mma.sync, f32 accumulate).  The reduction runs in 32-deep steps (a
//   128x32 slice of the vals tile and the 32x128 x rows it multiplies)
//   through a 2-deep cp.async ring, so the loads of step s+1 overlap the
//   MMAs of step s.  x rows load as 16-byte cp.async when N % 8 == 0 (zero-
//   filled past N by the src-size operand) and element by element
//   otherwise.  The f32 tile is staged through shared memory and leaves
//   masked at the ragged N edge.
// - f32: a CUDA-core path (f32 plans are for exact checks): 16-deep steps
//   loaded synchronously, 8 x 8 outputs per thread, fmaf in K order.
//
// What bounds it on the H100: at M = K = 512, N = 2^20 and 87.5 % block
// sparsity (2 of 16 blocks) the product is 0.07 TFLOP, while x (1.07 GB
// bf16) and y (2.15 GB f32) take ~0.96 ms at 3.35 TB/s: it is bound by
// bytes, mostly the f32 y.  wgmma + TMA are left for a later change.
//
// C interface (ctypes): tpuseg_bsr_matmul returns the cudaError_t of the
// launch (0 on success); it launches on the given stream, does not
// synchronize and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kB = 128;        // block rows = block columns (bm = bk)
constexpr int kBN = 128;       // y columns per CUDA block
constexpr int kThreads = 256;

// bf16 tensor-core path
constexpr int kBK = 32;            // reduction depth per pipeline step
constexpr int kAPitch = kBK + 8;   // bf16 per staged vals row: 80 bytes
constexpr int kBPitch = kBN + 8;   // bf16 per staged x row: 272 bytes
constexpr int kCPitch = kBN + 4;   // f32 per staged y row
constexpr int kAStage = kB * kAPitch;
constexpr int kBStage = kBK * kBPitch;
constexpr int kStage = kAStage + kBStage;
constexpr int kRingBytes = 2 * kStage * 2;
constexpr int kCTileBytes = kB * kCPitch * 4;
constexpr int kSmemBytes = kRingBytes > kCTileBytes ? kRingBytes : kCTileBytes;

// f32 CUDA-core path
constexpr int kFK = 16;

struct Geom {
  int m, k, n;
  int nrb;  // row blocks
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int src_bytes) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__global__ void __launch_bounds__(kThreads)
bsr_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ vals, const int* __restrict__ rowptr,
                       const int* __restrict__ colidx, const __nv_bfloat16* __restrict__ x,
                       float* __restrict__ y, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int i = blockIdx.x % g.nrb;                       // row block
  const long long n0 = static_cast<long long>(blockIdx.x / g.nrb) * kBN;  // first column
  const int tid = threadIdx.x;
  const int b0 = __ldg(rowptr + i);
  const int steps = (__ldg(rowptr + i + 1) - b0) * (kB / kBK);
  const bool vec = (g.n & 7) == 0;

  // stage `step` = (block b0 + step / 4, 32-deep slice step % 4) into `slot`
  auto load_stage = [&](int slot, int step) {
    const int b = b0 + step / (kB / kBK);
    const int kk0 = (step % (kB / kBK)) * kBK;
    __nv_bfloat16* a = ring + slot * kStage;
    __nv_bfloat16* bt = a + kAStage;
    const __nv_bfloat16* va = vals + static_cast<long long>(b) * kB * kB + kk0;
    for (int idx = tid; idx < kB * (kBK / 8); idx += kThreads) {
      const int r = idx / (kBK / 8);
      const int c = idx % (kBK / 8);
      cp_async_16(a + r * kAPitch + c * 8, va + r * kB + c * 8, 16);
    }
    const long long xrow0 = static_cast<long long>(__ldg(colidx + b)) * kB + kk0;
    if (vec) {
      for (int idx = tid; idx < kBK * (kBN / 8); idx += kThreads) {
        const int r = idx / (kBN / 8);
        const int c = idx % (kBN / 8);
        const long long col = n0 + c * 8;
        const bool ok = col < g.n;  // N % 8 == 0: a chunk is all in or all out
        const __nv_bfloat16* src = ok ? x + (xrow0 + r) * g.n + col : x;
        cp_async_16(bt + r * kBPitch + c * 8, src, ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
        const int r = idx / kBN;
        const int c = idx % kBN;
        const long long col = n0 + c;
        bt[r * kBPitch + c] = col < g.n ? x[(xrow0 + r) * g.n + col] : __float2bfloat16(0.0f);
      }
    }
  };

  const int warp = tid >> 5;
  const int wm = warp >> 1;  // rows wm*32 .. +32
  const int wn = warp & 1;   // columns wn*64 .. +64
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) wmma::fill_fragment(acc[r][c], 0.0f);

  if (steps > 0) load_stage(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    cp_async_wait_all();
    __syncthreads();  // step landed for all threads; the other slot is free
    if (step + 1 < steps) load_stage((step + 1) & 1, step + 1);
    cp_async_commit();
    const __nv_bfloat16* a = ring + (step & 1) * kStage;
    const __nv_bfloat16* bt = a + kAStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        wmma::load_matrix_sync(fa[r], a + (wm * 32 + r * 16) * kAPitch + kk, kAPitch);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wmma::load_matrix_sync(fb[c], bt + kk * kBPitch + wn * 64 + c * 16, kBPitch);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) wmma::mma_sync(acc[r][c], fa[r], fb[c], acc[r][c]);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the ring before it becomes the C tile

  float* sC = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wmma::store_matrix_sync(sC + (wm * 32 + r * 16) * kCPitch + wn * 64 + c * 16, acc[r][c],
                              kCPitch, wmma::mem_row_major);
  __syncthreads();
  float* yt = y + static_cast<long long>(i) * kB * g.n + n0;
  if ((g.n & 3) == 0) {
    for (int idx = tid; idx < kB * (kBN / 4); idx += kThreads) {
      const int r = idx / (kBN / 4);
      const int c4 = idx % (kBN / 4);
      if (n0 + c4 * 4 < g.n)
        *reinterpret_cast<float4*>(yt + static_cast<long long>(r) * g.n + c4 * 4) =
            *reinterpret_cast<const float4*>(sC + r * kCPitch + c4 * 4);
    }
  } else {
    for (int idx = tid; idx < kB * kBN; idx += kThreads) {
      const int r = idx / kBN;
      const int c = idx % kBN;
      if (n0 + c < g.n) yt[static_cast<long long>(r) * g.n + c] = sC[r * kCPitch + c];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bsr_matmul_f32_kernel(const float* __restrict__ vals, const int* __restrict__ rowptr,
                      const int* __restrict__ colidx, const float* __restrict__ x,
                      float* __restrict__ y, Geom g) {
  __shared__ float sA[kFK][kB + 4];  // [k][row]
  __shared__ float sB[kFK][kBN];     // [k][column]

  const int i = blockIdx.x % g.nrb;
  const long long n0 = static_cast<long long>(blockIdx.x / g.nrb) * kBN;
  const int tid = threadIdx.x;
  const int b0 = __ldg(rowptr + i);
  const int steps = (__ldg(rowptr + i + 1) - b0) * (kB / kFK);

  const int ty = tid >> 4;  // rows ty + 16*r
  const int tx = tid & 15;  // columns tx + 16*c
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int b = b0 + step / (kB / kFK);
    const int kk0 = (step % (kB / kFK)) * kFK;
    const float* va = vals + static_cast<long long>(b) * kB * kB + kk0;
    for (int idx = tid; idx < kB * kFK; idx += kThreads) {
      const int r = idx / kFK;
      const int kk = idx % kFK;
      sA[kk][r] = __ldg(va + r * kB + kk);
    }
    const long long xrow0 = static_cast<long long>(__ldg(colidx + b)) * kB + kk0;
    for (int idx = tid; idx < kFK * kBN; idx += kThreads) {
      const int kk = idx / kBN;
      const int c = idx % kBN;
      const long long col = n0 + c;
      sB[kk][c] = col < g.n ? __ldg(x + (xrow0 + kk) * g.n + col) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = sA[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 8; ++c) bv[c] = sB[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* yt = y + static_cast<long long>(i) * kB * g.n + n0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float* yr = yt + static_cast<long long>(ty + 16 * r) * g.n;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (n0 + col < g.n) yr[col] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" int tpuseg_bsr_matmul(const void* vals, const void* rowptr, const void* colidx,
                                 const void* x, void* y, int m, int k, int n, int dtype,
                                 void* stream) {
  if (m <= 0 || m % kB != 0 || k <= 0 || k % kB != 0 || n <= 0 ||
      ((uintptr_t)vals & 15u) != 0 || ((uintptr_t)x & 15u) != 0 || ((uintptr_t)y & 15u) != 0 ||
      ((uintptr_t)rowptr & 3u) != 0 || ((uintptr_t)colidx & 3u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Geom g;
  g.m = m;
  g.k = k;
  g.n = n;
  g.nrb = m / kB;
  const long long ctas = static_cast<long long>(g.nrb) * ((n + kBN - 1) / kBN);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(ctas));
  if (dtype == 1) {
    const cudaError_t e = cudaFuncSetAttribute(
        bsr_matmul_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    bsr_matmul_bf16_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        static_cast<const __nv_bfloat16*>(vals), static_cast<const int*>(rowptr),
        static_cast<const int*>(colidx), static_cast<const __nv_bfloat16*>(x),
        static_cast<float*>(y), g);
  } else if (dtype == 0) {
    bsr_matmul_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(vals), static_cast<const int*>(rowptr),
        static_cast<const int*>(colidx), static_cast<const float*>(x), static_cast<float*>(y),
        g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
