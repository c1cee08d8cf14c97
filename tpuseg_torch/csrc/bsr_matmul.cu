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
// The TPU kernels differ only in how a TPU grid walks a row's blocks (B5:
// one sequential grid step per block with the padded steps masked; B6: the
// row's support gathered into one dot).  Here a CTA loops over its row's
// blocks itself, so neither padding nor the repack carries over.
//
// What bounds it on the H100: at M = K = 512, N = 2^20 and 87.5 % block
// sparsity (2 of 16 blocks, two empty row blocks) the product is 0.07 TFLOP,
// while the x rows the live tiles read (0.54 GB bf16) and y (2.15 GB f32)
// take 0.80 ms at 3.35 TB/s: it is bound by bytes, mostly the f32 y, so the
// design is about keeping the y write streaming.  The TMA path runs it in
// about 1.04 ms, 2.6 TB/s (PERF.md).
//
// - bf16, N % 8 == 0 (x's and y's rows 16-byte multiples, as TMA needs):
//   persistent CTAs, one per SM, walk the tiles (row block i, 128-column
//   tile), row block fastest; in each wave of one tile per CTA the CTAs take
//   a rotation of consecutive tiles, so the row blocks of one column tile run
//   together (the x tiles they share come from L2) and no CTA keeps one row
//   block.  One producer thread TMA-loads per (block, 64-deep K slice) the W
//   slice (128 x 64, K-major) and the x slice (64 x 128, N-contiguous: two
//   64-column boxes, wgmma's MN-major B) into a 3-stage mbarrier ring; two
//   consumer warpgroups, 64 rows each, run wgmma m64n128k16 on them.  Each
//   consumer writes its 64 x 128 f32 tile into one of two shared buffers
//   (128-byte swizzled, so the writes are free of bank conflicts) and one
//   thread sends it out with four TMA stores (32 columns x 64 rows each), so
//   the store of tile t overlaps the loads and MMAs of tile t+1; the buffer
//   is written again only once its store has read it.  A dead row block
//   reads neither x nor W and stores a zero tile.
// - bf16, other N: the non-TMA path, one 128 x 128 y tile per CTA, 8 warps
//   of wmma 16x16x16 fragments (mma.sync) over a 2-deep cp.async ring of
//   32-deep K slices, x loaded element by element past the 8-aligned case,
//   the f32 tile staged through shared memory and masked at the ragged edge.
// - f32: a CUDA-core path (f32 plans are for exact checks): 16-deep steps
//   loaded synchronously, 8 x 8 outputs per thread, fmaf in K order.
//
// C interface (ctypes): tpuseg_bsr_matmul returns the cudaError_t of the
// launch (0 on success); it launches on the given stream, does not
// synchronize and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace nvcuda;
using namespace tpuseg_hopper;

constexpr int kB = 128;        // block rows = block columns (bm = bk)
constexpr int kBN = 128;       // y columns per CUDA block
constexpr int kThreads = 256;

// bf16 TMA + wgmma path
constexpr int kTK = 64;                      // K per stage: one 128-byte bf16 swizzle row
constexpr int kTStages = 3;
constexpr int kTConsumers = 2;               // warpgroups, 64 rows each
constexpr int kTThreads = (kTConsumers + 1) * 128;  // + the producer warpgroup
constexpr int kTABytes = kB * kTK * 2;       // 16 KB: the W slice
constexpr int kTBBytes = kTK * kBN * 2;      // 16 KB: the x slice, two 64-column boxes
constexpr int kTStageBytes = kTABytes + kTBBytes;
constexpr int kOutCols = 32;                 // f32 columns per 128-byte swizzle row
constexpr int kOutBox = 64 * kOutCols * 4;   // 8 KB: one TMA store box (32 columns x 64 rows)
constexpr int kOutBytes = 64 * kBN * 4;      // 32 KB: one consumer's tile, four boxes
constexpr int kTSmem = kTStages * kTStageBytes + 2 * kTConsumers * kOutBytes +
                       2 * kTStages * 8 + 1024;  // + barriers, alignment
static_assert(kTSmem <= kMaxSmem, "the ring and the output buffers do not fit shared memory");

// bf16 non-TMA path (ragged N)
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

// the it-th tile of CTA c (of G): the waves of G consecutive tiles, each
// rotated by the wave index so that no CTA keeps one row block
__device__ __forceinline__ long long tile_of(int it, int c, int G) {
  return static_cast<long long>(it) * G + (c + it) % G;
}

__global__ void __launch_bounds__(kTThreads, 1)
bsr_matmul_tma_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap ymap, const int* __restrict__ rowptr,
                      const int* __restrict__ colidx, int nrb, long long tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* outbuf = smem + kTStages * kTStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(outbuf + 2 * kTConsumers * kOutBytes);
  uint64_t* empty = full + kTStages;
  const int G = gridDim.x;
  const int c = blockIdx.x;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kTStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kTConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kTConsumers) {
    // producer warpgroup: one thread starts every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kTConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0;; ++it) {
        const long long t = tile_of(it, c, G);
        if (t >= tiles) break;
        const int i = static_cast<int>(t % nrb);
        const int n0 = static_cast<int>(t / nrb) * kBN;
        const int b1 = __ldg(rowptr + i + 1);
        for (int b = __ldg(rowptr + i); b < b1; ++b) {
          const int xrow = __ldg(colidx + b) * kB;
          for (int kc = 0; kc < kB / kTK; ++kc) {
            mbar_wait(&empty[stage], phase ^ 1);
            unsigned char* a = smem + stage * kTStageBytes;
            mbar_expect_tx(&full[stage], kTStageBytes);
            tma_load_2d(a, &wmap, &full[stage], kc * kTK, b * kB);
            tma_load_2d(a + kTABytes, &xmap, &full[stage], n0, xrow + kc * kTK);
            tma_load_2d(a + kTABytes + kTBBytes / 2, &xmap, &full[stage], n0 + kBN / 2,
                        xrow + kc * kTK);
            if (++stage == kTStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }
  // consumer warpgroups: rows wg*64 .. +63 of each tile, all 128 columns
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int r = (tid >> 5) * 16 + (lane >> 2);  // this thread's accumulator rows: r, r + 8
  int stage = 0, buf = 0;
  uint32_t phase = 0;
  float acc[64];
  for (int it = 0;; ++it) {
    const long long t = tile_of(it, c, G);
    if (t >= tiles) break;
    const int i = static_cast<int>(t % nrb);
    const int n0 = static_cast<int>(t / nrb) * kBN;
    const int ksteps = (__ldg(rowptr + i + 1) - __ldg(rowptr + i)) * (kB / kTK);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    int held = -1;
    for (int e = 0; e < ksteps; ++e) {
      mbar_wait(&full[stage], phase);
      const uint32_t a = smem_u32(smem + stage * kTStageBytes) + wg * 64 * (kTK * 2);
      const uint32_t bt = smem_u32(smem + stage * kTStageBytes + kTABytes);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)
        wgmma_m64n128k16(acc, sw128_desc(a + kk * 32, 16, 1024),
                         sw128_desc(bt + kk * 16 * (kBN / 2) * 2, kTBBytes / 2, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's MMAs are done: release its stage
      fence_acc(acc);
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == kTStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);

    // epilogue: the f32 tile into this consumer's buffer `buf` once the
    // store that last read it (two tiles ago) is done reading, then out
    unsigned char* ob = outbuf + (wg * 2 + buf) * kOutBytes;
    if (tid == 0) bulk_wait_read<1>();
    named_bar_sync(1 + wg, 128);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = r + 8 * half;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // columns 8j + 2(lane%4) + {0, 1}: box j/4, 16-byte unit 2(j%4) + (lane%4)/2
        const int unit = 2 * (j & 3) + ((lane & 3) >> 1);
        unsigned char* dst =
            ob + (j >> 2) * kOutBox + rr * 128 + ((unit ^ (rr & 7)) << 4) + (lane & 1) * 8;
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[j * 4 + 2 * half], acc[j * 4 + 2 * half + 1]);
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int bx = 0; bx < kBN / kOutCols; ++bx)
        tma_store_2d(&ymap, ob + bx * kOutBox, n0 + bx * kOutCols, i * kB + wg * 64);
      bulk_commit();
    }
    buf ^= 1;
  }
  if (tid == 0) bulk_wait_all();
}

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

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 0;
  }
  return count;
}

// The TMA path: maps over W's tiles, x and y, and one persistent CTA per SM.
cudaError_t launch_tma(const void* vals, const int* rowptr, const int* colidx, const void* x,
                       void* y, const Geom& g, int nnzb, cudaStream_t st) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  CUtensorMap wmap, xmap, ymap;
  // a W with no tile is never read; its map still needs a valid shape
  const cuuint64_t wdims[2] = {kB, (cuuint64_t)(nnzb > 0 ? nnzb : 1) * kB};
  const cuuint64_t wstrides[1] = {kB * 2};
  const cuuint32_t wbox[2] = {kTK, kB};
  const cuuint64_t xdims[2] = {(cuuint64_t)g.n, (cuuint64_t)g.k};
  const cuuint64_t xstrides[1] = {(cuuint64_t)g.n * 2};
  const cuuint32_t xbox[2] = {kBN / 2, kTK};
  const cuuint64_t ydims[2] = {(cuuint64_t)g.n, (cuuint64_t)g.m};
  const cuuint64_t ystrides[1] = {(cuuint64_t)g.n * 4};
  const cuuint32_t ybox[2] = {kOutCols, 64};
  if (!tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, nnzb > 0 ? vals : x, wdims,
                  wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstrides, xbox,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&ymap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, y, ydims, ystrides, ybox,
                  CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = static_cast<long long>(g.nrb) * ((g.n + kBN - 1) / kBN);
  const cudaError_t e = cudaFuncSetAttribute(
      bsr_matmul_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTSmem);
  if (e != cudaSuccess) return e;
  const int ctas = static_cast<int>(tiles < sms ? tiles : sms);
  bsr_matmul_tma_kernel<<<ctas, kTThreads, kTSmem, st>>>(wmap, xmap, ymap, rowptr, colidx,
                                                         g.nrb, tiles);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 f32, 1 bf16 (vals and x); nnzb = rowptr[m/128], the tiles in vals.
extern "C" int tpuseg_bsr_matmul(const void* vals, const void* rowptr, const void* colidx,
                                 const void* x, void* y, int m, int k, int n, int nnzb,
                                 int dtype, void* stream) {
  if (m <= 0 || m % kB != 0 || k <= 0 || k % kB != 0 || n <= 0 || nnzb < 0 ||
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
  if (ctas > 0x7fffffffLL || static_cast<long long>(nnzb) * kB > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(ctas));
  if (dtype == 1 && n % 8 == 0) {
    const cudaError_t e = launch_tma(vals, static_cast<const int*>(rowptr),
                                     static_cast<const int*>(colidx), x, y, g, nnzb, st);
    if (e != cudaSuccess) return (int)e;
  } else if (dtype == 1) {
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
