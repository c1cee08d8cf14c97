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
// The wrapper (tpuseg_torch/ops/sparse_conv.py fused_sparse_conv_apply_q)
// quantizes x per frame in PyTorch, as tpuseg does outside its Pallas kernel,
// and passes the N per-frame scales as a device array.  |acc| <= 127^2 *
// k*k*S*128, below 2^31 for every packing the wrapper admits, so the int32 sum
// is exact and y is bit-equal to an exact plain version.
//
// Design: sparse_conv.cu's row-segment implicit GEMM on int8 tensor cores.
// One CUDA block computes 256 output pixels (n, i, j0 .. j0+255) x 128
// channels of out-block jb.  The reduction runs over (kernel row p, support
// slot s): for each, the block stages ONE halo slab of xq, the 256 + 2*pad
// pixels (n, i + p*d - pad, j0 - pad ..) of that 128-channel block, zero-
// filled outside the image by cp.async's src-size operand, and the k weight
// tiles of taps (p, 0..k-1); tap q reads the slab shifted by q*d rows.  8 warps
// in a 4 (pixels) x 2 (channels) grid each own a 64 x 64 int32 tile and issue
// mma.sync m16n8k32 s8.s8.s32 on fragments loaded with ldmatrix.  Stages flow
// through a 2-deep cp.async ring.  None of the TPU kernel's Mosaic workarounds
// (W padded to 32, the tap-concatenated xmat, rows_per_tile) carry over.
//
// - int8 MMA takes both operands K-major.  The packing's vals are N-major (row
//   = input channel), so the kernel reads vals_k, the same values transposed
//   per (tap, slot) to (128 out, 128 in), built once with the plan.
// - Staged rows (slab pixels, weight columns) are 144 bytes apart: every row
//   start is 16-byte aligned for ldmatrix at any tap shift, and the 8 rows of
//   one 8x8 ldmatrix tile fall on 8 distinct 4-bank groups (no conflicts).
// - Epilogue: __fmul_rn(__int2float_rn(acc), __fmul_rn(xs[n], ws[o])), staged
//   through shared memory and written as coalesced float4 rows.
//
// What bounds it on the H100.  At the serving shape of layer.6.1.conv2 (x
// (32,128,256,512), d=4, S=1, nmb=4): 1.24 T int8 MMA operations, 0.63 ms at
// the 1979 TOP/s int8 peak (wgmma; mma.sync reaches a fraction of it); 2.1 GB
// of f32 y written once, 0.64 ms at 3.35 TB/s; and what each block pulls
// through L2: per (p, s) step one 34 KB slab and 48 KB of weights, ~960 bytes
// per output pixel and out-block, ~4 GB in all.  The three are of one order,
// so a first version lands at a few of these units.  What the design does:
// one slab serves k taps (x moves k times less), the weight tiles serve 256
// pixels, and loads overlap the MMAs of the previous step.  Left for later:
// wgmma + TMA, larger pixel tiles (weights amortized further), the quantize
// pass fused into the slab load, and a bf16 + bias epilogue (half the output).
//
// C interface (ctypes): tpuseg_sparse_conv_q returns the cudaError_t of the
// launch (0 on success); it launches on the given stream, does not
// synchronize and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;        // output channels per CUDA block (one out-block)
constexpr int kBlockK = 128;    // channels per support block: bytes per staged row
constexpr int kThreads = 256;
constexpr int kRowBM = 256;     // output pixels per CUDA block (one row segment)
constexpr int kPitch = kBlockK + 16;  // bytes per staged row (see the note above)
constexpr int kCPitch = kBN + 4;      // f32 per staged output row
constexpr int kMaxSmem = 232448;      // opt-in shared memory per block on sm_90

struct Geom {
  int h, w, cin, cout, s, k, dil, pad;
};

// Shared memory: two stages of (slab + k weight tiles), at least the staged
// f32 output tile.  Byte counts.
struct Smem {
  int a_stage, stage, bytes;
};
__host__ __device__ inline Smem smem_layout(int k, int pad) {
  Smem m;
  m.a_stage = (kRowBM + 2 * pad) * kPitch;
  m.stage = m.a_stage + k * kBN * kPitch;
  const int ring = 2 * m.stage;
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

// Four 8x8 b16 tiles (8 rows of 16 bytes each); lane l gives the address of
// row l%8 of tile l/8 and receives, per tile, 4 bytes of row l/4.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr));
}

// d += a (16x32, row) * b (32x8, col), int8 operands, int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1)
sparse_conv_q_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ vals_k,
                     const int* __restrict__ rows, const float* __restrict__ w_scale,
                     const float* __restrict__ x_scale, float* __restrict__ out, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm = smem_layout(g.k, g.pad);

  const int nmb = g.cout / kBN;
  const int segs = (g.w + kRowBM - 1) / kRowBM;  // row segments per image row
  const long long tile = blockIdx.x / nmb;
  const int jb = blockIdx.x % nmb;
  const long long row = tile / segs;             // n * h + i
  const int j0 = static_cast<int>(tile % segs) * kRowBM;
  const int i = static_cast<int>(row % g.h);
  const long long img_row0 = row - i;            // n * h
  const int img = static_cast<int>(row / g.h);
  const int tid = threadIdx.x;
  const int steps = g.k * g.s;
  const int slab = kRowBM + 2 * g.pad;           // slab pixels
  // vals_k[jb] is (k*k*S, 128 out, 128 in); tile (t*S + s) of it
  const long long tiles_jb = static_cast<long long>(jb) * g.k * g.k * g.s;

  // stage `step` = (kernel row p, support slot s) into `slot`
  auto load_stage = [&](int slot, int step) {
    const int p = step / g.s;
    const int s = step - p * g.s;
    unsigned char* a = smem + slot * sm.stage;
    unsigned char* b = a + sm.a_stage;
    const int ii = i + p * g.dil - g.pad;
    const bool row_ok = ii >= 0 && ii < g.h;
    const long long xrow = ((img_row0 + ii) * g.w) * g.cin +
                           static_cast<long long>(__ldg(rows + jb * g.s + s)) * kBlockK;
    for (int idx = tid; idx < slab * 8; idx += kThreads) {
      const int r = idx >> 3;
      const int c = idx & 7;
      const int j = j0 - g.pad + r;
      const bool ok = row_ok && j >= 0 && j < g.w;
      const int8_t* src = ok ? x + xrow + static_cast<long long>(j) * g.cin + c * 16 : x;
      cp_async_16(a + r * kPitch + c * 16, src, ok ? 16 : 0);
    }
    for (int idx = tid; idx < g.k * kBN * 8; idx += kThreads) {
      const int q = idx / (kBN * 8);
      const int o = (idx >> 3) % kBN;
      const int c = idx & 7;
      const long long t = tiles_jb + static_cast<long long>(p * g.k + q) * g.s + s;
      cp_async_16(b + (q * kBN + o) * kPitch + c * 16,
                  vals_k + (t * kBN + o) * kBlockK + c * 16, 16);
    }
  };

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // pixels wm*64 .. +64
  const int wn = warp & 1;   // channels wn*64 .. +64
  // ldmatrix row addresses of this lane.  A tiles: (rows 0-7, k 0-15), (rows
  // 8-15, k 0-15), (rows 0-7, k 16-31), (rows 8-15, k 16-31) = a0..a3 of
  // m16n8k32.  B tiles: (n-tile 0, k 0-15), (n-tile 0, k 16-31), (n-tile 1,
  // k 0-15), (n-tile 1, k 16-31) = b0, b1 of two n8 tiles.
  const int a_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + (lane >> 4) * 16;
  const int b_lane = ((lane & 7) + (lane >> 4) * 8) * kPitch + ((lane >> 3) & 1) * 16;

  int acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  load_stage(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    cp_async_wait_all();
    __syncthreads();  // step landed for all threads; the other slot is free
    if (step + 1 < steps) load_stage((step + 1) & 1, step + 1);
    cp_async_commit();
    const unsigned char* a = smem + (step & 1) * sm.stage;
    const unsigned char* b = a + sm.a_stage;
    for (int q = 0; q < g.k; ++q) {
      const unsigned char* aq = a + (wm * 64 + q * g.dil) * kPitch + a_lane;
      const unsigned char* bq = b + (q * kBN + wn * 64) * kPitch + b_lane;
#pragma unroll
      for (int kk = 0; kk < kBlockK; kk += 32) {
        unsigned fa[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(fa[mt], aq + mt * 16 * kPitch + kk);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned fb[4];
          ldmatrix_x4(fb, bq + np * 16 * kPitch + kk);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma_s8(acc[mt][2 * np], fa[mt], fb[0], fb[1]);
            mma_s8(acc[mt][2 * np + 1], fa[mt], fb[2], fb[3]);
          }
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the ring before it becomes the C tile

  float* sC = reinterpret_cast<float*>(smem);
  const float xs = __ldg(x_scale + img);
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = wn * 64 + nt * 8 + 2 * tig;
    const float s0 = __fmul_rn(xs, __ldg(w_scale + jb * kBN + col));
    const float s1 = __fmul_rn(xs, __ldg(w_scale + jb * kBN + col + 1));
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = wm * 64 + mt * 16 + gid;
      *reinterpret_cast<float2*>(sC + r * kCPitch + col) =
          make_float2(__fmul_rn(__int2float_rn(acc[mt][nt][0]), s0),
                      __fmul_rn(__int2float_rn(acc[mt][nt][1]), s1));
      *reinterpret_cast<float2*>(sC + (r + 8) * kCPitch + col) =
          make_float2(__fmul_rn(__int2float_rn(acc[mt][nt][2]), s0),
                      __fmul_rn(__int2float_rn(acc[mt][nt][3]), s1));
    }
  }
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

}  // namespace

extern "C" int tpuseg_sparse_conv_q(const void* x, const void* vals_k, const void* rows,
                                    const void* w_scale, const void* x_scale, void* out,
                                    int n, int h, int w, int cin, int cout, int s, int k,
                                    int dil, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || s <= 0 || k <= 0 || (k & 1) == 0 || dil <= 0 ||
      cin <= 0 || cin % kBlockK != 0 || cout <= 0 || cout % kBN != 0 ||
      ((uintptr_t)x & 15u) != 0 || ((uintptr_t)vals_k & 15u) != 0 ||
      ((uintptr_t)out & 15u) != 0 || ((uintptr_t)rows & 3u) != 0 ||
      ((uintptr_t)w_scale & 3u) != 0 || ((uintptr_t)x_scale & 3u) != 0) {
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
  const long long ctas = static_cast<long long>(n) * h * ((w + kRowBM - 1) / kRowBM) *
                         (cout / kBN);
  const Smem sm = smem_layout(k, g.pad);
  if (ctas > 0x7fffffffLL || sm.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      sparse_conv_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm.bytes);
  if (e != cudaSuccess) return (int)e;
  sparse_conv_q_kernel<<<dim3(static_cast<unsigned>(ctas)), dim3(kThreads), sm.bytes,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(vals_k),
      static_cast<const int*>(rows), static_cast<const float*>(w_scale),
      static_cast<const float*>(x_scale), static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}
