// Block motion estimation and id warping for temporal serving, for Hopper
// (sm_90a).
//
// Replaces XLA work of tpuseg/video/flow.py (no Pallas kernel there), which
// the interval and budgeted modes run with --temporal-warp:
//
// K6, estimate_block_shifts (:82-142): per (frame, block) of the pooled luma
// (B, hs, ws) f32, the SAD of the block against each of the (2r+1)^2 shifts
// of the keyframe luma, edge-replicated at the border:
//   sad[o] = sum_{y,x in block} |cur[y, x] - key[clamp(y + oy - r), clamp(x + ox - r)]|
// (o = oy * (2r+1) + ox); best = the first o of the least sad (jnp.argmin;
// NaN before any number, as torch.argmin); accepted where
// sad[best] < f32(0.7) * sad[centre], else (0, 0); returns dy = r - oy,
// dx = r - ox as int32 (B, hs/block, ws/block).
// Design: a CTA takes a run of up to kRunPixels / block blocks of one block
// row (8 at the serving grid: 288 threads, 9 full warps).  It stages the
// run's key window (block + 2r rows, row pitch = 4 mod 32 words, interior
// rows as float4, only the frame border clamped) and its current blocks in
// shared memory.  Thread (g, oy, q) sums, for block g of the run and window
// row offset oy, the rows y = q, q + 4, ... of the block: for each row, 4
// columns at a time (one float4 of cur and ceil((4 + 2r) / 4) float4 of the
// window), all 2r+1 column shifts ox at once into 2r+1 register sums, so
// every (pixel, shift) costs an FADD and an FADD of |.|.  The four threads
// q = 0..3 of a (g, oy) are neighbouring lanes and combine their sums with
// two shuffles: sad = (s0 + s1) + (s2 + s3), each s_q summed over its rows in
// order and each row left to right.  The argmin is one warp a block: each
// lane takes the first least of sad[lane], sad[lane + 32], ..., and five
// shuffle steps keep the lesser (sad, o), the lower o on ties.
// On integer luma (the decode size equal to the target grid) every |d| and
// every partial sum is an exact integer below 2^24 at block <= 16
// (256 * 48,960 = 12.5 M), so any order gives the plain version's bits; at
// block 32 the largest luma (1024 * 48,960 > 2^24) is no longer exact, and
// resized luma sums in this kernel's order.
// Bound: 2 f32 instructions a (pixel, shift), 81 x 2 x 1.05 M at (32, 128,
// 256), 5.1 us at 132 SMs x 128 lanes x 1.98 GHz; the 8 MB read under it.
// On an H100 (700 W) the serving shape takes ~14 us: the 512 CTAs run as one
// wave, so the launch and argmin (~3 us, timed without staging or sums) and
// the staging (~3.3 us) do not overlap the sums (~8 us).
//
// K7, warp_ids (:145-206): tpuseg's two separable roll + select passes as
// one gather per pixel:
//   xs = x - dx(y, x) * scale where dx(y, x) is a nonzero shift in [-r, r]
//        whose source column is in the frame, else x;
//   out[y, x] = key[y - dy(y, xs) * scale, xs] under the same rule for rows,
//               else key[y, xs]
// with (dy, dx)(y, x) the shifts of the block (y / (scale * block),
// x / (scale * block)).
// Design: a CTA owns a band of kBandRows = 2 whole rows of one frame, inside
// one block row (grid (h / 2, B)); it loads the block row's dx and dy into
// shared memory once, so no thread loads a shift from global memory.
// Where scale % 8 == 0, w % 16 == 0 and key and out are 16-byte aligned, each
// thread writes 16-byte vectors, one column of them down the band's rows:
// each 8-byte half of a vector takes its own xs and source dy (a half never
// straddles a block, and moves in or out of the frame whole, since shifts
// move by multiples of 8), computed once for the column; then every row's
// two 8-byte loads go out before any store, 32 bytes a thread in flight
// (on an H100, 8-row bands measured 2-4 % slower at the serving shape, 1-,
// 4- and 16-row bands slower too, and one 16-byte load where the halves'
// sources are contiguous and aligned no faster).  Any other call takes a byte path on the same kind of
// grid (bands of 2 rows, 1 where scale * block is odd).  Rows, columns and
// the frame come from the block and thread indices in 32-bit arithmetic;
// only the frame's offset is a 64-bit multiply.  Bound: the ids read and
// written once, 2 bytes a pixel, 40 us for (32, 1024, 2048) at 3.35 TB/s.
//
// C interface (ctypes): each returns the cudaError_t of its launch (0 on
// success); it launches on the given stream, does not synchronize and
// allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kMaxRadius = 7;
constexpr int kMaxBlock = 32;
constexpr int kRowGroups = 4;     // threads that share one (block, oy)'s rows
constexpr int kShiftLanes = 288;  // most threads a K6 CTA
constexpr int kRunPixels = 128;   // a K6 CTA's blocks span at most this many luma columns
constexpr int kBandRows = 2;      // rows of a K7 band (and of a thread) on the vector path
constexpr int kMaxSmem = 227 * 1024;

template <bool V4>
__device__ __forceinline__ void load4(float* dst, const float* src) {
  if (V4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else {
    dst[0] = src[0], dst[1] = src[1], dst[2] = src[2], dst[3] = src[3];
  }
}

// One luma row segment into shared memory: `n4` groups of 4 columns from
// global column x0, clamped into [0, ws); float4 loads where a group lies in
// the row and `vec` says the row is 16-byte aligned there.
__device__ __forceinline__ void stage_row(float* dst, const float* row, int x0, int n4, int ws,
                                          bool vec, int lane, int stride) {
  for (int c = lane; c < n4; c += stride) {
    const int x = x0 + 4 * c;
    float4 v;
    if (vec && x >= 0 && x + 3 < ws) {
      v = __ldg(reinterpret_cast<const float4*>(row + x));
    } else {
      v.x = __ldg(row + min(max(x, 0), ws - 1));
      v.y = __ldg(row + min(max(x + 1, 0), ws - 1));
      v.z = __ldg(row + min(max(x + 2, 0), ws - 1));
      v.w = __ldg(row + min(max(x + 3, 0), ws - 1));
    }
    *reinterpret_cast<float4*>(dst + 4 * c) = v;
  }
}

// (a, ia) before (b, ib) in torch.argmin's order: NaN first, then the least
// value, then the lower index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (na) return ia < ib;
  return a < b || (a == b && ia < ib);
}

template <int R, bool V4>
__global__ void __launch_bounds__(kShiftLanes)
block_shifts_kernel(const float* __restrict__ key, const float* __restrict__ cur, int hs, int ws,
                    int block, int run, int pw, int pc, float accept_frac,
                    int* __restrict__ dy, int* __restrict__ dx) {
  constexpr int K = 2 * R + 1;
  constexpr int WV = (4 + 2 * R + 3) / 4;  // float4s of window a 4-column step reads
  extern __shared__ __align__(16) float smem[];
  const int wn = block + 2 * R;
  float* win = smem;               // wn rows x pw: key columns from bx0 * block - R
  float* cur_s = win + wn * pw;    // block rows x pc: cur columns from bx0 * block
  float* sad = cur_s + block * pc;  // run x K * K
  const int nbx = ws / block, by = blockIdx.y, b = blockIdx.z;
  const int bx0 = blockIdx.x * run, nrun = min(run, nbx - bx0);
  const float* keyf = key + static_cast<size_t>(b) * hs * ws;
  const float* curf = cur + static_cast<size_t>(b) * hs * ws;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  // stage the columns the sums read (not the pitch's padding): a warp a row,
  // its lanes along the row
  const bool vec = V4 && ws % 4 == 0 && R % 4 == 0;
  const int cur4 = ((run - 1) * block + ((block + 3) & ~3) + 3) / 4, win4 = cur4 - 1 + WV;
  for (int r = warp; r < wn; r += nwarps) {
    const int ky = min(max(by * block + r - R, 0), hs - 1);
    stage_row(win + r * pw, keyf + static_cast<size_t>(ky) * ws, bx0 * block - R, win4, ws, vec,
              lane, 32);
  }
  for (int r = warp; r < block; r += nwarps) {
    stage_row(cur_s + r * pc, curf + static_cast<size_t>(by * block + r) * ws, bx0 * block,
              cur4, ws, V4 && ws % 4 == 0, lane, 32);
  }
  __syncthreads();

  // sums: thread (g, oy, q), q the fastest
  const int q = tid % kRowGroups, unit = tid / kRowGroups;
  const int g = unit / K, oy = unit - g * K;
  float acc[K];
#pragma unroll
  for (int ox = 0; ox < K; ++ox) acc[ox] = 0.0f;
  if (g < nrun) {
    for (int y = q; y < block; y += kRowGroups) {
      const float* crow = cur_s + y * pc + g * block;
      const float* wrow = win + (y + oy) * pw + g * block;
      for (int x = 0; x < block; x += 4) {
        float c[4], w[4 * WV];
        load4<V4>(c, crow + x);
#pragma unroll
        for (int i = 0; i < WV; ++i) load4<V4>(w + 4 * i, wrow + x + 4 * i);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (V4 || x + j < block) {
#pragma unroll
            for (int ox = 0; ox < K; ++ox) {
              acc[ox] = __fadd_rn(acc[ox], fabsf(__fsub_rn(c[j], w[j + ox])));
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int ox = 0; ox < K; ++ox) {
    acc[ox] = __fadd_rn(acc[ox], __shfl_xor_sync(0xffffffffu, acc[ox], 1));
    acc[ox] = __fadd_rn(acc[ox], __shfl_xor_sync(0xffffffffu, acc[ox], 2));
  }
  if (q == 0 && g < nrun) {
#pragma unroll
    for (int ox = 0; ox < K; ++ox) sad[(g * K + oy) * K + ox] = acc[ox];
  }
  __syncthreads();

  // argmin: one warp a block
  for (int gb = warp; gb < nrun; gb += nwarps) {
    const float* s = sad + gb * K * K;
    float v = INFINITY;
    int o = INT_MAX;
    for (int i = lane; i < K * K; i += 32) {
      if (before(s[i], i, v, o)) v = s[i], o = i;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oo = __shfl_xor_sync(0xffffffffu, o, off);
      if (before(ov, oo, v, o)) v = ov, o = oo;
    }
    if (lane == 0) {
      const bool accept = v < __fmul_rn(accept_frac, s[R * K + R]);
      const size_t out = (static_cast<size_t>(b) * gridDim.y + by) * nbx + bx0 + gb;
      dy[out] = accept ? R - o / K : 0;
      dx[out] = accept ? R - o % K : 0;
    }
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The least p >= need with p = 4 mod 32 (words): eight float4 rows read at
// one column by a quarter warp land in distinct banks.
int row_pitch(int need) { return need + ((4 - need % 32) % 32 + 32) % 32; }

template <int R>
int launch_block_shifts(const float* key, const float* cur, int n, int hs, int ws, int block,
                        float accept_frac, int* dy, int* dx, cudaStream_t st) {
  constexpr int K = 2 * R + 1, WV = (4 + 2 * R + 3) / 4;
  const int nbx = ws / block, bw = round_up(block, 4);
  const int run = std::min(std::min(nbx, kShiftLanes / (kRowGroups * K)), kRunPixels / block);
  const int threads = round_up(run * K * kRowGroups, 32);
  const int pw = row_pitch(round_up(
      std::max(run * block + 2 * R, (run - 1) * block + bw - 4 + 4 * WV), 4));
  const int pc = row_pitch(round_up((run - 1) * block + bw, 4));
  const size_t smem = sizeof(float) * ((block + 2 * R) * pw + block * pc + run * K * K);
  const dim3 grid((nbx + run - 1) / run, hs / block, n);
  const bool v4 = block % 4 == 0 && (reinterpret_cast<uintptr_t>(key) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(cur) & 15) == 0;
  auto kernel = v4 ? block_shifts_kernel<R, true> : block_shifts_kernel<R, false>;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, st>>>(key, cur, hs, ws, block, run, pw, pc, accept_frac, dy, dx);
  return (int)cudaGetLastError();
}

// The pixel offset tpuseg's rule moves pos by for shift s: s * scale where s
// is nonzero, within the radius and its source lies in [0, extent), else 0.
__device__ __forceinline__ int source_offset(int s, int pos, int scale, int extent, int radius) {
  const int src = pos - s * scale;
  return (s != 0 && s >= -radius && s <= radius && src >= 0 && src < extent) ? s * scale : 0;
}

// The band's block row of dx (shifts[0, nbx)) and dy (shifts[nbx, 2 nbx)).
__device__ __forceinline__ void stage_shifts(int* shifts, const int* __restrict__ dy,
                                             const int* __restrict__ dx, int b, int by, int nby,
                                             int nbx) {
  const size_t row = (static_cast<size_t>(b) * nby + by) * nbx;
  for (int i = threadIdx.x; i < nbx; i += blockDim.x) {
    shifts[i] = __ldg(dx + row + i);
    shifts[nbx + i] = __ldg(dy + row + i);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(128)
warp_ids_vec_kernel(const uint8_t* __restrict__ key, const int* __restrict__ dy,
                    const int* __restrict__ dx, uint8_t* __restrict__ out, int h, int w,
                    int scale, int up, int radius) {
  extern __shared__ int shifts[];
  const int nbx = w / up, y0 = blockIdx.x * kBandRows, b = blockIdx.y;
  stage_shifts(shifts, dy, dx, b, y0 / up, h / up, nbx);
  const size_t frame = static_cast<size_t>(b) * h * w;
  const uint8_t* keyf = key + frame;
  uint8_t* outf = out + frame + static_cast<size_t>(y0) * w;
  for (int v = threadIdx.x; v < w / 16; v += blockDim.x) {
    int xs[2], sy[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = 16 * v + 8 * half;
      xs[half] = x - source_offset(shifts[x / up], x, scale, w, radius);
      sy[half] = shifts[nbx + xs[half] / up];
    }
    uint4 vals[kBandRows];
#pragma unroll
    for (int j = 0; j < kBandRows; ++j) {
      const int y = y0 + j;
      const int ys0 = y - source_offset(sy[0], y, scale, h, radius);
      const int ys1 = y - source_offset(sy[1], y, scale, h, radius);
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(keyf + static_cast<size_t>(ys0) * w +
                                                           xs[0]));
      const uint2 c = __ldg(reinterpret_cast<const uint2*>(keyf + static_cast<size_t>(ys1) * w +
                                                           xs[1]));
      vals[j] = make_uint4(a.x, a.y, c.x, c.y);
    }
#pragma unroll
    for (int j = 0; j < kBandRows; ++j) {
      *reinterpret_cast<uint4*>(outf + static_cast<size_t>(j) * w + 16 * v) = vals[j];
    }
  }
}

__global__ void __launch_bounds__(256)
warp_ids_byte_kernel(const uint8_t* __restrict__ key, const int* __restrict__ dy,
                     const int* __restrict__ dx, uint8_t* __restrict__ out, int h, int w,
                     int scale, int up, int radius, int rows) {
  extern __shared__ int shifts[];
  const int nbx = w / up, y0 = blockIdx.x * rows, b = blockIdx.y;
  stage_shifts(shifts, dy, dx, b, y0 / up, h / up, nbx);
  const size_t frame = static_cast<size_t>(b) * h * w;
  const uint8_t* keyf = key + frame;
  uint8_t* outf = out + frame + static_cast<size_t>(y0) * w;
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    const int xs = x - source_offset(shifts[x / up], x, scale, w, radius);
    const int sy = shifts[nbx + xs / up];
    for (int j = 0; j < rows; ++j) {
      const int y = y0 + j;
      outf[static_cast<size_t>(j) * w + x] =
          __ldg(keyf + static_cast<size_t>(y - source_offset(sy, y, scale, h, radius)) * w + xs);
    }
  }
}

bool aligned(const void* p, uintptr_t a) { return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0; }

}  // namespace

// key, cur (n, hs, ws) f32 -> dy, dx (n, hs / block, ws / block) int32.
extern "C" int tpuseg_block_shifts(const void* key, const void* cur, void* dy, void* dx, int n,
                                   int hs, int ws, int radius, int block, float accept_frac,
                                   void* stream) {
  if (n <= 0 || hs <= 0 || ws <= 0 || radius < 0 || radius > kMaxRadius || block <= 0 ||
      block > kMaxBlock || hs % block != 0 || ws % block != 0 || n > 65535 ||
      hs / block > 65535 || !aligned(key, 4) || !aligned(cur, 4) || !aligned(dy, 4) ||
      !aligned(dx, 4) || key == nullptr || cur == nullptr || dy == nullptr || dx == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const float* k = static_cast<const float*>(key);
  const float* c = static_cast<const float*>(cur);
  int* y = static_cast<int*>(dy);
  int* x = static_cast<int*>(dx);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (radius) {
    case 0: return launch_block_shifts<0>(k, c, n, hs, ws, block, accept_frac, y, x, st);
    case 1: return launch_block_shifts<1>(k, c, n, hs, ws, block, accept_frac, y, x, st);
    case 2: return launch_block_shifts<2>(k, c, n, hs, ws, block, accept_frac, y, x, st);
    case 3: return launch_block_shifts<3>(k, c, n, hs, ws, block, accept_frac, y, x, st);
    case 4: return launch_block_shifts<4>(k, c, n, hs, ws, block, accept_frac, y, x, st);
    case 5: return launch_block_shifts<5>(k, c, n, hs, ws, block, accept_frac, y, x, st);
    case 6: return launch_block_shifts<6>(k, c, n, hs, ws, block, accept_frac, y, x, st);
    default: return launch_block_shifts<7>(k, c, n, hs, ws, block, accept_frac, y, x, st);
  }
}

// key (n, h, w) uint8, dy/dx (n, h / (scale*block), w / (scale*block)) int32
// -> out (n, h, w) uint8.  A block row of shifts must fit in shared memory
// (w / (scale * block) <= 29,056).
extern "C" int tpuseg_warp_ids(const void* key, const void* dy, const void* dx, void* out, int n,
                               int h, int w, int scale, int block, int radius, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || scale <= 0 || block <= 0 || radius < 0 || n > 65535 ||
      key == nullptr || out == nullptr || !aligned(dy, 4) || !aligned(dx, 4) || dy == nullptr ||
      dx == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long long up_ll = static_cast<long long>(scale) * block;
  if (h % up_ll != 0 || w % up_ll != 0) return (int)cudaErrorInvalidValue;
  const int up = static_cast<int>(up_ll), nbx = w / up;
  const size_t smem = 2 * sizeof(int) * static_cast<size_t>(nbx);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* k = static_cast<const uint8_t*>(key);
  const int* sy = static_cast<const int*>(dy);
  const int* sx = static_cast<const int*>(dx);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (scale % 8 == 0 && w % 16 == 0 && aligned(key, 16) && aligned(out, 16)) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          warp_ids_vec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(h / kBandRows, n);
    warp_ids_vec_kernel<<<grid, std::min(128, round_up(w / 16, 32)), smem, st>>>(
        k, sy, sx, o, h, w, scale, up, radius);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          warp_ids_byte_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int rows = std::min(kBandRows, up & -up);
    const dim3 grid(h / rows, n);
    warp_ids_byte_kernel<<<grid, std::min(256, round_up(w, 32)), smem, st>>>(
        k, sy, sx, o, h, w, scale, up, radius, rows);
  }
  return (int)cudaGetLastError();
}
