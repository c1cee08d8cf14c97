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
// (o = oy * (2r+1) + ox); best = the first o of the least sad (jnp.argmin);
// accepted where sad[best] < f32(0.7) * sad[centre], else (0, 0); returns
// dy = r - oy, dx = r - ox as int32 (B, hs/block, ws/block).  Design: one CTA
// a (frame, block): the current block and the key window (block + 2r)^2 go to
// shared memory, thread o sums shift o's SAD in row-major order (exact on
// integer luma: each |d| and every partial sum is an integer below 2^24 at
// the serving grid); thread 0 takes the argmin.  At (32, 128, 256) the
// function reads 8 MB and does 81 x 2 x 1.05M f32 operations: a few
// microseconds at either rate, so launch and shared-memory latency set the
// pace.
//
// K7, warp_ids (:145-206): tpuseg's two separable roll + select passes as
// one gather per pixel:
//   xs = x - dx(y, x) * scale where dx(y, x) is a nonzero shift in [-r, r]
//        whose source column is in the frame, else x;
//   out[y, x] = key[y - dy(y, xs) * scale, xs] under the same rule for rows,
//               else key[y, xs]
// with (dy, dx)(y, x) the shifts of the block (y / (scale * block),
// x / (scale * block)).  Design: one thread a group of G output pixels of a
// row, G = 8 when scale is a multiple of 8 (every shift then moves whole
// 8-byte groups, which stay within one block and in or out of the frame
// together: one 8-byte load and store), else 1.  Bound: the ids read and
// written once, 2 bytes a pixel, 40 us for (32, 1024, 2048) at 3.35 TB/s.
//
// C interface (ctypes): each returns the cudaError_t of its launch (0 on
// success); it launches on the given stream, does not synchronize and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kShiftThreads = 128;
constexpr int kMaxRadius = 7;   // (2r+1)^2 <= kShiftThreads
constexpr int kMaxBlock = 32;

__global__ void __launch_bounds__(kShiftThreads)
block_shifts_kernel(const float* __restrict__ key, const float* __restrict__ cur, int hs, int ws,
                    int radius, int block, float accept_frac, int* __restrict__ dy,
                    int* __restrict__ dx) {
  extern __shared__ float smem[];
  const int k = 2 * radius + 1, wn = block + 2 * radius;
  float* cur_s = smem;                    // block * block
  float* win = cur_s + block * block;     // wn * wn
  float* sad = win + wn * wn;             // k * k
  const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
  const long long base = static_cast<long long>(b) * hs * ws;
  for (int i = threadIdx.x; i < block * block; i += kShiftThreads) {
    cur_s[i] = cur[base + static_cast<long long>(by * block + i / block) * ws + bx * block +
                   i % block];
  }
  for (int i = threadIdx.x; i < wn * wn; i += kShiftThreads) {
    const int ky = min(max(by * block + i / wn - radius, 0), hs - 1);
    const int kx = min(max(bx * block + i % wn - radius, 0), ws - 1);
    win[i] = key[base + static_cast<long long>(ky) * ws + kx];
  }
  __syncthreads();
  const int o = threadIdx.x;
  if (o < k * k) {
    const int oy = o / k, ox = o % k;
    float s = 0.0f;
    for (int y = 0; y < block; ++y) {
      const float* wrow = win + (y + oy) * wn + ox;
      const float* crow = cur_s + y * block;
      for (int x = 0; x < block; ++x) s = __fadd_rn(s, fabsf(__fsub_rn(crow[x], wrow[x])));
    }
    sad[o] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int best = 0;
  for (int i = 1; i < k * k; ++i) {
    if (sad[i] < sad[best]) best = i;
  }
  const bool accept = sad[best] < __fmul_rn(accept_frac, sad[radius * k + radius]);
  const long long out = (static_cast<long long>(b) * gridDim.y + by) * gridDim.x + bx;
  dy[out] = accept ? radius - best / k : 0;
  dx[out] = accept ? radius - best % k : 0;
}

template <int G>
struct Group;
template <>
struct Group<8> {
  using T = uint2;
};
template <>
struct Group<1> {
  using T = uint8_t;
};

__device__ __forceinline__ bool shift_ok(int s, int pos, int scale, int extent, int radius) {
  const int src = pos - s * scale;
  return s != 0 && s >= -radius && s <= radius && src >= 0 && src < extent;
}

template <int G>
__global__ void warp_ids_kernel(const uint8_t* __restrict__ key, const int* __restrict__ dy,
                                const int* __restrict__ dx, uint8_t* __restrict__ out, int n,
                                int h, int w, int scale, int up, int radius) {
  using T = typename Group<G>::T;
  const int groups = w / G;
  const long long total = static_cast<long long>(n) * h * groups;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int g = static_cast<int>(idx % groups);
  const long long row = idx / groups;  // b * h + y
  const int y = static_cast<int>(row % h), b = static_cast<int>(row / h);
  const int nbx = w / up, nby = h / up;
  const int* dyb = dy + static_cast<long long>(b) * nby * nbx;
  const int* dxb = dx + static_cast<long long>(b) * nby * nbx;
  const int x = g * G;
  const int sx = dxb[(y / up) * nbx + x / up];
  const int xs = shift_ok(sx, x, scale, w, radius) ? x - sx * scale : x;
  const int sy = dyb[(y / up) * nbx + xs / up];
  const int ys = shift_ok(sy, y, scale, h, radius) ? y - sy * scale : y;
  const uint8_t* src = key + (static_cast<long long>(b) * h + ys) * w + xs;
  uint8_t* dst = out + row * w + x;
  *reinterpret_cast<T*>(dst) = *reinterpret_cast<const T*>(src);
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
  const int k = 2 * radius + 1, wn = block + 2 * radius;
  const size_t smem = sizeof(float) * (block * block + wn * wn + k * k);
  const dim3 grid(ws / block, hs / block, n);
  block_shifts_kernel<<<grid, kShiftThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(key), static_cast<const float*>(cur), hs, ws, radius, block,
      accept_frac, static_cast<int*>(dy), static_cast<int*>(dx));
  return (int)cudaGetLastError();
}

// key (n, h, w) uint8, dy/dx (n, h / (scale*block), w / (scale*block)) int32
// -> out (n, h, w) uint8.
extern "C" int tpuseg_warp_ids(const void* key, const void* dy, const void* dx, void* out, int n,
                               int h, int w, int scale, int block, int radius, void* stream) {
  const int up = scale * block;
  if (n <= 0 || h <= 0 || w <= 0 || scale <= 0 || block <= 0 || radius < 0 || h % up != 0 ||
      w % up != 0 || key == nullptr || out == nullptr || !aligned(dy, 4) || !aligned(dx, 4) ||
      dy == nullptr || dx == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool wide = scale % 8 == 0 && aligned(key, 8) && aligned(out, 8);
  const int g = wide ? 8 : 1;
  const long long total = static_cast<long long>(n) * h * (w / g);
  const long long blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (wide) {
    warp_ids_kernel<8><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        static_cast<const uint8_t*>(key), static_cast<const int*>(dy),
        static_cast<const int*>(dx), static_cast<uint8_t*>(out), n, h, w, scale, up, radius);
  } else {
    warp_ids_kernel<1><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        static_cast<const uint8_t*>(key), static_cast<const int*>(dy),
        static_cast<const int*>(dx), static_cast<uint8_t*>(out), n, h, w, scale, up, radius);
  }
  return (int)cudaGetLastError();
}
