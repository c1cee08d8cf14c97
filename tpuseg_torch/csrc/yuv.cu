// I420 -> RGB for the yuv420 transport, for Hopper (sm_90a): kernel K8.
//
// Replaces XLA work of tpuseg/video/yuv.py::i420_to_rgb_flat (:77-99; no
// Pallas kernel there), the first step of every served batch under
// --transport yuv420.  Input (B, H*3/2, W) uint8: rows [0, H) are Y, the next
// H/4 rows hold the (H/2, W/2) U plane row-major, the last H/4 rows V.
// Output FLAT (B, H, W*3) uint8 RGB, full-range BT.601 with chroma repeated
// 2x2:
//   u = U - 128, v = V - 128 (exact in f32);
//   R = Y + 1.402 v;  G = (Y - 0.344136 u) - 0.714136 v;  B = Y + 1.772 u
// each product and sum rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn:
// no FMA contraction, as XLA on the CPU and PyTorch's separate ops compute
// it), rounded half to even, clipped to [0, 255].
//
// Design: a CTA takes one chroma row, that is two luma rows, of one frame
// (grid: column groups x H/2 x B), so row and frame come from blockIdx: no
// thread divides, offsets inside a frame are 32-bit and only the frame's
// offset is a 64-bit multiply.  Each U/V sample is loaded once and its four
// products are computed once for the 2x2 block it serves.
// - Vector path (W % 16 == 0, in and out 16-byte aligned; with H % 4 == 0
//   every frame, plane and row offset is then a multiple of 16, since
//   1.5*H*W and 3*W are): a thread takes 16 columns of both luma rows, two
//   16-byte Y loads and one 8-byte U and V load each, all issued before any
//   store, and writes 32 pixels as 96 bytes in 16-byte stores.  Lane t's 48
//   bytes a row lie at stride 48, so each warp stages its two rows in shared
//   memory (conflict-free: 16-byte accesses at stride 48 hit distinct banks
//   in each quarter warp) and stores them back contiguously, every store
//   instruction writing whole 32-byte sectors (on an H100 at 700 W, 28 %
//   faster than lane-strided 16-byte stores at (8, 1024x2048)).
// - Byte path (any other call: W % 16 != 0, a misaligned view): a thread a
//   chroma sample, its 2x2 block of Y bytes, 12 byte stores.
// Bytes to floats on the vector path: the byte goes into the mantissa of
// 2^23 (one PRMT) and 2^23 (2^23 + 128 for chroma) is subtracted, exactly.
// Floats to bytes: clip to [0, 255], then adding 1.5 * 2^23 rounds half to
// even into the low byte; the same as rint then clip, since rint is
// monotone and fixes 0 and 255.  No conversion-unit instruction on the
// vector path: ~20 issued instructions a pixel (on the same card rint,
// fmax, fmin and a convert were 7 % slower, cvt.rni.sat.u8.f32 no faster).
// Bound: 4.5 bytes a pixel, 22.5 us for 8 frames of 1024x2048 at 3.35 TB/s;
// on an H100 (700 W) that call takes ~28 us of device time (80 %), 32
// frames ~105 us (87 %).
// Limits: H/2 <= 65,535 and B <= 65,535 (the grid's y and z), 3*H*W < 2^31
// (32-bit offsets inside a frame); beyond them the entry returns
// cudaErrorInvalidValue.
//
// C interface (ctypes): returns the cudaError_t of its launch (0 on success);
// it launches on the given stream, does not synchronize and allocates
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kMaxGridYZ = 65535;  // the grid's y (H/2) and z (B)
constexpr int kVecThreads = 128;
constexpr int kByteThreads = 256;
constexpr float kLuma = 8388608.0f;     // 2^23
constexpr float kChroma = 8388736.0f;   // 2^23 + 128
constexpr float kRound = 12582912.0f;   // 1.5 * 2^23

// Byte i of `word` as an exact float less (bias - 2^23): the byte in the
// mantissa of 2^23, then `bias` subtracted.
__device__ __forceinline__ float byte_f(uint32_t word, int i, float bias) {
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | i)), bias);
}

// rint(v) clipped to [0, 255], in the low byte of the result.
__device__ __forceinline__ uint32_t u8_of(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, 0.0f), 255.0f), kRound));
}

// The low bytes of a, b, c, d as one word, a lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

struct Chroma {
  float dr, gu, gv, db;
};

__device__ __forceinline__ Chroma chroma(float u, float v) {
  return {__fmul_rn(1.402f, v), __fmul_rn(0.344136f, u), __fmul_rn(0.714136f, v),
          __fmul_rn(1.772f, u)};
}

// One pixel's R, G, B, each in the low byte of o[0..2].
__device__ __forceinline__ void rgb(float y, const Chroma& c, uint32_t* o) {
  o[0] = u8_of(__fadd_rn(y, c.dr));
  o[1] = u8_of(__fsub_rn(__fsub_rn(y, c.gu), c.gv));
  o[2] = u8_of(__fadd_rn(y, c.db));
}

__global__ void __launch_bounds__(kVecThreads)
i420_vec_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h, int w) {
  const int cy = blockIdx.y, b = blockIdx.z;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;  // this thread's 16 columns
  const int groups = w >> 4, plane = h * w;
  const uint8_t* f = in + static_cast<size_t>(b) * (plane + (plane >> 1));
  uint8_t* o = out + static_cast<size_t>(b) * (3 * plane) + 2 * cy * (3 * w);
  uint32_t words[2][12];  // both rows' 96 output bytes
  if (g < groups) {
    const uint4 ya = __ldg(reinterpret_cast<const uint4*>(f + 2 * cy * w + 16 * g));
    const uint4 yb = __ldg(reinterpret_cast<const uint4*>(f + (2 * cy + 1) * w + 16 * g));
    const int c = plane + cy * (w >> 1) + 8 * g;
    const uint2 uu = __ldg(reinterpret_cast<const uint2*>(f + c));
    const uint2 vv = __ldg(reinterpret_cast<const uint2*>(f + c + (plane >> 2)));
    Chroma cs[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cs[k] = chroma(byte_f(k < 4 ? uu.x : uu.y, k & 3, kChroma),
                     byte_f(k < 4 ? vv.x : vv.y, k & 3, kChroma));
    }
    const uint32_t ys[2][4] = {{ya.x, ya.y, ya.z, ya.w}, {yb.x, yb.y, yb.z, yb.w}};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t px[48];
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        rgb(byte_f(ys[j][p >> 2], p & 3, kLuma), cs[p >> 1], px + 3 * p);
      }
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        words[j][i] = pack4(px[4 * i], px[4 * i + 1], px[4 * i + 2], px[4 * i + 3]);
      }
    }
  }
  // Through shared memory: lane t's 16-byte chunks go in at 3t .. 3t + 2
  // and chunk lane + 32k comes out, so each store instruction writes
  // 512 contiguous bytes.
  __shared__ uint4 stage[kVecThreads / 32][2][96];  // a warp's two rows, 1.5 KB each
  const int lane = threadIdx.x & 31, g0 = g - lane;
  if (g0 >= groups) return;  // the whole warp is past the row's end
  uint4(*rows)[96] = stage[threadIdx.x >> 5];
  if (g < groups) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        rows[j][3 * lane + k] = make_uint4(words[j][4 * k], words[j][4 * k + 1],
                                           words[j][4 * k + 2], words[j][4 * k + 3]);
      }
    }
  }
  __syncwarp();
  const int chunks = 3 * min(32, groups - g0);  // the warp's 16-byte chunks a row
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int chunk = lane + 32 * k;
      if (chunk < chunks) {
        *reinterpret_cast<uint4*>(o + j * (3 * w) + 48 * g0 + 16 * chunk) = rows[j][chunk];
      }
    }
  }
}

__global__ void __launch_bounds__(kByteThreads)
i420_byte_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h, int w) {
  const int half = w >> 1;
  const int cx = blockIdx.x * blockDim.x + threadIdx.x;  // this thread's chroma column
  if (cx >= half) return;
  const int cy = blockIdx.y, b = blockIdx.z, plane = h * w;
  const uint8_t* f = in + static_cast<size_t>(b) * (plane + (plane >> 1));
  uint8_t* o = out + static_cast<size_t>(b) * (3 * plane) + 2 * cy * (3 * w) + 6 * cx;
  const int c = plane + cy * half + cx;
  const uint8_t* yr = f + 2 * cy * w + 2 * cx;
  const uint8_t ub = __ldg(f + c), vb = __ldg(f + c + (plane >> 2));
  const uint8_t ys[4] = {__ldg(yr), __ldg(yr + 1), __ldg(yr + w), __ldg(yr + w + 1)};
  const Chroma cs = chroma(static_cast<float>(ub) - 128.0f, static_cast<float>(vb) - 128.0f);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t px[3];
    rgb(static_cast<float>(ys[q]), cs, px);
    uint8_t* d = o + (q >> 1) * (3 * w) + 3 * (q & 1);
    d[0] = static_cast<uint8_t>(px[0]);
    d[1] = static_cast<uint8_t>(px[1]);
    d[2] = static_cast<uint8_t>(px[2]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// in (n, h*3/2, w) uint8 -> out (n, h, w*3) uint8; h % 4 == 0, w % 2 == 0,
// within the limits above.
extern "C" int tpuseg_i420_to_rgb(const void* in, void* out, int n, int h, int w, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || h % 4 != 0 || w % 2 != 0 || in == nullptr ||
      out == nullptr || n > kMaxGridYZ || h / 2 > kMaxGridYZ ||
      3LL * h * w > static_cast<long long>(INT_MAX)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (w % 16 == 0 && aligned16(in) && aligned16(out)) {
    const int groups = w / 16, threads = std::min(kVecThreads, (groups + 31) / 32 * 32);
    const dim3 grid((groups + threads - 1) / threads, h / 2, n);
    i420_vec_kernel<<<grid, threads, 0, st>>>(src, dst, h, w);
  } else {
    const int half = w / 2, threads = std::min(kByteThreads, (half + 31) / 32 * 32);
    const dim3 grid((half + threads - 1) / threads, h / 2, n);
    i420_byte_kernel<<<grid, threads, 0, st>>>(src, dst, h, w);
  }
  return (int)cudaGetLastError();
}
