// I420 -> RGB for the yuv420 transport, for Hopper (sm_90a).
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
// it), rounded half to even (rintf), clipped to [0, 255].  Design: one thread
// a horizontal pair of pixels (they share U and V): 2 + 2 bytes in, 6 out.
// Bound: 4.5 bytes a pixel, 22.5 us for 8 frames of 1024x2048 at 3.35 TB/s.
//
// C interface (ctypes): returns the cudaError_t of its launch (0 on success);
// it launches on the given stream, does not synchronize and allocates
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint8_t to_u8(float v) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

__global__ void i420_to_rgb_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                                   int n, int h, int w) {
  const int pairs = w / 2;
  const long long per_frame = static_cast<long long>(h) * pairs;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= per_frame * n) return;
  const long long b = idx / per_frame;
  const int rem = static_cast<int>(idx % per_frame);
  const int y = rem / pairs, xp = rem % pairs;
  const long long plane = static_cast<long long>(h) * w;
  const uint8_t* f = in + b * (plane + plane / 2);
  const long long c = static_cast<long long>(y / 2) * pairs + xp;
  const float u = static_cast<float>(f[plane + c]) - 128.0f;
  const float v = static_cast<float>(f[plane + plane / 4 + c]) - 128.0f;
  const float dr = __fmul_rn(1.402f, v);
  const float gu = __fmul_rn(0.344136f, u), gv = __fmul_rn(0.714136f, v);
  const float db = __fmul_rn(1.772f, u);
  uint8_t* o = out + (b * h + y) * static_cast<long long>(w) * 3 + 6LL * xp;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float yv = static_cast<float>(f[static_cast<long long>(y) * w + 2 * xp + j]);
    o[3 * j] = to_u8(__fadd_rn(yv, dr));
    o[3 * j + 1] = to_u8(__fsub_rn(__fsub_rn(yv, gu), gv));
    o[3 * j + 2] = to_u8(__fadd_rn(yv, db));
  }
}

}  // namespace

// in (n, h*3/2, w) uint8 -> out (n, h, w*3) uint8; h % 4 == 0, w % 2 == 0.
extern "C" int tpuseg_i420_to_rgb(const void* in, void* out, int n, int h, int w, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || h % 4 != 0 || w % 2 != 0 || in == nullptr ||
      out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = static_cast<long long>(n) * h * (w / 2);
  const long long blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  i420_to_rgb_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, h, w);
  return (int)cudaGetLastError();
}
