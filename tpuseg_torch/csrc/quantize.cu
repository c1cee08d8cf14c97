// Per-frame symmetric int8 quantization of an activation, for Hopper (sm_90a).
//
// Replaces the quantize step of tpuseg/ops/sparse_conv.py::fused_sparse_conv_apply_q
// (:1312-1324), which tpuseg runs in XLA outside its Pallas kernel, and with
// it the five PyTorch passes of tpuseg_torch/ops/sparse_conv.py
// quantize_activation_reference.  Same function, bit for bit:
//
//   xs[n] = max_nan(max |x[n]|, 1e-8) / 127     (dynamic; static: one given scale)
//   xq[n, p, c] = clamp(round_half_even(x[n, p, chan[c]] / xs[n]), -127, 127)
//
// x is (N, P, Cx) bf16 or f32, channels innermost; chan (Cq,) int32 picks the
// channels to quantize (CompactSparseQ's live channels), or is null for all
// of them (Cq = Cx); a negative entry of chan reads as 0, so chan = [0..47] +
// [-1] x 80 writes the int8 stem's conv0 operand, its 48 channels padded to
// the 128 that B3 takes, in this one pass (the padded bf16 copy is never
// made; a zero changes neither the absmax nor any other element's xq); xq is
// (N, P, Cq) int8.  Both divisions are IEEE
// (__fdiv_rn), as PyTorch's division by a tensor is: a reciprocal multiply
// differs in the last bit.
//
// Two kernels.  absmax: each block takes a slice of one frame, reduces max |x|
// as the uint32 bits of the magnitude (non-negative floats order as their
// bits; a NaN's bits sort above +inf, so a NaN propagates as in PyTorch's
// inf-norm), and folds it into absmax[n] with one atomicMax; the wrapper
// zeroes absmax first.  quantize: one read of x and one write of xq, 8
// elements (a 16-byte bf16 or two 16-byte f32 loads, an 8-byte store) per
// thread and step; each thread derives xs[n] from absmax[n] itself, and the
// first block of each frame writes it out.
//
// What bounds it on the H100: bytes.  At B3's serving input (32,128,256,512)
// bf16 the dynamic pair moves 2 + 2 + 1 bytes per element (x read twice: it
// is 1 GB, beyond L2), 2.7 GB, ~0.8 ms at 3.35 TB/s; the function itself
// needs 3 bytes per element.  The IEEE division costs ~20 instructions an
// element, below the memory time at these rates.
//
// C interface (ctypes): each returns the cudaError_t of its launch (0 on
// success); it launches on the given stream, does not synchronize and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;            // elements per thread and step
constexpr long long kBlocks = 4096;  // target blocks in the grid (~31 per SM)

// the 8 elements of vector v of frame `frame` (of `vecs`), as floats
template <typename T, bool kMap>
__device__ __forceinline__ void load8(const T* __restrict__ frame, const int* __restrict__ chan,
                                      int v, int cq8, int cx, float (&f)[kVec]);

template <>
__device__ __forceinline__ void load8<__nv_bfloat16, false>(const __nv_bfloat16* __restrict__ frame,
                                                           const int* __restrict__, int v, int,
                                                           int, float (&f)[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(frame) + v);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

template <>
__device__ __forceinline__ void load8<float, false>(const float* __restrict__ frame,
                                                   const int* __restrict__, int v, int, int,
                                                   float (&f)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(frame) + 2 * v);
  const float4 b = __ldg(reinterpret_cast<const float4*>(frame) + 2 * v + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <>
__device__ __forceinline__ void load8<__nv_bfloat16, true>(const __nv_bfloat16* __restrict__ frame,
                                                          const int* __restrict__ chan, int v,
                                                          int cq8, int cx, float (&f)[kVec]) {
  const int p = v / cq8;
  const int c = (v - p * cq8) * kVec;
  const __nv_bfloat16* px = frame + static_cast<long long>(p) * cx;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int ch = __ldg(chan + c + i);
    f[i] = ch < 0 ? 0.0f : to_f32(px[ch]);
  }
}

template <>
__device__ __forceinline__ void load8<float, true>(const float* __restrict__ frame,
                                                  const int* __restrict__ chan, int v, int cq8,
                                                  int cx, float (&f)[kVec]) {
  const int p = v / cq8;
  const int c = (v - p * cq8) * kVec;
  const float* px = frame + static_cast<long long>(p) * cx;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int ch = __ldg(chan + c + i);
    f[i] = ch < 0 ? 0.0f : __ldg(px + ch);
  }
}

struct Shape {
  long long pixels;  // P, per frame
  int cx, cq;
  int vecs;          // P * Cq / 8, per frame
};

template <typename T, bool kMap>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, const int* __restrict__ chan,
              unsigned* __restrict__ absmax, Shape s) {
  const int n = blockIdx.y;
  const T* frame = x + static_cast<long long>(n) * s.pixels * s.cx;
  unsigned m = 0;
  for (int v = blockIdx.x * kThreads + threadIdx.x; v < s.vecs; v += gridDim.x * kThreads) {
    float f[kVec];
    load8<T, kMap>(frame, chan, v, s.cq / kVec, s.cx, f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) m = max(m, __float_as_uint(f[i]) & 0x7fffffffu);
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) m = max(m, warp_max[i]);
    atomicMax(absmax + n, m);
  }
}

template <typename T, bool kMap>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, const int* __restrict__ chan,
                const unsigned* __restrict__ absmax, float static_scale,
                int8_t* __restrict__ xq, float* __restrict__ xs, Shape s) {
  const int n = blockIdx.y;
  float scale = static_scale;
  if (absmax != nullptr) {
    const float a = __uint_as_float(__ldg(absmax + n));
    scale = __fdiv_rn(a != a ? a : fmaxf(a, 1e-8f), 127.0f);  // max that keeps a NaN
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) xs[n] = scale;
  const T* frame = x + static_cast<long long>(n) * s.pixels * s.cx;
  uint2* out = reinterpret_cast<uint2*>(xq + static_cast<long long>(n) * s.pixels * s.cq);
  for (int v = blockIdx.x * kThreads + threadIdx.x; v < s.vecs; v += gridDim.x * kThreads) {
    float f[kVec];
    load8<T, kMap>(frame, chan, v, s.cq / kVec, s.cx, f);
    unsigned w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int q = min(max(__float2int_rn(__fdiv_rn(f[i], scale)), -127), 127);
      w[i >> 2] |= (static_cast<unsigned>(q) & 0xffu) << (8 * (i & 3));
    }
    out[v] = make_uint2(w[0], w[1]);
  }
}

// The grid for n frames of s.vecs vectors; false where the shape does not fit.
bool plan_grid(int n, long long pixels, int cx, int cq, const void* chan, Shape* s,
               dim3* grid) {
  if (n <= 0 || n > 65535 || pixels <= 0 || cx <= 0 || cq <= 0 || cq % kVec != 0 ||
      (chan == nullptr && (cq != cx || cx % kVec != 0))) {
    return false;
  }
  const long long vecs = pixels * cq / kVec;
  if (vecs > 0x7fffffffLL) return false;
  s->pixels = pixels;
  s->cx = cx;
  s->cq = cq;
  s->vecs = static_cast<int>(vecs);
  const long long per_frame = (kBlocks + n - 1) / n;
  const long long need = (vecs + kThreads - 1) / kThreads;
  *grid = dim3(static_cast<unsigned>(need < per_frame ? need : per_frame), n);
  return true;
}

template <typename T>
void launch_absmax(const void* x, const int* chan, unsigned* absmax, const Shape& s, dim3 grid,
                   cudaStream_t st) {
  if (chan != nullptr)
    absmax_kernel<T, true><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), chan, absmax, s);
  else
    absmax_kernel<T, false><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), chan, absmax, s);
}

template <typename T>
void launch_quantize(const void* x, const int* chan, const unsigned* absmax, float scale,
                     int8_t* xq, float* xs, const Shape& s, dim3 grid, cudaStream_t st) {
  if (chan != nullptr)
    quantize_kernel<T, true><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), chan, absmax,
                                                        scale, xq, xs, s);
  else
    quantize_kernel<T, false><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), chan, absmax,
                                                         scale, xq, xs, s);
}

bool aligned(const void* p, uintptr_t a) { return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0; }

}  // namespace

// x (n, pixels, cx) f32 (dtype 0) or bf16 (1); chan (cq,) int32 (negative: 0) or null;
// absmax (n,) uint32, zeroed by the caller: absmax[f] = max over the frame's
// (mapped) elements of the bits of |x|.
extern "C" int tpuseg_absmax(const void* x, const void* chan, void* absmax, int n,
                             long long pixels, int cx, int cq, int dtype, void* stream) {
  Shape s;
  dim3 grid;
  if (!plan_grid(n, pixels, cx, cq, chan, &s, &grid) || !aligned(x, 16) || !aligned(chan, 4) ||
      !aligned(absmax, 4) || absmax == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(chan);
  unsigned* a = static_cast<unsigned*>(absmax);
  if (dtype == 1) {
    launch_absmax<__nv_bfloat16>(x, c, a, s, grid, st);
  } else if (dtype == 0) {
    launch_absmax<float>(x, c, a, s, grid, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// xq (n, pixels, cq) int8 and xs (n,) f32 from x: the scale from absmax (the
// output of tpuseg_absmax on the same x), or static_scale where absmax is null.
extern "C" int tpuseg_quantize(const void* x, const void* chan, const void* absmax,
                               float static_scale, void* xq, void* xs, int n, long long pixels,
                               int cx, int cq, int dtype, void* stream) {
  Shape s;
  dim3 grid;
  if (!plan_grid(n, pixels, cx, cq, chan, &s, &grid) || !aligned(x, 16) || !aligned(chan, 4) ||
      !aligned(absmax, 4) || !aligned(xq, 8) || !aligned(xs, 4)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(chan);
  const unsigned* a = static_cast<const unsigned*>(absmax);
  int8_t* q = static_cast<int8_t*>(xq);
  float* f = static_cast<float*>(xs);
  if (dtype == 1) {
    launch_quantize<__nv_bfloat16>(x, c, a, static_scale, q, f, s, grid, st);
  } else if (dtype == 0) {
    launch_quantize<float>(x, c, a, static_scale, q, f, s, grid, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
