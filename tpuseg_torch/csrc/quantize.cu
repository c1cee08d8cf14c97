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
// of them (Cq = Cx); a negative entry of chan reads as 0 (a zero changes
// neither the absmax nor any other element's xq, so a map ending in -1s pads
// the int8 operand in this one pass); xq is (N, P, Cq) int8.  Both divisions
// are IEEE (__fdiv_rn), as PyTorch's division by a tensor is: a reciprocal
// multiply differs in the last bit.
//
// A channel map comes with its vector descriptor (ops/sparse_conv.py
// channel_map_vectors, built once with the map): vecs[v] says how output
// channels 8v .. 8v+7 read x.  vecs[v] >= 0: contiguous, source channels
// vecs[v] .. vecs[v]+7 with vecs[v] a multiple of 8, one 16-byte load of
// bf16 (two of f32); kZeroVec (-1): every entry -1, nothing is loaded; -2:
// element by element through chan.  CompactSparseQ's maps are runs of whole
// 128-channel blocks, so every vector of them is contiguous.  Each block
// stages the descriptor in shared memory; threads walk pixels x vectors, so
// a warp's loads of one pixel's contiguous vectors are consecutive.
//
// Two kernels.  absmax: each block takes a slice of one frame, reduces max |x|
// as the uint32 bits of the magnitude (non-negative floats order as their
// bits; a NaN's bits sort above +inf, so a NaN propagates as in PyTorch's
// inf-norm), and folds it into absmax[n] with one atomicMax (the C entry
// zeroes absmax on the stream first); it skips zero vectors.  One C call
// launches both.  quantize: one read of x and
// one write of xq, 8 elements (a 16-byte bf16 or two 16-byte f32 loads, an
// 8-byte store) per thread and step; each thread derives xs[n] from
// absmax[n] itself, and the first block of each frame writes it out.
//
// What bounds it on the H100: bytes.  At B3's serving input (32,128,256,512)
// bf16 the dynamic pair moves 2 + 2 + 1 bytes per element (x read twice: it
// is 1 GB, beyond L2), 2.7 GB, ~0.8 ms at 3.35 TB/s; the function itself
// needs 3 bytes per element.  Through a map only the mapped channels' bytes
// count.  The IEEE division costs ~20 instructions an element, below the
// memory time at these rates.
//
// C interface (ctypes): tpuseg_quantize returns the cudaError_t of its
// launches (0 on success); it launches on the given stream, does not
// synchronize and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;            // elements per thread and step
constexpr long long kBlocks = 4096;  // target blocks in the grid (~31 per SM)
constexpr int kZeroVec = -1;       // descriptor kinds below 0; kGatherVec = -2 is any other
constexpr int kMaxVecs = 12288;    // descriptor entries staged in shared memory: 48 KB,
                                   // the most a launch gets without opting in

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// 8 consecutive elements at px (16-byte aligned), as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ px, float (&f)[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(px));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ void load8(const float* __restrict__ px, float (&f)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(px));
  const float4 b = __ldg(reinterpret_cast<const float4*>(px) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Output channels c .. c+7 of the pixel at px through descriptor entry d
// (not kZeroVec: contiguous, or a gather through chan).  vec_ok: a
// contiguous vector's source is 16-byte aligned (Cx divides by 8); else it
// reads element by element.
template <typename T>
__device__ __forceinline__ void load8_mapped(const T* __restrict__ px,
                                             const int* __restrict__ chan, int d, int c,
                                             bool vec_ok, float (&f)[kVec]) {
  if (d >= 0 && vec_ok) {
    load8(px + d, f);
  } else if (d >= 0) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) f[i] = to_f32(px[d + i]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int ch = __ldg(chan + c + i);
      f[i] = ch < 0 ? 0.0f : to_f32(px[ch]);
    }
  }
}

struct Shape {
  long long pixels;  // P, per frame
  int cx, cq;
  int cq8;           // Cq / 8, vectors per pixel
  int vecs;          // P * Cq / 8, per frame
};

// The mapped kernels' descriptor, staged in shared memory by every block
__device__ __forceinline__ void stage_vecs(const int* __restrict__ vecs, int* vsm, int cq8) {
  for (int i = threadIdx.x; i < cq8; i += kThreads) vsm[i] = __ldg(vecs + i);
  __syncthreads();
}

template <typename T, bool kMap>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, const int* __restrict__ chan,
              const int* __restrict__ vecs, unsigned* __restrict__ absmax, Shape s) {
  extern __shared__ int vsm[];
  if (kMap) stage_vecs(vecs, vsm, s.cq8);
  const int n = blockIdx.y;
  const T* frame = x + static_cast<long long>(n) * s.pixels * s.cx;
  const bool vec_ok = s.cx % kVec == 0;
  unsigned m = 0;
  for (int v = blockIdx.x * kThreads + threadIdx.x; v < s.vecs; v += gridDim.x * kThreads) {
    float f[kVec];
    if (kMap) {
      const int p = v / s.cq8;
      const int c8 = v - p * s.cq8;
      const int d = vsm[c8];
      if (d == kZeroVec) continue;  // zeros: no load, no larger max
      load8_mapped(frame + static_cast<long long>(p) * s.cx, chan, d, c8 * kVec, vec_ok, f);
    } else {
      load8(frame + static_cast<long long>(v) * kVec, f);
    }
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
                const int* __restrict__ vecs, const unsigned* __restrict__ absmax,
                float static_scale, int8_t* __restrict__ xq, float* __restrict__ xs, Shape s) {
  extern __shared__ int vsm[];
  if (kMap) stage_vecs(vecs, vsm, s.cq8);
  const int n = blockIdx.y;
  float scale = static_scale;
  if (absmax != nullptr) {
    const float a = __uint_as_float(__ldg(absmax + n));
    scale = __fdiv_rn(a != a ? a : fmaxf(a, 1e-8f), 127.0f);  // max that keeps a NaN
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) xs[n] = scale;
  const T* frame = x + static_cast<long long>(n) * s.pixels * s.cx;
  uint2* out = reinterpret_cast<uint2*>(xq + static_cast<long long>(n) * s.pixels * s.cq);
  const bool vec_ok = s.cx % kVec == 0;
  for (int v = blockIdx.x * kThreads + threadIdx.x; v < s.vecs; v += gridDim.x * kThreads) {
    unsigned w[2] = {0u, 0u};
    float f[kVec];
    bool zero = false;
    if (kMap) {
      const int p = v / s.cq8;
      const int c8 = v - p * s.cq8;
      const int d = vsm[c8];
      zero = d == kZeroVec;  // zeros quantize to 0 whatever the scale
      if (!zero)
        load8_mapped(frame + static_cast<long long>(p) * s.cx, chan, d, c8 * kVec, vec_ok, f);
    } else {
      load8(frame + static_cast<long long>(v) * kVec, f);
    }
    if (!zero) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int q = min(max(__float2int_rn(__fdiv_rn(f[i], scale)), -127), 127);
        w[i >> 2] |= (static_cast<unsigned>(q) & 0xffu) << (8 * (i & 3));
      }
    }
    out[v] = make_uint2(w[0], w[1]);
  }
}

// The grid for n frames of s.vecs vectors; false where the shape does not
// fit.  A map needs its descriptor (vecs), and no more than kMaxVecs entries.
bool plan_grid(int n, long long pixels, int cx, int cq, const void* chan, const void* vecs,
               Shape* s, dim3* grid) {
  if (n <= 0 || n > 65535 || pixels <= 0 || cx <= 0 || cq <= 0 || cq % kVec != 0 ||
      (chan == nullptr && (cq != cx || cx % kVec != 0 || vecs != nullptr)) ||
      (chan != nullptr && (vecs == nullptr || cq / kVec > kMaxVecs))) {
    return false;
  }
  const long long vecs_n = pixels * cq / kVec;
  if (vecs_n > 0x7fffffffLL) return false;
  s->pixels = pixels;
  s->cx = cx;
  s->cq = cq;
  s->cq8 = cq / kVec;
  s->vecs = static_cast<int>(vecs_n);
  const long long per_frame = (kBlocks + n - 1) / n;
  const long long need = (vecs_n + kThreads - 1) / kThreads;
  *grid = dim3(static_cast<unsigned>(need < per_frame ? need : per_frame), n);
  return true;
}

template <typename T>
void launch_absmax(const void* x, const int* chan, const int* vecs, unsigned* absmax,
                   const Shape& s, dim3 grid, cudaStream_t st) {
  if (chan != nullptr)
    absmax_kernel<T, true><<<grid, kThreads, s.cq8 * sizeof(int), st>>>(
        static_cast<const T*>(x), chan, vecs, absmax, s);
  else
    absmax_kernel<T, false><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), chan, vecs,
                                                       absmax, s);
}

template <typename T>
void launch_quantize(const void* x, const int* chan, const int* vecs, const unsigned* absmax,
                     float scale, int8_t* xq, float* xs, const Shape& s, dim3 grid,
                     cudaStream_t st) {
  if (chan != nullptr)
    quantize_kernel<T, true><<<grid, kThreads, s.cq8 * sizeof(int), st>>>(
        static_cast<const T*>(x), chan, vecs, absmax, scale, xq, xs, s);
  else
    quantize_kernel<T, false><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), chan, vecs,
                                                         absmax, scale, xq, xs, s);
}

bool aligned(const void* p, uintptr_t a) { return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0; }

}  // namespace

// xq (n, pixels, cq) int8 and xs (n,) f32 from x (n, pixels, cx), f32
// (dtype 0) or bf16 (1), through chan (cq,) int32 (negative: 0) and its
// descriptor vecs (cq / 8,) int32, or unmapped (both null).  With absmax
// ((n,) uint32 scratch) the scale is per frame: absmax is zeroed on the
// stream, the absmax kernel folds max |x| of each frame's (mapped) elements
// into it as bits, then the quantize kernel runs on it (two launches, one
// call); with absmax null every frame takes static_scale.
extern "C" int tpuseg_quantize(const void* x, const void* chan, const void* vecs, void* absmax,
                               float static_scale, void* xq, void* xs, int n, long long pixels,
                               int cx, int cq, int dtype, void* stream) {
  Shape s;
  dim3 grid;
  if (!plan_grid(n, pixels, cx, cq, chan, vecs, &s, &grid) || !aligned(x, 16) ||
      !aligned(chan, 4) || !aligned(vecs, 4) || !aligned(absmax, 4) || !aligned(xq, 8) ||
      !aligned(xs, 4) || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(chan);
  const int* vd = static_cast<const int*>(vecs);
  unsigned* a = static_cast<unsigned*>(absmax);
  int8_t* q = static_cast<int8_t*>(xq);
  float* f = static_cast<float*>(xs);
  if (a != nullptr) {
    const cudaError_t e = cudaMemsetAsync(a, 0, static_cast<size_t>(n) * sizeof(unsigned), st);
    if (e != cudaSuccess) return (int)e;
    if (dtype == 1)
      launch_absmax<__nv_bfloat16>(x, c, vd, a, s, grid, st);
    else
      launch_absmax<float>(x, c, vd, a, s, grid, st);
  }
  if (dtype == 1)
    launch_quantize<__nv_bfloat16>(x, c, vd, a, static_scale, q, f, s, grid, st);
  else
    launch_quantize<float>(x, c, vd, a, static_scale, q, f, s, grid, st);
  return (int)cudaGetLastError();
}
