// Budgeted temporal serving's per-batch selection, for Hopper (sm_90a).
//
// Replaces XLA work of tpuseg/video/pipeline.py::program_budget (no Pallas
// kernel there): the consecutive-frame deltas (:670-678, K3) and the scalar
// selection scan with its slot arithmetic (:680-704, K4).  Both stay on the
// device, so batches chain through the carry with no host sync.
//
// K3, frame deltas: d[i] = mean |f[i] - f[i-1]| over the bytes of flat uint8
// frames (B, F), f[-1] the carried previous frame (F,).  The |differences| are
// summed exactly in integers (64-bit per frame), then divided once in double
// by F and rounded to f32.  tpuseg takes an f32 jnp.mean, whose summation
// order XLA chooses, so d may differ from tpuseg's in the last bits.
// Design: each thread owns kPer 16-byte words of the frame at the same offset
// in every frame and walks the batch in order, keeping the previous frame's
// words in registers, so every byte is read once: (B + 1) * F bytes, 0.062 ms
// at 3.35 TB/s for 32 frames of 1024x2048 (bytes bound it; the per-byte work
// is one __vabsdiffu4 and one __dp4a a word).  Per frame a block reduces its
// threads' sums (warp shuffles, then shared memory) and adds it to the
// frame's 64-bit sum with one atomic; the last block to finish (a counter
// after the sums) writes d.  A frame size that is not a multiple of 16 takes
// the same kernel on bytes.
//
// K4, budget selection: one thread runs tpuseg's scan over d:
//   acc = acc + d[i] (f32); want = n == 0 or acc > thresh; run = want and
//   used < K; on run: acc = 0, slot `used` gets frame i, used++, n++
// and writes flags (B,), fwd_idx (K,) (the s-th promoted frame, 0 where no
// frame was promoted: frame 0 is forwarded as padding), keyslot (B,) =
// cumsum(flags) - 1, and the new acc and n.  B is at most the serving batch,
// so the scan is a few hundred cycles; a kernel keeps it off the host.
//
// K5, sequential keyframe choice (tpuseg/video/pipeline.py::program_adaptive,
// :614-638, the scan's diff and run): for each frame i in order,
//   diff = mean |f[i] - kf| against the live keyframe kf;
//   run = n == 0 or diff > thresh; on run: kf = f[i], n++
// with kf the carried keyframe until the batch promotes one.  Outputs: flags
// (B,), each frame's keyframe slot (the count of promotions so far - 1; -1 is
// the carried keyframe), the promoted frames' indices in order, the diffs, a
// state (live keyframe index or -1, n, promotions this batch) and the new
// carried keyframe pixels.  The diff is the exact integer sum divided once in
// double and rounded to f32, as K3's.  Design: one launch per frame, K3's
// reduction over (f[i], kf) with kf read through the state's device-side
// index; the last block to finish frame i's sum decides and writes the state,
// so the next launch (stream order) reads the new keyframe; one more launch
// copies the live keyframe into the carry.  B + 1 launches a batch, no host
// sync; each frame reads 2 F bytes (kf mostly from L2).
//
// C interface (ctypes): each returns the cudaError_t of its launch (0 on
// success); it launches on the given stream, does not synchronize and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFrames = 4096;  // shared per-frame sums of a block

__device__ __forceinline__ unsigned absdiff_sum(uint4 a, uint4 b, unsigned acc) {
  acc = __dp4a(__vabsdiffu4(a.x, b.x), 0x01010101u, acc);
  acc = __dp4a(__vabsdiffu4(a.y, b.y), 0x01010101u, acc);
  acc = __dp4a(__vabsdiffu4(a.z, b.z), 0x01010101u, acc);
  return __dp4a(__vabsdiffu4(a.w, b.w), 0x01010101u, acc);
}

__device__ __forceinline__ unsigned absdiff_sum(uint8_t a, uint8_t b, unsigned acc) {
  return acc + static_cast<unsigned>(a > b ? a - b : b - a);
}

// T: the word (uint4 = 16 bytes, or one byte); kPer words a thread
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
frame_deltas_kernel(const T* __restrict__ frames, const T* __restrict__ prev,
                    unsigned long long* __restrict__ sums, float* __restrict__ d, int nframes,
                    long long words, long long frame_bytes) {
  extern __shared__ unsigned block_sum[];  // (nframes,)
  for (int i = threadIdx.x; i < nframes; i += kThreads) block_sum[i] = 0u;
  __syncthreads();
  const long long w0 = static_cast<long long>(blockIdx.x) * kPer * kThreads + threadIdx.x;
  T held[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long w = w0 + static_cast<long long>(k) * kThreads;
    held[k] = w < words ? prev[w] : T{};
  }
  for (int i = 0; i < nframes; ++i) {
    const T* f = frames + static_cast<long long>(i) * words;
    unsigned acc = 0u;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long w = w0 + static_cast<long long>(k) * kThreads;
      const T cur = w < words ? f[w] : T{};
      acc = absdiff_sum(cur, held[k], acc);
      held[k] = cur;
    }
    acc = __reduce_add_sync(0xffffffffu, acc);
    if ((threadIdx.x & 31) == 0 && acc != 0u) atomicAdd(block_sum + i, acc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nframes; i += kThreads) {
    if (block_sum[i] != 0u) atomicAdd(sums + i, static_cast<unsigned long long>(block_sum[i]));
  }
  // the last block to finish turns the sums into means
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) last = atomicAdd(sums + nframes, 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < nframes; i += kThreads) {
    const unsigned long long s = atomicAdd(sums + i, 0ull);
    d[i] = __double2float_rn(__ddiv_rn(static_cast<double>(s), static_cast<double>(frame_bytes)));
  }
}

template <typename T, int kPer>
int launch_deltas(const void* frames, const void* prev, unsigned long long* sums, float* d,
                  int nframes, long long words, long long frame_bytes, cudaStream_t st) {
  const long long blocks = (words + static_cast<long long>(kPer) * kThreads - 1) /
                           (static_cast<long long>(kPer) * kThreads);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  frame_deltas_kernel<T, kPer><<<static_cast<unsigned>(blocks), kThreads,
                                  nframes * sizeof(unsigned), st>>>(
      static_cast<const T*>(frames), static_cast<const T*>(prev), sums, d, nframes, words,
      frame_bytes);
  return (int)cudaGetLastError();
}

__global__ void budget_select_kernel(const float* __restrict__ d, const float* __restrict__ acc_in,
                                     const int* __restrict__ n_in, float thresh, int budget,
                                     int nframes, bool* __restrict__ flags,
                                     int* __restrict__ fwd_idx, int* __restrict__ keyslot,
                                     float* __restrict__ acc_out, int* __restrict__ n_out) {
  float acc = *acc_in;
  int n = *n_in, used = 0;
  for (int s = 0; s < budget; ++s) fwd_idx[s] = 0;
  for (int i = 0; i < nframes; ++i) {
    acc = __fadd_rn(acc, d[i]);
    const bool run = (n == 0 || acc > thresh) && used < budget;
    if (run) {
      acc = 0.0f;
      fwd_idx[used++] = i;
      ++n;
    }
    flags[i] = run;
    keyslot[i] = used - 1;
  }
  *acc_out = acc;
  *n_out = n;
}

bool aligned(const void* p, uintptr_t a) { return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0; }

// state (int32): [0] the live keyframe's index in the batch (-1: the carried
// one), [1] n_keyed, [2] promotions this batch.  Launch i == 0 reads no state
// (the carried keyframe, n from n_in, none promoted).
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
keyframe_diff_kernel(const T* __restrict__ frames, const T* __restrict__ carried,
                     const int* __restrict__ n_in, int* __restrict__ state,
                     unsigned long long* __restrict__ sums, unsigned* __restrict__ done, int i,
                     float thresh, long long words, long long frame_bytes, bool* __restrict__ flags,
                     int* __restrict__ keyslot, int* __restrict__ fwd_idx,
                     float* __restrict__ diffs) {
  const int key = i == 0 ? -1 : state[0];
  const T* kf = key < 0 ? carried : frames + static_cast<long long>(key) * words;
  const T* f = frames + static_cast<long long>(i) * words;
  const long long w0 = static_cast<long long>(blockIdx.x) * kPer * kThreads + threadIdx.x;
  unsigned acc = 0u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long w = w0 + static_cast<long long>(k) * kThreads;
    if (w < words) acc = absdiff_sum(f[w], kf[w], acc);
  }
  acc = __reduce_add_sync(0xffffffffu, acc);
  __shared__ unsigned block_sum;
  if (threadIdx.x == 0) block_sum = 0u;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && acc != 0u) atomicAdd(&block_sum, acc);
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (block_sum != 0u) atomicAdd(sums + i, static_cast<unsigned long long>(block_sum));
  __threadfence();
  if (atomicAdd(done + i, 1u) != gridDim.x - 1) return;
  // the last block decides frame i
  __threadfence();
  const unsigned long long s = atomicAdd(sums + i, 0ull);
  const float diff =
      __double2float_rn(__ddiv_rn(static_cast<double>(s), static_cast<double>(frame_bytes)));
  const int n = i == 0 ? *n_in : state[1];
  int used = i == 0 ? 0 : state[2];
  const bool run = n == 0 || diff > thresh;
  if (run) {
    fwd_idx[used++] = i;
    state[0] = i;
  } else if (i == 0) {
    state[0] = -1;
  }
  state[1] = n + (run ? 1 : 0);
  state[2] = used;
  flags[i] = run;
  keyslot[i] = used - 1;
  diffs[i] = diff;
}

// out = the live keyframe: frames[state[0]], or the carried frame when the
// batch promoted none
template <typename T>
__global__ void keyframe_copy_kernel(const T* __restrict__ frames, const T* __restrict__ carried,
                                     const int* __restrict__ state, T* __restrict__ out,
                                     long long words) {
  const int key = state[0];
  const T* src = key < 0 ? carried : frames + static_cast<long long>(key) * words;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; w < words;
       w += static_cast<long long>(gridDim.x) * blockDim.x) {
    out[w] = src[w];
  }
}

template <typename T, int kPer>
int launch_keyframe_diffs(const void* frames, const void* carried, const int* n_in, int* state,
                          unsigned long long* sums, unsigned* done, int nframes, float thresh,
                          long long words, long long frame_bytes, bool* flags, int* keyslot,
                          int* fwd_idx, float* diffs, void* out, cudaStream_t st) {
  const long long blocks = (words + static_cast<long long>(kPer) * kThreads - 1) /
                           (static_cast<long long>(kPer) * kThreads);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nframes; ++i) {
    keyframe_diff_kernel<T, kPer><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const T*>(frames), static_cast<const T*>(carried), n_in, state, sums, done, i,
        thresh, words, frame_bytes, flags, keyslot, fwd_idx, diffs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long copy_blocks = words < 132LL * 4 * kThreads ? (words + kThreads - 1) / kThreads
                                                             : 132LL * 4;
  keyframe_copy_kernel<T><<<static_cast<unsigned>(copy_blocks), kThreads, 0, st>>>(
      static_cast<const T*>(frames), static_cast<const T*>(carried), state,
      static_cast<T*>(out), words);
  return (int)cudaGetLastError();
}

}  // namespace

// frames (nframes, frame_bytes) and prev (frame_bytes,) uint8; sums
// (nframes + 1,) uint64, zeroed by the caller (the per-frame sums, then the
// blocks' finish counter); d (nframes,) f32.
extern "C" int tpuseg_frame_deltas(const void* frames, const void* prev, void* sums, void* d,
                                   int nframes, long long frame_bytes, void* stream) {
  if (nframes <= 0 || nframes > kMaxFrames || frame_bytes <= 0 || frames == nullptr ||
      prev == nullptr || !aligned(sums, 8) || !aligned(d, 4)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  unsigned long long* s = static_cast<unsigned long long*>(sums);
  float* out = static_cast<float*>(d);
  if (frame_bytes % 16 == 0 && aligned(frames, 16) && aligned(prev, 16)) {
    return launch_deltas<uint4, 4>(frames, prev, s, out, nframes, frame_bytes / 16, frame_bytes,
                                   st);
  }
  return launch_deltas<uint8_t, 16>(frames, prev, s, out, nframes, frame_bytes, frame_bytes, st);
}

// d (nframes,) f32, acc_in (1,) f32, n_in (1,) int32 -> flags (nframes,) bool,
// fwd_idx (budget,) int32, keyslot (nframes,) int32, acc_out (1,) f32,
// n_out (1,) int32.
extern "C" int tpuseg_budget_select(const void* d, const void* acc_in, const void* n_in,
                                    float thresh, int budget, int nframes, void* flags,
                                    void* fwd_idx, void* keyslot, void* acc_out, void* n_out,
                                    void* stream) {
  if (nframes <= 0 || budget <= 0 || budget > nframes || !aligned(d, 4) || !aligned(acc_in, 4) ||
      !aligned(n_in, 4) || flags == nullptr || !aligned(fwd_idx, 4) || !aligned(keyslot, 4) ||
      !aligned(acc_out, 4) || !aligned(n_out, 4) || d == nullptr || acc_in == nullptr ||
      n_in == nullptr || fwd_idx == nullptr || keyslot == nullptr || acc_out == nullptr ||
      n_out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  budget_select_kernel<<<1, 1, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const float*>(acc_in),
      static_cast<const int*>(n_in), thresh, budget, nframes, static_cast<bool*>(flags),
      static_cast<int*>(fwd_idx), static_cast<int*>(keyslot), static_cast<float*>(acc_out),
      static_cast<int*>(n_out));
  return (int)cudaGetLastError();
}

// frames (nframes, frame_bytes) and carried (frame_bytes,) uint8; n_in (1,)
// int32; state (3,) int32 (written: live keyframe index, n, promotions);
// sums (nframes,) uint64 and done (nframes,) uint32, zeroed by the caller;
// flags (nframes,) bool, keyslot (nframes,) int32, fwd_idx (nframes,) int32
// (the first `promotions` entries written), diffs (nframes,) f32, out
// (frame_bytes,) uint8: the new carried keyframe.  nframes + 1 launches.
extern "C" int tpuseg_keyframe_select(const void* frames, const void* carried, const void* n_in,
                                      void* state, void* sums, void* done, float thresh,
                                      int nframes, long long frame_bytes, void* flags,
                                      void* keyslot, void* fwd_idx, void* diffs, void* out,
                                      void* stream) {
  if (nframes <= 0 || frame_bytes <= 0 || frames == nullptr || carried == nullptr ||
      out == nullptr || flags == nullptr || !aligned(n_in, 4) || !aligned(state, 4) ||
      !aligned(sums, 8) || !aligned(done, 4) || !aligned(keyslot, 4) || !aligned(fwd_idx, 4) ||
      !aligned(diffs, 4) || n_in == nullptr || state == nullptr || sums == nullptr ||
      done == nullptr || keyslot == nullptr || fwd_idx == nullptr || diffs == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* s = static_cast<unsigned long long*>(sums);
  auto* dn = static_cast<unsigned*>(done);
  const int* n = static_cast<const int*>(n_in);
  int* stt = static_cast<int*>(state);
  if (frame_bytes % 16 == 0 && aligned(frames, 16) && aligned(carried, 16) && aligned(out, 16)) {
    return launch_keyframe_diffs<uint4, 4>(
        frames, carried, n, stt, s, dn, nframes, thresh, frame_bytes / 16, frame_bytes,
        static_cast<bool*>(flags), static_cast<int*>(keyslot), static_cast<int*>(fwd_idx),
        static_cast<float*>(diffs), out, st);
  }
  return launch_keyframe_diffs<uint8_t, 16>(
      frames, carried, n, stt, s, dn, nframes, thresh, frame_bytes, frame_bytes,
      static_cast<bool*>(flags), static_cast<int*>(keyslot), static_cast<int*>(fwd_idx),
      static_cast<float*>(diffs), out, st);
}
