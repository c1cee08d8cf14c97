// Temporal serving's per-batch keyframe choice, for Hopper (sm_90a).
//
// Replaces XLA work of tpuseg/video/pipeline.py (no Pallas kernel there):
// program_budget's consecutive-frame deltas (:670-678, K3) and its scalar
// selection scan with the slot arithmetic (:680-704, K4), and
// program_adaptive's sequential keyframe choice (:614-638, K5).  All stay on
// the device, so batches chain through the carry with no host sync.
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
// is one `vabsdiff4.add` a 4-byte lane).  Per frame a block reduces its
// threads' sums (warp shuffles, then shared memory) and adds it to the
// frame's 64-bit sum with one atomic; the last block to finish (a counter
// after the sums) writes d.  A frame size that is not a multiple of 16 takes
// the same kernel on bytes.
//
// K4, budget selection (budget_scan): one thread runs tpuseg's scan over d:
//   acc = acc + d[i] (f32); want = n == 0 or acc > thresh; run = want and
//   used < K; on run: acc = 0, slot `used` gets frame i, used++, n++
// and writes flags (B,), fwd_idx (K,) (the s-th promoted frame, 0 where no
// frame was promoted: frame 0 is forwarded as padding), keyslot (B,) =
// cumsum(flags) - 1, and the new acc and n.  The budgeted mode runs it in
// K3's last block, over the d that block has just made, kept in shared
// memory (tpuseg_frame_deltas_budget): one launch a batch for both.  A
// one-thread kernel runs it over deltas a caller gives (tpuseg_budget_select).
//
// K5, sequential keyframe choice: for each frame i in order,
//   diff = mean |f[i] - kf| against the live keyframe kf;
//   run = n == 0 or diff > thresh; on run: kf = f[i], n++
// with kf the carried keyframe until the batch promotes one.  Outputs: flags
// (B,), each frame's keyframe slot (the count of promotions so far - 1; -1 is
// the carried keyframe), the promoted frames' indices in order, the diffs, a
// state (live keyframe index or -1, n, promotions this batch) and the new
// carried keyframe pixels.  The diff is the exact integer sum divided once in
// double and rounded to f32, as K3's.
// Design: frame i's keyframe is the carried frame or some frame j < i, so
// every sum the scan can need comes from one pass over frame pairs, and only
// a scan over scalars stays sequential.  The frames go in chunks of kChunk;
// a chunk's live keyframe k is known when it starts (the carried frame, or
// the last promotion of an earlier chunk), and its pass computes the
// kChunk * (kChunk + 1) / 2 pair sums S[k, i] and S[j, i] (j < i, both in the
// chunk).  Each thread loads a 16-byte word of k and of the chunk's frames
// once into registers and keeps the pair sums there in 32 bits (one
// `vabsdiff4.add` a 4-byte lane and pair); warps reduce with
// __reduce_add_sync, blocks through shared memory, and each block writes its
// own column of partial sums (no atomics, so nothing to zero).  One
// cooperative launch holds all blocks resident: after a grid barrier block p
// adds pair p's partials in 64 bits; after a second one block turns the
// totals into means and runs the chunk's scan (the key moves to j on each
// promotion and reads S[key, i]), writing the outputs and the state; after a
// third the next chunk starts from the state's keyframe.  After the last
// chunk every block copies the live keyframe into the new carry.
// Bytes: (B + ceil(B / kChunk)) F read for the pairs, F read and F written
// for the copy: 69 MB, 0.021 ms at 3.35 TB/s, at B = 8 of 1024x2048 frames.
// The pair work, 36 `vabsdiff4.add` a 4-byte lane at B = 8 (113 M), stays
// under the bytes at the card's integer rate.
//
// C interface (ctypes): each returns the cudaError_t of its launch (0 on
// success); it launches on the given stream, does not synchronize and
// allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFrames = 4096;  // shared per-frame sums of a block
constexpr int kChunk = 8;         // K5's frames a pass: the sequential mode's serving batch
constexpr int kPairs = kChunk * (kChunk + 1) / 2;
// K5 keeps each thread's pair sums in 32 bits: a word adds at most 16 * 255,
// and a warp's sum must fit too
constexpr long long kMaxWordsPerThread = 0xffffffffLL / (32LL * 16 * 255);

// acc + sum over the 4 bytes of |a - b|: one PTX instruction, and one SASS
// VABSDIFF4.U8.ACC on sm_90a
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned acc) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

// acc + sum of |a - b| over the word's bytes
__device__ __forceinline__ unsigned absdiff_sum(uint4 a, uint4 b, unsigned acc) {
  return sad4(a.w, b.w, sad4(a.z, b.z, sad4(a.y, b.y, sad4(a.x, b.x, acc))));
}

__device__ __forceinline__ unsigned absdiff_sum(uint8_t a, uint8_t b, unsigned acc) {
  return acc + static_cast<unsigned>(a > b ? a - b : b - a);
}

__device__ __forceinline__ float mean_of(unsigned long long s, long long frame_bytes) {
  return __double2float_rn(__ddiv_rn(static_cast<double>(s), static_cast<double>(frame_bytes)));
}

// K4's scan over d (nframes,) from the carried drift and count
__device__ void budget_scan(const float* d, int nframes, float acc, int n, float thresh,
                            int budget, bool* flags, int* fwd_idx, int* keyslot, float* acc_out,
                            int* n_out) {
  int used = 0;
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

// K4's inputs and outputs when it runs in K3's last block; budget 0: K3 alone
struct Budget {
  const float* acc_in;
  const int* n_in;
  float thresh;
  int budget;
  bool* flags;
  int* fwd_idx;
  int* keyslot;
  float* acc_out;
  int* n_out;
};

// T: the word (uint4 = 16 bytes, or one byte); kPer words a thread
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
frame_deltas_kernel(const T* __restrict__ frames, const T* __restrict__ prev,
                    unsigned long long* __restrict__ sums, float* __restrict__ d, int nframes,
                    long long words, long long frame_bytes, Budget bud) {
  extern __shared__ unsigned block_sum[];  // (nframes,); the last block's d after the sums
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
  float* ds = reinterpret_cast<float*>(block_sum);
  for (int i = threadIdx.x; i < nframes; i += kThreads) {
    ds[i] = d[i] = mean_of(atomicAdd(sums + i, 0ull), frame_bytes);
  }
  if (bud.budget == 0) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    budget_scan(ds, nframes, *bud.acc_in, *bud.n_in, bud.thresh, bud.budget, bud.flags,
                bud.fwd_idx, bud.keyslot, bud.acc_out, bud.n_out);
  }
}

template <typename T, int kPer>
int launch_deltas(const void* frames, const void* prev, unsigned long long* sums, float* d,
                  int nframes, long long words, long long frame_bytes, const Budget& bud,
                  cudaStream_t st) {
  const long long blocks = (words + static_cast<long long>(kPer) * kThreads - 1) /
                           (static_cast<long long>(kPer) * kThreads);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  frame_deltas_kernel<T, kPer><<<static_cast<unsigned>(blocks), kThreads,
                                  nframes * sizeof(unsigned), st>>>(
      static_cast<const T*>(frames), static_cast<const T*>(prev), sums, d, nframes, words,
      frame_bytes, bud);
  return (int)cudaGetLastError();
}

__global__ void budget_select_kernel(const float* __restrict__ d, const float* __restrict__ acc_in,
                                     const int* __restrict__ n_in, float thresh, int budget,
                                     int nframes, bool* __restrict__ flags,
                                     int* __restrict__ fwd_idx, int* __restrict__ keyslot,
                                     float* __restrict__ acc_out, int* __restrict__ n_out) {
  budget_scan(d, nframes, *acc_in, *n_in, thresh, budget, flags, fwd_idx, keyslot, acc_out,
              n_out);
}

bool aligned(const void* p, uintptr_t a) { return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0; }

int deltas(const void* frames, const void* prev, void* sums, void* d, int nframes,
           long long frame_bytes, const Budget& bud, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  unsigned long long* s = static_cast<unsigned long long*>(sums);
  float* out = static_cast<float*>(d);
  if (frame_bytes % 16 == 0 && aligned(frames, 16) && aligned(prev, 16)) {
    return launch_deltas<uint4, 4>(frames, prev, s, out, nframes, frame_bytes / 16, frame_bytes,
                                   bud, st);
  }
  return launch_deltas<uint8_t, 16>(frames, prev, s, out, nframes, frame_bytes, frame_bytes, bud,
                                    st);
}

struct Keyframe {
  const void* frames;
  const void* carried;
  const int* n_in;
  int* state;                         // (3,): live keyframe index (-1: carried), n, promotions
  unsigned long long* partials;       // (kPairs + 1, gridDim.x): each block's pair sums, totals
  float thresh;
  int nframes;
  long long words;
  long long frame_bytes;
  bool* flags;
  int* keyslot;
  int* fwd_idx;
  float* diffs;
  void* out;
};

// pair (r, i) of a chunk, r <= i: r = 0 is the chunk's live keyframe, r = j + 1
// the chunk's frame j
__host__ __device__ constexpr int pair_index(int r, int i) { return i * (i + 1) / 2 + r; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) keyframe_select_kernel(Keyframe a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned warp_sum[kThreads / 32][kPairs];
  __shared__ unsigned long long warp_total[kThreads / 32];
  __shared__ float mean[kPairs];
  const T* frames = static_cast<const T*>(a.frames);
  const T* carried = static_cast<const T*>(a.carried);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  int n = 0, used = 0, key = -1;  // the scan's state: block 0's thread 0 only
  for (int start = 0; start < a.nframes; start += kChunk) {
    const int c = min(kChunk, a.nframes - start);
    const int live = start == 0 ? -1 : __ldcg(a.state);
    const T* kf = live < 0 ? carried : frames + static_cast<long long>(live) * a.words;
    const T* f0 = frames + static_cast<long long>(start) * a.words;
    unsigned acc[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) acc[p] = 0u;
    for (long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; w < a.words;
         w += stride) {
      const T kw = kf[w];
      T fw[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) fw[i] = i < c ? f0[i * a.words + w] : T{};
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        acc[pair_index(0, i)] = absdiff_sum(fw[i], kw, acc[pair_index(0, i)]);
#pragma unroll
        for (int j = 0; j < i; ++j) {
          acc[pair_index(j + 1, i)] = absdiff_sum(fw[i], fw[j], acc[pair_index(j + 1, i)]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const unsigned v = __reduce_add_sync(0xffffffffu, acc[p]);
      if (lane == 0) warp_sum[warp][p] = v;
    }
    __syncthreads();
    if (threadIdx.x < kPairs) {
      unsigned long long s = 0;
#pragma unroll
      for (int k = 0; k < kThreads / 32; ++k) s += warp_sum[k][threadIdx.x];
      a.partials[static_cast<long long>(threadIdx.x) * gridDim.x + blockIdx.x] = s;
    }
    grid.sync();
    // the chunk's pair totals: block p adds row p of the partials, a load or
    // two a thread (one block adding every row ran its loads in series),
    // into the row after them
    unsigned long long* totals = a.partials + static_cast<long long>(kPairs) * gridDim.x;
    for (int p = blockIdx.x; p < kPairs; p += gridDim.x) {
      unsigned long long v = 0;
      for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
        v += __ldcg(a.partials + static_cast<long long>(p) * gridDim.x + b);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) warp_total[warp] = v;
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int k = 1; k < kThreads / 32; ++k) v += warp_total[k];
        totals[p] = v;
      }
      __syncthreads();
    }
    grid.sync();
    if (blockIdx.x == 0) {
      // every pair's mean, one a thread; then the scan
      if (threadIdx.x < kPairs) {
        mean[threadIdx.x] = mean_of(__ldcg(totals + threadIdx.x), a.frame_bytes);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        if (start == 0) n = *a.n_in;
        int r = 0;  // the key's row in the chunk's pairs
        for (int i = 0; i < c; ++i) {
          const float diff = mean[pair_index(r, i)];
          const bool run = n == 0 || diff > a.thresh;
          if (run) {
            a.fwd_idx[used++] = start + i;
            r = i + 1;
            ++n;
          }
          a.flags[start + i] = run;
          a.keyslot[start + i] = used - 1;
          a.diffs[start + i] = diff;
        }
        if (r > 0) key = start + r - 1;
        a.state[0] = key;
        a.state[1] = n;
        a.state[2] = used;
      }
    }
    grid.sync();
  }
  // the new carry: the live keyframe
  const int live = __ldcg(a.state);
  const T* src = live < 0 ? carried : frames + static_cast<long long>(live) * a.words;
  T* out = static_cast<T*>(a.out);
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; w < a.words;
       w += stride) {
    out[w] = src[w];
  }
}

// blocks of keyframe_select_kernel<T> resident on one SM, and the SMs, of the
// current device (cached per device)
template <typename T>
cudaError_t keyframe_residency(int* per_sm, int* sms) {
  constexpr int kDevices = 64;
  static int cached[kDevices][2];  // 0: not yet asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && cached[dev][0] != 0) {
    *per_sm = cached[dev][0];
    *sms = cached[dev][1];
    return cudaSuccess;
  }
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, keyframe_select_kernel<T>,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  if (*per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < kDevices) {
    cached[dev][1] = *sms;
    cached[dev][0] = *per_sm;
  }
  return cudaSuccess;
}

template <typename T>
int launch_keyframe(Keyframe a, long long capacity, cudaStream_t st) {
  int per_sm = 0, sms = 0;
  cudaError_t err = keyframe_residency<T>(&per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  const long long needed = (a.words + kThreads - 1) / kThreads;
  const long long grid = needed < static_cast<long long>(per_sm) * sms
                             ? needed : static_cast<long long>(per_sm) * sms;
  if ((grid + 1) * kPairs > capacity) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((a.words + grid * kThreads - 1) / (grid * kThreads) > kMaxWordsPerThread) {
    return (int)cudaErrorInvalidValue;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(keyframe_select_kernel<T>),
                                    dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0,
                                    st);
  if (err != cudaSuccess) return (int)err;
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
  return deltas(frames, prev, sums, d, nframes, frame_bytes, Budget{}, stream);
}

// K3 with K4's scan in its last block: tpuseg_frame_deltas's arguments, then
// tpuseg_budget_select's (d is K3's output).
extern "C" int tpuseg_frame_deltas_budget(const void* frames, const void* prev, void* sums,
                                          void* d, int nframes, long long frame_bytes,
                                          const void* acc_in, const void* n_in, float thresh,
                                          int budget, void* flags, void* fwd_idx, void* keyslot,
                                          void* acc_out, void* n_out, void* stream) {
  if (nframes <= 0 || nframes > kMaxFrames || frame_bytes <= 0 || frames == nullptr ||
      prev == nullptr || !aligned(sums, 8) || !aligned(d, 4) || budget <= 0 ||
      budget > nframes || acc_in == nullptr || !aligned(acc_in, 4) || n_in == nullptr ||
      !aligned(n_in, 4) || flags == nullptr || fwd_idx == nullptr || !aligned(fwd_idx, 4) ||
      keyslot == nullptr || !aligned(keyslot, 4) || acc_out == nullptr ||
      !aligned(acc_out, 4) || n_out == nullptr || !aligned(n_out, 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const Budget bud{static_cast<const float*>(acc_in), static_cast<const int*>(n_in), thresh,
                   budget, static_cast<bool*>(flags), static_cast<int*>(fwd_idx),
                   static_cast<int*>(keyslot), static_cast<float*>(acc_out),
                   static_cast<int*>(n_out)};
  return deltas(frames, prev, sums, d, nframes, frame_bytes, bud, stream);
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
// partials: capacity uint64 of scratch, at least what
// tpuseg_keyframe_select_partials says (else the call returns
// cudaErrorCooperativeLaunchTooLarge and launches nothing); flags (nframes,)
// bool, keyslot (nframes,) int32, fwd_idx (nframes,) int32 (the first
// `promotions` entries written), diffs (nframes,) f32, out (frame_bytes,)
// uint8: the new carried keyframe.  One cooperative launch; nothing needs
// zeroing.
extern "C" int tpuseg_keyframe_select(const void* frames, const void* carried, const void* n_in,
                                      void* state, void* partials, long long capacity,
                                      float thresh, int nframes, long long frame_bytes,
                                      void* flags, void* keyslot, void* fwd_idx, void* diffs,
                                      void* out, void* stream) {
  if (nframes <= 0 || frame_bytes <= 0 || capacity <= 0 || frames == nullptr ||
      carried == nullptr || out == nullptr || flags == nullptr || !aligned(n_in, 4) ||
      !aligned(state, 4) || !aligned(partials, 8) || !aligned(keyslot, 4) ||
      !aligned(fwd_idx, 4) || !aligned(diffs, 4) || n_in == nullptr || state == nullptr ||
      partials == nullptr || keyslot == nullptr || fwd_idx == nullptr || diffs == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Keyframe a{frames, carried, static_cast<const int*>(n_in), static_cast<int*>(state),
             static_cast<unsigned long long*>(partials), thresh, nframes, frame_bytes,
             frame_bytes, static_cast<bool*>(flags), static_cast<int*>(keyslot),
             static_cast<int*>(fwd_idx), static_cast<float*>(diffs), out};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (frame_bytes % 16 == 0 && aligned(frames, 16) && aligned(carried, 16) && aligned(out, 16)) {
    a.words = frame_bytes / 16;
    return launch_keyframe<uint4>(a, capacity, st);
  }
  return launch_keyframe<uint8_t>(a, capacity, st);
}

// The uint64 scratch tpuseg_keyframe_select needs on the current device
// (kPairs partial sums for each block the card holds at once, and kPairs
// totals), in *count.
extern "C" int tpuseg_keyframe_select_partials(long long* count) {
  int vec = 0, bytes = 0, sms = 0;
  cudaError_t err = keyframe_residency<uint4>(&vec, &sms);
  if (err == cudaSuccess) err = keyframe_residency<uint8_t>(&bytes, &sms);
  if (err != cudaSuccess) return (int)err;
  *count = static_cast<long long>(kPairs) * ((vec > bytes ? vec : bytes) * sms + 1);
  return 0;
}
