// The single-tile ladder k-nearest-neighbour observation kernels for
// TagContinuous, for Hopper (sm_90a): one templated kernel (a key and a
// selection phase as template parameters) and three entry points, one per
// TPU kernel it replaces.
//
//   knn_obs_packed    K6  _knn_obs_kernel_v2 (warpdrive_tpu/ops/knn_obs.py:
//                         137), variant="packed": knn_algorithm="pallas"
//   knn_obs_onehot    K7  _knn_obs_kernel (knn_obs.py:57), variant="onehot":
//                         "pallas_onehot"
//   knn_obs_twolevel  K8  _knn_obs_kernel_v6 (knn_obs.py:359), variant=
//                         "twolevel[_exact]": "pallas_twolevel[_exact]"
//
// All three are reached through the single-tile pallas_call of the TPU's
// knn_observation (knn_obs.py:1053) and through the Python wrapper
// warpdrive_tpu_torch/ops/knn_obs.py:knn_observation here, with its
// contract, for N <= 128 agents (one TPU lane tile; knn_obs.py:980):
//
//   inputs  loc_x, loc_y (E, N), feats (E, 5, N), types_f (N,),
//           still_f (E, N), t_norm (E,)            all float32, contiguous
//   output  out (E, N, 8k+1) float32
//
// For env e and observer i the candidates j are every other live agent
// (still_j >= 0.5), at d2 = dx*dx + dy*dy (difference form, f32).  Order:
//   K7, K8 exact: ascending d2, the lowest j first among equal d2 (v1's
//          "d2 <= min" then index-min, knn_obs.py:103-108; v6's exact
//          index-min, :436-442); valid iff d2 < 1e18.  v1 tests m < 1e20
//          (:104), the others m < 1e18 (_VALID_MAX): the two agree for
//          every distance below 1e18, i.e. on any grid narrower than 1e9,
//          so the kernel and the plain version both take 1e18.
//   K6, K8 packed: ascending int32 key (bits(d2) & ~127) | j, the 7-bit
//          packed index of _CLEAR_MASK (:52, :177-180, :424-426) whatever
//          N; valid iff key < bits(1e18).
// The first min(k, #valid) winners fill slots
//   [feat_j[c] - feat_i[c] for c in 0..4, type_j, 1, 1];
// later slots and every row of a dead observer are zeros; the row ends
// with t_norm[e] for a live observer.  The TPU kernels select features by
// one-hot masked f32 sums (v1, v2: exact) or, in v6, through bf16 hi/lo
// pairs gathered by constant permutation planes on the MXU (~4e-6 feature
// rounding); this kernel gathers exact f32 features by index, so the
// permutation planes, a TPU layout device, have no counterpart here.
//
// What bounds them: bytes.  At the flagship shape (E=1024, N=105, k=10)
// the function reads 3.4 MB and writes 34.8 MB: 11.4 us at 3.35 TB/s.  The
// difference form is 5 flops a pair (1.7 us for all pairs there at 67
// TFLOP/s); the ladder's k min-reductions are integer work on top, k
// passes of N candidates per observer.
//
// Design (correct first, simple), the TPU ladder as warp-wide reductions.
// One block per env, 8 warps, one warp per observer (the block's warps
// loop over the env's observers: at N = 128 one warp each would be 4096
// threads, above the 1024-thread cap).  The block stages its env's x, y,
// alive flag and six selectable channels in shared memory (knn_common.cuh:
// stage_env).  Candidate j = lane + 32q sits in lane j % 32's registers
// (q < 4 at N <= 128) as its key: the exact 64-bit (uint64(bits(d2)) << 32)
// | j, or the 7-bit packed int32; self, dead and missing candidates hold
// the all-ones key, above every valid one.  Each of the k passes is v1/v2/
// v6's slot_body: a lane-local min over the lane's four keys, then a
// __shfl_xor_sync butterfly min (one shuffle of the 64-bit key, which the
// compiler splits into two), so every lane holds the slot's winner; keys
// are unique (they carry j), so exactly one entry equals the min and its
// lane knocks it out.  The exact key's one reduction gives the lowest
// index among equal distances, as v1's min then index-min does.  Then:
//   EMIT (K6, K7), v1/v2's per-slot select: lanes 0..7 form the slot's
//          eight values as the pass ends and store them side by side.
//   RECORD (K8), v6's record-winners-then-select: the pass only records
//          the winner index (or -1) in a shared (N, k) table; after every
//          observer's ladder, the block gathers all rows of its env from
//          the table and writes the env's contiguous output block, one
//          float a thread, in order.
// Distances use __fmul_rn / __fadd_rn (and the library is built with
// -fmad=false), in the plain version's order, so kernel and plain agree bit
// for bit.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "knn_common.cuh"

namespace {

constexpr int kMaxAgents = 128;               // one TPU lane tile
constexpr int kPerLane = kMaxAgents / 32;     // candidates in a lane
constexpr int kWarps = 8;                     // observers in flight a block
constexpr int kPackedBits = 7;                // _CLEAR_MASK clears 7 bits
constexpr int kClearMask = ~((1 << kPackedBits) - 1);
constexpr int kMaxRecordK = 16;               // v6's k <= _VALID_ROWS
constexpr unsigned kFullMask = 0xffffffffu;

// Exact order: the 64-bit key (bits(d2) << 32) | j.  Non-negative floats
// order as their bit patterns, so one min gives the least d2 and, among
// equal d2, the lowest j.
struct ExactLadderKey {
  using Type = unsigned long long;
  __device__ static Type invalid() { return ~0ull; }
  __device__ __forceinline__ static Type make(float d2, int j) {
    return (static_cast<Type>(__float_as_uint(d2)) << 32) |
           static_cast<unsigned>(j);
  }
  __device__ __forceinline__ static int index(Type key) {
    return static_cast<int>(key & 0xffffffffull);
  }
  __device__ __forceinline__ static bool valid(Type key) {
    return static_cast<unsigned>(key >> 32) <
           __float_as_uint(knn::kValidMax);
  }
};

// Packed order: the int32 key (bits(d2) & ~127) | j of v2 and v6.
struct PackedLadderKey {
  using Type = int;
  __device__ static Type invalid() { return INT_MAX; }
  __device__ __forceinline__ static Type make(float d2, int j) {
    return (__float_as_int(d2) & kClearMask) | j;
  }
  __device__ __forceinline__ static int index(Type key) {
    return key & ~kClearMask;
  }
  __device__ __forceinline__ static bool valid(Type key) {
    return key < __float_as_int(knn::kValidMax);
  }
};

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const T other = __shfl_xor_sync(kFullMask, v, m);
    v = other < v ? other : v;
  }
  return v;
}

// Slot value c (0..7) of neighbour j for observer i.
__device__ __forceinline__ float slot_value(const knn::EnvTile& t, int i,
                                            int j, int c) {
  if (c < 5) return __fsub_rn(t.f[c * t.n + j], t.f[c * t.n + i]);
  return c == 5 ? t.f[5 * t.n + j] : 1.0f;
}

template <typename Key, bool RECORD>
__global__ void __launch_bounds__(kWarps * 32)
    ladder_kernel(knn::KnnArgs a) {
  extern __shared__ __align__(16) float knn_smem[];
  const int e = blockIdx.x;
  const int n = a.n;
  const int k = a.k;
  const knn::EnvTile t = knn::stage_env(knn_smem, a.loc_x, a.loc_y, a.feats,
                                        a.types_f, a.still_f, e, n);
  // RECORD: winner j of (observer i, slot s) at winners[i * k + s], -1 for
  // an invalid slot
  int* winners = reinterpret_cast<int*>(knn_smem + knn::env_floats(n));
  const int lane = threadIdx.x & 31;
  const int row_len = 8 * k + 1;
  const float t_norm = a.t_norm[e];
  float* env_out = a.out + static_cast<long long>(e) * n * row_len;

  for (int i = threadIdx.x >> 5; i < n; i += kWarps) {
    if (t.alive[i] == 0.0f) {
      if (!RECORD) {  // RECORD: the gather phase writes the zero row
        float* row = env_out + static_cast<long long>(i) * row_len;
        for (int f = lane; f < row_len; f += 32) row[f] = 0.0f;
      }
      continue;
    }
    const knn::DiffDist dist(t, nullptr, a, e, i);
    typename Key::Type key[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int j = lane + 32 * q;
      key[q] = (j < n && j != i && t.alive[j] != 0.0f)
                   ? Key::make(dist(j), j)
                   : Key::invalid();
    }
    for (int s = 0; s < k; ++s) {
      typename Key::Type m = key[0];
#pragma unroll
      for (int q = 1; q < kPerLane; ++q) m = key[q] < m ? key[q] : m;
      m = warp_min(m);
      const bool valid = Key::valid(m);
      // knock the winner out (every remaining entry is invalid once the
      // min is, and rewriting those changes nothing)
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        if (key[q] == m) key[q] = Key::invalid();
      }
      if (RECORD) {
        if (lane == 0) winners[i * k + s] = valid ? Key::index(m) : -1;
      } else if (lane < 8) {
        env_out[static_cast<long long>(i) * row_len + 8 * s + lane] =
            valid ? slot_value(t, i, Key::index(m), lane) : 0.0f;
      }
    }
    if (!RECORD && lane == 0) {
      env_out[static_cast<long long>(i) * row_len + 8 * k] = t_norm;
    }
  }
  if (!RECORD) return;

  // the selection phase: every row of the env from the winners table
  __syncthreads();
  const int total = n * row_len;
  for (int f = threadIdx.x; f < total; f += blockDim.x) {
    const int i = f / row_len;
    const int r = f - i * row_len;
    float v = 0.0f;
    if (t.alive[i] != 0.0f) {
      if (r == 8 * k) {
        v = t_norm;
      } else {
        const int j = winners[i * k + (r >> 3)];
        if (j >= 0) v = slot_value(t, i, j, r & 7);
      }
    }
    env_out[f] = v;
  }
}

template <typename Key, bool RECORD>
cudaError_t launch(const knn::KnnArgs& a, int e, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(knn::env_floats(a.n)) * sizeof(float) +
      (RECORD ? static_cast<size_t>(a.n) * a.k * sizeof(int) : 0);
  ladder_kernel<Key, RECORD><<<e, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// The checks all three entry points share.
bool bad_call(int e, int n, int k, int mxu_dist) {
  return e <= 0 || n <= 0 || n > kMaxAgents || k < 1 || k > n ||
         mxu_dist != 0;
}

knn::KnnArgs args_of(const float* loc_x, const float* loc_y,
                     const float* feats, const float* types_f,
                     const float* still_f, const float* t_norm, float* out,
                     int n, int k) {
  return knn::make_args(loc_x, loc_y, feats, types_f, still_f, t_norm,
                        nullptr, nullptr, nullptr, out, n, k);
}

}  // namespace

// Plain C entry points for ctypes, with the common signature
// (knn_common.cuh:KNN_ENTRY); the MXU-distance operands are not used
// (mxu_dist must be 0).  Each returns a cudaError_t: 0 on a launch that was
// accepted, cudaErrorInvalidValue for a call the kernel does not take
// (1 <= n <= 128, 1 <= k <= n, k <= 16 for K8; packed_bits 7 for K6, 0 for
// K7, either for K8).

// K6: the 7-bit packed order, per-slot selection.
KNN_ENTRY(knn_obs_packed) {
  if (bad_call(e, n, k, mxu_dist) || packed_bits != kPackedBits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch<PackedLadderKey, false>(
      args_of(loc_x, loc_y, feats, types_f, still_f, t_norm, out, n, k), e,
      static_cast<cudaStream_t>(stream)));
}

// K7: the exact order, per-slot selection.
KNN_ENTRY(knn_obs_onehot) {
  if (bad_call(e, n, k, mxu_dist) || packed_bits != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch<ExactLadderKey, false>(
      args_of(loc_x, loc_y, feats, types_f, still_f, t_norm, out, n, k), e,
      static_cast<cudaStream_t>(stream)));
}

// K8: the exact (packed_bits == 0) or 7-bit packed order, winners recorded
// first and selected in a second phase.
KNN_ENTRY(knn_obs_twolevel) {
  if (bad_call(e, n, k, mxu_dist) || k > kMaxRecordK ||
      (packed_bits != 0 && packed_bits != kPackedBits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const knn::KnnArgs a =
      args_of(loc_x, loc_y, feats, types_f, still_f, t_norm, out, n, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(packed_bits ? launch<PackedLadderKey, true>(a, e, st)
                                      : launch<ExactLadderKey, true>(a, e, st));
}
