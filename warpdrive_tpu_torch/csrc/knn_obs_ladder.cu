// The single-tile ladder k-nearest-neighbour observation kernels for
// TagContinuous, for Hopper (sm_90a): one kernel templated on its key
// (exact or 7-bit packed) and three entry points, one per TPU kernel it
// replaces.
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
// the function reads 3.4 MB and writes 34.8 MB: 11.4 us at 3.35 TB/s; the
// difference form's 5 flops a pair take 1.7 us at 67 TFLOP/s.  The time is
// set by instruction issue instead: k passes of N candidates per observer
// on top of the distances, so each pass is cut to a few instructions.
//
// Design: the TPU ladder as warp-wide hardware min-reductions.  The block
// stages its env's x, y, alive flag and six selectable channels in shared
// memory (knn_common.cuh:stage_env); each warp takes its observers one at
// a time, in scan_grid's geometry (a warp per 8 observers, at most 16, and
// enough blocks an env to fill the card at small E).  Candidate j = lane +
// 32q (q < 4) sits in lane j % 32's registers as a 32-bit key; self, dead
// and missing candidates hold the all-ones key, above every valid one.
// Each lane sorts its four entries once by (key, j), so that its head,
// entry 0, is its least key at its lowest j.  A pass of the ladder is
// v1/v2/v6's slot_body over the heads:
//   packed (K6, K8 packed): the int32 key (bits(d2) & ~127) | j, unique;
//          __reduce_min_sync (one REDUX) over the heads gives the winner,
//          its low 7 bits the index.
//   exact (K7, K8 exact): the key bits(d2) as unsigned (d2 >= +0, so the
//          bit order is the float order); one REDUX gives the least key m,
//          a second the lowest j among the heads at m: the lowest j at the
//          least d2, as v1's min then index-min and v6's exact index-min
//          give.  Other candidates at the same d2 stay for the next passes.
// The winner's lane pops its head (its other entries move up one).  A
// winner is valid iff its key is below bits(1e18); the passes stop at the
// first invalid one, since every key left is invalid then.  Lane 0
// records each pass's winner in the warp's table of k ints in shared
// memory (v6's record-winners-then-select, at warp scope, for every mode);
// after the passes the warp writes the observer's 8k+1 floats from the
// table with 128-byte stores (knn_common.cuh:emit_row), a dead observer's
// row as zeros.  So K7 and K8 exact run one code, and K6 and K8 packed
// another; the entry points keep the TPU kernels' limits.  Distances use
// __fmul_rn / __fadd_rn (and the library is built with -fmad=false), in
// the plain version's order, so kernel and plain agree bit for bit.

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

#include "knn_common.cuh"

namespace {

constexpr int kMaxAgents = 128;                         // one TPU lane tile
constexpr int kPerLane = kMaxAgents / knn::kWarpLanes;  // candidates a lane
constexpr int kPackedBits = 7;  // _CLEAR_MASK clears 7 bits
constexpr int kClearMask = ~((1 << kPackedBits) - 1);
constexpr int kMaxRecordK = 16;  // v6's k <= _VALID_ROWS

// A lane's four entries, sorted ascending by (key, j): a sorting network
// of five compare-exchanges.
template <typename T>
__device__ __forceinline__ void compare_exchange(T& ka, int& ja, T& kb,
                                                 int& jb) {
  const bool swap = kb < ka || (kb == ka && jb < ja);
  const T k = ka;
  const int j = ja;
  ka = swap ? kb : ka;
  kb = swap ? k : kb;
  ja = swap ? jb : ja;
  jb = swap ? j : jb;
}

template <typename T>
__device__ __forceinline__ void sort_lane(T (&key)[kPerLane],
                                          int (&idx)[kPerLane]) {
  compare_exchange(key[0], idx[0], key[1], idx[1]);
  compare_exchange(key[2], idx[2], key[3], idx[3]);
  compare_exchange(key[0], idx[0], key[2], idx[2]);
  compare_exchange(key[1], idx[1], key[3], idx[3]);
  compare_exchange(key[1], idx[1], key[2], idx[2]);
}

// Pops a lane's head: its other entries move up one.
template <typename T>
__device__ __forceinline__ void pop_head(T (&key)[kPerLane], T invalid) {
#pragma unroll
  for (int q = 0; q + 1 < kPerLane; ++q) key[q] = key[q + 1];
  key[kPerLane - 1] = invalid;
}

// Each key type's take() is one pass over the lanes' sorted entries: the
// winner's index, its entry popped, or -1 when no valid key is left.

// Packed order: the int32 key (bits(d2) & ~127) | j of v2 and v6.
struct PackedLadderKey {
  using Type = int;
  __device__ static Type invalid() { return INT_MAX; }
  __device__ __forceinline__ static Type make(float d2, int j) {
    return (__float_as_int(d2) & kClearMask) | j;
  }
  __device__ __forceinline__ static int take(Type (&key)[kPerLane],
                                             int (&)[kPerLane]) {
    const Type m = __reduce_min_sync(knn::kFullMask, key[0]);
    // keys are unique: one head holds m (an invalid m pops nothing but
    // invalid keys)
    if (key[0] == m) pop_head(key, invalid());
    return m < __float_as_int(knn::kValidMax) ? m & ~kClearMask : -1;
  }
};

// Exact order: bits(d2) as unsigned, the lowest index first among equal
// keys.
struct ExactLadderKey {
  using Type = unsigned;
  __device__ static Type invalid() { return 0xffffffffu; }
  __device__ __forceinline__ static Type make(float d2, int) {
    return __float_as_uint(d2);
  }
  __device__ __forceinline__ static int take(Type (&key)[kPerLane],
                                             int (&idx)[kPerLane]) {
    const Type m = __reduce_min_sync(knn::kFullMask, key[0]);
    const int w = static_cast<int>(__reduce_min_sync(
        knn::kFullMask,
        key[0] == m ? static_cast<unsigned>(idx[0]) : invalid()));
    if (idx[0] == w) {
      pop_head(key, invalid());
      pop_head(idx, 0);
    }
    return m < __float_as_uint(knn::kValidMax) ? w : -1;
  }
};

template <typename Key>
__global__ void __launch_bounds__(knn::kScanMaxWarps* knn::kWarpLanes)
    ladder_kernel(knn::KnnArgs a) {
  extern __shared__ __align__(16) float knn_smem[];
  const int e = blockIdx.x;
  const int n = a.n;
  const int k = a.k;
  const knn::EnvTile t = knn::stage_env(knn_smem, a.loc_x, a.loc_y, a.feats,
                                        a.types_f, a.still_f, e, n);
  const int lane = threadIdx.x % knn::kWarpLanes;
  const int warp = threadIdx.x / knn::kWarpLanes;
  const int warps = blockDim.x / knn::kWarpLanes;
  // the warp's winners: slot s's candidate at winners[s]
  int* winners = reinterpret_cast<int*>(knn_smem + knn::env_floats(n)) +
                 warp * k;
  const int row_len = 8 * k + 1;
  const float t_norm = a.t_norm[e];
  const knn::StagedFeature feature{t.f, n};
  for (int i = blockIdx.y * warps + warp; i < n; i += gridDim.y * warps) {
    const bool live = t.alive[i] != 0.0f;
    int n_valid = 0;
    if (live) {
      const knn::DiffDist dist(t, nullptr, a, e, i);
      typename Key::Type key[kPerLane];
      int idx[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        // a lane past the last candidate reads candidate n - 1, so that
        // every load stays in the staging
        const int j = lane + knn::kWarpLanes * q;
        const int jc = min(j, n - 1);
        const bool valid = (j < n) & (j != i) & (t.alive[jc] != 0.0f);
        key[q] = valid ? Key::make(dist(jc), jc) : Key::invalid();
        idx[q] = j;
      }
      sort_lane(key, idx);
      for (; n_valid < k; ++n_valid) {
        const int w = Key::take(key, idx);
        if (w < 0) break;
        if (lane == 0) winners[n_valid] = w;
      }
      __syncwarp();
    }
    knn::emit_row(
        a.out + (static_cast<long long>(e) * n + i) * row_len,
        [&](int s) { return s < n_valid ? winners[s] : 0; }, n_valid, k,
        live ? t_norm : 0.0f, feature, i, lane);
    __syncwarp();  // every lane has read the table before it is rewritten
  }
}

template <typename Key>
cudaError_t launch(const knn::KnnArgs& a, int e, cudaStream_t stream) {
  const int warps = std::min(knn::kScanMaxWarps, (a.n + 7) / 8);
  const size_t smem =
      static_cast<size_t>(knn::env_floats(a.n)) * sizeof(float) +
      static_cast<size_t>(warps) * a.k * sizeof(int);
  ladder_kernel<Key><<<knn::scan_grid(e, a.n, warps),
                       warps * knn::kWarpLanes, smem, stream>>>(a);
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

// K6: the 7-bit packed order.
KNN_ENTRY(knn_obs_packed) {
  if (bad_call(e, n, k, mxu_dist) || packed_bits != kPackedBits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch<PackedLadderKey>(
      args_of(loc_x, loc_y, feats, types_f, still_f, t_norm, out, n, k), e,
      static_cast<cudaStream_t>(stream)));
}

// K7: the exact order.
KNN_ENTRY(knn_obs_onehot) {
  if (bad_call(e, n, k, mxu_dist) || packed_bits != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch<ExactLadderKey>(
      args_of(loc_x, loc_y, feats, types_f, still_f, t_norm, out, n, k), e,
      static_cast<cudaStream_t>(stream)));
}

// K8: the exact (packed_bits == 0) or 7-bit packed order, k <= 16.
KNN_ENTRY(knn_obs_twolevel) {
  if (bad_call(e, n, k, mxu_dist) || k > kMaxRecordK ||
      (packed_bits != 0 && packed_bits != kPackedBits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const knn::KnnArgs a =
      args_of(loc_x, loc_y, feats, types_f, still_f, t_norm, out, n, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(packed_bits ? launch<PackedLadderKey>(a, e, st)
                                      : launch<ExactLadderKey>(a, e, st));
}
