// The envs-on-lanes k-nearest-neighbour observation kernel for
// TagContinuous, for Hopper (sm_90a), in its two tie-break modes.
//
// Replaces the TPU kernel warpdrive_tpu/ops/knn_obs.py:_knn_obs_kernel_v8
// (:1440), which _knn_observation_envlanes (:1561) launches (pallas_call
// :1610) for variant="envlanes" (knn_algorithm "pallas_envlanes") and
// "envlanes_exact" ("pallas_envlanes_exact"), for any agent count and any
// number of envs.  (On a TPU it runs in interpret mode only, :940-979.)
// Same contract as the Python wrapper
// warpdrive_tpu_torch/ops/knn_obs.py:knn_observation:
//
//   inputs  loc_x, loc_y (E, N), feats (E, 5, N), types_f (N,),
//           still_f (E, N), t_norm (E,)            all float32, contiguous
//   output  out (E, N, 8k+1) float32
//
// For env e and observer i the candidates j are every other live agent
// (still_j >= 0.5), at d2 = dx*dx + dy*dy (difference form, f32).  Order:
//   exact (packed_bits == 0): ascending d2, the lowest j first among equal
//          d2 (v8's index-min, :1526-1531); valid iff d2 < 1e18.
//   packed: ascending int32 key (bits(d2) & ~(2^b - 1)) | j with b =
//          max(bit_length(SUBn - 1), 1), SUBn = ceil(N/8)*8 (:1510-1515),
//          passed at launch (4 at N = 15, 7 at N = 105, 10 at N = 1024);
//          valid iff the key < bits(1e18).
// That is the function of K1 and K3 (knn_obs.cu).  The first min(k,
// #valid) candidates fill slots
//   [feat_j[c] - feat_i[c] for c in 0..4, type_j, 1, 1];
// later slots and every row of a dead observer are zeros; the row ends
// with t_norm[e] for a live observer.  v8 selects features by one-hot f32
// sums over the candidate sublanes (:1537-1540), exact; so does this
// kernel's gather by index.
//
// What bounds it: bytes.  At the flagship shape (E=1024, N=105, k=10) 38.3
// MB, 11.4 us at 3.35 TB/s; at (256, 1024, 10) 93.3 MB, 27.9 us.  The
// difference form is 5 flops a pair, 20 us for the 268 M pairs at (256,
// 1024, 10) at 67 TFLOP/s.  Beyond the bound, what costs time is the
// selection, as in K1.
//
// Design.  v8 puts envs on the TPU's 128 lanes so that every lane is busy
// at small N; on this card a warp is already filled by candidates, so K9
// runs the warp scan of K1 and K3 (knn_common.cuh: WarpList, one list
// entry a lane, the first round sorted and later ones ballot-filtered and
// inserted in ascending j, emit_warp_row's coalesced row stores).  What it keeps of its own is v8's reach: any N.
// A block serves 32 observers of one env (8 warps, each holding the lists
// of 4 observers at once: one key and one index register a lane each) and
// stages the env's candidates in chunks of 1024 -- x, y and alive flag, 12
// KB at any N -- so no agent count exceeds its shared memory.  A warp
// takes a chunk's candidates 32 at a time, one a lane, loads each once and
// offers it to its 4 lists.  At emission the lanes read the winners'
// features from global memory by index.  The kernel reads the (E, N)
// inputs directly: no relayout before the launch.  Every d2 is formed with
// __fmul_rn / __fadd_rn (and the library is built with -fmad=false), in
// the plain version's order, so kernel and plain agree bit for bit.

#include <cuda_runtime.h>

#include "knn_common.cuh"

namespace {

constexpr int kWarps = 8;                 // warps a block
constexpr int kLists = 4;                 // observers a warp serves at once
constexpr int kTile = kWarps * kLists;    // observers a block
constexpr int kChunk = 1024;              // candidates staged a pass
constexpr int kMaxK = knn::kWarpListMax;  // one list entry a lane

template <typename KeyOf>
__global__ void __launch_bounds__(kWarps* knn::kWarpLanes)
    envlanes_kernel(knn::KnnArgs a, KeyOf key_of) {
  using Key = typename KeyOf::Type;
  __shared__ float cx[kChunk];
  __shared__ float cy[kChunk];
  __shared__ float calive[kChunk];
  const int e = blockIdx.x;
  const int n = a.n;
  const int k = a.k;
  const int lane = threadIdx.x % knn::kWarpLanes;
  const int warp = threadIdx.x / knn::kWarpLanes;
  const long long env_base = static_cast<long long>(e) * n;

  // observer m of this warp: the block's tile, interleaved over the warps
  int obs[kLists];
  bool live[kLists];
  float xi[kLists];
  float yi[kLists];
  knn::WarpList<Key> lists[kLists];
#pragma unroll
  for (int m = 0; m < kLists; ++m) {
    obs[m] = blockIdx.y * kTile + m * kWarps + warp;
    live[m] = obs[m] < n && a.still_f[env_base + obs[m]] >= 0.5f;
    xi[m] = live[m] ? a.loc_x[env_base + obs[m]] : 0.0f;
    yi[m] = live[m] ? a.loc_y[env_base + obs[m]] : 0.0f;
    lists[m] = knn::WarpList<Key>(KeyOf::sentinel());
  }

  for (int chunk = 0; chunk < n; chunk += kChunk) {
    const int count = min(kChunk, n - chunk);
    __syncthreads();  // every warp is done with the previous chunk
    for (int q = threadIdx.x; q < count; q += blockDim.x) {
      cx[q] = a.loc_x[env_base + chunk + q];
      cy[q] = a.loc_y[env_base + chunk + q];
      calive[q] = a.still_f[env_base + chunk + q] >= 0.5f ? 1.0f : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < count; r += knn::kWarpLanes) {
      const int jj = r + lane;  // below kChunk: count <= kChunk, r % 32 == 0
      const int j = chunk + jj;
      const bool in = (jj < count) & (calive[jj] != 0.0f);
      const float x = cx[jj];
      const float y = cy[jj];
#pragma unroll
      for (int m = 0; m < kLists; ++m) {
        if (!live[m]) continue;  // the same in every lane of the warp
        Key kc;
        const bool valid =
            in & (j != obs[m]) &
            key_of(knn::diff_sq_dist(x, y, xi[m], yi[m]), j, &kc);
        const Key c = valid ? kc : KeyOf::sentinel();
        if (chunk + r == 0) {
          lists[m].first(valid, c, 0, k, lane);
        } else {
          lists[m].offer(valid, c, chunk + r, k, lane);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kLists; ++m) lists[m].finish();
  const knn::GlobalFeature feature{a.feats + env_base * 5, a.types_f, n};
  const float t_norm = a.t_norm[e];
  const int row_len = 8 * k + 1;
#pragma unroll
  for (int m = 0; m < kLists; ++m) {
    if (obs[m] >= n) continue;
    knn::emit_warp_row(a.out + (env_base + obs[m]) * row_len, lists[m], k,
                       live[m] ? t_norm : 0.0f, feature, obs[m], lane);
  }
}

template <typename KeyOf>
cudaError_t launch(const knn::KnnArgs& a, int e, KeyOf key_of,
                   cudaStream_t stream) {
  const dim3 grid(e, (a.n + kTile - 1) / kTile);
  envlanes_kernel<KeyOf><<<grid, kWarps * knn::kWarpLanes, 0, stream>>>(
      a, key_of);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes, with the common signature (knn_common.cuh:
// KNN_ENTRY).  The MXU-distance operands are not used (amat and aux are
// ignored, mxu_dist must be 0).  packed_bits == 0 selects the exact order,
// else the packed key with that many index bits.  Returns a cudaError_t: 0
// on a launch that was accepted, cudaErrorInvalidValue for a call the
// kernel does not take (1 <= k <= min(32, n); packed_bits in [1, 22] with
// n <= 2^packed_bits, or 0; grid rows below 65536).
KNN_ENTRY(knn_obs_envlanes) {
  int clear = 0;
  if (e <= 0 || n <= 0 || k < 1 || k > kMaxK || k > n ||
      !knn::packed_clear(packed_bits, n, &clear) || mxu_dist != 0 ||
      (n + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const knn::KnnArgs a =
      knn::make_args(loc_x, loc_y, feats, types_f, still_f, t_norm, nullptr,
                     nullptr, nullptr, out, n, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      packed_bits == 0 ? launch(a, e, knn::ExactKey{}, st)
                       : launch(a, e, knn::PackedKey{clear}, st);
  return static_cast<int>(err);
}
