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
//   inputs  planes (8, N, E) float32: x, y, still, then the 5 features,
//           each an (agent, env) plane with the env fastest -- built by the
//           wrapper with a permute, as the JAX wrapper's to_lanes builds
//           its (channel, agent, env) operands outside its kernel
//           (knn_obs.py:1586-1605); types_f (N,), t_norm (E,) float32
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
// The first min(k, #valid) candidates fill slots
//   [feat_j[c] - feat_i[c] for c in 0..4, type_j, 1, 1];
// later slots and every row of a dead observer are zeros; the row ends
// with t_norm[e] for a live observer.  v8 selects features by one-hot f32
// sums over the candidate sublanes (:1537-1540), exact; so does this
// kernel's gather by index.
//
// What bounds it: bytes.  At the flagship shape (E=1024, N=105, k=10) 38.3
// MB, 11.4 us at 3.35 TB/s; at (256, 1024, 10) 93.3 MB, 27.9 us (the
// planes' permute, a torch op before the launch, moves another 2 x 29 MB
// there and is not counted).  The difference form is 5 flops a pair, 20 us
// for the 268 M pairs at (256, 1024, 10) at 67 TFLOP/s.
//
// Design (correct first, simple), v8's idea on Hopper: envs, not agents,
// on the parallel fast axis, so every lane is a live env at any N.  One
// thread per (env, observer), the env fastest: a block is 32 envs (one
// warp, the lanes) by 8 observers (v8's 8 observers per grid step), and
// the grid covers ceil(E/32) x ceil(N/8) blocks.  Candidates are staged in
// chunks of 64: the block's threads copy the chunk's x, y and alive flag
// of its 32 envs into shared memory (each warp load is 32 adjacent envs of
// one candidate, one coalesced 128-byte access), and all 8 observers scan
// them, so a chunk is 24 KB at any N (1024 agents x 9 floats of an env
// would not fit a block's 227 KB for 32 envs).  Each thread keeps its k
// best in a register-resident sorted list (knn_common.cuh: SortedList,
// ExactKey or PackedKey) over an ascending scan, whose strict "<" keeps the
// lowest index first among equal exact keys; invalid candidates are
// skipped and the valid ones counted (knn_common.cuh explains why that
// equals v8's BIG-masked ladder).  Then each thread reads its winners'
// features from the planes (adjacent threads read adjacent envs) and
// writes its row.  Known cost left for later: adjacent threads' rows lie
// N * (8k+1) * 4 bytes apart, so the row stores are uncoalesced.  Every d2
// is formed with __fmul_rn / __fadd_rn (and the library is built with
// -fmad=false), in the plain version's order, so kernel and plain agree bit
// for bit.

#include <cuda_runtime.h>

#include "knn_common.cuh"

namespace {

constexpr int kEnvs = 32;       // envs a block: the fast thread axis
constexpr int kObservers = 8;   // observers a block
constexpr int kChunk = 64;      // candidates staged a pass
constexpr int kMaxK = 32;       // the largest K_MAX instantiation

template <int K_MAX, typename KeyOf>
__global__ void __launch_bounds__(kEnvs* kObservers)
    envlanes_kernel(const float* __restrict__ planes,
                    const float* __restrict__ types_f,
                    const float* __restrict__ t_norm, float* __restrict__ out,
                    int num_envs, int n, int k, KeyOf key_of) {
  __shared__ float cx[kChunk][kEnvs];
  __shared__ float cy[kChunk][kEnvs];
  __shared__ float calive[kChunk][kEnvs];
  const int le = threadIdx.x;
  const int e = blockIdx.x * kEnvs + le;
  const int i = blockIdx.y * kObservers + threadIdx.y;
  const long long plane = static_cast<long long>(n) * num_envs;
  const bool active = e < num_envs && i < n;
  const long long own_at = static_cast<long long>(i) * num_envs + e;
  const float xi = active ? planes[own_at] : 0.0f;
  const float yi = active ? planes[plane + own_at] : 0.0f;
  const bool alive_i = active && planes[2 * plane + own_at] >= 0.5f;

  knn::SortedList<K_MAX, typename KeyOf::Type> list(KeyOf::sentinel());
  int n_valid = 0;
  const int tid = threadIdx.y * kEnvs + threadIdx.x;
  for (int base = 0; base < n; base += kChunk) {
    const int count = min(kChunk, n - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int q = tid; q < count * kEnvs; q += kEnvs * kObservers) {
      const int jj = q / kEnvs;
      const int ee = q - jj * kEnvs;
      const int eg = blockIdx.x * kEnvs + ee;
      float x = 0.0f, y = 0.0f, alive = 0.0f;
      if (eg < num_envs) {
        const long long at = static_cast<long long>(base + jj) * num_envs + eg;
        x = planes[at];
        y = planes[plane + at];
        alive = planes[2 * plane + at] >= 0.5f ? 1.0f : 0.0f;
      }
      cx[jj][ee] = x;
      cy[jj][ee] = y;
      calive[jj][ee] = alive;
    }
    __syncthreads();
    if (!alive_i) continue;
    for (int jj = 0; jj < count; ++jj) {
      const int j = base + jj;
      if (j == i || calive[jj][le] == 0.0f) continue;
      const float dx = __fsub_rn(cx[jj][le], xi);
      const float dy = __fsub_rn(cy[jj][le], yi);
      typename KeyOf::Type key;
      if (!key_of(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), j, &key)) {
        continue;
      }
      ++n_valid;
      list.insert(key, j, k);
    }
  }
  if (!active) return;

  const int row_len = 8 * k + 1;
  float* row = out + (static_cast<long long>(e) * n + i) * row_len;
  if (!alive_i) {
    knn::zero_row(row, row_len);
    return;
  }
  const float* feat = planes + 3 * plane;  // feature c of (j, e) at
                                           // feat[c * plane + j * E + e]
  float own[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) own[c] = feat[c * plane + own_at];
#pragma unroll
  for (int s = 0; s < K_MAX; ++s) {
    if (s < k) {
      float* slot = row + 8 * s;
      if (s < n_valid) {
        const int j = list.idx[s];
        const long long at = static_cast<long long>(j) * num_envs + e;
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          slot[c] = __fsub_rn(feat[c * plane + at], own[c]);
        }
        slot[5] = types_f[j];
        slot[6] = 1.0f;
        slot[7] = 1.0f;
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) slot[c] = 0.0f;
      }
    }
  }
  row[8 * k] = t_norm[e];
}

template <int K_MAX, typename KeyOf>
cudaError_t launch(const float* planes, const float* types_f,
                   const float* t_norm, float* out, int e, int n, int k,
                   KeyOf key_of, cudaStream_t stream) {
  const dim3 block(kEnvs, kObservers);
  const dim3 grid((e + kEnvs - 1) / kEnvs, (n + kObservers - 1) / kObservers);
  envlanes_kernel<K_MAX, KeyOf><<<grid, block, 0, stream>>>(
      planes, types_f, t_norm, out, e, n, k, key_of);
  return cudaGetLastError();
}

template <typename KeyOf>
cudaError_t launch_keyed(const float* planes, const float* types_f,
                         const float* t_norm, float* out, int e, int n, int k,
                         KeyOf key_of, cudaStream_t stream) {
  return k <= 16 ? launch<16>(planes, types_f, t_norm, out, e, n, k, key_of,
                              stream)
                 : launch<32>(planes, types_f, t_norm, out, e, n, k, key_of,
                              stream);
}

}  // namespace

// Plain C entry point for ctypes, with the common signature (knn_common.cuh:
// KNN_ENTRY).  aux is the (8, N, E) planes; loc_x, loc_y, feats and still_f
// are read through them, and the MXU-distance operands are not used
// (mxu_dist must be 0).  packed_bits == 0 selects the exact order, else the
// packed key with that many index bits.  Returns a cudaError_t: 0 on a
// launch that was accepted, cudaErrorInvalidValue for a call the kernel
// does not take (1 <= k <= min(32, n); packed_bits in [1, 22] with n <=
// 2^packed_bits, or 0; the planes given; grid rows below 65536).
KNN_ENTRY(knn_obs_envlanes) {
  int clear = 0;
  if (e <= 0 || n <= 0 || k < 1 || k > kMaxK || k > n ||
      !knn::packed_clear(packed_bits, n, &clear) || mxu_dist != 0 ||
      aux == nullptr || (n + kObservers - 1) / kObservers > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* planes = static_cast<const float*>(aux);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      packed_bits == 0
          ? launch_keyed(planes, types_f, t_norm, out, e, n, k,
                         knn::ExactKey{}, st)
          : launch_keyed(planes, types_f, t_norm, out, e, n, k,
                         knn::PackedKey{clear}, st);
  return static_cast<int>(err);
}
