// Single-tile k-nearest-neighbour observation for TagContinuous, for Hopper
// (sm_90a), in the two tie-break modes of the TPU's MXU-select kernel.
//
// Replaces the TPU kernel warpdrive_tpu/ops/knn_obs.py:_knn_obs_kernel_v3,
// which knn_observation launches for variant="mxu" (knn_algorithm
// "pallas_mxu") and variant="mxu_exact" ("pallas_mxu_exact", the shipped
// tag_continuous training config).  Same contract as the Python wrapper
// warpdrive_tpu_torch/ops/knn_obs.py:knn_observation, for N <= 128 agents
// and k <= 16:
//
//   inputs  loc_x, loc_y (E, N), feats (E, 5, N), types_f (N,),
//           still_f (E, N), t_norm (E,)            all float32, contiguous
//   output  out (E, N, 8k+1) float32
//
// For env e and observer i the candidates j are every other live agent
// (still_j >= 0.5).  Their order:
//   exact  (PACKED=false): ascending d2 = dx*dx + dy*dy (dx = x_j - x_i,
//          f32, difference form), the lowest j first among equal d2;
//          valid iff d2 < 1e18 (the TPU kernel's _VALID_MAX).
//   packed (PACKED=true):  ascending int32 key (bits(d2) & ~127) | j, the
//          TPU kernel's 7-bit packed index (_CLEAR_MASK): two distances
//          that differ only in their low 7 mantissa bits order by index,
//          not by distance.  Valid iff key < bits(1e18).
// The first min(k, #valid) candidates fill slots
//   [feat_j[c] - feat_i[c] for c in 0..4, type_j, 1, 1];
// later slots and every row of a dead observer are zeros; the row ends
// with t_norm[e] for a live observer.  The TPU kernel selects features
// through a bf16 hi/lo matmul; this kernel gathers them as exact f32.
//
// What bounds it: bytes.  At the training config (E=100, N=110, k=10) it
// reads 0.35 MB and writes 3.56 MB: 1.17 us at 3.35 TB/s, so launch
// latency dominates there.  At E=1024, N=105, k=10 the bound is 11.4 us.
// The distance work is a few flops per pair, far below the f32 rate.
//
// Design (correct first, simple): one block per env, one thread per
// observer (N <= 128, so the block holds the whole tile, rounded up to a
// warp multiple).  The block stages its env's x, y, alive flag and six
// selectable channels in shared memory; each thread scans the candidates
// in ascending j into a register-resident sorted list (knn_common.cuh:
// select_and_emit with DiffDist and ExactKey, or PackedKey with 7 bits),
// whose strict "<" gives the lowest-index tie-break in exact mode (packed
// keys are unique).  The rows are staged in shared memory too -- at most
// N * (8k+1) * 4 B = 66 KB at N=128, k=16, which needs the dynamic
// shared-memory limit raised -- and the block writes its env's contiguous
// output block with 16-byte stores, a scalar head and tail around them.
// Distances use __fmul_rn / __fadd_rn and the library is built with
// -fmad=false, so they round as the plain PyTorch versions round them.

#include <cstdint>

#include <cuda_runtime.h>

#include "knn_common.cuh"

namespace {

constexpr int kPackedBits = 7;  // the TPU kernel's _CLEAR_MASK clears 7 bits
constexpr int kClearMask = ~((1 << kPackedBits) - 1);
constexpr int kMaxAgents = 128;
constexpr int kMaxK = 16;

template <bool PACKED, int K_MAX>
__global__ void knn_obs_mxu_kernel(
    const float* __restrict__ loc_x, const float* __restrict__ loc_y,
    const float* __restrict__ feats, const float* __restrict__ types_f,
    const float* __restrict__ still_f, const float* __restrict__ t_norm,
    float* __restrict__ out, int n, int k) {
  extern __shared__ float smem[];
  const int e = blockIdx.x;
  const knn::EnvTile t =
      knn::stage_env(smem, loc_x, loc_y, feats, types_f, still_f, e, n);
  const int row_len = 8 * k + 1;
  float* stage = smem + (3 + knn::kChannels) * n;  // n rows of row_len

  const int i = threadIdx.x;
  if (i < n) {
    float* row = stage + i * row_len;
    if (t.alive[i] == 0.0f) {
      knn::zero_row(row, row_len);
    } else {
      const knn::KnnArgs unused{};
      const knn::DiffDist dist(t, nullptr, unused, e, i);
      if (PACKED) {
        knn::select_and_emit<K_MAX>(row, t, knn::PackedKey{kClearMask}, dist,
                                    i, k, t_norm[e]);
      } else {
        knn::select_and_emit<K_MAX>(row, t, knn::ExactKey{}, dist, i, k,
                                    t_norm[e]);
      }
    }
  }
  __syncthreads();

  // the env's rows are one contiguous block of the output: scalar stores
  // up to a 16-byte boundary, float4 stores, then the scalar tail
  float* dst = out + static_cast<long long>(e) * n * row_len;
  const int total = n * row_len;
  const int misalign = static_cast<int>(
      (reinterpret_cast<uintptr_t>(dst) / sizeof(float)) % 4);
  const int head = min(total, (4 - misalign) % 4);
  if (static_cast<int>(threadIdx.x) < head) {
    dst[threadIdx.x] = stage[threadIdx.x];
  }
  const int body = (total - head) / 4;
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
  for (int q = threadIdx.x; q < body; q += blockDim.x) {
    const float* s = stage + head + 4 * q;
    dst4[q] = make_float4(s[0], s[1], s[2], s[3]);
  }
  for (int f = head + 4 * body + threadIdx.x; f < total; f += blockDim.x) {
    dst[f] = stage[f];
  }
}

template <bool PACKED>
cudaError_t launch(const float* loc_x, const float* loc_y, const float* feats,
                   const float* types_f, const float* still_f,
                   const float* t_norm, float* out, int e, int n, int k,
                   cudaStream_t stream) {
  const int threads = ((n + 31) / 32) * 32;
  const size_t smem =
      (static_cast<size_t>(3 + knn::kChannels) * n +
       static_cast<size_t>(n) * (8 * k + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_obs_mxu_kernel<PACKED, kMaxK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  knn_obs_mxu_kernel<PACKED, kMaxK><<<e, threads, smem, stream>>>(
      loc_x, loc_y, feats, types_f, still_f, t_norm, out, n, k);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes, with the common signature (knn_common.cuh:
// KNN_ENTRY).  packed_bits is 0 (exact) or 7 (the packed tie-break); the
// MXU-distance operands are not used (mxu_dist must be 0).  Returns a
// cudaError_t: 0 on a launch that was accepted, cudaErrorInvalidValue for
// a shape the kernel does not take (1 <= n <= 128, 1 <= k <= 16) or other
// packed bits.
KNN_ENTRY(knn_obs_mxu) {
  if (e <= 0 || n <= 0 || n > kMaxAgents || k < 1 || k > kMaxK ||
      (packed_bits != 0 && packed_bits != kPackedBits) || mxu_dist != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      packed_bits ? launch<true>(loc_x, loc_y, feats, types_f, still_f,
                                 t_norm, out, e, n, k, st)
                  : launch<false>(loc_x, loc_y, feats, types_f, still_f,
                                  t_norm, out, e, n, k, st);
  return static_cast<int>(err);
}
