// Single-tile k-nearest-neighbour observation for TagContinuous, for Hopper
// (sm_90a), in the two tie-break modes of the TPU's MXU-select kernel.
//
// Replaces the TPU kernel warpdrive_tpu/ops/knn_obs.py:_knn_obs_kernel_v3,
// which knn_observation launches for variant="mxu" (knn_algorithm
// "pallas_mxu") and variant="mxu_exact" ("pallas_mxu_exact", the shipped
// tag_continuous training config).  Same contract as the Python wrapper
// warpdrive_tpu_torch/ops/knn_obs.py:knn_observation, for N <= 128 agents
// and k <= 16 (the TPU kernel's own limits):
//
//   inputs  loc_x, loc_y (E, N), feats (E, 5, N), types_f (N,),
//           still_f (E, N), t_norm (E,)            all float32, contiguous
//   output  out (E, N, 8k+1) float32
//
// For env e and observer i the candidates j are every other live agent
// (still_j >= 0.5).  Their order:
//   exact  (packed_bits 0): ascending d2 = dx*dx + dy*dy (dx = x_j - x_i,
//          f32, difference form), the lowest j first among equal d2;
//          valid iff d2 < 1e18 (the TPU kernel's _VALID_MAX).
//   packed (packed_bits 7): ascending int32 key (bits(d2) & ~127) | j, the
//          TPU kernel's 7-bit packed index (_CLEAR_MASK): two distances
//          that differ only in their low 7 mantissa bits order by index,
//          not by distance.  Valid iff key < bits(1e18).
// The first min(k, #valid) candidates fill slots
//   [feat_j[c] - feat_i[c] for c in 0..4, type_j, 1, 1];
// later slots and every row of a dead observer are zeros; the row ends
// with t_norm[e] for a live observer.  The TPU kernel selects features
// through a bf16 hi/lo matmul; this kernel gathers them as exact f32.
//
// That is K1's function in the exact order (ExactKey with DiffDist) and
// K3's with b = 7 in the packed one (PackedKey with clear = ~127), so K2
// runs the warp scan of knn_common.cuh (scan_kernel) at its own limits:
// one warp per observer, the candidates 32 at a time across the lanes, the
// k-list one entry a lane (the first round sorted, later ones
// ballot-filtered and inserted lowest lane first), the row written by the
// whole warp with coalesced stores.
//
// What bounds it: bytes.  At the training config (E=100, N=110, k=10) it
// reads 0.35 MB and writes 3.56 MB: 1.17 us at 3.35 TB/s, below the
// latency of one launch, so the floor there is a launch's; at E=1024,
// N=105, k=10 the bound is 11.4 us.  The distance work is a few flops per
// pair, far below the f32 rate.  Geometry: launch_scan's, a warp for every
// 8 of an env's observers and blocks that fill the card ((100, 8) blocks
// of 14 warps at the training shape); it measured faster there than one
// block an env of 4, 8 or 16 warps.
// Distances use __fmul_rn / __fadd_rn and the library is built with
// -fmad=false, so they round as the plain PyTorch versions round them.

#include <cuda_runtime.h>

#include "knn_common.cuh"

namespace {

constexpr int kPackedBits = 7;  // the TPU kernel's _CLEAR_MASK clears 7 bits
constexpr int kClearMask = ~((1 << kPackedBits) - 1);
constexpr int kMaxAgents = 128;
constexpr int kMaxK = 16;

}  // namespace

// Plain C entry point for ctypes, with the common signature (knn_common.cuh:
// KNN_ENTRY).  packed_bits is 0 (exact) or 7 (the packed tie-break); the
// MXU-distance operands are not used (mxu_dist must be 0).  Returns a
// cudaError_t: 0 on a launch that was accepted, cudaErrorInvalidValue for
// a shape the kernel does not take (1 <= n <= 128, 1 <= k <= min(16, n))
// or other packed bits.
KNN_ENTRY(knn_obs_mxu) {
  if (e <= 0 || n <= 0 || n > kMaxAgents || k < 1 || k > kMaxK || k > n ||
      (packed_bits != 0 && packed_bits != kPackedBits) || mxu_dist != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const knn::KnnArgs a =
      knn::make_args(loc_x, loc_y, feats, types_f, still_f, t_norm, nullptr,
                     nullptr, nullptr, out, n, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      packed_bits == 0
          ? knn::launch_scan<knn::ExactKey, knn::DiffDist>(
                a, e, knn::ExactKey{}, st)
          : knn::launch_scan<knn::PackedKey, knn::DiffDist>(
                a, e, knn::PackedKey{kClearMask}, st);
  return static_cast<int>(err);
}
