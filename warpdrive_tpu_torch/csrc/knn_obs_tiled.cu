// The v7 multi-tile k-nearest-neighbour observation kernel for
// TagContinuous, for Hopper (sm_90a), in its four modes.
//
// Replaces the TPU kernel warpdrive_tpu/ops/knn_obs.py:_v7_body (:536),
// reached through _knn_obs_kernel_v7 (:521, difference-form distance) and
// _knn_obs_kernel_v7_mxu (:528, MXU-expansion distance), which
// _knn_observation_tiled dispatches for knn_algorithm "pallas_tiled",
// "pallas_tiled_exact", "pallas_mxudist" and "pallas_mxudist_exact" -- and
// for "pallas_mxu[_exact]" above 128 agents, where the env routes those
// names to "pallas_tiled[_exact]" (warpdrive_tpu/envs/tag_continuous.py:
// 195-203).  Same contract as the Python wrapper
// warpdrive_tpu_torch/ops/knn_obs.py:knn_observation, for k <= 16 (the TPU
// kernel's assert, knn_obs.py:1314):
//
//   inputs  loc_x, loc_y (E, N), feats (E, 5, N), types_f (N,),
//           still_f (E, N), t_norm (E,)            all float32, contiguous
//           amat (E, N, 12) bfloat16, centred (E, 2, N) float32: MXU mode
//           only, the candidate-side operand and the per-env centred x, y
//   output  out (E, N, 8k+1) float32
//
// What v7 computes, against v9 (K1/K3/K4 in knn_obs.cu).  For valid
// candidates the two are the same function: v9 adds +0.0 to them where v7
// writes BIG into the invalid ones with a where; v9 gates slot s by a
// pre-ladder count, v7 by a per-slot m2 < 1e18, and both give "more than s
// valid candidates"; and both pack b = bit_length(SUBn - 1) index bits.
// The invalid-candidate argument of knn_common.cuh holds in all four modes.
// What differs is v7's k <= 16, the TPU layout (row emit, (E, rows_pad,
// NP)), which the contract does not expose, and where the MXU distance's
// observer-side operand is made: v9 hoists bmat out of its kernel, v7 forms
// it in its body from the observer's centred coordinates (knn_obs.py:
// 606-631).  This kernel does the same: CentredTerms below forms observer
// i's 12 terms in the kernel -- the bf16 hi/lo split of xc, yc and of n_i =
// xc*xc + yc*yc, and the -2 scaling -- with the rounding of the wrapper's
// expansion_operands, so its d2 equals K4's and the plain version's bit for
// bit.  The difference-form modes run the same scan as K1/K3.
//
// What bounds it: as for knn_obs.cu -- bytes (93.3 MB at (256, 1024, 10),
// 27.9 us at 3.35 TB/s) in every mode: the MXU expansion is 12
// multiply-adds a pair, 6.5 us for all pairs there at the tensor cores'
// bf16 rate, though this kernel runs it on the CUDA cores (ExpansionDist,
// 12 multiplies and 11 adds a pair), bit for bit with the plain version;
// K4's tensor-core tile (knn_common.cuh:tile_kernel) could take its place.
//
// Design: the warp scan of knn_common.cuh (scan_kernel), as for K1, K3 and
// K4 -- one warp per observer, the candidates 32 at a time across the
// lanes, the k-list one entry a lane (the first round sorted, later ones
// ballot-filtered and inserted in ascending j), and the row written by the
// whole warp with coalesced stores
// -- under this entry point, with CentredTerms as the observer side of the
// MXU distance and v7's k <= 16.  __fmul_rn / __fadd_rn distances in the
// plain version's order: bit for bit equal to the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "knn_common.cuh"

namespace {

constexpr int kMaxK = 16;  // the TPU kernel's k <= _VALID_ROWS

// The bf16 hi/lo pair of v: hi = bf16(v), lo = bf16(v - hi), both rounded
// to nearest even, as float32 values.
__device__ __forceinline__ void bf16_pair(float v, float* hi, float* lo) {
  *hi = __bfloat162float(__float2bfloat16_rn(v));
  *lo = __bfloat162float(__float2bfloat16_rn(__fsub_rn(v, *hi)));
}

// v7's observer-side MXU operand, formed in the kernel from observer i's
// centred coordinates (warpdrive_tpu/ops/knn_obs.py:606-631):
// [-2xh, -2xl, -2xh, -2xl, -2yh, -2yl, -2yh, -2yl, 1, 1, nh, nl] with n =
// xc*xc + yc*yc.  Doubling a bf16 value is exact.
struct CentredTerms {
  __device__ __forceinline__ static void load(const knn::KnnArgs& a, int e,
                                              int i, float* b) {
    const float* c = a.centred + static_cast<long long>(e) * 2 * a.n;
    const float xc = c[i];
    const float yc = c[a.n + i];
    float xh, xl, yh, yl, nh, nl;
    bf16_pair(xc, &xh, &xl);
    bf16_pair(yc, &yh, &yl);
    bf16_pair(__fadd_rn(__fmul_rn(xc, xc), __fmul_rn(yc, yc)), &nh, &nl);
    const float v[knn::kTerms] = {
        __fmul_rn(-2.0f, xh), __fmul_rn(-2.0f, xl), __fmul_rn(-2.0f, xh),
        __fmul_rn(-2.0f, xl), __fmul_rn(-2.0f, yh), __fmul_rn(-2.0f, yl),
        __fmul_rn(-2.0f, yh), __fmul_rn(-2.0f, yl), 1.0f,
        1.0f,                 nh,                   nl};
#pragma unroll
    for (int t = 0; t < knn::kTerms; ++t) b[t] = v[t];
  }
};

template <typename Dist>
cudaError_t launch(const knn::KnnArgs& a, int e, int packed_bits, int clear,
                   cudaStream_t stream) {
  return packed_bits == 0
             ? knn::launch_scan<knn::ExactKey, Dist>(a, e, knn::ExactKey{},
                                                     stream)
             : knn::launch_scan<knn::PackedKey, Dist>(
                   a, e, knn::PackedKey{clear}, stream);
}

}  // namespace

// Plain C entry point for ctypes, with the common signature (knn_common.cuh:
// KNN_ENTRY).  packed_bits == 0 selects the exact order, else the packed
// key with that many index bits; mxu_dist != 0 selects the MXU-expansion
// distance (amat, and the centred coordinates as aux, required).
// Returns a cudaError_t: 0 on a launch that was accepted,
// cudaErrorInvalidValue for a shape it does not take (1 <= k <= min(16,
// n); packed_bits in [1, 22] with n <= 2^packed_bits, or 0) or an N whose
// staging exceeds the card's shared memory.
KNN_ENTRY(knn_obs_tiled) {
  int clear = 0;
  if (e <= 0 || n <= 0 || k < 1 || k > kMaxK || k > n ||
      !knn::packed_clear(packed_bits, n, &clear) ||
      (mxu_dist && (amat == nullptr || aux == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const knn::KnnArgs a =
      knn::make_args(loc_x, loc_y, feats, types_f, still_f, t_norm,
                     mxu_dist ? amat : nullptr, nullptr,
                     mxu_dist ? aux : nullptr, out, n, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      mxu_dist ? launch<knn::ExpansionDist<CentredTerms>>(a, e, packed_bits,
                                                           clear, st)
               : launch<knn::DiffDist>(a, e, packed_bits, clear, st);
  return static_cast<int>(err);
}
