// The v9 flat k-nearest-neighbour observation kernels for TagContinuous,
// for Hopper (sm_90a): the templated warp scan (knn_common.cuh:
// scan_kernel, and its tensor-core tile tile_kernel for K4) and three entry
// points, one per TPU kernel they replace.
//
//   knn_obs_flat_exact    K1  _knn_obs_kernel_v9 (knn_obs.py:711), i.e.
//                             _v9_body(exact=True, dist_mxu=False):
//                             knn_algorithm="pallas_flat_exact"
//   knn_obs_flat          K3  the same with exact=False (packed ties):
//                             "pallas_flat"
//   knn_obs_flat_mxudist  K4  _knn_obs_kernel_v9_mxu (knn_obs.py:720),
//                             _v9_body(dist_mxu=True), exact or packed:
//                             "pallas_flat_mxudist[_exact]"
//
// All three are dispatched by _knn_observation_flat on the TPU and by the
// Python wrapper warpdrive_tpu_torch/ops/knn_obs.py:knn_observation here,
// with its contract:
//
//   inputs  loc_x, loc_y (E, N), feats (E, 5, N), types_f (N,),
//           still_f (E, N), t_norm (E,)            all float32, contiguous
//           amat (E, N, 12), bmat (E, 12, N)       bfloat16 (K4 only: the
//           MXU distance operands, built by the wrapper's expansion_operands)
//   output  out (E, N, 8k+1) float32
//
// For env e and observer i, the candidates j are every other agent that is
// alive (still_j >= 0.5).  Distance: K1/K3 the difference form dx*dx +
// dy*dy on raw f32 coordinates; K4 the 12-term expansion on centred
// coordinates, max(., 0) (knn_common.cuh:tile_kernel).  Order: exact
// (K1, K4 exact) ascending d2, lowest index first among equal d2, valid iff
// d2 < 1e18 (the TPU's _VALID_MAX); packed (K3, K4 packed) ascending
// (bits(d2) & ~(2^b - 1)) | j with b = bit_length(SUBn - 1), SUBn =
// ceil(N/8)*8, passed at launch (10 bits at N = 1024, 7 at N = 105), valid
// iff the key < bits(1e18).  The k first valid candidates fill slots
//   [feat_j[c] - feat_i[c] for c in 0..4, type_j, 1, 1];
// slots past the number of valid candidates, and every row of a dead
// observer, are zeros (the TPU's n_valid gate: see knn_common.cuh on why
// skipping invalid candidates equals pushing them to 1e20).  The row ends
// with t_norm[e] for a live observer, else 0.
//
// What bounds them.  Bytes for K1 and K3: at the flagship shape (E=1024,
// N=105, k=10) 38.3 MB (3.4 MB read, 34.8 MB written), 11.4 us at 3.35
// TB/s; at (256, 1024, 10) 93.3 MB, 27.9 us.  The difference form is 5
// flops a pair, 20 us for the 268 M pairs at (256, 1024, 10) at 67 TFLOP/s.
// Bytes for K4 too: its expansion is 12 multiply-adds a pair, 24 flops, on
// the tensor cores at 989 TFLOP/s (bf16), 6.5 us for all 268 M pairs.
// Beyond the bound, what costs time in all three is the scan: the ballots
// and insertions of the selection (a candidate that enters the k best pays
// a shift of the list, and at N = 1024 some 56 of an observer's candidates
// enter when they come in random order) and the loads, keys and masks of
// every candidate, which set the warps' instruction issue rate.
//
// Design, K1 and K3: the warp scan of knn_common.cuh (scan_kernel), one
// warp per observer.  The block stages its env's x, y, alive flag and six
// selectable channels in dynamic shared memory (36 B per agent).  A warp
// takes the candidates 32 at a time, one a lane, so its shared-memory
// loads are consecutive words.  The k best (key, j) sit one a lane (k <=
// 32).  The first round is sorted across the lanes; in every later round a
// ballot of the lanes whose key beats the k-th leaves few lanes, and those
// enter one at a time, lowest lane first, by one __shfl_up_sync of the
// list -- no list array in registers or on the stack, and no shift for
// candidates that do not enter.  An entering key goes behind every held key
// it equals, so among equal exact keys the lower index stays first -- the
// TPU ladder's order (packed keys are unique).  The warp then writes the
// observer's 8k+1 floats together, 32 contiguous floats a store.  A block
// has one warp for every 8 observers (at most 16); an env has as many
// blocks as fill the card's SMs eight times over, at most one a warp's
// observer.  Every d2 is formed with __fmul_rn / __fadd_rn (and the
// library is built with -fmad=false), in the plain version's order, so
// kernel and plain agree bit for bit.
//
// Design, K4: from kTileMinAgents agents on, the same scan with its
// distance on the tensor cores (knn_common.cuh: tile_kernel, whose note
// gives the tile, why WMMA and not wgmma, and the derivation of the
// swap-class window W).  A block takes its env's live observers in groups
// of 16, one warp each: its warps form the group's distances to every
// candidate in 16x16x16 bf16 products into 16 rows of shared memory, a
// chunk of candidates at a time, then each warp scans its observer's row
// as K1 does.  The block stages, per agent, an alive flag, a live
// observer's index and the 12 terms as a bf16 row of 16 (40 B, the rows
// padded to a multiple of 32), and the 16 distance rows of a chunk of up
// to 512 candidates: 73 KB at N = 1024, above the default 48 KB, so the
// launch raises the limit; the wrapper refuses an N past the card's 227 KB
// (4960 agents).  The tensor core sums in its own order, so K4 is held to
// the swap class, not bit for bit: see ops/knn_obs.py:check_swap_class.
// Below kTileMinAgents, where the tile's barriers and per-group staging
// cost more than its products save (it measured 11-23% slower than the
// scalar form from 105 to 768 agents: knn_common.cuh's tile note), K4 runs
// K1's scan with the expansion on the CUDA cores (ExpansionDist over
// bmat's observer column, 12 multiplies and 11 adds a pair in the plain
// version's order), bit for bit with the plain version, which the swap
// class contains.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "knn_common.cuh"

namespace {

constexpr int kMaxK = knn::kWarpListMax;  // one list entry a lane
// K4 takes the tensor-core tile from this many agents on, K1's scan with
// the scalar expansion below it
constexpr int kTileMinAgents = 1024;

// v9's observer-side MXU operand, hoisted out of the kernel: observer i's
// column of bmat (E, 12, N).
struct BmatTerms {
  __device__ __forceinline__ static void load(const knn::KnnArgs& a, int e,
                                              int i, float* b) {
    const __nv_bfloat16* col =
        a.bmat + static_cast<long long>(e) * knn::kTerms * a.n + i;
#pragma unroll
    for (int t = 0; t < knn::kTerms; ++t) {
      b[t] = __bfloat162float(col[static_cast<long long>(t) * a.n]);
    }
  }
};

using BmatDist = knn::ExpansionDist<BmatTerms>;

template <typename Dist>
cudaError_t launch_keyed(const knn::KnnArgs& a, int e, int packed_bits,
                         int clear, cudaStream_t stream) {
  return packed_bits == 0
             ? knn::launch_scan<knn::ExactKey, Dist>(a, e, knn::ExactKey{},
                                                     stream)
             : knn::launch_scan<knn::PackedKey, Dist>(
                   a, e, knn::PackedKey{clear}, stream);
}

// The checks all three entry points share: the shape, and a packed bit
// count the key takes (its clear mask in *clear).
bool bad_call(int e, int n, int k, int packed_bits, int* clear) {
  return e <= 0 || n <= 0 || k < 1 || k > kMaxK || k > n ||
         !knn::packed_clear(packed_bits, n, clear);
}

}  // namespace

// Plain C entry points for ctypes, with the common signature
// (knn_common.cuh:KNN_ENTRY).  Each returns a cudaError_t: 0 on a launch
// that was accepted, cudaErrorInvalidValue for a call the kernel does not
// take (1 <= k <= min(32, n); packed_bits in [1, 22] with n <=
// 2^packed_bits, or 0 for the exact order where the entry allows it; the
// distance the entry computes) or an N whose staging exceeds the card's
// shared memory.

// K1: exact order (packed_bits == 0), difference-form distance.
KNN_ENTRY(knn_obs_flat_exact) {
  int clear = 0;
  if (bad_call(e, n, k, packed_bits, &clear) || packed_bits != 0 ||
      mxu_dist != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const knn::KnnArgs a = knn::make_args(loc_x, loc_y, feats, types_f,
                                        still_f, t_norm, nullptr, nullptr,
                                        nullptr, out, n, k);
  return static_cast<int>(launch_keyed<knn::DiffDist>(
      a, e, 0, clear, static_cast<cudaStream_t>(stream)));
}

// K3: packed order (packed_bits >= 1), difference-form distance.
KNN_ENTRY(knn_obs_flat) {
  int clear = 0;
  if (bad_call(e, n, k, packed_bits, &clear) || packed_bits == 0 ||
      mxu_dist != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const knn::KnnArgs a = knn::make_args(loc_x, loc_y, feats, types_f,
                                        still_f, t_norm, nullptr, nullptr,
                                        nullptr, out, n, k);
  return static_cast<int>(launch_keyed<knn::DiffDist>(
      a, e, packed_bits, clear, static_cast<cudaStream_t>(stream)));
}

// K4: MXU-expansion distance (mxu_dist != 0, aux = bmat), on the tensor
// cores from kTileMinAgents agents on, exact order (packed_bits == 0) or
// packed.
KNN_ENTRY(knn_obs_flat_mxudist) {
  int clear = 0;
  if (bad_call(e, n, k, packed_bits, &clear) || mxu_dist == 0 ||
      amat == nullptr || aux == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const knn::KnnArgs a = knn::make_args(loc_x, loc_y, feats, types_f,
                                        still_f, t_norm, amat, aux, nullptr,
                                        out, n, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < kTileMinAgents) {
    return static_cast<int>(
        launch_keyed<BmatDist>(a, e, packed_bits, clear, st));
  }
  const cudaError_t err =
      packed_bits == 0
          ? knn::launch_tile<knn::ExactKey>(a, e, knn::ExactKey{}, st)
          : knn::launch_tile<knn::PackedKey>(a, e, knn::PackedKey{clear},
                                             st);
  return static_cast<int>(err);
}
