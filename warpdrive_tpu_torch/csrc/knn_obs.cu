// Exact k-nearest-neighbour observation for TagContinuous, for Hopper (sm_90a).
//
// Replaces the TPU kernel warpdrive_tpu/ops/knn_obs.py:_knn_obs_kernel_v9,
// i.e. _v9_body(exact=True, dist_mxu=False), which _knn_observation_flat
// dispatches for knn_algorithm="pallas_flat_exact".  Same contract as the
// Python wrapper warpdrive_tpu_torch/ops/knn_obs.py:knn_observation:
//
//   inputs  loc_x, loc_y (E, N), feats (E, 5, N), types_f (N,),
//           still_f (E, N), t_norm (E,)            all float32, contiguous
//   output  out (E, N, 8k+1) float32
//
// For env e and observer i, the candidates j are every other agent that is
// alive (still_j >= 0.5) and whose squared distance dx*dx + dy*dy (raw f32
// coordinates, difference form) is below 1e18 -- the TPU kernel's
// _VALID_MAX.  The k nearest, in ascending d2 with the lowest index first
// among equal distances, fill the k slots
//   [feat_j[c] - feat_i[c] for c in 0..4, type_j, 1, 1];
// slots past the number of candidates, and every row of a dead observer,
// are zeros.  The row ends with t_norm[e] for a live observer, else 0.
//
// What bounds it: bytes.  At the flagship shape (E=1024, N=105, k=10) it
// writes 34.8 MB and reads 3.4 MB, about 11 us at 3.35 TB/s, while the
// distance work (11.3 M pairs, a few flops each) needs under 1 us.
//
// Design (correct first, simple): one block per (env, tile of up to 128
// observers), one thread per observer.  The block stages its env's x, y,
// alive flag and the six selectable channels (5 features + type) in
// dynamic shared memory (36 B per agent, so any N up to the card's shared
// memory).  Each thread scans the candidates in ascending j and keeps a
// sorted list of (d2, j) in registers; a candidate enters with a strict
// "<", so among equal distances the earlier (lower) index stays first --
// the TPU ladder's order.  The list holds K_MAX entries (the kernel is
// templated on K_MAX and the insertion fully unrolled, so it stays in
// registers); only its first k are emitted.  Every d2 is formed with
// __fmul_rn / __fadd_rn (and the library is built with -fmad=false) so no
// FMA contraction moves a distance by an ulp and flips a near-tie.
// Known cost left for later: each thread writes its own (8k+1)-float row,
// so the output stores are uncoalesced.  The staging, distance, sorted list
// and row emission are shared with knn_obs_mxu.cu through knn_common.cuh.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_common.cuh"

namespace {

template <int K_MAX>
__global__ void knn_obs_flat_exact_kernel(
    const float* __restrict__ loc_x, const float* __restrict__ loc_y,
    const float* __restrict__ feats, const float* __restrict__ types_f,
    const float* __restrict__ still_f, const float* __restrict__ t_norm,
    float* __restrict__ out, int n, int k) {
  extern __shared__ float smem[];
  const int e = blockIdx.x;
  const knn::EnvTile t =
      knn::stage_env(smem, loc_x, loc_y, feats, types_f, still_f, e, n);

  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row_len = 8 * k + 1;
  float* row = out + (static_cast<long long>(e) * n + i) * row_len;
  if (t.alive[i] == 0.0f) {
    knn::zero_row(row, row_len);
    return;
  }

  knn::SortedList<K_MAX, float> list(CUDART_INF_F);
  int n_valid = 0;
  for (int j = 0; j < n; ++j) {
    if (j == i || t.alive[j] == 0.0f) continue;
    const float d2 = knn::sq_dist(t, j, i);
    if (!(d2 < knn::kValidMax)) continue;
    ++n_valid;
    list.insert(d2, j, k);
  }
  knn::emit_row(row, list, n_valid, k, t, i, t_norm[e]);
}

template <int K_MAX>
cudaError_t launch(const float* loc_x, const float* loc_y, const float* feats,
                   const float* types_f, const float* still_f,
                   const float* t_norm, float* out, int e, int n, int k,
                   cudaStream_t stream) {
  const int threads = n >= 128 ? 128 : ((n + 31) / 32) * 32;
  const dim3 grid(e, (n + threads - 1) / threads);
  const size_t smem =
      static_cast<size_t>(3 + knn::kChannels) * n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_obs_flat_exact_kernel<K_MAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  knn_obs_flat_exact_kernel<K_MAX><<<grid, threads, smem, stream>>>(
      loc_x, loc_y, feats, types_f, still_f, t_norm, out, n, k);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Returns a cudaError_t: 0 on a launch
// that was accepted, cudaErrorInvalidValue for a k the kernel does not
// take (1 <= k <= 32).
extern "C" int knn_obs_flat_exact(const float* loc_x, const float* loc_y,
                                  const float* feats, const float* types_f,
                                  const float* still_f, const float* t_norm,
                                  float* out, int e, int n, int k,
                                  void* stream) {
  if (e <= 0 || n <= 0 || k < 1 || k > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      k <= 16 ? launch<16>(loc_x, loc_y, feats, types_f, still_f, t_norm, out,
                           e, n, k, st)
              : launch<32>(loc_x, loc_y, feats, types_f, still_f, t_norm, out,
                           e, n, k, st);
  return static_cast<int>(err);
}
