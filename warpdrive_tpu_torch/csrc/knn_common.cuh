// Device helpers shared by the k-nearest-neighbour observation kernels
// (knn_obs.cu, knn_obs_mxu.cu): staging one env's inputs in shared memory,
// the difference-form squared distance, a register-resident sorted list of
// the k best candidates, and the emission of one observation row.
//
// Contract (see warpdrive_tpu_torch/ops/knn_obs.py): inputs loc_x, loc_y
// (E, N), feats (E, 5, N), types_f (N,), still_f (E, N), t_norm (E,), all
// float32; an observer's row is, for each of k slots,
//   [feat_j[c] - feat_i[c] for c in 0..4, type_j, 1, 1]
// (zeros past the number of valid candidates), then t_norm[e].  A dead
// observer's row is all zeros.

#pragma once

#include <cuda_runtime.h>

namespace knn {

constexpr int kChannels = 6;        // 5 features + type
constexpr float kValidMax = 1e18f;  // candidates at d2 >= this are invalid

// One env's inputs in shared memory: x, y, alive flag (1 or 0) and the six
// selectable channels, channel-major.  (3 + kChannels) * n floats.
struct EnvTile {
  const float* x;
  const float* y;
  const float* alive;
  const float* f;
  int n;
};

__device__ __forceinline__ EnvTile stage_env(
    float* smem, const float* __restrict__ loc_x,
    const float* __restrict__ loc_y, const float* __restrict__ feats,
    const float* __restrict__ types_f, const float* __restrict__ still_f,
    int e, int n) {
  float* sx = smem;
  float* sy = sx + n;
  float* salive = sy + n;
  float* sf = salive + n;
  const long long env_base = static_cast<long long>(e) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sx[j] = loc_x[env_base + j];
    sy[j] = loc_y[env_base + j];
    salive[j] = still_f[env_base + j] >= 0.5f ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      sf[c * n + j] = feats[env_base * 5 + static_cast<long long>(c) * n + j];
    }
    sf[5 * n + j] = types_f[j];
  }
  __syncthreads();
  return EnvTile{sx, sy, salive, sf, n};
}

// d2 = (x_j - x_i)^2 + (y_j - y_i)^2 with every operation rounded on its
// own: no FMA contraction moves a distance by an ulp and flips a near-tie.
__device__ __forceinline__ float sq_dist(const EnvTile& t, int j, int i) {
  const float dx = __fsub_rn(t.x[j], t.x[i]);
  const float dy = __fsub_rn(t.y[j], t.y[i]);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The k smallest (key, index) pairs seen so far, ascending.  Candidates are
// offered in ascending index and enter with a strict "<", so among equal
// keys the lower index stays first.  Every array index is a compile-time
// constant after unrolling, so the lists live in registers; only the first
// k of the K_MAX entries are used.
template <int K_MAX, typename Key>
struct SortedList {
  Key key[K_MAX];
  int idx[K_MAX];
  Key worst;  // key[k - 1]: a candidate must beat it to enter

  __device__ __forceinline__ explicit SortedList(Key sentinel) {
#pragma unroll
    for (int s = 0; s < K_MAX; ++s) {
      key[s] = sentinel;
      idx[s] = 0;
    }
    worst = sentinel;
  }

  __device__ __forceinline__ void insert(Key c, int j, int k) {
    if (!(c < worst)) return;
    // slots from the first one c beats shift down by one
    bool shifting = false;
#pragma unroll
    for (int s = 0; s < K_MAX; ++s) {
      const bool take = shifting || c < key[s];
      const Key tk = key[s];
      const int tj = idx[s];
      if (take) {
        key[s] = c;
        idx[s] = j;
        c = tk;
        j = tj;
      }
      shifting = take;
    }
#pragma unroll
    for (int s = 0; s < K_MAX; ++s) {
      if (s == k - 1) worst = key[s];
    }
  }
};

// Observer i's row (8k + 1 floats) for a live observer whose first
// n_valid list entries are valid neighbours.  ``row`` may point to global
// or shared memory.
template <int K_MAX, typename Key>
__device__ __forceinline__ void emit_row(float* row,
                                         const SortedList<K_MAX, Key>& list,
                                         int n_valid, int k, const EnvTile& t,
                                         int i, float t_norm) {
  const int n = t.n;
  float own[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) own[c] = t.f[c * n + i];
#pragma unroll
  for (int s = 0; s < K_MAX; ++s) {
    if (s < k) {
      float* slot = row + 8 * s;
      if (s < n_valid) {
        const int j = list.idx[s];
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          slot[c] = __fsub_rn(t.f[c * n + j], own[c]);
        }
        slot[5] = t.f[5 * n + j];
        slot[6] = 1.0f;
        slot[7] = 1.0f;
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) slot[c] = 0.0f;
      }
    }
  }
  row[8 * k] = t_norm;
}

__device__ __forceinline__ void zero_row(float* row, int row_len) {
  for (int f = 0; f < row_len; ++f) row[f] = 0.0f;
}

}  // namespace knn
