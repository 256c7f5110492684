// Device code shared by the k-nearest-neighbour observation kernels
// (knn_obs.cu, knn_obs_mxu.cu, knn_obs_tiled.cu, knn_obs_ladder.cu,
// knn_obs_envlanes.cu), and the common C signature of every entry point.
// Which kernel uses what:
//   K1, K2, K3, K5  the warp scan (scan_kernel: stage_env, DiffDist or,
//                   for K5's MXU modes, ExpansionDist; ExactKey or
//                   PackedKey; WarpList; emit_warp_row over StagedFeature);
//   K4              from 1024 agents on, the warp scan over a tensor-core
//                   tile (tile_kernel: the bf16 candidate terms, WMMA
//                   products of a group of 16 observers' distances into
//                   shared memory, then scan_observer, WarpList and
//                   emit_warp_row over GlobalFeature for each observer's
//                   row); below, scan_kernel with ExpansionDist;
//   K9              WarpList, the keys, diff_sq_dist and emit_warp_row,
//                   over candidates it stages in chunks itself;
//   K6-K8           stage_env, DiffDist, scan_grid's geometry and emit_row
//                   over StagedFeature, from a winner table of their own.
//
// Contract (see warpdrive_tpu_torch/ops/knn_obs.py): inputs loc_x, loc_y
// (E, N), feats (E, 5, N), types_f (N,), still_f (E, N), t_norm (E,), all
// float32; an observer's row is, for each of k slots,
//   [feat_j[c] - feat_i[c] for c in 0..4, type_j, 1, 1]
// (zeros past the number of valid candidates), then t_norm[e].  A dead
// observer's row is all zeros.
//
// Invalid candidates.  The TPU kernels push self, dead and padded
// candidates to d2 >= 1e20 (the v9 kernels by adding BIG, the v7 ones by
// writing it) and gate slot s of observer i by "i has more than s valid
// candidates" (a pre-ladder count in v9, a per-slot m2 < 1e18 in v7).  The
// kernels here skip those candidates and count the valid ones instead.  The
// two agree in every mode: an invalid entry's key, exact or packed, lies
// above every valid key, so the ladder takes all valid candidates before
// any invalid one, and the gate zeroes every slot from n_valid on.

#pragma once

#include <algorithm>
#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

namespace knn {

constexpr int kChannels = 6;        // 5 features + type
constexpr float kValidMax = 1e18f;  // candidates at d2 >= this are invalid
constexpr int kTerms = 12;          // terms of the MXU distance expansion
// the card's dynamic shared memory per block (227 KB)
constexpr size_t kMaxSharedBytes = 232448;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpLanes = 32;
// the warp scan's k-list holds one entry a lane
constexpr int kWarpListMax = kWarpLanes;

// Everything a kNN kernel reads and writes.  amat, bmat and centred are
// the MXU distance's operands (tile_kernel and ExpansionDist only, else
// null): amat always, and the observer side either as bmat (v9, K4's
// tile_kernel) or as the centred coordinates it is formed from in the
// kernel (v7, K5's ExpansionDist).
struct KnnArgs {
  const float* loc_x;
  const float* loc_y;
  const float* feats;
  const float* types_f;
  const float* still_f;
  const float* t_norm;
  const __nv_bfloat16* amat;  // (E, N, 12): candidate-side expansion
  const __nv_bfloat16* bmat;  // (E, 12, N): observer-side expansion
  const float* centred;       // (E, 2, N): per-env centred x, y
  float* out;
  int n;
  int k;
};

// The common C signature of the kNN entry points (K1-K9), so that the
// Python wrapper makes one ctypes call for every kernel.  amat is the MXU
// distance's candidate-side operand (K4, K5).  aux is the MXU distance's
// observer-side operand -- bmat for K4, the centred coordinates for K5 --
// else null.
#define KNN_ENTRY(name)                                                     \
  extern "C" int name(const float* loc_x, const float* loc_y,               \
                      const float* feats, const float* types_f,             \
                      const float* still_f, const float* t_norm,            \
                      const void* amat, const void* aux, float* out,        \
                      int e, int n, int k, int packed_bits, int mxu_dist,   \
                      void* stream)

// KnnArgs of an entry point's arguments, with aux as bmat (v9) or as the
// centred coordinates (v7).
inline KnnArgs make_args(const float* loc_x, const float* loc_y,
                         const float* feats, const float* types_f,
                         const float* still_f, const float* t_norm,
                         const void* amat, const void* bmat,
                         const void* centred, float* out, int n, int k) {
  return KnnArgs{loc_x,
                 loc_y,
                 feats,
                 types_f,
                 still_f,
                 t_norm,
                 static_cast<const __nv_bfloat16*>(amat),
                 static_cast<const __nv_bfloat16*>(bmat),
                 static_cast<const float*>(centred),
                 out,
                 n,
                 k};
}

// Floats of stage_env's staging, rounded up to a 16-byte multiple so that
// what follows it can be read with float4 loads.
__host__ __device__ inline int env_floats(int n) {
  return (((3 + kChannels) * n) + 3) & ~3;
}

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

// ---------------------------------------------------------------- distances
// Each distance is a functor built for one observer i; dist(j) is the
// squared distance of candidate j.  stage() runs before any thread leaves
// (it may synchronise the block) and returns what the functor reads from
// shared memory.

// The difference form d2 = (x_j - x_i)^2 + (y_j - y_i)^2 on raw float32
// coordinates, every operation rounded on its own: no FMA contraction
// moves a distance by an ulp and flips a near-tie.
__device__ __forceinline__ float diff_sq_dist(float xj, float yj, float xi,
                                              float yi) {
  const float dx = __fsub_rn(xj, xi);
  const float dy = __fsub_rn(yj, yi);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

struct DiffDist {
  static size_t extra_floats(int) { return 0; }
  __device__ static const float* stage(float*, const KnnArgs&, int, int) {
    return nullptr;
  }

  const float* x;
  const float* y;
  float xi;
  float yi;

  __device__ __forceinline__ DiffDist(const EnvTile& t, const float*,
                                      const KnnArgs&, int, int i)
      : x(t.x), y(t.y), xi(t.x[i]), yi(t.y[i]) {}

  __device__ __forceinline__ float operator()(int j) const {
    return diff_sq_dist(x[j], y[j], xi, yi);
  }
};

// The TPU's MXU distance (warpdrive_tpu/ops/knn_obs.py:1176-1205) on the
// CUDA cores, for K5's MXU modes and for K4 below 1024 agents (K4 forms it
// on the tensor cores from there on: tile_kernel below): on per-env
// centred coordinates, d2 = sum over t of
// amat[j, t] * bmat[t, i], the 12-term bf16 hi/lo expansion of |p_j|^2 +
// |p_i|^2 - 2 p_j.p_i, then max(d2, 0) + 0.0 (the v9 kernel's mask add,
// which also turns a -0 into +0).  Each product of two bf16 values is exact
// in float32, and the sum runs in the fixed order t = 0..11 with __fadd_rn,
// as the plain version sums it, so the two agree bit for bit on one device.
// The candidates' amat rows are staged in shared memory as float32 (48 B
// per agent; lanes reading consecutive rows with float4 loads meet no bank
// conflict, since each quarter warp's eight 16-byte pieces fall on
// distinct banks); the observer's 12 terms sit in registers, where
// ObserverTerms::load(args, e, i, b) puts them: formed from the centred
// coordinates, as v7 forms them in its body.
template <typename ObserverTerms>
struct ExpansionDist {
  static size_t extra_floats(int n) {
    return static_cast<size_t>(kTerms) * n;
  }
  __device__ static const float* stage(float* smem, const KnnArgs& a, int e,
                                       int n) {
    const __nv_bfloat16* src =
        a.amat + static_cast<long long>(e) * kTerms * n;
    for (int q = threadIdx.x; q < kTerms * n; q += blockDim.x) {
      smem[q] = __bfloat162float(src[q]);
    }
    __syncthreads();
    return smem;
  }

  const float* a;  // (n, 12) in shared memory, 16-byte aligned rows
  float b[kTerms];

  __device__ __forceinline__ ExpansionDist(const EnvTile&, const float* staged,
                                           const KnnArgs& args, int e, int i)
      : a(staged) {
    ObserverTerms::load(args, e, i, b);
  }

  __device__ __forceinline__ float operator()(int j) const {
    const float4* row = reinterpret_cast<const float4*>(a + kTerms * j);
    const float4 r0 = row[0], r1 = row[1], r2 = row[2];
    const float av[kTerms] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                              r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
    float d = __fmul_rn(av[0], b[0]);
#pragma unroll
    for (int t = 1; t < kTerms; ++t) d = __fadd_rn(d, __fmul_rn(av[t], b[t]));
    return __fadd_rn(fmaxf(d, 0.0f), 0.0f);
  }
};

// --------------------------------------------------------------------- keys
// A key maps a candidate's (d2, j) to its sort key and says whether the
// candidate is valid.

// Exact order: the float d2 itself, lowest index first among equal d2 (the
// lists keep an equal key behind the ones already held, and candidates
// come in ascending j); valid iff d2 < 1e18.
struct ExactKey {
  using Type = float;
  __device__ static Type sentinel() { return CUDART_INF_F; }
  __device__ __forceinline__ bool operator()(float d2, int, Type* key) const {
    *key = d2;
    return d2 < kValidMax;
  }
};

// Packed order: the int32 key (bits(d2) & clear) | j, the TPU kernels'
// packed index.  clear = ~(2^b - 1) with b = 7 for v3 (_CLEAR_MASK) and
// b = bit_length(SUBn - 1) for v7/v9 (knn_obs.py:654, :810): distances
// that differ only in their low b mantissa bits order by index.  Keys are
// unique, so the lists need no tie rule; valid iff key < bits(1e18).
struct PackedKey {
  using Type = int;
  int clear;
  __device__ static Type sentinel() { return INT_MAX; }
  __device__ __forceinline__ bool operator()(float d2, int j, Type* key) const {
    *key = (__float_as_int(d2) & clear) | j;
    return *key < __float_as_int(kValidMax);
  }
};

// ------------------------------------------------------- the warp's k-list
// The k smallest (key, index) pairs offered so far to one warp, one entry a
// lane: lane s < k holds the s-th smallest, ascending across the lanes.
// Candidates are offered in rounds of 32, candidate base + l in lane l, in
// ascending base.  A round takes one ballot of the lanes whose key beats
// the list's k-th key (worst); those lanes then enter one at a time, the
// lowest lane first, each checked again against the list as it stands.  An
// entering key goes to position pos = the number of held keys <= it, and
// the lanes from pos on shift up by one (__shfl_up_sync); since the lanes
// are sorted, a lane finds itself at or past pos by comparing its own key
// and its lower neighbour's, with no count across the warp.  So an equal
// key stays behind the ones held: with ascending j, the lowest index wins
// every tie, as a stable sort's does.  The lanes from k on hold what was
// pushed out; their keys are >= worst, so they never move pos.  The first
// round, into the empty list, is taken at once instead: a bitonic sort of
// the 32 lanes by (key, index) leaves the list that its insertions one at
// a time would leave.  Each lane counts its own valid candidates; finish()
// sums the counts.
template <typename Key>
struct WarpList {
  Key key;      // this lane's entry
  int idx;
  Key worst;    // lane k-1's key, the same in every lane
  int n_valid;  // this lane's valid candidates; after finish(), the warp's

  WarpList() = default;
  __device__ __forceinline__ explicit WarpList(Key sentinel)
      : key(sentinel), idx(0), worst(sentinel), n_valid(0) {}

  // The first round, as offer() takes it, into an empty list: sorted
  // across the lanes, ascending by (key, index), with __shfl_xor_sync.
  __device__ __forceinline__ void first(bool valid, Key c, int base, int k,
                                        int lane) {
    n_valid += valid;
    key = c;
    idx = base + lane;
#pragma unroll
    for (int size = 2; size <= kWarpLanes; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const Key other_key = __shfl_xor_sync(kFullMask, key, stride);
        const int other_idx = __shfl_xor_sync(kFullMask, idx, stride);
        const bool other_less =
            other_key < key || (other_key == key && other_idx < idx);
        // the lower lane of a pair in an ascending run keeps the smaller
        const bool ascending = size == kWarpLanes || (lane & size) == 0;
        const bool lower = (lane & stride) == 0;
        if (other_less == (lower == ascending)) {
          key = other_key;
          idx = other_idx;
        }
      }
    }
    worst = __shfl_sync(kFullMask, key, k - 1);
  }

  // One round: lane l offers candidate base + l, whose key is c if it is
  // valid and the sentinel if not.  Every lane of the warp calls it.
  __device__ __forceinline__ void offer(bool valid, Key c, int base, int k,
                                        int lane) {
    n_valid += valid;
    unsigned pass = __ballot_sync(kFullMask, c < worst);
    while (pass != 0) {
      const int src = __ffs(pass) - 1;
      pass &= pass - 1;
      const Key ck = __shfl_sync(kFullMask, c, src);
      if (!(ck < worst)) continue;
      const Key up_key = __shfl_up_sync(kFullMask, key, 1);
      const int up_idx = __shfl_up_sync(kFullMask, idx, 1);
      if (!(key <= ck)) {  // this lane is at or past pos
        const bool at = lane == 0 || up_key <= ck;
        key = at ? ck : up_key;
        idx = at ? base + src : up_idx;
      }
      worst = __shfl_sync(kFullMask, key, k - 1);
    }
  }

  // After the last round: n_valid becomes the warp's count.
  __device__ __forceinline__ void finish() {
    n_valid = __reduce_add_sync(kFullMask, n_valid);
  }
};

// Feature c (0..4; 5 is the type) of agent j in the staged env.
struct StagedFeature {
  const float* f;
  int n;
  __device__ __forceinline__ float operator()(int c, int j) const {
    return f[c * n + j];
  }
};

// Observer i's row of 8k + 1 floats, written by the whole warp with
// coalesced stores: lane l forms float f = 32p + l of the row in pass p
// (slot f / 8, entry f % 8), so each store covers 128 contiguous bytes.
// index_of(s) is slot s's candidate; every lane calls it (it may shuffle),
// for every s up to (8k + 32) / 8, and only slots below n_valid use it:
// later slots are zeros.  t_end is t_norm[e] for a live observer and 0 for
// a dead one, whose n_valid is 0.
template <typename SlotIndex, typename Feature>
__device__ __forceinline__ void emit_row(float* row, const SlotIndex& index_of,
                                         int n_valid, int k, float t_end,
                                         const Feature& feature, int i,
                                         int lane) {
  const int row_len = 8 * k + 1;
  for (int base = 0; base < row_len; base += kWarpLanes) {
    const int f = base + lane;
    const int s = f >> 3;
    const int j = index_of(s);
    if (f < row_len) {
      float v = 0.0f;
      if (f == 8 * k) {
        v = t_end;
      } else if (s < n_valid) {
        const int c = f & 7;
        if (c < kChannels) {
          const float fj = feature(c, j);
          v = c < 5 ? __fsub_rn(fj, feature(c, i)) : fj;
        } else {
          v = 1.0f;
        }
      }
      row[f] = v;
    }
  }
}

// Observer i's row from its warp's list: slot s's index is lane s's, by a
// shuffle.
template <typename Key, typename Feature>
__device__ __forceinline__ void emit_warp_row(float* row,
                                              const WarpList<Key>& list,
                                              int k, float t_end,
                                              const Feature& feature, int i,
                                              int lane) {
  emit_row(
      row,
      [&](int s) {
        return __shfl_sync(kFullMask, list.idx, s & (kWarpLanes - 1));
      },
      list.n_valid, k, t_end, feature, i, lane);
}

// --------------------------------------------------------------- the scan
// The warp scan (K1, K2, K3, K5): the block stages one env's inputs (and
// the distance's operands) in dynamic shared memory; each warp then takes
// its observers one at a time, offers every candidate in rounds of 32
// (lane l of round r takes j = 32r + l: consecutive shared-memory words,
// free of bank conflicts) to a WarpList and writes the row with
// emit_warp_row.  Blocks (e, y) of one env share its observers: warp w of
// block y takes i = y * warps + w, then every gridDim.y * warps-th after.
constexpr int kScanMaxWarps = 16;

// One live observer i's scan of the candidates begin <= j < end (begin a
// multiple of 64) in rounds of 32 (two rounds a step, so that the second
// round's loads and distances overlap the first one's insertions) into the
// warp's list, the round of j = 0 sorted into it; dist(j) is candidate
// j's squared distance and alive[j] its staged flag.
template <typename KeyOf, typename Dist>
__device__ __forceinline__ void scan_observer(
    WarpList<typename KeyOf::Type>& list, const Dist& dist,
    const float* alive, const KeyOf& key_of, int i, int begin, int end,
    int k, int lane) {
  using Key = typename KeyOf::Type;
  // candidate j's key, or the sentinel when it is not valid; a lane past
  // the last candidate reads candidate end - 1, so that every load stays
  // in the staging and none needs a branch
  auto candidate = [&](int j, Key* c) {
    const int jc = min(j, end - 1);
    Key kc;
    const bool valid = (j < end) & (j != i) & (alive[jc] != 0.0f) &
                       key_of(dist(jc), jc, &kc);
    *c = valid ? kc : KeyOf::sentinel();
    return valid;
  };
  for (int base = begin; base < end; base += 2 * kWarpLanes) {
    Key c0, c1;
    const bool v0 = candidate(base + lane, &c0);
    const bool v1 = candidate(base + kWarpLanes + lane, &c1);
    if (base == 0) {
      list.first(v0, c0, base, k, lane);
    } else {
      list.offer(v0, c0, base, k, lane);
    }
    list.offer(v1, c1, base + kWarpLanes, k, lane);
  }
}

template <typename KeyOf, typename Dist>
__global__ void __launch_bounds__(kScanMaxWarps* kWarpLanes)
    scan_kernel(KnnArgs a, KeyOf key_of) {
  using Key = typename KeyOf::Type;
  extern __shared__ __align__(16) float knn_smem[];
  const int e = blockIdx.x;
  const int n = a.n;
  const EnvTile t = stage_env(knn_smem, a.loc_x, a.loc_y, a.feats, a.types_f,
                              a.still_f, e, n);
  const float* staged = Dist::stage(knn_smem + env_floats(n), a, e, n);

  const int lane = threadIdx.x % kWarpLanes;
  const int warps = blockDim.x / kWarpLanes;
  const int row_len = 8 * a.k + 1;
  const float t_norm = a.t_norm[e];
  const StagedFeature feature{t.f, n};
  for (int i = blockIdx.y * warps + threadIdx.x / kWarpLanes; i < n;
       i += gridDim.y * warps) {
    WarpList<Key> list(KeyOf::sentinel());
    const bool live = t.alive[i] != 0.0f;
    if (live) {
      scan_observer(list, Dist(t, staged, a, e, i), t.alive, key_of, i, 0, n,
                    a.k, lane);
    }
    list.finish();
    emit_warp_row(a.out + (static_cast<long long>(e) * n + i) * row_len, list,
                  a.k, live ? t_norm : 0.0f, feature, i, lane);
  }
}

// Dynamic shared memory of scan_kernel for n agents.
template <typename Dist>
size_t scan_smem_bytes(int n) {
  return (static_cast<size_t>(env_floats(n)) + Dist::extra_floats(n)) *
         sizeof(float);
}

// The card's multiprocessor count (132 on an H100 SXM), read once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0) {
      sms = 132;
    }
  }
  return sms;
}

// The grid of a scan over e envs whose env holds `units` tasks, `warps` of
// them a block at a time (scan_kernel: an observer a warp; tile_kernel: a
// group of observers a block): enough blocks an env that the grid holds at
// least 8 blocks an SM, but no more than leave each block tasks for all
// its warps.
inline dim3 scan_grid(int e, int units, int warps) {
  const int fill = (8 * sm_count() + e - 1) / e;
  const int most = (units + warps - 1) / warps;
  return dim3(e, std::max(1, std::min(fill, most)));
}

// Raise the kernel's dynamic shared-memory limit when smem needs it.
// cudaErrorInvalidValue when smem exceeds the card's shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launch scan_kernel over e envs: a block has one warp for every 8
// observers of its env, at most 16, and the blocks of scan_grid.  Returns
// cudaErrorInvalidValue when the staging exceeds the card's shared memory,
// else the launch's error.
template <typename KeyOf, typename Dist>
cudaError_t launch_scan(const KnnArgs& a, int e, KeyOf key_of,
                        cudaStream_t stream) {
  const int n = a.n;
  const size_t smem = scan_smem_bytes<Dist>(n);
  const cudaError_t err = allow_smem(scan_kernel<KeyOf, Dist>, smem);
  if (err != cudaSuccess) return err;
  const int warps = std::min(kScanMaxWarps, (n + 7) / 8);
  scan_kernel<KeyOf, Dist>
      <<<scan_grid(e, n, warps), warps * kWarpLanes, smem, stream>>>(a,
                                                                     key_of);
  return cudaGetLastError();
}

// ------------------------------------------------ the tensor-core tile (K4)
// The warp scan with the MXU distance of the TPU's _knn_obs_kernel_v9_mxu
// (warpdrive_tpu/ops/knn_obs.py:720) formed on the tensor cores:
// d2[i, j] = sum over t of amat[j, t] * bmat[t, i] (12 terms, padded to
// 16 with zeros), then max(d2, 0) + 0.0, as ExpansionDist forms it.
//
// A block serves its env's live observers 16 at a time, one warp each;
// dead observers, whose rows are zeros, take no place in a group, so that
// no warp of a group idles for one.  The block stages each candidate's 12
// terms as one bf16 row of 16 (the terms, then 4 zeros), the rows
// zero-padded to a multiple of 32, the candidates' alive flags and the
// live observers' indices.  For a group it stages the A operand, A[r, t] =
// bmat[t, i_r] for its r-th observer i_r, and takes the candidates a chunk
// of up to 512 at a time: its warps form the group's distances to the
// chunk in 16x16x16 tensor-core products, bf16 in and float32 sums out,
// with the B operand, B[t, j] = amat[j, t], a column-major view of the
// staged rows, and store the 16 rows of float distances in shared memory;
// then each warp runs the warp scan of its observer (scan_observer, as
// K1's: WarpList, the first round sorted, rounds of 32 candidates
// ballot-filtered) over its row.  After the last chunk each warp writes
// its observer's row with emit_warp_row, the features read from global
// memory.  A barrier waits for every warp's scan before the next chunk's
// or group's products overwrite the rows, and the other blocks on the SM
// run meanwhile: 73 KB of shared memory and 40 registers a thread hold
// three blocks of 16 warps an SM at N = 1024.
//
// What bounds it: not the product.  It is 16 deep, 12 MACs a pair; at
// (256, 1024) 268 M pairs, 6.5 us at the tensor cores' bf16 rate and a
// few percent of the kernel's instructions.  The scan's ballots and
// insertions set the pace, as for K1, with fewer instructions a round: a
// shared-memory load in place of the difference form.  What the shared
// product costs: a group's warps wait at its barriers for its slowest scan
// (its observer with the most insertions), and 48 warps fit an SM where 64
// of K1's do.  Those costs take back what the products save: on the
// H100 the tile ran 11-23% slower than the scalar form (ExpansionDist) on
// random states from 105 to 768 agents, as fast at 1024, and 6% faster on
// the 1024-agent configuration's rolled state, so K4 takes the tile only
// from kTileMinAgents = 1024 agents on (knn_obs.cu).  The product takes
// mma.sync-class WMMA and not wgmma: wgmma's 64-row warpgroup tiles would
// make groups of 64 observers, 64 warps waiting at each barrier and four
// times the rows of distances, and gain nothing on a product this
// shallow.  Nor does one warp hold the lists of a whole group of 16 and
// scan it alone: 16 lists of 4 registers a lane leave one block of 16
// warps an SM, and the insertions of 16 lists one after another are one
// chain of shuffles, with too few warps to hide its latency.
//
// The order of the float32 sums inside the tensor core is not the plain
// version's t = 0..11 (and its adds may truncate), so kernel and plain may
// pick different neighbours where two distances lie within the summation
// error: the swap class, as the JAX MXU kernel against its oracle.  Every
// product of two bf16 values is exact in float32 and the padded terms add
// +0, so only the order of the adds differs.  Take e = 16 * 2^-23 * sum_t
// |amat[j, t] * bmat[t, i]|: a sum of 16 terms takes at most 15 adds, each
// off by less than one ulp of its result (truncated or rounded), which is
// at most 2^-23 * sum_t |term|, so either device's d2 lies within e of the
// exact sum, and the two within 2e of each other.  The s-th smallest of
// values that each move by at most 2e moves by at most 2e, so a slot whose
// pick differs holds candidates j_k (kernel) and j_p (plain) with
// |d2_plain(i, j_k) - d2_plain(i, j_p)| <= W = 4e, e the larger over the
// two candidates; in the packed order W also takes in one packed bucket,
// 2^b ulps of the larger plain d2.  ops/knn_obs.py:check_swap_class holds
// a kernel's output to that.
constexpr int kTileRows = 16;    // observers a group: the product's M
constexpr int kTileDepth = 16;   // the product's K: 12 terms and 4 zeros
constexpr int kTileChunk = 512;  // candidates a chunk
static_assert(kTileChunk % (2 * kWarpLanes) == 0, "whole steps of the scan");
// blocks an SM that tile_kernel's register budget is cut to hold
// (__launch_bounds__: 40 registers a thread for three blocks of 16 warps,
// as many as its shared memory leaves at N = 1024)
constexpr int kTileMinBlocks = 3;

// Candidate rows staged: n rounded up to a round of 32.
__host__ __device__ inline int tile_rows_padded(int n) {
  return (n + kWarpLanes - 1) / kWarpLanes * kWarpLanes;
}

// Candidates a chunk at n agents, and the floats between two observers'
// distance rows: 4 past the chunk, so that the rows of a product's store
// fall on different banks.
__host__ __device__ inline int tile_chunk(int n) {
  return tile_rows_padded(n) < kTileChunk ? tile_rows_padded(n) : kTileChunk;
}
__host__ __device__ inline int tile_row_stride(int n) {
  return tile_chunk(n) + 4;
}

// Dynamic shared memory of tile_kernel for n agents: the alive flags, live
// observers' indices and bf16 terms (16 a row) of the padded rows, a
// group's 16 distance rows of a chunk and its A operand (16 x 16 bf16).
inline size_t tile_smem_bytes(int n) {
  const size_t rows = tile_rows_padded(n);
  return (2 * rows + rows * kTileDepth / 2 +
          static_cast<size_t>(kTileRows) * tile_row_stride(n) +
          kTileRows * kTileDepth / 2) *
         sizeof(float);
}

// Feature c (0..4; 5 is the type) of agent j of one env, from global memory.
struct GlobalFeature {
  const float* feats;  // the env's (5, N) features
  const float* types_f;
  int n;
  __device__ __forceinline__ float operator()(int c, int j) const {
    return c < 5 ? feats[c * n + j] : types_f[j];
  }
};

// The distance of candidate j as tile_kernel's products left it in the
// observer's row of the chunk from candidate begin on, clamped and with
// the v9 kernel's + 0.0.
struct RowDist {
  const float* row;
  int begin;
  __device__ __forceinline__ float operator()(int j) const {
    return __fadd_rn(fmaxf(row[j - begin], 0.0f), 0.0f);
  }
};

template <typename KeyOf>
__global__ void __launch_bounds__(kTileRows* kWarpLanes, kTileMinBlocks)
    tile_kernel(KnnArgs a, KeyOf key_of) {
  using Key = typename KeyOf::Type;
  namespace wmma = nvcuda::wmma;
  constexpr int L = kTileRows;
  constexpr int kCols = 16;  // the product's N
  extern __shared__ __align__(128) float knn_tile_smem[];
  const int e = blockIdx.x;
  const int n = a.n;
  const int rows = tile_rows_padded(n);
  const int chunk = tile_chunk(n);
  const int stride = tile_row_stride(n);
  __shared__ int live_count;
  float* alive = knn_tile_smem;
  int* live_idx = reinterpret_cast<int*>(alive + rows);
  __nv_bfloat16* terms = reinterpret_cast<__nv_bfloat16*>(alive + 2 * rows);
  float* dist = alive + 2 * rows + rows * kTileDepth / 2;
  __nv_bfloat16* a_rows = reinterpret_cast<__nv_bfloat16*>(dist + L * stride);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  const long long env_base = static_cast<long long>(e) * n;
  const __nv_bfloat16* src = a.amat + env_base * kTerms;
  for (int q = threadIdx.x; q < rows * kTileDepth; q += blockDim.x) {
    const int j = q / kTileDepth;
    const int t = q % kTileDepth;
    terms[q] = (j < n && t < kTerms) ? src[j * kTerms + t] : zero;
  }
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    alive[j] = j < n && a.still_f[env_base + j] >= 0.5f ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarpLanes;
  const int warp = threadIdx.x / kWarpLanes;
  const int row_len = 8 * a.k + 1;
  // the live observers' indices, in order: the groups hold live observers
  // only, so that no warp of a group idles for a dead one
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < n; base += kWarpLanes) {
      const int j = base + lane;
      const bool live = j < n && alive[j] != 0.0f;
      const unsigned mask = __ballot_sync(kFullMask, live);
      if (live) live_idx[count + __popc(mask & ((1u << lane) - 1))] = j;
      count += __popc(mask);
    }
    if (lane == 0) live_count = count;
  }
  // a dead observer's row is all zeros: the blocks of the env share them
  for (int i = blockIdx.y * L + warp; i < n; i += gridDim.y * L) {
    if (alive[i] == 0.0f) {
      for (int f = lane; f < row_len; f += kWarpLanes) {
        a.out[(env_base + i) * row_len + f] = 0.0f;
      }
    }
  }
  __syncthreads();

  const int n_live = live_count;
  const float t_norm = a.t_norm[e];
  const GlobalFeature feature{a.feats + env_base * 5, a.types_f, n};
  const __nv_bfloat16* bmat = a.bmat + env_base * kTerms;
  const int groups = (n_live + L - 1) / L;
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    // A[r, t] = bmat[t, i] for the group's r-th observer i, zero past the
    // live observers and past the 12 terms; the barrier after it also
    // waits for the previous group's scans
    for (int q = threadIdx.x; q < L * kTileDepth; q += blockDim.x) {
      const int r = g * L + q / kTileDepth;
      const int t = q % kTileDepth;
      a_rows[q] = (r < n_live && t < kTerms)
                      ? bmat[static_cast<long long>(t) * n + live_idx[r]]
                      : zero;
    }
    __syncthreads();
    // the same in every lane of the warp
    const bool live = g * L + warp < n_live;
    const int i = live ? live_idx[g * L + warp] : 0;
    WarpList<Key> list(KeyOf::sentinel());
    for (int begin = 0; begin < rows; begin += chunk) {
      if (begin > 0) __syncthreads();  // the previous chunk's rows are read
      const int end = min(begin + chunk, rows);
      wmma::fragment<wmma::matrix_a, L, kCols, kTileDepth, __nv_bfloat16,
                     wmma::row_major>
          a_frag;
      wmma::load_matrix_sync(a_frag, a_rows, kTileDepth);
      for (int col = begin + warp * kCols; col < end; col += L * kCols) {
        wmma::fragment<wmma::matrix_b, L, kCols, kTileDepth, __nv_bfloat16,
                       wmma::col_major>
            b_frag;
        wmma::fragment<wmma::accumulator, L, kCols, kTileDepth, float> acc;
        wmma::load_matrix_sync(b_frag, terms + col * kTileDepth, kTileDepth);
        wmma::fill_fragment(acc, 0.0f);
        wmma::mma_sync(acc, a_frag, b_frag, acc);
        wmma::store_matrix_sync(dist + col - begin, acc, stride,
                                wmma::mem_row_major);
      }
      __syncthreads();
      if (live) {
        scan_observer(list, RowDist{dist + warp * stride, begin}, alive,
                      key_of, i, begin, min(end, n), a.k, lane);
      }
    }
    if (live) {
      list.finish();
      emit_warp_row(a.out + (env_base + i) * row_len, list, a.k, t_norm,
                    feature, i, lane);
    }
  }
}

template <typename KeyOf>
cudaError_t launch_tile(const KnnArgs& a, int e, KeyOf key_of,
                        cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(a.n);
  const cudaError_t err = allow_smem(tile_kernel<KeyOf>, smem);
  if (err != cudaSuccess) return err;
  const int groups = (a.n + kTileRows - 1) / kTileRows;
  tile_kernel<KeyOf><<<scan_grid(e, groups, 1), kTileRows * kWarpLanes,
                       smem, stream>>>(a, key_of);
  return cudaGetLastError();
}

// b-bit packed key for b in [1, 22] covering every index below n, or an
// all-ones mask (exact) for b = 0; false for a b that does not fit.
inline bool packed_clear(int packed_bits, int n, int* clear) {
  if (packed_bits == 0) {
    *clear = -1;
    return true;
  }
  if (packed_bits < 1 || packed_bits > 22 || n > (1 << packed_bits)) {
    return false;
  }
  *clear = ~((1 << packed_bits) - 1);
  return true;
}

}  // namespace knn
