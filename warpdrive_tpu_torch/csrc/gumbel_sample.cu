// The categorical draw over all of a policy's action heads as one kernel,
// for Hopper (sm_90a): per row and head, argmax(logits + g) with the
// Gumbel noise g = -log(-log(max(u, FLT_MIN))) of a uniform u.
//
// Replaces no TPU kernel.  The JAX package draws with
// jax.random.categorical, which XLA fuses
// (warpdrive_tpu/sampling/samplers.py:sample_from_logits); run op by op in
// PyTorch the draw is 9 kernels a head (clamp, log, neg, log, neg, add,
// argmax, the int32 cast, besides the uniform draw) and a stack, each a
// launch of ~2 us on an H100.  The plain version is
// warpdrive_tpu_torch/sampling/samplers.py:draw_heads_plain, which this
// kernel equals bit for bit on the card for the same uniforms; the wrapper
// is ops/gumbel_sample.py, called by samplers.sample_heads.
//
//   inputs  any number of heads: float32 logits (rows, width) with a row
//           stride and unit column stride (slices of the fused head
//           output, taken as they are), and a contiguous float32 uniform
//           tensor of the same shape a head
//   output  int32 (rows, heads), contiguous: head h's draw of row r at
//           r * heads + h
//
// The plain chain's arithmetic, op for op: fmaxf(u, FLT_MIN) is the clamp
// (a NaN passed through, as torch.clamp passes it), logf is the accurate
// call that PyTorch's log makes (no fast-math build), the negations are
// exact, and the sum is __fadd_rn, so no build flag can contract it.  The
// argmax is torch.argmax's on the card: a NaN counts as the largest, and
// among equal values (and among NaNs) the lowest index wins.  That order
// is total, so the result does not depend on the order in which the lanes
// combine.
//
// What bounds it: latency and instruction issue, not bytes.  It reads the
// logits and uniforms once and writes an int32 a row and head: 3.4 MB at
// the runners' (10,000 rows, 21 + 21), ~1 us at 3.35 TB/s, where it takes
// ~5 us on an H100: two accurate logf an element, and a launch that fills
// the card about once.
//
// Design.  A team of kTeam lanes (8 or a warp) takes a row: its lanes
// stride over each head's width, each keeping the best key of each head
// (order_key: torch.argmax's order as one unsigned integer) and its lowest
// index; then two warp reductions a head (REDUX: the team's best key, then
// the lowest index among the lanes that hold it), the heads interleaved.
// A launch takes up to kMaxHeads heads; the entry point launches once for
// each group of kMaxHeads, each writing its columns of the one output.
// The team size follows the row count (team_of).

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHeads = 8;
constexpr int kThreads = 256;
// the lanes a launch needs to hide its loads' latency (a quarter of an
// H100's 132 x 2048 resident threads)
constexpr long long kMinLanes = 65536;

struct SampleArgs {
  const float* logits[kMaxHeads];
  long long row_stride[kMaxHeads];
  const float* uniform[kMaxHeads];
  int width[kMaxHeads];
  int heads;
  int rows;
  int* out;      // the group's first column of the output
  int out_cols;  // the output's row stride: every group's heads
};

// torch.argmax's order on the card (at::native's GreaterOrNan) as one
// unsigned key a value: a larger key wins, a NaN lies above every number,
// -0 and +0 are alike, and among equal keys the lowest index wins.  Every
// value's key is above 0 (-inf's is 0x007fffff), so 0 marks an empty slot.
__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned bits = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (bits & 0x80000000u) ? ~bits : bits | 0x80000000u;
}

template <int kTeam>
__global__ void __launch_bounds__(kThreads)
gumbel_sample_kernel(const SampleArgs a) {
  const long long thread =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int row = static_cast<int>(thread / kTeam);
  if (row >= a.rows) return;  // a team's lanes leave together
  const int lane = threadIdx.x % kTeam;
  // the team's lanes of the warp: kTeam bits from its first lane on
  const unsigned team_mask =
      kTeam == 32 ? 0xffffffffu
                  : ((1u << kTeam % 32) - 1u) << (threadIdx.x % 32 - lane);

  // each lane's best key of each head and its lowest index
  unsigned best[kMaxHeads];
  unsigned best_at[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    best[h] = 0u;
    best_at[h] = 0xffffffffu;
    if (h < a.heads) {
      const float* logits = a.logits[h] + row * a.row_stride[h];
      const float* uniform =
          a.uniform[h] + static_cast<long long>(row) * a.width[h];
      for (int j = lane; j < a.width[h]; j += kTeam) {
        const float u = uniform[j];
        const float g = -logf(-logf(u != u ? u : fmaxf(u, FLT_MIN)));
        const unsigned key = order_key(__fadd_rn(logits[j], g));
        if (key > best[h]) {
          best[h] = key;
          best_at[h] = j;
        }
      }
    }
  }
  // the team's best key of each head, then the lowest index holding it
  unsigned top[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < a.heads) top[h] = __reduce_max_sync(team_mask, best[h]);
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < a.heads) {
      best_at[h] = __reduce_min_sync(
          team_mask, best[h] == top[h] ? best_at[h] : 0xffffffffu);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < a.heads) {
        a.out[static_cast<long long>(row) * a.out_cols + h] =
            static_cast<int>(best_at[h]);
      }
    }
  }
}

// The team size: 8 lanes a row where that still gives kMinLanes lanes, a
// warp a row below.  Measured on an H100 at 21 + 21 logits a row: 8 is the
// best at 10,000 rows (5.1 us against a warp's 5.8), a warp the best at
// 1,000 (2.3 us), where 8 lanes a row leave the card mostly idle.
int team_of(int rows) {
  return static_cast<long long>(rows) * 8 >= kMinLanes ? 8 : 32;
}

template <int kTeam>
void launch(const SampleArgs& a, cudaStream_t stream) {
  const long long threads = static_cast<long long>(a.rows) * kTeam;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  gumbel_sample_kernel<kTeam><<<blocks, kThreads, 0, stream>>>(a);
}

}  // namespace

// Plain C entry point for ctypes.  logits, uniform: `heads` device
// pointers each; row_stride: the logits' row strides in elements; width:
// each head's width; out: int32 (rows, heads).  One launch a group of up to
// kMaxHeads heads.  Returns a cudaError_t: 0 when every launch was
// accepted, cudaErrorInvalidValue for a call the kernel does not take
// (heads or rows below 1, a width below 1).
extern "C" int gumbel_sample(const void* const* logits,
                             const long long* row_stride,
                             const void* const* uniform, const int* width,
                             int heads, int rows, int* out, void* stream) {
  if (heads < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int h = 0; h < heads; ++h) {
    if (width[h] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int team = team_of(rows);
  for (int first = 0; first < heads; first += kMaxHeads) {
    SampleArgs a{};
    a.heads = heads - first < kMaxHeads ? heads - first : kMaxHeads;
    for (int h = 0; h < a.heads; ++h) {
      a.logits[h] = static_cast<const float*>(logits[first + h]);
      a.row_stride[h] = row_stride[first + h];
      a.uniform[h] = static_cast<const float*>(uniform[first + h]);
      a.width[h] = width[first + h];
    }
    a.rows = rows;
    a.out = out + first;
    a.out_cols = heads;
    if (team == 8) {
      launch<8>(a, s);
    } else {
      launch<32>(a, s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
