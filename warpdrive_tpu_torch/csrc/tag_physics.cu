// The TagContinuous physics step as one kernel, for Hopper (sm_90a):
// dynamics, tagging, rewards, the still-in-the-game update, the timestep
// and the done flag of every env replica, in one launch.
//
// Replaces no TPU kernel.  The JAX package leaves this code to XLA, which
// fuses it (warpdrive_tpu/envs/tag_continuous.py:physics_fn); run op by op
// in PyTorch it is ~72 small kernels a step, each a launch of ~2 us on
// an H100, so the step was a chain of launches.  The plain version is
// warpdrive_tpu_torch/envs/tag_continuous.py:TorchTagContinuous.
// physics_plain, which this kernel equals bit for bit on the card; the
// wrapper is TorchTagContinuous.physics_fn (ops/tag_physics.py launches).
//
//   inputs  loc_x, loc_y, speed, direction, acceleration (E, N) float32,
//           still (E, N) int32, timestep (E,) int32, actions (E, N, 2) int32
//           (acceleration and turn level), and the env's constants:
//           max_speed, step_rewards (N,) float32, acc_table, turn_table
//           float32, tagger_slot (N,) int32 (agent i's index among the
//           taggers in ascending id, -1 for a runner)
//   An action indexes its table as a PyTorch index does: a negative one
//   counts from the end, and one outside [-size, size) is a device-side
//   assert, the refusal of the plain version's indexing on the card.
//   outputs the same five float32 fields, still, rewards (E, N), timestep
//           and done (E,): new buffers, the inputs untouched
//
// What bounds it: latency, not bytes or operations.  It reads ~32 B and
// writes ~28 B an agent (6.5 MB at the flagship's 1024 x 105, 1.9 us at
// 3.35 TB/s), and does a few dozen flops an agent plus T distances.  What
// costs time is one launch and the dependent chain inside a block: a
// cos/sin, then a barrier, T distances, a barrier, one more add.
//
// Design.  One block per env; its threads stride over the env's N agents,
// so one code path takes any N (10, 105, 1024 and above).
//   1. Each agent: table lookups, the direction's remainder by float32 2 pi,
//      the speed clamp, the acceleration mask, the position update and the
//      edge penalty.  Its new fields go to the outputs; a tagger also puts
//      its new position in shared memory at its tagger slot.
//   2. After a barrier, each agent takes sqrt(dx*dx + dy*dy) to the T
//      taggers and keeps the least, the lowest slot among ties (as
//      argmin).  A tagged runner pays its penalty and credits its nearest
//      tagger with an integer atomicAdd in shared memory: small integers,
//      so the order of the adds does not matter; they become float only at
//      the multiply.  __syncthreads_count over "holds a surviving runner"
//      is the barrier and the done flag's count at once.
//   3. Each agent adds its tag credit and the end-of-game reward.
// Every agent's reward takes every add of the plain version, the adds of
// a 0.0 included, which decide the sign of a zero.  Every product and sum
// is written with __fmul_rn / __fadd_rn / __fsub_rn in the plain version's
// order, so no build flag can contract them into an FMA; cosf, sinf and
// sqrtf are the calls PyTorch's own kernels make.  A thread re-reads in
// phases 2 and 3 the outputs it wrote itself in the earlier phase.

// the action check is a refusal, as PyTorch's index kernels make it, and
// holds in every build
#undef NDEBUG
#include <cassert>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
// shared memory a block may take without an opt-in: T x 12 bytes
constexpr int kMaxTaggers = 48 * 1024 / 12;

struct PhysicsArgs {
  const float* loc_x;
  const float* loc_y;
  const float* speed;
  const float* direction;
  const float* acceleration;
  const int* still;
  const int* timestep;
  const int* actions;
  const float* max_speed;
  const float* step_rewards;
  const float* acc_table;
  const float* turn_table;
  const int* tagger_slot;
  int acc_size;
  int turn_size;
  float* out_loc_x;
  float* out_loc_y;
  float* out_speed;
  float* out_direction;
  float* out_acceleration;
  int* out_still;
  float* out_rewards;
  int* out_timestep;
  int* out_done;
  int n;
  int taggers;
  float grid;
  float two_pi;
  float edge_hit_penalty;
  float margin;
  float tag_penalty;
  float tag_reward;
  float end_reward;
  int episode_length;
  int runner_exits;
};

// torch.clamp(min=), torch.minimum and torch.clamp on the card, NaN
// passed through (v != v)
__device__ __forceinline__ float torch_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float torch_minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float torch_clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// torch.remainder of float32 on the card: fmod, moved into b's sign
__device__ __forceinline__ float torch_remainder(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod = __fadd_rn(mod, b);
  return mod;
}

__device__ __forceinline__ float as_float(bool b) { return b ? 1.0f : 0.0f; }

// table[index] as a PyTorch index takes it: negative from the end, and a
// device-side assert outside [-size, size)
__device__ __forceinline__ float lookup(const float* table, int size,
                                        int index) {
  assert(index >= -size && index < size && "action index out of bounds");
  return table[index < 0 ? index + size : index];
}

__global__ void __launch_bounds__(kMaxThreads)
tag_physics_kernel(const PhysicsArgs a) {
  extern __shared__ float physics_smem[];
  float* tx = physics_smem;
  float* ty = physics_smem + a.taggers;
  int* credit = reinterpret_cast<int*>(physics_smem + 2 * a.taggers);

  const int e = blockIdx.x;
  const size_t base = static_cast<size_t>(e) * a.n;
  const int t = a.timestep[e] + 1;
  for (int s = threadIdx.x; s < a.taggers; s += blockDim.x) credit[s] = 0;

  // 1. dynamics, the edge penalty and the step reward
  for (int i = threadIdx.x; i < a.n; i += blockDim.x) {
    const size_t g = base + i;
    const int still_in = a.still[g];
    const float still = __int2float_rn(still_in);
    const float delta_acc =
        lookup(a.acc_table, a.acc_size, a.actions[2 * g]);
    const float delta_turn =
        lookup(a.turn_table, a.turn_size, a.actions[2 * g + 1]);

    const float direction = __fmul_rn(
        torch_remainder(__fadd_rn(a.direction[g], delta_turn), a.two_pi),
        still);
    float acc = __fadd_rn(a.acceleration[g], delta_acc);
    const float max_speed = a.max_speed[i];
    const float speed = __fmul_rn(
        torch_minimum(torch_clamp_min(__fadd_rn(a.speed[g], acc), 0.0f),
                      max_speed),
        still);
    acc = __fmul_rn(__fmul_rn(acc, as_float(speed > 0.0f)),
                    as_float(speed < max_speed));

    const float new_x =
        __fadd_rn(a.loc_x[g], __fmul_rn(speed, cosf(direction)));
    const float new_y =
        __fadd_rn(a.loc_y[g], __fmul_rn(speed, sinf(direction)));
    const bool crossed = !(new_x >= 0.0f && new_x <= a.grid &&
                           new_y >= 0.0f && new_y <= a.grid);
    const float loc_x = torch_clamp(new_x, 0.0f, a.grid);
    const float loc_y = torch_clamp(new_y, 0.0f, a.grid);
    const float edge = __fmul_rn(as_float(crossed), a.edge_hit_penalty);

    a.out_loc_x[g] = loc_x;
    a.out_loc_y[g] = loc_y;
    a.out_speed[g] = speed;
    a.out_direction[g] = direction;
    a.out_acceleration[g] = acc;
    a.out_rewards[g] =
        still_in > 0 ? __fadd_rn(edge, a.step_rewards[i]) : 0.0f;
    const int slot = a.tagger_slot[i];
    if (slot >= 0) {
      tx[slot] = loc_x;
      ty[slot] = loc_y;
    }
  }
  __syncthreads();

  // 2. the nearest tagger, tags, credit and the still-in-the-game update
  int holds_survivor = 0;
  for (int i = threadIdx.x; i < a.n; i += blockDim.x) {
    const size_t g = base + i;
    const float x = a.out_loc_x[g];
    const float y = a.out_loc_y[g];
    float best = 0.0f;
    int nearest = 0;
    for (int s = 0; s < a.taggers; ++s) {
      const float dx = __fsub_rn(x, tx[s]);
      const float dy = __fsub_rn(y, ty[s]);
      const float d =
          sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      if (s == 0 || d < best) {
        best = d;
        nearest = s;
      }
    }
    const int still_in = a.still[g];
    const bool runner = a.tagger_slot[i] < 0;
    const bool tagged = still_in > 0 && runner && best < a.margin;
    a.out_rewards[g] = __fadd_rn(a.out_rewards[g],
                                 __fmul_rn(as_float(tagged), a.tag_penalty));
    if (tagged) atomicAdd(&credit[nearest], 1);
    const int still_out = (tagged && a.runner_exits) ? 0 : still_in;
    a.out_still[g] = still_out;
    holds_survivor |= runner && still_out > 0;
  }
  const int runners_alive = __syncthreads_count(holds_survivor);

  // 3. the taggers' credit and the end-of-game reward, for every agent
  const bool last_step = t == a.episode_length;
  for (int i = threadIdx.x; i < a.n; i += blockDim.x) {
    const size_t g = base + i;
    const int slot = a.tagger_slot[i];
    const float tag_credit = slot >= 0 ? __int2float_rn(credit[slot]) : 0.0f;
    const float rew = __fadd_rn(a.out_rewards[g],
                                __fmul_rn(tag_credit, a.tag_reward));
    const bool survivor = slot < 0 && a.out_still[g] > 0;
    a.out_rewards[g] =
        __fadd_rn(rew, (last_step && survivor) ? a.end_reward : 0.0f);
  }
  if (threadIdx.x == 0) {
    a.out_timestep[e] = t;
    a.out_done[e] = (t >= a.episode_length || runners_alive == 0) ? 1 : 0;
  }
}

}  // namespace

// Plain C entry point for ctypes.  Returns a cudaError_t: 0 on a launch
// that was accepted, cudaErrorInvalidValue for a call the kernel does not
// take (e, n, t or a table's size below 1, t, the taggers, above n or
// above kMaxTaggers).
extern "C" int tag_physics(
    const float* loc_x, const float* loc_y, const float* speed,
    const float* direction, const float* acceleration, const int* still,
    const int* timestep, const int* actions, const float* max_speed,
    const float* step_rewards, const float* acc_table,
    const float* turn_table, const int* tagger_slot, int acc_size,
    int turn_size, float* out_loc_x, float* out_loc_y, float* out_speed,
    float* out_direction, float* out_acceleration, int* out_still,
    float* out_rewards, int* out_timestep, int* out_done, int e, int n,
    int t, float grid, float two_pi, float edge_hit_penalty, float margin,
    float tag_penalty, float tag_reward, float end_reward,
    int episode_length, int runner_exits, void* stream) {
  if (e <= 0 || n <= 0 || t <= 0 || t > n || t > kMaxTaggers ||
      acc_size <= 0 || turn_size <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PhysicsArgs a{
      loc_x, loc_y, speed, direction, acceleration, still, timestep,
      actions, max_speed, step_rewards, acc_table, turn_table, tagger_slot,
      acc_size, turn_size, out_loc_x, out_loc_y, out_speed, out_direction,
      out_acceleration, out_still, out_rewards, out_timestep, out_done, n, t,
      grid, two_pi, edge_hit_penalty, margin, tag_penalty, tag_reward,
      end_reward, episode_length, runner_exits};
  const int threads = n >= kMaxThreads ? kMaxThreads : (n + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(t) * 12;
  tag_physics_kernel<<<e, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
