// Native (C++) batched environment steppers for the CPU backend.
//
// The reference accelerates env stepping with native per-thread kernels
// (CUDA C++ / numba-jitted device code, e.g.
// example_envs/single_agent/classic_control/cartpole/cartpole_step_numba.py:5-83,
// example_envs/tag_gridworld/tag_gridworld_step_pycuda.cu); the device compute
// path here is PyTorch/CUDA, and THIS file is the native equivalent for the
// host CPU backend (reference EnvWrapper env_backend='cpu'): one C++ call
// steps every env replica, replacing the per-env python loop.
//
// Semantics contract: numerically identical to the numpy reference
// implementations in warpdrive_tpu_torch/envs/. Under NumPy 2 (NEP 50) python
// float constants are weak — float32 state stays float32 through the
// arithmetic — so these kernels use float arithmetic with the double
// constants rounded to float exactly where numpy rounds them.
// sin/cos are computed as (float)sin((double)x): numpy's float32 loops
// are correctly-rounded to ~1 ulp, so trajectories agree to float
// precision (asserted by tests/test_torch_native_backend.py).
//
// Build: g++ -O3 -shared -fPIC (see native/__init__.py; no external deps).

#include <cmath>
#include <cstdint>

namespace {

// ----- CartPole constants (warpdrive_tpu_torch/envs/classic_control/cartpole.py)
const float GRAVITY = 9.8f;
const float MASSPOLE = 0.1f;
const float TOTAL_MASS = (float)(0.1 + 1.0);  // MASSPOLE + MASSCART
const float LENGTH = 0.5f;                    // half the pole's length
const float POLEMASS_LENGTH = (float)(0.1 * 0.5);
const float FORCE_MAG = 10.0f;
const float TAU = 0.02f;
const float FOUR_THIRDS = (float)(4.0 / 3.0);
const float THETA_THRESHOLD_RADIANS = (float)(12.0 * 2.0 * M_PI / 360.0);
const float X_THRESHOLD = 2.4f;

// (dx, dy) per discrete action: no-op, +x, -x, +y, -y
const int STEP_DX[5] = {0, 1, -1, 0, 0};
const int STEP_DY[5] = {0, 0, 0, 1, -1};

// numpy floored modulo on float32 (np.mod): result has the divisor's sign.
inline float wrap_pi(float x) {
  // ((x + pi) % (2 pi)) - pi with numpy semantics
  const float two_pi = (float)(2.0 * M_PI);
  float y = x + (float)M_PI;
  float r = fmodf(y, two_pi);
  if (r < 0.0f) r += two_pi;
  return r - (float)M_PI;
}

inline float clipf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

inline float cosf_np(float x) { return (float)cos((double)x); }
inline float sinf_np(float x) { return (float)sin((double)x); }

}  // namespace

extern "C" {

// CartPole: advance every env one step.
//   state:     (n_envs, 4) float32, updated in place  [x, x_dot, th, th_dot]
//   actions:   (n_envs,)   int32    {0, 1}
//   timesteps: (n_envs,)   int32, incremented in place
//   rewards:   (n_envs,)   float32 out (always +1, incl. terminating step)
//   dones:     (n_envs,)   int32 out (1 on termination or episode end)
void wd_cartpole_step(int n_envs, float* state, const int* actions,
                      int* timesteps, float* rewards, int* dones,
                      int episode_length) {
  for (int e = 0; e < n_envs; ++e) {
    float* s = state + 4 * e;
    timesteps[e] += 1;
    const float force = actions[e] > 0 ? FORCE_MAG : -FORCE_MAG;
    float x = s[0], x_dot = s[1], theta = s[2], theta_dot = s[3];
    const float costheta = (float)cos((double)theta);
    const float sintheta = (float)sin((double)theta);
    const float temp =
        (force + POLEMASS_LENGTH * (theta_dot * theta_dot) * sintheta) /
        TOTAL_MASS;
    const float thetaacc =
        (GRAVITY * sintheta - costheta * temp) /
        (LENGTH * (FOUR_THIRDS - MASSPOLE * (costheta * costheta) / TOTAL_MASS));
    const float xacc =
        temp - POLEMASS_LENGTH * thetaacc * costheta / TOTAL_MASS;
    x = x + TAU * x_dot;
    x_dot = x_dot + TAU * xacc;
    theta = theta + TAU * theta_dot;
    theta_dot = theta_dot + TAU * thetaacc;
    s[0] = x;
    s[1] = x_dot;
    s[2] = theta;
    s[3] = theta_dot;
    const bool terminated = (x < -X_THRESHOLD) || (x > X_THRESHOLD) ||
                            (theta < -THETA_THRESHOLD_RADIANS) ||
                            (theta > THETA_THRESHOLD_RADIANS);
    rewards[e] = 1.0f;
    dones[e] = (timesteps[e] >= episode_length || terminated) ? 1 : 0;
  }
}

// Pendulum (warpdrive_tpu_torch/envs/classic_control/pendulum.py; reference
// numba kernel pendulum_step_numba.py:31-74): cost on the PRE-step angle,
// obs (cos th, sin th, thdot), done only at episode end.  Python-float
// constant subexpressions are folded in double then rounded to float at the
// point numpy's weak-scalar promotion rounds them.
//   state: (n_envs, 2) float32 [theta, theta_dot]; obs out: (n_envs, 3)
void wd_pendulum_step(int n_envs, float* state, const float* actions,
                      int* timesteps, float* rewards, int* dones,
                      int episode_length, float* obs) {
  const float coef_g = (float)(3.0 * 9.81 / (2.0 * 1.0));  // 3g/(2L)
  const float coef_u = (float)(3.0 / (1.0 * 1.0));         // 3/(M L^2)
  const float dt = 0.05f;
  for (int e = 0; e < n_envs; ++e) {
    float* s = state + 2L * e;
    timesteps[e] += 1;
    const float u = clipf(actions[e], -2.0f, 2.0f);
    const float th = s[0], thdot = s[1];
    const float an = wrap_pi(th);
    const float costs =
        an * an + 0.1f * (thdot * thdot) + 0.001f * (u * u);
    float newthdot =
        thdot + (coef_g * sinf_np(th) + coef_u * u) * dt;
    newthdot = clipf(newthdot, -8.0f, 8.0f);
    const float newth = th + newthdot * dt;
    s[0] = newth;
    s[1] = newthdot;
    float* o = obs + 3L * e;
    o[0] = cosf_np(newth);
    o[1] = sinf_np(newth);
    o[2] = newthdot;
    rewards[e] = -costs;
    dones[e] = timesteps[e] >= episode_length ? 1 : 0;
  }
}

// MountainCar-v0, discrete (mountain_car.py:67-87; reference numba kernel
// mountain_car_step_numba.py:15-70).  obs == state.
//   state: (n_envs, 2) float32 [position, velocity]; actions in {0,1,2}
void wd_mountain_car_step(int n_envs, float* state, const int* actions,
                          int* timesteps, float* rewards, int* dones,
                          int episode_length) {
  for (int e = 0; e < n_envs; ++e) {
    float* s = state + 2L * e;
    timesteps[e] += 1;
    float position = s[0], velocity = s[1];
    // velocity += float32((a-1)*FORCE) + float32(cos(3p)*(-GRAVITY))
    const float acc = (float)((double)(actions[e] - 1) * 0.001);
    const float grav = cosf_np(3.0f * position) * (-0.0025f);
    velocity = velocity + (acc + grav);
    velocity = clipf(velocity, -0.07f, 0.07f);
    position = position + velocity;
    position = clipf(position, -1.2f, 0.6f);
    if (position == -1.2f && velocity < 0.0f) velocity = 0.0f;
    s[0] = position;
    s[1] = velocity;
    const bool terminated = position >= 0.5f && velocity >= 0.0f;
    rewards[e] = -1.0f;
    dones[e] = (timesteps[e] >= episode_length || terminated) ? 1 : 0;
  }
}

// Continuous MountainCar (continuous_mountain_car.py:69-89; reference numba
// kernel continuous_mountain_car_step_numba.py:15-73).  The action penalty
// float(action)**2 * 0.1 is computed in python DOUBLE before the engine's
// final float32 cast — reproduced exactly.  obs == state.
void wd_continuous_mountain_car_step(int n_envs, float* state,
                                     const float* actions, int* timesteps,
                                     float* rewards, int* dones,
                                     int episode_length) {
  for (int e = 0; e < n_envs; ++e) {
    float* s = state + 2L * e;
    timesteps[e] += 1;
    const float action = actions[e];
    float position = s[0], velocity = s[1];
    const float force = clipf(action, -1.0f, 1.0f);
    const float a = force * 0.0015f;                       // float32(force*POWER)
    const float b = (float)(0.0025) * cosf_np(3.0f * position);
    velocity = velocity + (a - b);
    velocity = clipf(velocity, -0.07f, 0.07f);
    position = position + velocity;
    position = clipf(position, -1.2f, 0.6f);
    if (position == -1.2f && velocity < 0.0f) velocity = 0.0f;
    s[0] = position;
    s[1] = velocity;
    const bool terminated = position >= 0.45f && velocity >= 0.0f;
    const double rew =
        (terminated ? 100.0 : 0.0) - (double)action * (double)action * 0.1;
    rewards[e] = (float)rew;
    dones[e] = (timesteps[e] >= episode_length || terminated) ? 1 : 0;
  }
}

namespace {

// Acrobot two-link ODE RHS (acrobot.py:50-80; reference numba kernel
// acrobot_step_numba.py:71-109).  Evaluation order and the double→float
// rounding points mirror the numpy expression tree: pure-python-float
// subexpressions fold in double, everything touching state is float32.
inline void acrobot_dsdt(const float* s, float torque, float* out) {
  const float th1 = s[0], th2 = s[1], dth1 = s[2], dth2 = s[3];
  const float cos_th2 = cosf_np(th2);
  const float sin_th2 = sinf_np(th2);
  // d1 = 0.25 + 1.0*(1.25 + 1.0*cos th2) + 1 + 1  (m,l,lc folded)
  const float d1 = (float)(0.25) + ((float)(1.25) + (float)(1.0) * cos_th2)
                   + (float)(1.0) + (float)(1.0);
  // d2 = 1.0 * (0.25 + 0.5*cos th2) + 1
  const float d2 = ((float)(0.25) + (float)(0.5) * cos_th2) + (float)(1.0);
  const float phi2 =
      (float)(0.5 * 9.8) * cosf_np(th1 + th2 - (float)(M_PI / 2.0));
  const float phi1 =
      (float)(-0.5) * (dth2 * dth2) * sin_th2
      - (float)(1.0) * dth2 * dth1 * sin_th2
      + (float)((1.0 * 0.5 + 1.0 * 1.0) * 9.8)
            * cosf_np(th1 - (float)(M_PI / 2.0))
      + phi2;
  const float ddth2 =
      (torque + d2 / d1 * phi1
       - (float)(0.5) * (dth1 * dth1) * sin_th2 - phi2)
      / ((float)(1.25) - (d2 * d2) / d1);
  const float ddth1 = -(d2 * ddth2 + phi1) / d1;
  out[0] = dth1;
  out[1] = dth2;
  out[2] = ddth1;
  out[3] = ddth2;
}

}  // namespace

// Acrobot, discrete torque {-1,0,1}, one RK4 step per env step
// (acrobot.py:83-104,149-163; reference acrobot_step_numba.py:112-178).
//   state: (n_envs, 4) float32 [th1, th2, dth1, dth2]
//   obs out: (n_envs, 6) [cos th1, sin th1, cos th2, sin th2, dth1, dth2]
void wd_acrobot_step(int n_envs, float* state, const int* actions,
                     int* timesteps, float* rewards, int* dones,
                     int episode_length, float* obs) {
  const float dt = 0.2f;
  const float dt2 = (float)(0.2 / 2.0);
  const float dt6 = (float)(0.2 / 6.0);
  const float max_v1 = (float)(4.0 * M_PI);
  const float max_v2 = (float)(9.0 * M_PI);
  for (int e = 0; e < n_envs; ++e) {
    float* s = state + 4L * e;
    timesteps[e] += 1;
    const float torque = (float)(actions[e] - 1);
    float k1[4], k2[4], k3[4], k4[4], tmp[4], ns[4];
    acrobot_dsdt(s, torque, k1);
    for (int i = 0; i < 4; ++i) tmp[i] = s[i] + k1[i] * dt2;
    acrobot_dsdt(tmp, torque, k2);
    for (int i = 0; i < 4; ++i) tmp[i] = s[i] + k2[i] * dt2;
    acrobot_dsdt(tmp, torque, k3);
    for (int i = 0; i < 4; ++i) tmp[i] = s[i] + k3[i] * dt;
    acrobot_dsdt(tmp, torque, k4);
    for (int i = 0; i < 4; ++i)
      ns[i] = s[i] + dt6 * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
    s[0] = wrap_pi(ns[0]);
    s[1] = wrap_pi(ns[1]);
    s[2] = clipf(ns[2], -max_v1, max_v1);
    s[3] = clipf(ns[3], -max_v2, max_v2);
    const bool terminated =
        (-cosf_np(s[0]) - cosf_np(s[1] + s[0])) > 1.0f;
    float* o = obs + 6L * e;
    o[0] = cosf_np(s[0]);
    o[1] = sinf_np(s[0]);
    o[2] = cosf_np(s[1]);
    o[3] = sinf_np(s[1]);
    o[4] = s[2];
    o[5] = s[3];
    rewards[e] = terminated ? 0.0f : -1.0f;
    dones[e] = (timesteps[e] >= episode_length || terminated) ? 1 : 0;
  }
}

// TagGridWorld: advance every env one step (N-1 taggers chase 1 runner,
// the runner is the LAST agent).
//   loc_x/loc_y: (n_envs, n_agents) int32, updated in place
//   actions:     (n_envs, n_agents) int32 in [0, 5)
//   timesteps:   (n_envs,) int32, incremented in place
//   rewards:     (n_envs, n_agents) float32 out
//   dones:       (n_envs,) int32 out
// Penalty/reward terms are applied in float32 with the double config
// values rounded to float first (numpy NEP-50 weak-scalar semantics).
void wd_tag_gridworld_step(int n_envs, int n_agents, int grid_length,
                           int* loc_x, int* loc_y, const int* actions,
                           int* timesteps, float* rewards, int* dones,
                           int episode_length, double wall_hit_penalty,
                           double tag_reward_for_tagger,
                           double tag_penalty_for_runner,
                           double step_cost_for_tagger) {
  const float wall_pen_f = (float)(-wall_hit_penalty);
  const float tag_rew_f = (float)tag_reward_for_tagger;
  const float tag_pen_f = (float)(-tag_penalty_for_runner);
  const float step_cost_f = (float)step_cost_for_tagger;
  const float neg_step_cost_f = (float)(-step_cost_for_tagger);
  for (int e = 0; e < n_envs; ++e) {
    int* lx = loc_x + (long)e * n_agents;
    int* ly = loc_y + (long)e * n_agents;
    const int* act = actions + (long)e * n_agents;
    float* rew = rewards + (long)e * n_agents;
    timesteps[e] += 1;

    for (int a = 0; a < n_agents; ++a) {
      const int nx = lx[a] + STEP_DX[act[a]];
      const int ny = ly[a] + STEP_DY[act[a]];
      const int cx = nx < 0 ? 0 : (nx > grid_length ? grid_length : nx);
      const int cy = ny < 0 ? 0 : (ny > grid_length ? grid_length : ny);
      const bool wall_hit = (nx != cx) || (ny != cy);
      rew[a] = wall_hit ? wall_pen_f : 0.0f;
      lx[a] = cx;
      ly[a] = cy;
    }
    bool tag = false;
    const int rx = lx[n_agents - 1], ry = ly[n_agents - 1];
    for (int a = 0; a < n_agents - 1; ++a) {
      if (lx[a] == rx && ly[a] == ry) { tag = true; break; }
    }
    for (int a = 0; a < n_agents - 1; ++a) {
      rew[a] = (tag ? tag_rew_f : neg_step_cost_f) + rew[a];
    }
    rew[n_agents - 1] = (tag ? tag_pen_f : step_cost_f) + rew[n_agents - 1];
    dones[e] = (timesteps[e] >= episode_length || tag) ? 1 : 0;
  }
}

// TagGridWorld observation build.
//   full observation  (use_full != 0): (n_envs, n_agents, 4*N + 1)
//     [x_all/L, y_all/L, types, onehot(self), t/T]
//   partial           (use_full == 0): (n_envs, n_agents, 6)
//     [own_x, own_y, target_x, target_y, is_runner, t/T]
void wd_tag_gridworld_observe(int n_envs, int n_agents, int grid_length,
                              const int* loc_x, const int* loc_y,
                              const int* timesteps, int episode_length,
                              int use_full, float* obs) {
  const float L = (float)grid_length;
  const int N = n_agents;
  const int D = use_full ? (4 * N + 1) : 6;
  for (int e = 0; e < n_envs; ++e) {
    const int* lx = loc_x + (long)e * N;
    const int* ly = loc_y + (long)e * N;
    float* o_env = obs + (long)e * N * D;
    const float t_norm = (float)((double)timesteps[e] / (double)episode_length);
    if (use_full) {
      for (int a = 0; a < N; ++a) {
        float* o = o_env + (long)a * D;
        for (int j = 0; j < N; ++j) o[j] = (float)lx[j] / L;
        for (int j = 0; j < N; ++j) o[N + j] = (float)ly[j] / L;
        for (int j = 0; j < N; ++j) o[2 * N + j] = (j == N - 1) ? 1.0f : 0.0f;
        for (int j = 0; j < N; ++j) o[3 * N + j] = (j == a) ? 1.0f : 0.0f;
        o[4 * N] = t_norm;
      }
    } else {
      // nearest tagger to the runner (squared distance, lowest id on ties)
      long best = 0;
      long best_d2 = 0x7fffffffffffffffL;
      for (int a = 0; a < N - 1; ++a) {
        const long dx = (long)lx[a] - lx[N - 1];
        const long dy = (long)ly[a] - ly[N - 1];
        const long d2 = dx * dx + dy * dy;
        if (d2 < best_d2) { best_d2 = d2; best = a; }
      }
      for (int a = 0; a < N; ++a) {
        float* o = o_env + (long)a * D;
        const bool is_runner = (a == N - 1);
        o[0] = (float)lx[a] / L;
        o[1] = (float)ly[a] / L;
        o[2] = is_runner ? (float)lx[best] / L : (float)lx[N - 1] / L;
        o[3] = is_runner ? (float)ly[best] / L : (float)ly[N - 1] / L;
        o[4] = is_runner ? 1.0f : 0.0f;
        o[5] = t_norm;
      }
    }
  }
}

// TagContinuous: taggers chase runners on a continuous 2D square
// (warpdrive_tpu_torch/envs/tag_continuous.py; reference CUDA kernel
// tag_continuous_step_pycuda.cu:28-521).  One call advances every env:
// physics, tagging (nearest-tagger credit, sequential float32 accumulation
// in runner-id order like np.add.at), exits, end-of-game rewards, done.
//   loc_x/loc_y/speed/direction/accel: (n_envs, n_agents) float32, in place
//   still:     (n_envs, n_agents) int32, in place
//   actions:   (n_envs, n_agents, 2) int32 [acc level, turn level]
//   rewards:   (n_envs, n_agents) float32 out
void wd_tag_continuous_step(
    int n_envs, int n_agents, float* loc_x, float* loc_y, float* speed,
    float* direction, float* accel, int* still, const int* actions,
    int* timesteps, float* rewards, int* dones, const float* acc_table,
    const float* turn_table, const int* is_tagger, const float* skill,
    const float* step_rewards, int episode_length, float max_speed,
    float grid_length, float edge_hit_penalty, float distance_margin,
    float tag_reward, float tag_penalty, float end_reward,
    int runner_exits) {
  const float two_pi = (float)(2.0 * M_PI);
#pragma omp parallel for schedule(static)
  for (int e = 0; e < n_envs; ++e) {
    float* lx = loc_x + (long)e * n_agents;
    float* ly = loc_y + (long)e * n_agents;
    float* sp = speed + (long)e * n_agents;
    float* dir = direction + (long)e * n_agents;
    float* ac = accel + (long)e * n_agents;
    int* st = still + (long)e * n_agents;
    const int* act = actions + (long)e * n_agents * 2;
    float* rew = rewards + (long)e * n_agents;
    timesteps[e] += 1;

    for (int a = 0; a < n_agents; ++a) {
      const float still_f = (float)st[a];
      // direction' = ((dir + dturn) mod 2pi) * still
      float d = dir[a] + turn_table[act[2 * a + 1]];
      float r = fmodf(d, two_pi);
      if (r < 0.0f) r += two_pi;
      dir[a] = r * still_f;
      // speed' = clip(speed + acc', 0, max_speed*skill) * still;
      // acceleration zeroed at the speed bounds
      const float acc_new = ac[a] + acc_table[act[2 * a]];
      const float ms = max_speed * skill[a];
      float s = sp[a] + acc_new;
      s = clipf(s, 0.0f, ms);
      s *= still_f;
      sp[a] = s;
      ac[a] = (s > 0.0f && s < ms) ? acc_new : 0.0f;

      const float nx = lx[a] + s * cosf_np(dir[a]);
      const float ny = ly[a] + s * sinf_np(dir[a]);
      const bool crossed =
          !(nx >= 0.0f && nx <= grid_length && ny >= 0.0f &&
            ny <= grid_length);
      lx[a] = clipf(nx, 0.0f, grid_length);
      ly[a] = clipf(ny, 0.0f, grid_length);
      // rew[alive] += edge_penalty + step_rewards  (alive = pre-tag still)
      rew[a] = st[a] > 0
                   ? (edge_hit_penalty * (crossed ? 1.0f : 0.0f) +
                      step_rewards[a])
                   : 0.0f;
    }

    // tagging: per alive runner, nearest tagger (first index at the min,
    // like argmin); runner-id-order accumulation matches np.add.at
    for (int a = 0; a < n_agents; ++a) {
      if (is_tagger[a] || st[a] <= 0) continue;
      float best_d = 1e20f;
      int best_j = -1;
      for (int j = 0; j < n_agents; ++j) {
        if (!is_tagger[j]) continue;
        const float ddx = lx[a] - lx[j];
        const float ddy = ly[a] - ly[j];
        const float dist = (float)sqrt((double)(ddx * ddx + ddy * ddy));
        if (dist < best_d) { best_d = dist; best_j = j; }
      }
      if (best_j >= 0 && best_d < distance_margin) {
        rew[a] += tag_penalty;
        rew[best_j] += tag_reward;
        if (runner_exits) st[a] = 0;
      }
    }

    int runners_alive = 0;
    for (int a = 0; a < n_agents; ++a)
      if (!is_tagger[a] && st[a] > 0) runners_alive += 1;
    if (timesteps[e] == episode_length) {
      for (int a = 0; a < n_agents; ++a)
        if (!is_tagger[a] && st[a] > 0) rew[a] += end_reward;
    }
    dones[e] =
        (timesteps[e] >= episode_length || runners_alive == 0) ? 1 : 0;
  }
}

// TagContinuous observation build (tag_continuous.py:247-305; reference
// obs kernel tag_continuous_step_pycuda.cu:295-468).
//   full mode (use_full != 0): per agent, channel-major
//     [5 rel feats x (N-1), types x (N-1), still x (N-1), t_norm];
//     dead agents: zero features but REAL type/still rows and time 0.
//   kNN mode: slot-major [k x (5 rel, type, still, valid)] + t_norm;
//     dead agents: all zeros.  Neighbor order = stable argsort of the
//     distance matrix (iterated lowest-index argmin).
//   feats normalization constants are passed in pre-rounded to float32
//   exactly as numpy computes them.
void wd_tag_continuous_observe(
    int n_envs, int n_agents, const float* loc_x, const float* loc_y,
    const float* speed, const float* direction, const float* accel,
    const int* still, const int* timesteps, const int* is_tagger,
    int episode_length, float grid_diagonal, float speed_denom,
    int use_full, int k, float* obs) {
  const float two_pi = (float)(2.0 * M_PI);
  const int D = use_full ? (7 * (n_agents - 1) + 1) : (8 * k + 1);
  const float big = 1e20f;
#pragma omp parallel for schedule(static)
  for (int e = 0; e < n_envs; ++e) {
    const float* lx = loc_x + (long)e * n_agents;
    const float* ly = loc_y + (long)e * n_agents;
    const float* sp = speed + (long)e * n_agents;
    const float* dr = direction + (long)e * n_agents;
    const float* ac = accel + (long)e * n_agents;
    const int* st = still + (long)e * n_agents;
    float* o_env = obs + (long)e * n_agents * D;
    const float t_norm =
        (float)((double)timesteps[e] / (double)episode_length);
    const int N = n_agents;

    // feats[c][j], c in {x, y, speed, acc, dir}
    float* feats = new float[5L * N];
    for (int j = 0; j < N; ++j) {
      feats[0 * N + j] = lx[j] / grid_diagonal;
      feats[1 * N + j] = ly[j] / grid_diagonal;
      feats[2 * N + j] = sp[j] / speed_denom;
      feats[3 * N + j] = ac[j] / speed_denom;
      feats[4 * N + j] = dr[j] / two_pi;
    }

    if (use_full) {
      for (int i = 0; i < N; ++i) {
        float* o = o_env + (long)i * D;
        const bool alive = st[i] > 0;
        int col = 0;
        for (int c = 0; c < 5; ++c) {
          const float fi = feats[c * N + i];
          for (int j = 0; j < N; ++j) {
            if (j == i) continue;
            o[col++] = alive ? feats[c * N + j] - fi : 0.0f;
          }
        }
        for (int j = 0; j < N; ++j)
          if (j != i) o[col++] = is_tagger[j] ? 1.0f : 0.0f;
        for (int j = 0; j < N; ++j)
          if (j != i) o[col++] = (float)st[j];
        o[col] = alive ? t_norm : 0.0f;
      }
    } else {
      float* dist = new float[(long)N];
      for (int i = 0; i < N; ++i) {
        float* o = o_env + (long)i * D;
        if (st[i] <= 0) {
          for (int c = 0; c < D; ++c) o[c] = 0.0f;
          continue;
        }
        for (int j = 0; j < N; ++j) {
          if (j == i || st[j] == 0) { dist[j] = big; continue; }
          const float ddx = lx[i] - lx[j];
          const float ddy = ly[i] - ly[j];
          dist[j] = (float)sqrt((double)(ddx * ddx + ddy * ddy));
        }
        for (int s = 0; s < k; ++s) {
          float best_d = big;
          int best_j = -1;
          for (int j = 0; j < N; ++j)
            if (dist[j] < best_d) { best_d = dist[j]; best_j = j; }
          float* slot = o + 8L * s;
          if (best_j >= 0) {
            for (int c = 0; c < 5; ++c)
              slot[c] = feats[c * N + best_j] - feats[c * N + i];
            slot[5] = is_tagger[best_j] ? 1.0f : 0.0f;
            slot[6] = (float)st[best_j];
            slot[7] = 1.0f;
            dist[best_j] = big;
          } else {
            for (int c = 0; c < 8; ++c) slot[c] = 0.0f;
          }
        }
        o[8 * k] = t_norm;
      }
      delete[] dist;
    }
    delete[] feats;
  }
}

}  // extern "C"
