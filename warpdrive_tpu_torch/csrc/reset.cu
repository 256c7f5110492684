// The done-driven auto-reset and its write-back into the static state as
// one kernel, for Hopper (sm_90a): every entry of a step's new state is
// written straight into its static buffer, an env row at a time from one of
// four sources -- the at-reset snapshot row, a reset-pool row, zero, or the
// step's own value.
//
// Replaces no TPU kernel.  The JAX package resets with jnp.where over the
// carry (warpdrive_tpu/core/reset.py:auto_reset), which XLA fuses with the
// donated carry's update.  Run op by op in PyTorch that is a `gt`, a `where`
// an entry (and a pool gather), two fills of the scalar zero the timestep's
// and the done flag's `where` take, then one copy an entry into the static
// state (core/program.py:assign_state): 11 kernels and 9 memcpy nodes a
// TagContinuous step, each ~1-3 us on an H100.  The plain version is
// core/reset.py's `where` chain followed by assign_state, which this kernel
// equals bit for bit: it selects bytes and computes nothing.  The wrapper is
// ops/reset.py, called by core/reset.py for CUDA tensors.
//
//   an entry  dst (envs, ...) the static buffer; src (envs, ...) the step's
//             value; kind:
//               kKeep      dst = src
//               kSnapshot  dst[e] = reset(e) ? from[...] : src[e]
//               kPool      dst[e] = reset(e) ? from[rows[e]] : src[e]
//               kZero      dst[e] = reset(e) ? 0 : src[e]
//             with reset(e) = force || done[e] > 0, done int32 (envs,);
//             from the snapshot row or the pool's first row, rows int64
//             (envs,) pool rows (a negative one counts from the end; one out
//             of range is a device-side assert, as the plain gather's is)
//
// What bounds it: bytes.  Each entry is read once and written once (a reset
// row read from the snapshot or the pool in place of the step's value): 2 x
// 3.44 MB at the flagship's (1024, 105), ~2.1 us at 3.35 TB/s.
//
// Design.  One thread a unit of `vec` bytes (16, 8, 4, 2 or 1: the widest
// that divides the entry's row and aligns its pointers), the units of all
// entries laid end to end, so that one launch covers every entry whatever
// their shapes: 10,000 one-element rows or 1024 rows of 105 get the same
// code.  A kKeep entry is one row of all its bytes, so it moves in the
// widest units its size and pointers allow.  Any element type passes through
// unchanged, since whole rows are selected.  A destination that is its own
// source is read and written at the same byte only, by one thread, and its
// rows that do not reset are left as they are.  Up to kMaxEntries entries,
// in one launch.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxEntries = 32;
constexpr int kThreads = 256;

enum Kind : int { kKeep = 0, kSnapshot = 1, kPool = 2, kZero = 3 };

struct Entry {
  char* dst;
  const char* src;
  const char* from;       // kSnapshot: the row; kPool: the pool's first row
  const long long* rows;  // kPool: a pool row an env
  long long pool_rows;    // kPool: the pool's rows
  unsigned first;         // the entry's first unit in the launch
  unsigned row_units;     // units a row
  int vec;                // bytes a unit
  int kind;
};

struct ResetArgs {
  Entry entry[kMaxEntries];
  int entries;
  unsigned units;  // every entry's units
  const int* done;
  int force;
};

template <typename T>
__device__ __forceinline__ void move(char* dst, const char* src) {
  *reinterpret_cast<T*>(dst) = *reinterpret_cast<const T*>(src);
}

template <typename T>
__device__ __forceinline__ void clear(char* dst) {
  *reinterpret_cast<T*>(dst) = T{};
}

__device__ __forceinline__ void move_unit(int vec, char* dst,
                                          const char* src) {
  switch (vec) {
    case 16: move<uint4>(dst, src); break;
    case 8: move<uint2>(dst, src); break;
    case 4: move<unsigned>(dst, src); break;
    case 2: move<unsigned short>(dst, src); break;
    default: move<unsigned char>(dst, src); break;
  }
}

__device__ __forceinline__ void clear_unit(int vec, char* dst) {
  switch (vec) {
    case 16: clear<uint4>(dst); break;
    case 8: clear<uint2>(dst); break;
    case 4: clear<unsigned>(dst); break;
    case 2: clear<unsigned short>(dst); break;
    default: clear<unsigned char>(dst); break;
  }
}

__global__ void __launch_bounds__(kThreads)
reset_when_done_kernel(const ResetArgs a) {
  const unsigned unit = blockIdx.x * kThreads + threadIdx.x;
  if (unit >= a.units) return;
  int i = 0;
  while (i + 1 < a.entries && unit >= a.entry[i + 1].first) ++i;
  const Entry& en = a.entry[i];
  const unsigned u = unit - en.first;
  const unsigned env = u / en.row_units;
  const long long row_bytes =
      static_cast<long long>(en.row_units) * en.vec;
  const long long in_row =
      static_cast<long long>(u - env * en.row_units) * en.vec;
  const long long at = env * row_bytes + in_row;
  if (en.kind == kKeep) {
    move_unit(en.vec, en.dst + at, en.src + at);
    return;
  }
  const bool reset = a.force || a.done[env] > 0;
  if (!reset) {
    if (en.dst != en.src) move_unit(en.vec, en.dst + at, en.src + at);
    return;
  }
  if (en.kind == kZero) {
    clear_unit(en.vec, en.dst + at);
  } else if (en.kind == kSnapshot) {
    move_unit(en.vec, en.dst + at, en.from + in_row);
  } else {
    long long r = en.rows[env];
    if (r < 0) r += en.pool_rows;
    assert(r >= 0 && r < en.pool_rows);
    move_unit(en.vec, en.dst + at, en.from + r * row_bytes + in_row);
  }
}

// The widest unit that divides `bytes` and aligns every pointer given.
int unit_of(long long bytes, const void* a, const void* b, const void* c) {
  const unsigned long long bits =
      reinterpret_cast<unsigned long long>(a) |
      reinterpret_cast<unsigned long long>(b) |
      reinterpret_cast<unsigned long long>(c) |
      static_cast<unsigned long long>(bytes);
  for (int vec = 16; vec > 1; vec /= 2) {
    if (bits % vec == 0) return vec;
  }
  return 1;
}

}  // namespace

// Plain C entry point for ctypes.  dst, src, from, rows: `entries` device
// pointers each (from and rows null where the kind takes none); row_bytes:
// each entry's bytes an env row; pool_rows: each kPool entry's pool rows;
// kind: each entry's Kind; done: int32 (envs,), read unless force.  One
// launch.  Returns a cudaError_t: 0 when the launch was accepted,
// cudaErrorInvalidValue for a call the kernel does not take (no entry or
// env, more than kMaxEntries entries, a row of no bytes, an unknown kind, a
// missing pointer, or 2^31 units or more).
extern "C" int reset_when_done(void* const* dst, const void* const* src,
                               const void* const* from,
                               const void* const* rows,
                               const long long* row_bytes,
                               const long long* pool_rows, const int* kind,
                               int entries, int envs, const int* done,
                               int force, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (entries < 1 || entries > kMaxEntries || envs < 1) return bad;
  ResetArgs a{};
  a.entries = entries;
  a.done = done;
  a.force = force;
  unsigned long long units = 0;
  for (int n = 0; n < entries; ++n) {
    Entry& en = a.entry[n];
    if (row_bytes[n] < 1 || dst[n] == nullptr || src[n] == nullptr ||
        kind[n] < kKeep || kind[n] > kZero) {
      return bad;
    }
    if (kind[n] != kKeep && !force && done == nullptr) return bad;
    if ((kind[n] == kSnapshot || kind[n] == kPool) && from[n] == nullptr) {
      return bad;
    }
    if (kind[n] == kPool && (rows[n] == nullptr || pool_rows[n] < 1)) {
      return bad;
    }
    // a kKeep entry is one row of all its bytes
    const long long bytes =
        kind[n] == kKeep ? row_bytes[n] * envs : row_bytes[n];
    const long long nrows = kind[n] == kKeep ? 1 : envs;
    en.dst = static_cast<char*>(dst[n]);
    en.src = static_cast<const char*>(src[n]);
    en.from = static_cast<const char*>(from[n]);
    en.rows = static_cast<const long long*>(rows[n]);
    en.pool_rows = pool_rows[n];
    en.kind = kind[n];
    en.vec = unit_of(bytes, dst[n], src[n], from[n]);
    const unsigned long long row_units = bytes / en.vec;
    if (row_units >= (1ull << 31)) return bad;
    en.row_units = static_cast<unsigned>(row_units);
    en.first = static_cast<unsigned>(units);
    units += row_units * nrows;
    if (units >= (1ull << 31)) return bad;
  }
  a.units = static_cast<unsigned>(units);
  const unsigned blocks =
      static_cast<unsigned>((units + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  reset_when_done_kernel<<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
