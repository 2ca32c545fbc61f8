// SAFA's Eq. 6-8 on the K active rows of a sparse schedule, as deltas on
// the running aggregate, for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/safa_aggregate.py:_rows_kernel
//     (safa_aggregate_packed_rows) -> safa_aggregate_rows_f32 below;
//   * src/repro/kernels/safa_aggregate.py:_q8_rows_kernel
//     (safa_aggregate_packed_q8_rows) -> safa_aggregate_q8_rows_f32 below;
//   * src/repro/kernels/safa_aggregate.py:_rows_fleet_kernel
//     (safa_aggregate_packed_rows_fleet) -> safa_aggregate_rows_fleet_f32;
//   * src/repro/kernels/safa_aggregate.py:_q8_rows_fleet_kernel
//     (safa_aggregate_packed_q8_rows_fleet)
//     -> safa_aggregate_q8_rows_fleet_f32 below;
//   * src/repro/kernels/safa_aggregate.py:_tier_rows_kernel
//     (safa_aggregate_packed_tier_rows) -> safa_aggregate_tier_rows_f32
//     and, with a member axis the JAX package has not (it vmaps the
//     single kernel), safa_aggregate_tier_rows_fleet_f32;
//   * src/repro/kernels/safa_aggregate.py:_q8_tier_rows_kernel
//     (safa_aggregate_packed_q8_tier_rows)
//     -> safa_aggregate_q8_tier_rows_f32 and
//     safa_aggregate_q8_tier_rows_fleet_f32.
// The tier forms are described before their kernels, below.
//
// The fleet forms run S independent servers in one launch: every operand
// gains a leading member axis (cache [S, R, N], trained and the outputs'
// rows [S, K, N], global/agg [S, N], rows/roles/weights [S, K]) and the
// grid a second dimension, blockIdx.y = s.  A block of member s runs
// exactly the single-run code on member s's slices (its slots staged from
// offset s * K, a row index outside [0, R) read from member s's row
// R - 1), so member s gets the single-run launch's bits; a single run is
// the fleet of one (gridDim.y = 1).  Padded slots (role 0, weight 0, the
// scratch row) add exact zeros to the sums: fmaf(0, d, acc) is acc.
//
// Math, per slot j (cache row c0 = cache[rows[j]], role bits f_j, weight
// w_j) and column:
//   c1 = picked ? trained : (deprecated ? global : c0)          (Eq. 6)
//   c2 = undrafted ? trained : c1                               (Eq. 8)
//   new_global = agg + sum_j w_j (c1 - c0)                      (Eq. 7)
//   new_agg    = agg + sum_j w_j (c2 - c0)
// with agg = sum_k w_k cache_k the running Eq. 7 sum the engine carries,
// and c2 written for every slot (the engine scatters it back into the
// cache).  The int8 form first forms trained = q * scales[j, col / 128]
// in registers where the slot committed, and its base row elsewhere, and
// writes that trained row too (the slot's new local model).  A row index
// outside [0, R) reads row R - 1, the buffer's scratch row, where the
// schedule's sentinel slots (role 0, weight 0) point.
//
// Bound: device-memory bytes.  Per slot and column 4 floating-point
// operations against 12 or more bytes.  The bytes the roles need: the
// cache row of every slot (its c2 is c0 where no role changes it, and c0
// enters both deltas), the trained row only where the slot is picked or
// undrafted (the int8 form: q and scales where it committed, its base row
// elsewhere, since the local row is written for every slot), c2 (and the
// local row) written for every slot, global and agg read once and the two
// new vectors written once.
//
// Design: the TPU grid runs (column tile, slot) with the slot innermost,
// carrying the two sums in output blocks that the inner axis revisits.  On
// Hopper the slot axis is a loop inside the block, kernel 1's layout
// (safa_aggregate.cu): a block owns 128 adjacent columns, each of its 32
// lanes 4 of them (16-byte loads), each of its 8 warps every 8th slot,
// with the two delta sums in f32 registers.  The warps' partial sums are
// added in warp order in shared memory and then to agg, so every launch
// gives the same bits.  The slots' rows, roles and weights are staged in
// shared memory in chunks of 256, so any K works.  A thread issues every
// load of kGroup of its slots before their math and stores.  The outputs
// are fresh buffers and the cache is only read (the engine scatters c2
// back afterwards), so every pointer is __restrict__.  Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;       // threads across columns (4 floats each)
constexpr int kSlices = 8;       // warps across slots
constexpr int kThreads = kLanes * kSlices;
constexpr int kChunk = 256;      // slots staged in shared memory at a time
constexpr int kQBlock = 128;     // values per int8 scale (comm_quant.QBLOCK)
constexpr int kVec = 4;          // floats per thread (one 16-byte load)
constexpr int kGroup = 4;        // slots whose loads go together

// SAFA role bits (core.protocol.ROLE_*)
constexpr uint8_t kCommitted = 2, kPicked = 4, kUndrafted = 8,
                  kDeprecated = 16;

__device__ __forceinline__ long long fix_row(int r, int n_rows) {
  return (r >= 0 && r < n_rows) ? r : n_rows - 1;
}

// Where fleet member s = blockIdx.y starts in each operand, in floats or
// elements: its [R, n] cache, its [K, n] slot rows, its [n] vectors and
// its [K] slots.  64-bit, as every offset here.
struct Member {
  long long cache, rows, vec, slots;
  __device__ Member(int n_rows, int k, long long n)
      : cache((long long)blockIdx.y * n_rows * n),
        rows((long long)blockIdx.y * k * n), vec((long long)blockIdx.y * n),
        slots((long long)blockIdx.y * k) {}
};

// acc += w * (a - b), per component
__device__ __forceinline__ void add_delta(float4& acc, float4 a, float4 b,
                                          float w) {
  acc.x = fmaf(w, a.x - b.x, acc.x);
  acc.y = fmaf(w, a.y - b.y, acc.y);
  acc.z = fmaf(w, a.z - b.z, acc.z);
  acc.w = fmaf(w, a.w - b.w, acc.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Shared state of a block: the staged slots and the warps' partial sums.
struct Stage {
  long long src[kChunk];         // cache row offset of each slot (floats4)
  uint8_t role[kChunk];
  float w[kChunk];
  float4 dg[kSlices][kLanes];
  float4 da[kSlices][kLanes];
};

__device__ __forceinline__ void stage_slots(Stage& s, int k0, int kn,
                                            const int* rows,
                                            const uint8_t* roles,
                                            const float* w_rows, int n_rows,
                                            long long n4) {
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int i = tid; i < kn; i += kThreads) {
    s.src[i] = fix_row(rows[k0 + i], n_rows) * n4;
    s.role[i] = roles[k0 + i];
    s.w[i] = w_rows[k0 + i];
  }
}

// Add the warps' partial sums in warp order, then to agg; write both.
// ``late`` (the tier forms) is a store held back until every warp of the
// block has passed the barrier, and so has done all its reads.
template <class St>
__device__ __forceinline__ void finish(St& s, float4 dg, float4 da,
                                       bool active, const float4* agg,
                                       float4* new_global, float4* new_agg,
                                       long long col,
                                       float4* late = nullptr,
                                       float4 late_v = float4()) {
  s.dg[threadIdx.y][threadIdx.x] = dg;
  s.da[threadIdx.y][threadIdx.x] = da;
  __syncthreads();
  if (late != nullptr) *late = late_v;
  if (threadIdx.y != 0 || !active) return;
  float4 sg = s.dg[0][threadIdx.x], sa = s.da[0][threadIdx.x];
  for (int y = 1; y < kSlices; ++y) {
    sg = add4(sg, s.dg[y][threadIdx.x]);
    sa = add4(sa, s.da[y][threadIdx.x]);
  }
  const float4 a = agg[col];
  new_global[col] = add4(a, sg);
  new_agg[col] = add4(a, sa);
}

__global__ void __launch_bounds__(kThreads)
safa_rows_kernel(const float* __restrict__ cache,
                 const float* __restrict__ trained,
                 const float* __restrict__ global,
                 const float* __restrict__ agg,
                 const int* __restrict__ rows,
                 const uint8_t* __restrict__ roles,
                 const float* __restrict__ w_rows,
                 float* __restrict__ new_global, float* __restrict__ new_agg,
                 float* __restrict__ c2, int n_rows, int k, long long n4) {
  __shared__ Stage s;
  const Member mb(n_rows, k, n4 * kVec);
  cache += mb.cache;
  trained += mb.rows;
  c2 += mb.rows;
  global += mb.vec;
  agg += mb.vec;
  new_global += mb.vec;
  new_agg += mb.vec;
  rows += mb.slots;
  roles += mb.slots;
  w_rows += mb.slots;
  const long long col = (long long)blockIdx.x * kLanes + threadIdx.x;
  const bool active = col < n4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 g =
      active ? reinterpret_cast<const float4*>(global)[col] : zero;
  const float4* c4 = reinterpret_cast<const float4*>(cache);
  const float4* t4 = reinterpret_cast<const float4*>(trained);
  float4* o4 = reinterpret_cast<float4*>(c2);
  float4 dg = zero, da = zero;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kn = min(kChunk, k - k0);
    __syncthreads();   // the previous chunk's readers are done
    stage_slots(s, k0, kn, rows, roles, w_rows, n_rows, n4);
    __syncthreads();
    if (!active) continue;
    for (int i0 = threadIdx.y; i0 < kn; i0 += kSlices * kGroup) {
      float4 c[kGroup], t[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u * kSlices;
        if (i >= kn) continue;
        c[u] = c4[s.src[i] + col];
        t[u] = (s.role[i] & (kPicked | kUndrafted))
                   ? t4[(long long)(k0 + i) * n4 + col] : zero;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u * kSlices;
        if (i >= kn) continue;
        const uint8_t f = s.role[i];
        const float4 c1 = (f & kPicked) ? t[u]
                          : (f & kDeprecated) ? g : c[u];
        const float4 cc = (f & kUndrafted) ? t[u] : c1;
        o4[(long long)(k0 + i) * n4 + col] = cc;
        add_delta(dg, c1, c[u], s.w[i]);
        add_delta(da, cc, c[u], s.w[i]);
      }
    }
  }
  finish(s, dg, da, active, reinterpret_cast<const float4*>(agg),
         reinterpret_cast<float4*>(new_global),
         reinterpret_cast<float4*>(new_agg), col);
}

__global__ void __launch_bounds__(kThreads)
safa_q8_rows_kernel(const int8_t* __restrict__ q,
                    const float* __restrict__ scales,
                    const float* __restrict__ base,
                    const float* __restrict__ cache,
                    const float* __restrict__ global,
                    const float* __restrict__ agg,
                    const int* __restrict__ rows,
                    const uint8_t* __restrict__ roles,
                    const float* __restrict__ w_rows,
                    float* __restrict__ new_global,
                    float* __restrict__ new_agg, float* __restrict__ c2,
                    float* __restrict__ local, int n_rows, int k,
                    long long n4) {
  __shared__ Stage s;
  const Member mb(n_rows, k, n4 * kVec);
  q += mb.rows;
  scales += mb.rows / kQBlock;
  base += mb.rows;
  c2 += mb.rows;
  local += mb.rows;
  cache += mb.cache;
  global += mb.vec;
  agg += mb.vec;
  new_global += mb.vec;
  new_agg += mb.vec;
  rows += mb.slots;
  roles += mb.slots;
  w_rows += mb.slots;
  const long long col = (long long)blockIdx.x * kLanes + threadIdx.x;
  const bool active = col < n4;
  const long long n_scales = n4 / (kQBlock / kVec);   // scales per row
  const long long sblk = col / (kQBlock / kVec);      // this thread's block
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 g =
      active ? reinterpret_cast<const float4*>(global)[col] : zero;
  const char4* q4 = reinterpret_cast<const char4*>(q);
  const float4* b4 = reinterpret_cast<const float4*>(base);
  const float4* c4 = reinterpret_cast<const float4*>(cache);
  float4* o4 = reinterpret_cast<float4*>(c2);
  float4* l4 = reinterpret_cast<float4*>(local);
  float4 dg = zero, da = zero;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kn = min(kChunk, k - k0);
    __syncthreads();
    stage_slots(s, k0, kn, rows, roles, w_rows, n_rows, n4);
    __syncthreads();
    if (!active) continue;
    for (int i0 = threadIdx.y; i0 < kn; i0 += kSlices * kGroup) {
      char4 qv[kGroup];
      float sc[kGroup];
      float4 b[kGroup], c[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u * kSlices;
        if (i >= kn) continue;
        const long long j = k0 + i;
        const bool done = s.role[i] & kCommitted;
        qv[u] = done ? q4[j * n4 + col] : make_char4(0, 0, 0, 0);
        sc[u] = done ? scales[j * n_scales + sblk] : 0.f;
        b[u] = done ? zero : b4[j * n4 + col];
        c[u] = c4[s.src[i] + col];
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u * kSlices;
        if (i >= kn) continue;
        const long long off = (long long)(k0 + i) * n4 + col;
        const uint8_t f = s.role[i];
        const float x = sc[u];
        const float4 t = (f & kCommitted)
            ? make_float4((float)qv[u].x * x, (float)qv[u].y * x,
                          (float)qv[u].z * x, (float)qv[u].w * x)
            : b[u];
        const float4 c1 = (f & kPicked) ? t : (f & kDeprecated) ? g : c[u];
        const float4 cc = (f & kUndrafted) ? t : c1;
        l4[off] = t;
        o4[off] = cc;
        add_delta(dg, c1, c[u], s.w[i]);
        add_delta(da, cc, c[u], s.w[i]);
      }
    }
  }
  finish(s, dg, da, active, reinterpret_cast<const float4*>(agg),
         reinterpret_cast<float4*>(new_global),
         reinterpret_cast<float4*>(new_agg), col);
}

// ---------------------------------------------------------------------------
// The lag tier's forms (kernels 19 and 20): the rows kernels over the tier
// value buffer buf [C + 1, n] (its last row the scratch slot), each slot
// reading its cache row c0 = buf[srcs[j]] and writing its c2 to
// buf[dsts[j]] in the same launch, in place (the TPU call aliases buf to
// its output).  The math is the rows kernels', with no c2 output; the
// int8 form dequantises its uploads in registers where the slot
// committed, takes its base row elsewhere, and writes no local row (the
// tier's local state is the version ring).
//
// In place, and the same bits as the plain version, which gathers every
// c0 before it scatters:
//   * rows written other than the scratch row: the schedule keeps them
//     apart from every row read in the round (a value written in round t
//     is first read strictly later), so no read can see a write.  The
//     kernel relies on that and does not check it.
//   * a shared destination: the last slot wins, as in the row scatter
//     (rows.cu); a slot skips its write where a later slot writes the
//     same row, so each row is written once.
//   * the scratch row is read and written by the inert slots (and by
//     slots whose value is never read again).  Its one write, the last
//     such slot's, is held in registers by the warp that computes it and
//     stored after the block's final barrier, when every warp has read
//     the buffer.
// Bound: device-memory bytes, as the rows kernels': c0 of every slot, the
// trained row (int8: q and scales, or base) only where the slot is picked
// or undrafted, one c2 row per distinct destination, global and agg read
// once and the two new vectors written once.  The fleet forms are the
// same code with blockIdx.y = s, member s's buffer [C + 1, n] at
// s * (C + 1) * n.

// Shared state of a tier block: the staged slots and the partial sums.
struct TierStage {
  long long src[kChunk];         // buffer row offset each slot reads
  long long dst[kChunk];         // row offset it writes, -1: skipped
  uint8_t role[kChunk];
  float w[kChunk];
  float4 dg[kSlices][kLanes];
  float4 da[kSlices][kLanes];
};

__device__ __forceinline__ void stage_tier_slots(
    TierStage& s, int k0, int kn, int k, const int* srcs, const int* dsts,
    const uint8_t* roles, const float* w_rows, int n_rows, long long n4) {
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int i = tid; i < kn; i += kThreads) {
    const int j = k0 + i;
    const long long d = fix_row(dsts[j], n_rows);
    bool last = true;
    for (int l = j + 1; l < k && last; ++l) {
      last = fix_row(dsts[l], n_rows) != d;
    }
    s.src[i] = fix_row(srcs[j], n_rows) * n4;
    s.dst[i] = last ? d * n4 : -1;
    s.role[i] = roles[j];
    s.w[i] = w_rows[j];
  }
}

// Store c2 of a staged slot, or hold it back if it goes to the scratch row.
__device__ __forceinline__ void tier_store(float4* b4, long long dst,
                                           long long scratch, long long col,
                                           float4 v, float4& held,
                                           bool& holds) {
  if (dst == scratch) {
    held = v;
    holds = true;
  } else if (dst >= 0) {
    b4[dst + col] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
safa_tier_rows_kernel(float* buf, const float* __restrict__ trained,
                      const float* __restrict__ global,
                      const float* __restrict__ agg,
                      const int* __restrict__ srcs,
                      const int* __restrict__ dsts,
                      const uint8_t* __restrict__ roles,
                      const float* __restrict__ w_rows,
                      float* __restrict__ new_global,
                      float* __restrict__ new_agg, int n_rows, int k,
                      long long n4) {
  __shared__ TierStage s;
  const Member mb(n_rows, k, n4 * kVec);
  buf += mb.cache;
  trained += mb.rows;
  global += mb.vec;
  agg += mb.vec;
  new_global += mb.vec;
  new_agg += mb.vec;
  srcs += mb.slots;
  dsts += mb.slots;
  roles += mb.slots;
  w_rows += mb.slots;
  const long long col = (long long)blockIdx.x * kLanes + threadIdx.x;
  const bool active = col < n4;
  const long long scratch = (long long)(n_rows - 1) * n4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 g =
      active ? reinterpret_cast<const float4*>(global)[col] : zero;
  // buf is read and written: no __restrict__, so every load of a group is
  // ordered before the group's stores
  float4* b4 = reinterpret_cast<float4*>(buf);
  const float4* t4 = reinterpret_cast<const float4*>(trained);
  float4 dg = zero, da = zero, held = zero;
  bool holds = false;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kn = min(kChunk, k - k0);
    __syncthreads();   // the previous chunk's readers are done
    stage_tier_slots(s, k0, kn, k, srcs, dsts, roles, w_rows, n_rows, n4);
    __syncthreads();
    if (!active) continue;
    for (int i0 = threadIdx.y; i0 < kn; i0 += kSlices * kGroup) {
      float4 c[kGroup], t[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u * kSlices;
        if (i >= kn) continue;
        c[u] = b4[s.src[i] + col];
        t[u] = (s.role[i] & (kPicked | kUndrafted))
                   ? t4[(long long)(k0 + i) * n4 + col] : zero;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u * kSlices;
        if (i >= kn) continue;
        const uint8_t f = s.role[i];
        const float4 c1 = (f & kPicked) ? t[u]
                          : (f & kDeprecated) ? g : c[u];
        const float4 cc = (f & kUndrafted) ? t[u] : c1;
        tier_store(b4, s.dst[i], scratch, col, cc, held, holds);
        add_delta(dg, c1, c[u], s.w[i]);
        add_delta(da, cc, c[u], s.w[i]);
      }
    }
  }
  finish(s, dg, da, active, reinterpret_cast<const float4*>(agg),
         reinterpret_cast<float4*>(new_global),
         reinterpret_cast<float4*>(new_agg), col,
         holds ? b4 + scratch + col : nullptr, held);
}

__global__ void __launch_bounds__(kThreads)
safa_q8_tier_rows_kernel(const int8_t* __restrict__ q,
                         const float* __restrict__ scales,
                         const float* __restrict__ base, float* buf,
                         const float* __restrict__ global,
                         const float* __restrict__ agg,
                         const int* __restrict__ srcs,
                         const int* __restrict__ dsts,
                         const uint8_t* __restrict__ roles,
                         const float* __restrict__ w_rows,
                         float* __restrict__ new_global,
                         float* __restrict__ new_agg, int n_rows, int k,
                         long long n4) {
  __shared__ TierStage s;
  const Member mb(n_rows, k, n4 * kVec);
  q += mb.rows;
  scales += mb.rows / kQBlock;
  base += mb.rows;
  buf += mb.cache;
  global += mb.vec;
  agg += mb.vec;
  new_global += mb.vec;
  new_agg += mb.vec;
  srcs += mb.slots;
  dsts += mb.slots;
  roles += mb.slots;
  w_rows += mb.slots;
  const long long col = (long long)blockIdx.x * kLanes + threadIdx.x;
  const bool active = col < n4;
  const long long scratch = (long long)(n_rows - 1) * n4;
  const long long n_scales = n4 / (kQBlock / kVec);   // scales per row
  const long long sblk = col / (kQBlock / kVec);      // this thread's block
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 g =
      active ? reinterpret_cast<const float4*>(global)[col] : zero;
  const char4* q4 = reinterpret_cast<const char4*>(q);
  const float4* bs4 = reinterpret_cast<const float4*>(base);
  float4* b4 = reinterpret_cast<float4*>(buf);
  float4 dg = zero, da = zero, held = zero;
  bool holds = false;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kn = min(kChunk, k - k0);
    __syncthreads();
    stage_tier_slots(s, k0, kn, k, srcs, dsts, roles, w_rows, n_rows, n4);
    __syncthreads();
    if (!active) continue;
    for (int i0 = threadIdx.y; i0 < kn; i0 += kSlices * kGroup) {
      char4 qv[kGroup];
      float sc[kGroup];
      float4 b[kGroup], c[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u * kSlices;
        if (i >= kn) continue;
        const long long j = k0 + i;
        const uint8_t f = s.role[i];
        const bool need = f & (kPicked | kUndrafted);
        const bool done = f & kCommitted;
        qv[u] = (need && done) ? q4[j * n4 + col] : make_char4(0, 0, 0, 0);
        sc[u] = (need && done) ? scales[j * n_scales + sblk] : 0.f;
        b[u] = (need && !done) ? bs4[j * n4 + col] : zero;
        c[u] = b4[s.src[i] + col];
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u * kSlices;
        if (i >= kn) continue;
        const uint8_t f = s.role[i];
        const float x = sc[u];
        const float4 t = (f & kCommitted)
            ? make_float4((float)qv[u].x * x, (float)qv[u].y * x,
                          (float)qv[u].z * x, (float)qv[u].w * x)
            : b[u];
        const float4 c1 = (f & kPicked) ? t : (f & kDeprecated) ? g : c[u];
        const float4 cc = (f & kUndrafted) ? t : c1;
        tier_store(b4, s.dst[i], scratch, col, cc, held, holds);
        add_delta(dg, c1, c[u], s.w[i]);
        add_delta(da, cc, c[u], s.w[i]);
      }
    }
  }
  finish(s, dg, da, active, reinterpret_cast<const float4*>(agg),
         reinterpret_cast<float4*>(new_global),
         reinterpret_cast<float4*>(new_agg), col,
         holds ? b4 + scratch + col : nullptr, held);
}

inline dim3 grid_for(long long n4, int s) {
  return dim3((unsigned int)((n4 + kLanes - 1) / kLanes), (unsigned int)s);
}

int launch_rows(const float* cache, const float* trained,
                const float* global, const float* agg, const int* rows,
                const uint8_t* roles, const float* w, float* new_global,
                float* new_agg, float* c2, int s, int r, int k, long long n,
                cudaStream_t stream) {
  const long long n4 = n / kVec;
  if (n4 == 0 || s == 0) return (int)cudaSuccess;
  safa_rows_kernel<<<grid_for(n4, s), dim3(kLanes, kSlices), 0, stream>>>(
      cache, trained, global, agg, rows, roles, w, new_global, new_agg, c2,
      r, k, n4);
  return (int)cudaGetLastError();
}

int launch_q8_rows(const int8_t* q, const float* scales, const float* base,
                   const float* cache, const float* global, const float* agg,
                   const int* rows, const uint8_t* roles, const float* w,
                   float* new_global, float* new_agg, float* c2,
                   float* local, int s, int r, int k, long long n,
                   cudaStream_t stream) {
  const long long n4 = n / kVec;
  if (n4 == 0 || s == 0) return (int)cudaSuccess;
  safa_q8_rows_kernel<<<grid_for(n4, s), dim3(kLanes, kSlices), 0,
                        stream>>>(
      q, scales, base, cache, global, agg, rows, roles, w, new_global,
      new_agg, c2, local, r, k, n4);
  return (int)cudaGetLastError();
}

int launch_tier_rows(float* buf, const float* trained, const float* global,
                     const float* agg, const int* srcs, const int* dsts,
                     const uint8_t* roles, const float* w, float* new_global,
                     float* new_agg, int s, int r, int k, long long n,
                     cudaStream_t stream) {
  const long long n4 = n / kVec;
  if (n4 == 0 || s == 0) return (int)cudaSuccess;
  safa_tier_rows_kernel<<<grid_for(n4, s), dim3(kLanes, kSlices), 0,
                          stream>>>(
      buf, trained, global, agg, srcs, dsts, roles, w, new_global, new_agg,
      r, k, n4);
  return (int)cudaGetLastError();
}

int launch_q8_tier_rows(const int8_t* q, const float* scales,
                        const float* base, float* buf, const float* global,
                        const float* agg, const int* srcs, const int* dsts,
                        const uint8_t* roles, const float* w,
                        float* new_global, float* new_agg, int s, int r,
                        int k, long long n, cudaStream_t stream) {
  const long long n4 = n / kVec;
  if (n4 == 0 || s == 0) return (int)cudaSuccess;
  safa_q8_tier_rows_kernel<<<grid_for(n4, s), dim3(kLanes, kSlices), 0,
                             stream>>>(
      q, scales, base, buf, global, agg, srcs, dsts, roles, w, new_global,
      new_agg, r, k, n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cache: [r, n] f32; trained: [k, n] f32; global/agg: [n] f32; rows: [k]
// int32; roles: [k] uint8 of ROLE_* bits; w: [k] f32.  Writes new_global
// and new_agg ([n] f32) and c2 ([k, n] f32), all fresh buffers.  n must be
// a multiple of 4.  Returns the launch's cudaError_t.
int safa_aggregate_rows_f32(const float* cache, const float* trained,
                            const float* global, const float* agg,
                            const int* rows, const uint8_t* roles,
                            const float* w, float* new_global,
                            float* new_agg, float* c2, int r, int k,
                            long long n, cudaStream_t stream) {
  return launch_rows(cache, trained, global, agg, rows, roles, w,
                     new_global, new_agg, c2, 1, r, k, n, stream);
}

// The int8 form: q: [k, n] int8; scales: [k, n / 128] f32; base: [k, n]
// f32; the rest as above, and local ([k, n] f32, fresh) receives each
// slot's trained row.  n must be a multiple of 128.
int safa_aggregate_q8_rows_f32(const int8_t* q, const float* scales,
                               const float* base, const float* cache,
                               const float* global, const float* agg,
                               const int* rows, const uint8_t* roles,
                               const float* w, float* new_global,
                               float* new_agg, float* c2, float* local,
                               int r, int k, long long n,
                               cudaStream_t stream) {
  return launch_q8_rows(q, scales, base, cache, global, agg, rows, roles, w,
                        new_global, new_agg, c2, local, 1, r, k, n, stream);
}

// The fleet forms: cache [s, r, n]; trained, base, c2, local [s, k, n];
// q [s, k, n] int8; scales [s, k, n / 128]; global, agg, new_global,
// new_agg [s, n]; rows, roles, w [s, k].  gridDim.y = s (at most 65,535).
int safa_aggregate_rows_fleet_f32(const float* cache, const float* trained,
                                  const float* global, const float* agg,
                                  const int* rows, const uint8_t* roles,
                                  const float* w, float* new_global,
                                  float* new_agg, float* c2, int s, int r,
                                  int k, long long n, cudaStream_t stream) {
  return launch_rows(cache, trained, global, agg, rows, roles, w,
                     new_global, new_agg, c2, s, r, k, n, stream);
}

int safa_aggregate_q8_rows_fleet_f32(const int8_t* q, const float* scales,
                                     const float* base, const float* cache,
                                     const float* global, const float* agg,
                                     const int* rows, const uint8_t* roles,
                                     const float* w, float* new_global,
                                     float* new_agg, float* c2, float* local,
                                     int s, int r, int k, long long n,
                                     cudaStream_t stream) {
  return launch_q8_rows(q, scales, base, cache, global, agg, rows, roles, w,
                        new_global, new_agg, c2, local, s, r, k, n, stream);
}

// The lag tier's forms.  buf: [r, n] f32 tier value buffer, read and
// written in place (its last row the scratch slot); trained: [k, n] f32,
// not overlapping buf; global/agg: [n] f32; srcs/dsts: [k] int32 rows of
// buf each slot reads c0 from and writes c2 to (outside [0, r): row
// r - 1); roles: [k] uint8; w: [k] f32.  Writes new_global and new_agg
// ([n] f32, fresh).  Rows written other than row r - 1 must not be read
// by any slot.  n must be a multiple of 4.
int safa_aggregate_tier_rows_f32(float* buf, const float* trained,
                                 const float* global, const float* agg,
                                 const int* srcs, const int* dsts,
                                 const uint8_t* roles, const float* w,
                                 float* new_global, float* new_agg, int r,
                                 int k, long long n, cudaStream_t stream) {
  return launch_tier_rows(buf, trained, global, agg, srcs, dsts, roles, w,
                          new_global, new_agg, 1, r, k, n, stream);
}

// The int8 form: q: [k, n] int8; scales: [k, n / 128] f32; base: [k, n]
// f32; the rest as above.  n must be a multiple of 128.
int safa_aggregate_q8_tier_rows_f32(const int8_t* q, const float* scales,
                                    const float* base, float* buf,
                                    const float* global, const float* agg,
                                    const int* srcs, const int* dsts,
                                    const uint8_t* roles, const float* w,
                                    float* new_global, float* new_agg, int r,
                                    int k, long long n,
                                    cudaStream_t stream) {
  return launch_q8_tier_rows(q, scales, base, buf, global, agg, srcs, dsts,
                             roles, w, new_global, new_agg, 1, r, k, n,
                             stream);
}

// Their fleet forms: buf [s, r, n]; trained, base [s, k, n]; q [s, k, n]
// int8; scales [s, k, n / 128]; global, agg, new_global, new_agg [s, n];
// srcs, dsts, roles, w [s, k].  gridDim.y = s (at most 65,535).
int safa_aggregate_tier_rows_fleet_f32(float* buf, const float* trained,
                                       const float* global, const float* agg,
                                       const int* srcs, const int* dsts,
                                       const uint8_t* roles, const float* w,
                                       float* new_global, float* new_agg,
                                       int s, int r, int k, long long n,
                                       cudaStream_t stream) {
  return launch_tier_rows(buf, trained, global, agg, srcs, dsts, roles, w,
                          new_global, new_agg, s, r, k, n, stream);
}

int safa_aggregate_q8_tier_rows_fleet_f32(
    const int8_t* q, const float* scales, const float* base, float* buf,
    const float* global, const float* agg, const int* srcs, const int* dsts,
    const uint8_t* roles, const float* w, float* new_global, float* new_agg,
    int s, int r, int k, long long n, cudaStream_t stream) {
  return launch_q8_tier_rows(q, scales, base, buf, global, agg, srcs, dsts,
                             roles, w, new_global, new_agg, s, r, k, n,
                             stream);
}

}  // extern "C"
