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
// Kernel 20 (the int8 tier form) departs from this layout: a persistent
// block streams each slot's row segments into a shared-memory ring with
// Hopper's bulk copies, so its bytes in flight no longer depend on its
// registers; it is described before its code, below.
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
// int8 form dequantises its uploads where the slot committed, takes its
// base row elsewhere, and writes no local row (the tier's local state is
// the version ring).
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
// same code with blockIdx.y = s (kernel 20: with the work items of every
// member), member s's buffer [C + 1, n] at s * (C + 1) * n.

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

// ---------------------------------------------------------------------------
// Kernel 20, the int8 tier form, on Hopper's bulk-copy engine.
//
// Why not kernel 19's layout: with every load of kGroup slots held in
// registers (a float4 of c0, a char4 of q, a scale, a float4 of base), that
// layout took 101 registers a thread, two blocks of 256 threads an SM and
// about 41 KB of loads in flight an SM, where kernel 19 keeps about 98 KB
// at 80 registers; on an H100 80GB HBM3 at 700 W it ran at 42 % of its
// byte bound (0.156 ms at the main path's round of 124 slots), kernel 19
// at 84 %.  Its bytes in flight were capped by the register file.
//
// Here they are set by a ring in shared memory instead.  A work item is
// one member's tile of kTile adjacent columns.  One producer thread
// streams, for every slot of the item in slot order, the slot's row
// segments into the next stage of a ring of kStages: the c0 segment
// (4 kTile bytes at buf[srcs[j]]) and, where the slot needs its trained
// row, the q segment (kTile bytes) and its kTile / 128 scales if it
// committed, else its base segment (4 kTile bytes).  Each is one 1-D bulk
// copy (cp.async.bulk, the non-tensor form of TMA) completing on the
// stage's full mbarrier; the consumers free the stage on its empty
// mbarrier, each thread after a fence.proxy.async.shared::cta that orders
// its reads of the stage (generic proxy) before the next bulk copy's
// write into it (async proxy), as the PTX ISA asks.  Bulk copies take 16-byte sizes at 16-byte-aligned addresses:
// n is a multiple of kTile (the wrapper takes multiples of 2048), so every
// segment is aligned, and kTile / 128 scales are 32 bytes.  The consumer
// warps own the tile's columns, 4 a thread (16-byte shared-memory reads),
// dequantise from shared memory, apply Eq. 6-8, store c2 to its row
// straight from registers and add the two deltas in f32 registers, slot
// after slot, so each column's sums are taken in slot order and every
// launch, and every member of an S-axis launch, gives the same bits.
//
// Grid: persistent.  The launch asks the runtime how many blocks an SM
// holds (three: 56,832 bytes of shared memory and 72 x 288 registers a
// block), spreads the S x n / kTile items over at most that many blocks
// an SM, and gives each block a run of ceil(items / capacity) adjacent
// items, so every block has the same count but the last: at the main
// path's width (n = 342,016: 334 tiles) 334 blocks of one item, one wave
// of the card's 396 places; S = 4, 1,336 items: 334 blocks of 4.  The
// producer runs ahead across the items of a block; a block stages its
// member's slot maps (rows, roles, weights, the last-writer flags: an
// O(K) scan in shared memory a slot) once, and again only when its run
// enters another member or K exceeds kSlotChunk slots.
//
// Resources (nvcc -Xptxas -v, sm_90a): the register-tiled kernel took 101
// registers, no spills, 13,568 bytes of static shared memory, 256 threads
// a block; this one takes 72 registers, no spills, 56,832 bytes of
// dynamic shared memory (6 stages of 8 KB, each holding c0 and either q
// and its scales or a base segment, and the staged slots), 288 threads.
// In flight: 6 stages of 5,152 bytes (c0, q, scales) a block, 30.9 KB, and
// 92.7 KB an SM at three blocks.  What bounds it, from the card (H100
// 80GB HBM3, 700 W): device memory.  At the main path's round of 124
// slots it moves 2.6-2.7 TB/s, about kernel 19's rate on the same round;
// rings of 5, 6 and 8 stages at three or four blocks an SM all took
// 0.081-0.084 ms, twelve stages at two blocks 0.096, twenty at one
// 0.107, and 512-column tiles (twice the copies) 0.089-0.115.
//
// Bound: device-memory bytes, as above.  The in-place semantics are
// kernel 19's: rows written other than the scratch row are never read in
// the round, a shared destination goes to the last slot, and the scratch
// row's write, the last such slot's, is held in the consumer's registers
// until the item's last slot is consumed, when every bulk copy of the
// item, the scratch row's included, has landed (the copies read only the
// item's columns, and no other item has them).
namespace q8tier {

constexpr int kTile = 1024;                   // columns of a work item
constexpr int kCons = kTile / kVec;           // consumer threads
constexpr int kConsWarps = kCons / 32;
constexpr int kThreads = kCons + 32;          // and one producer warp
constexpr int kStages = 6;                    // ring depth
constexpr int kSlotChunk = 512;               // slots staged at a time
constexpr int kSeg = 4 * kTile;               // bytes of an f32 segment
constexpr int kQBytes = kTile;                // bytes of a q segment
constexpr int kScaleBytes = kTile / kQBlock * 4;
constexpr int kStageBytes = 2 * kSeg;         // c0, then q + scales or base
constexpr int kBarBytes = 512;
constexpr int kSmem = kBarBytes + kStages * kStageBytes + kSlotChunk * 14;
static_assert(kCons % 32 == 0, "whole consumer warps");
static_assert(2048 % kTile == 0, "a tile divides the wrapper's 2048");
static_assert(kScaleBytes % 16 == 0, "bulk copies move 16-byte multiples");
static_assert(kQBytes + kScaleBytes <= kSeg, "q and scales fit a segment");
static_assert(2 * kStages * 8 <= kBarBytes, "the barriers fit");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// `bytes` bytes from global `src` to shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The staged slots of a block: each slot's source and destination rows
// (fixed into [0, R)), whether it is the last to write its destination,
// its role and its weight.
struct Slots {
  int* src;
  int* dst;
  float* w;
  uint8_t* role;
  uint8_t* last;
  __device__ explicit Slots(unsigned char* p)
      : src(reinterpret_cast<int*>(p)), dst(src + kSlotChunk),
        w(reinterpret_cast<float*>(dst + kSlotChunk)),
        role(reinterpret_cast<uint8_t*>(w + kSlotChunk)),
        last(role + kSlotChunk) {}
};

// Stage slots k0 .. k0 + kn of one member; every thread of the block
// calls it, between barriers.
__device__ __forceinline__ void stage(const Slots& sl, int k0, int kn, int k,
                                      const int* srcs, const int* dsts,
                                      const uint8_t* roles,
                                      const float* w_rows, int n_rows) {
  for (int i = threadIdx.x; i < kn; i += kThreads) {
    const int j = k0 + i;
    sl.src[i] = (int)fix_row(srcs[j], n_rows);
    sl.dst[i] = (int)fix_row(dsts[j], n_rows);
    sl.role[i] = roles[j];
    sl.w[i] = w_rows[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kn; i += kThreads) {
    const int d = sl.dst[i];
    bool last = true;
#pragma unroll 8
    for (int l = i + 1; l < kn; ++l) last &= sl.dst[l] != d;
    for (int l = k0 + kn; l < k; ++l) last &= fix_row(dsts[l], n_rows) != d;
    sl.last[i] = last;
  }
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
                         long long n, long long tiles, long long items,
                         long long per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + kBarBytes;
  const Slots sl(ring + kStages * kStageBytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool producer = warp == kConsWarps;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_u32(full + i), 1);
      mbar_init(smem_u32(empty + i), kConsWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long n4 = n / kVec, n_scales = n / kQBlock;
  const long long scratch = n_rows - 1;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long first = (long long)blockIdx.x * per_block;
  const long long stop = min(first + per_block, items);
  int staged = -1;     // the member whose slots are staged
  uint32_t it = 0;     // ring position, kept alike by every thread
  for (long long item = first; item < stop; ++item) {
    const int s = (int)(item / tiles);
    const long long col0 = (item % tiles) * kTile;   // first column
    // member s's operands (the S-axis layout; s = 0 for a single run)
    float* mbuf = buf + (long long)s * n_rows * n;
    const long long rows0 = (long long)s * k;        // its first slot row
    const long long col = (long long)s * n4 + col0 / kVec + threadIdx.x;
    float4 g = zero, dg = zero, da = zero, held = zero;
    bool holds = false;
    if (!producer) g = reinterpret_cast<const float4*>(global)[col];
    for (int k0 = 0; k0 < k; k0 += kSlotChunk) {
      const int kn = min(kSlotChunk, k - k0);
      if (s != staged || k > kSlotChunk) {
        __syncthreads();   // every thread is done with the staged slots
        stage(sl, k0, kn, k, srcs + rows0, dsts + rows0, roles + rows0,
              w_rows + rows0, n_rows);
        __syncthreads();
        staged = s;
      }
      if (producer) {
        if (lane == 0) {
          for (int i = 0; i < kn; ++i) {
            const uint32_t p = it + i, st = p % kStages;
            const uint32_t full_b = smem_u32(full + st);
            const uint8_t f = sl.role[i];
            const long long src = sl.src[i];
            mbar_wait(smem_u32(empty + st), ((p / kStages) & 1) ^ 1);
            const bool need = f & (kPicked | kUndrafted);
            const bool done = f & kCommitted;
            mbar_expect_tx(full_b, kSeg + (!need ? 0
                                           : done ? kQBytes + kScaleBytes
                                                  : kSeg));
            const uint32_t dst = smem_u32(ring + st * kStageBytes);
            bulk_load(dst, mbuf + src * n + col0, kSeg, full_b);
            const long long j = rows0 + k0 + i;
            if (need && done) {
              bulk_load(dst + kSeg, q + j * n + col0, kQBytes, full_b);
              bulk_load(dst + kSeg + kQBytes,
                        scales + j * n_scales + col0 / kQBlock, kScaleBytes,
                        full_b);
            } else if (need) {
              bulk_load(dst + kSeg, base + j * n + col0, kSeg, full_b);
            }
          }
        }
        __syncwarp();
      } else {
        float4* b4 = reinterpret_cast<float4*>(mbuf) + col0 / kVec +
                     threadIdx.x;
        for (int i = 0; i < kn; ++i) {
          const uint32_t p = it + i, st = p % kStages;
          // the slot's staged fields, read before the wait
          const uint8_t f = sl.role[i];
          const float w = sl.w[i];
          const long long d = sl.last[i] ? sl.dst[i] : -1;
          mbar_wait(smem_u32(full + st), (p / kStages) & 1);
          const unsigned char* stg = ring + st * kStageBytes;
          const float4 c = reinterpret_cast<const float4*>(stg)[threadIdx.x];
          float4 t = zero;
          if (f & (kPicked | kUndrafted)) {
            if (f & kCommitted) {
              const char4 qv =
                  reinterpret_cast<const char4*>(stg + kSeg)[threadIdx.x];
              const float x = reinterpret_cast<const float*>(
                  stg + kSeg + kQBytes)[threadIdx.x / (kQBlock / kVec)];
              t = make_float4((float)qv.x * x, (float)qv.y * x,
                              (float)qv.z * x, (float)qv.w * x);
            } else {
              t = reinterpret_cast<const float4*>(stg + kSeg)[threadIdx.x];
            }
          }
          // the stage was read by the generic proxy and the next bulk
          // copy into it writes by the async proxy: order the reads first
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(empty + st));
          const float4 c1 = (f & kPicked) ? t : (f & kDeprecated) ? g : c;
          const float4 cc = (f & kUndrafted) ? t : c1;
          if (d == scratch) {
            held = cc;
            holds = true;
          } else if (d >= 0) {
            b4[d * n4] = cc;
          }
          add_delta(dg, c1, c, w);
          add_delta(da, cc, c, w);
        }
      }
      it += kn;
    }
    if (!producer) {
      const float4 a = reinterpret_cast<const float4*>(agg)[col];
      reinterpret_cast<float4*>(new_global)[col] = add4(a, dg);
      reinterpret_cast<float4*>(new_agg)[col] = add4(a, da);
      if (holds) {
        reinterpret_cast<float4*>(mbuf)[scratch * n4 + col0 / kVec +
                                        threadIdx.x] = held;
      }
    }
  }
}

// The launch's shape for S members of width n: {tile, stages, shared
// bytes a block, blocks an SM, blocks, items a block}.
struct Grid {
  int tile, stages, smem, per_sm;
  long long blocks, per_block;
};

int grid_of(int s, long long n, Grid* out) {
  constexpr int kMaxDevices = 64;
  static int per_sm[kMaxDevices], sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(safa_q8_tier_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    int blocks = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, safa_q8_tier_rows_kernel, kThreads, kSmem);
    }
    if (err != cudaSuccess) return (int)err;
    if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
    per_sm[dev] = blocks;
  }
  const long long items = (long long)s * (n / kTile);
  const long long cap = (long long)per_sm[dev] * sms[dev];
  out->tile = kTile;
  out->stages = kStages;
  out->smem = kSmem;
  out->per_sm = per_sm[dev];
  out->per_block = items == 0 ? 0 : (items + cap - 1) / cap;
  out->blocks =
      items == 0 ? 0 : (items + out->per_block - 1) / out->per_block;
  return (int)cudaSuccess;
}

}  // namespace q8tier

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
  if (n == 0 || s == 0) return (int)cudaSuccess;
  if (n % q8tier::kTile != 0) return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(scales) |
                        reinterpret_cast<uintptr_t>(base) |
                        reinterpret_cast<uintptr_t>(buf);
  if (ptrs % 16 != 0) return (int)cudaErrorMisalignedAddress;
  q8tier::Grid g;
  const int err = q8tier::grid_of(s, n, &g);
  if (err != (int)cudaSuccess) return err;
  const long long tiles = n / q8tier::kTile;
  q8tier::safa_q8_tier_rows_kernel<<<(unsigned int)g.blocks,
                                     q8tier::kThreads, q8tier::kSmem,
                                     stream>>>(
      q, scales, base, buf, global, agg, srcs, dsts, roles, w, new_global,
      new_agg, r, k, n, tiles, (long long)s * tiles, g.per_block);
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
// f32; the rest as above.  n must be a multiple of 1024 (q8tier::kTile),
// and q, scales, base and buf must start 16-byte aligned.
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

// How the int8 tier forms launch for s members of width n on the current
// device, into out[6]: columns a work item, ring stages, shared-memory
// bytes a block, blocks an SM holds, blocks, items a block.  Returns the
// cudaError_t of the runtime's queries.
int safa_q8_tier_rows_grid(int s, long long n, long long* out) {
  q8tier::Grid g;
  const int err = q8tier::grid_of(s, n, &g);
  if (err != (int)cudaSuccess) return err;
  const long long v[6] = {g.tile, g.stages, g.smem, g.per_sm, g.blocks,
                          g.per_block};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return (int)cudaSuccess;
}

}  // extern "C"
