// SAFA discriminative aggregation (Eq. 6 + 7 + 8) for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/safa_aggregate.py:_kernel     (safa_aggregate,
//     safa_aggregate_packed)  -> safa_aggregate_f32 below;
//   * src/repro/kernels/safa_aggregate.py:_q8_kernel  (safa_aggregate_packed_q8)
//     -> safa_aggregate_q8_f32 below;
//   * src/repro/kernels/safa_aggregate.py:_fleet_kernel
//     (safa_aggregate_packed_fleet) -> safa_aggregate_fleet_f32 below;
//   * src/repro/kernels/safa_aggregate.py:_q8_fleet_kernel
//     (safa_aggregate_packed_q8_fleet) -> safa_aggregate_q8_fleet_f32 below.
//
// The fleet forms run S independent servers in one launch: every operand
// gains a leading member axis ([S, m, N] rows, [S, N] globals, [S, m] masks
// and weights) and the grid a second dimension, blockIdx.y = s.  A block
// of member s runs exactly the single-run code on member s's slices, so
// its new_global is bit for bit what the single-run launch gives on them;
// a single run is the fleet of one (gridDim.y = 1).
//
// Math, per client k and column j of the [m, N] pack buffers:
//   c1 = picked ? trained : (deprecated ? global : cache)       (Eq. 6)
//   new_global[j] = sum_k w_k * c1[k, j], f32, in a fixed order    (Eq. 7)
//   new_cache[k, j] = undrafted ? trained : c1                  (Eq. 8)
// The int8 form first dequantises trained = q * scales[k, j / 128] in
// registers and takes base where the client did not complete the round;
// it also writes that trained value as new_local.
//
// Bound: device-memory bytes.  Each column does 2 floating-point operations
// per client against up to 12 bytes moved (16+ for the int8 form), far below
// the card's ~20 FLOP/byte balance point.  The bytes a round needs depend on
// its masks, since Eq. 6-8 selects whole client rows:
//   * trained is read only for picked or undrafted clients;
//   * cache is read only for clients neither picked nor deprecated;
//   * a cache written in place changes only where the client is picked,
//     deprecated or undrafted (a fresh new_cache is written everywhere);
//   * the int8 form reads q and scales only for completed clients and base
//     only for the others, and writes new_local for every client.
// The kernels move only those bytes: the masks are per client, so every
// branch below is uniform across the block and costs no divergence.
//
// Design, simple and right first: the TPU kernel holds the whole m-client
// column of a 2048-wide tile in VMEM; a Hopper block cannot.  Here a block
// owns 128 adjacent columns: each of its 32 lanes 4 of them (16-byte loads,
// neighbouring lanes on neighbouring addresses), and each of its 8 warps
// every 8th client, streamed through registers with the Eq. 7 partial sum
// in an f32 register.  The warps' partial sums are added in warp order in
// shared memory, so the result does not depend on scheduling.  Splitting
// the clients across warps gives the grid one block per 128 columns.  In
// the int8 form a thread issues every load of kGroup of its clients before
// any math or store of theirs, since the compiler may not move a load above
// a store that could alias it: its loads are chosen by the masks and would
// otherwise wait on one another.  The f32 form, with fewer loads per
// client, ran slower so grouped (more registers, fewer blocks per SM), and
// keeps the plain loop.  The per-client masks
// and weights are staged in shared memory in chunks, so any m works.  The
// new cache may be the cache itself (the packed paths write in place, as
// the TPU's input_output_aliases does): every element is read before the
// same thread overwrites it, so nothing here is marked __restrict__.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;       // threads across columns (4 floats each)
constexpr int kSlices = 8;       // warps across clients
constexpr int kThreads = kLanes * kSlices;
constexpr int kChunk = 256;      // clients staged in shared memory at a time
constexpr int kQBlock = 128;     // values per int8 scale (comm_quant.QBLOCK)
constexpr int kVec = 4;          // floats per thread (one 16-byte load)
constexpr int kGroup = 4;        // clients whose loads go together (int8)

constexpr uint8_t kPicked = 1, kUndrafted = 2, kDeprecated = 4, kCompleted = 8;

__device__ __forceinline__ void fma4(float4& acc, float4 v, float w) {
  acc.x = fmaf(v.x, w, acc.x);
  acc.y = fmaf(v.y, w, acc.y);
  acc.z = fmaf(v.z, w, acc.z);
  acc.w = fmaf(v.w, w, acc.w);
}

// Where fleet member s = blockIdx.y starts in each operand: its [m, n]
// rows (in float4s), its [n] global row (in float4s) and its [m] masks and
// weights.  64-bit, as every offset here.
struct Member {
  long long rows, row, clients;
  __device__ Member(int m, long long n4)
      : rows((long long)blockIdx.y * m * n4), row((long long)blockIdx.y * n4),
        clients((long long)blockIdx.y * m) {}
};

// Stage clients [k0, k0 + kn) of the masks and weights into shared memory.
__device__ __forceinline__ void stage(uint8_t* s_flags, float* s_w, int k0,
                                      int kn, const bool* picked,
                                      const bool* undrafted,
                                      const bool* deprecated,
                                      const bool* completed,
                                      const float* weights) {
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int i = tid; i < kn; i += kThreads) {
    const int k = k0 + i;
    uint8_t f = 0;
    if (picked[k]) f |= kPicked;
    if (undrafted[k]) f |= kUndrafted;
    if (deprecated[k]) f |= kDeprecated;
    if (completed != nullptr && completed[k]) f |= kCompleted;
    s_flags[i] = f;
    s_w[i] = weights[k];
  }
}

// Add the warps' partial sums in warp order and write new_global.
__device__ __forceinline__ void finish(float4 (*s_acc)[kLanes], float4 acc,
                                       bool active, float* new_global,
                                       long long col) {
  s_acc[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || !active) return;
  float4 sum = s_acc[0][threadIdx.x];
  for (int y = 1; y < kSlices; ++y) {
    const float4 p = s_acc[y][threadIdx.x];
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  reinterpret_cast<float4*>(new_global)[col] = sum;
}

__global__ void __launch_bounds__(kThreads)
safa_aggregate_kernel(const float* cache, const float* trained,
                      const float* global, const bool* picked,
                      const bool* undrafted, const bool* deprecated,
                      const float* weights, float* new_global,
                      float* new_cache, bool in_place, int m,
                      long long n4) {
  __shared__ uint8_t s_flags[kChunk];
  __shared__ float s_w[kChunk];
  __shared__ float4 s_acc[kSlices][kLanes];
  const Member mb(m, n4);
  const long long col = (long long)blockIdx.x * kLanes + threadIdx.x;
  const bool active = col < n4;
  const float4 g = active
      ? reinterpret_cast<const float4*>(global)[mb.row + col]
      : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* c4 = reinterpret_cast<const float4*>(cache) + mb.rows;
  const float4* t4 = reinterpret_cast<const float4*>(trained) + mb.rows;
  float4* nc4 = reinterpret_cast<float4*>(new_cache) + mb.rows;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < m; k0 += kChunk) {
    const int kn = min(kChunk, m - k0);
    __syncthreads();   // the previous chunk's readers are done
    stage(s_flags, s_w, k0, kn, picked + mb.clients,
          undrafted + mb.clients, deprecated + mb.clients, nullptr,
          weights + mb.clients);
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int i = threadIdx.y; i < kn; i += kSlices) {
      const long long off = (long long)(k0 + i) * n4 + col;
      const uint8_t f = s_flags[i];
      const float4 c1 = (f & kPicked) ? t4[off]
                        : (f & kDeprecated) ? g : c4[off];
      fma4(acc, c1, s_w[i]);
      if (f & kUndrafted) {
        nc4[off] = (f & kPicked) ? c1 : t4[off];
      } else if (!in_place || (f & (kPicked | kDeprecated))) {
        nc4[off] = c1;
      }
    }
  }
  finish(s_acc, acc, active, new_global + mb.row * kVec, col);
}

__global__ void __launch_bounds__(kThreads)
safa_aggregate_q8_kernel(const int8_t* q, const float* scales,
                         const float* base, float* cache,
                         const float* global, const bool* picked,
                         const bool* undrafted, const bool* deprecated,
                         const bool* completed, const float* weights,
                         float* new_global, float* new_local, int m,
                         long long n4) {
  __shared__ uint8_t s_flags[kChunk];
  __shared__ float s_w[kChunk];
  __shared__ float4 s_acc[kSlices][kLanes];
  const Member mb(m, n4);
  const long long col = (long long)blockIdx.x * kLanes + threadIdx.x;
  const bool active = col < n4;
  const long long n_scales = n4 / (kQBlock / kVec);   // scales per row
  const long long sblk = col / (kQBlock / kVec);      // this thread's block
  const float4 g = active
      ? reinterpret_cast<const float4*>(global)[mb.row + col]
      : make_float4(0.f, 0.f, 0.f, 0.f);
  const char4* q4 = reinterpret_cast<const char4*>(q) + mb.rows;
  scales += mb.clients * n_scales;
  const float4* b4 = reinterpret_cast<const float4*>(base) + mb.rows;
  // new cache, in place
  float4* c4 = reinterpret_cast<float4*>(cache) + mb.rows;
  float4* nl4 = reinterpret_cast<float4*>(new_local) + mb.rows;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < m; k0 += kChunk) {
    const int kn = min(kChunk, m - k0);
    __syncthreads();
    stage(s_flags, s_w, k0, kn, picked + mb.clients,
          undrafted + mb.clients, deprecated + mb.clients,
          completed + mb.clients, weights + mb.clients);
    __syncthreads();
    if (!active) continue;
    for (int i0 = threadIdx.y; i0 < kn; i0 += kSlices * kGroup) {
      // every load of the group first, none waiting on another
      char4 qv[kGroup];
      float sc[kGroup];
      float4 b[kGroup], c[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u * kSlices;
        if (i >= kn) continue;
        const int k = k0 + i;
        const long long off = (long long)k * n4 + col;
        const uint8_t f = s_flags[i];
        const bool done = f & kCompleted;
        qv[u] = done ? q4[off] : make_char4(0, 0, 0, 0);
        sc[u] = done ? scales[(long long)k * n_scales + sblk] : 0.f;
        b[u] = done ? g : b4[off];
        c[u] = (f & (kPicked | kDeprecated)) ? g : c4[off];
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u * kSlices;
        if (i >= kn) continue;
        const long long off = (long long)(k0 + i) * n4 + col;
        const uint8_t f = s_flags[i];
        const float s = sc[u];
        const float4 t = (f & kCompleted)
            ? make_float4((float)qv[u].x * s, (float)qv[u].y * s,
                          (float)qv[u].z * s, (float)qv[u].w * s)
            : b[u];
        const float4 c1 = (f & kPicked) ? t : (f & kDeprecated) ? g : c[u];
        nl4[off] = t;
        fma4(acc, c1, s_w[i]);
        if (f & kUndrafted) {
          c4[off] = t;
        } else if (f & (kPicked | kDeprecated)) {
          c4[off] = c1;
        }
      }
    }
  }
  finish(s_acc, acc, active, new_global + mb.row * kVec, col);
}

inline dim3 grid_for(long long n4, int s) {
  return dim3((unsigned int)((n4 + kLanes - 1) / kLanes), (unsigned int)s);
}

int launch_f32(const float* cache, const float* trained, const float* global,
               const bool* picked, const bool* undrafted,
               const bool* deprecated, const float* weights,
               float* new_global, float* new_cache, int s, int m, long long n,
               cudaStream_t stream) {
  const long long n4 = n / kVec;
  if (n4 == 0 || s == 0) return (int)cudaSuccess;
  safa_aggregate_kernel<<<grid_for(n4, s), dim3(kLanes, kSlices), 0,
                          stream>>>(
      cache, trained, global, picked, undrafted, deprecated, weights,
      new_global, new_cache, new_cache == cache, m, n4);
  return (int)cudaGetLastError();
}

int launch_q8(const int8_t* q, const float* scales, const float* base,
              float* cache, const float* global, const bool* picked,
              const bool* undrafted, const bool* deprecated,
              const bool* completed, const float* weights, float* new_global,
              float* new_local, int s, int m, long long n,
              cudaStream_t stream) {
  const long long n4 = n / kVec;
  if (n4 == 0 || s == 0) return (int)cudaSuccess;
  safa_aggregate_q8_kernel<<<grid_for(n4, s), dim3(kLanes, kSlices), 0,
                             stream>>>(
      q, scales, base, cache, global, picked, undrafted, deprecated,
      completed, weights, new_global, new_local, m, n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cache/trained/new_cache: [m, n] f32 (new_cache may equal cache);
// global/new_global: [n] f32; masks: [m] bool; weights: [m] f32.
// n must be a multiple of 4.  In place, rows Eq. 8 leaves unchanged are
// not written.  Returns the launch's cudaError_t.
int safa_aggregate_f32(const float* cache, const float* trained,
                       const float* global, const bool* picked,
                       const bool* undrafted, const bool* deprecated,
                       const float* weights, float* new_global,
                       float* new_cache, int m, long long n,
                       cudaStream_t stream) {
  return launch_f32(cache, trained, global, picked, undrafted, deprecated,
                    weights, new_global, new_cache, 1, m, n, stream);
}

// The fleet form: cache/trained/new_cache [s, m, n] f32 (new_cache may
// equal cache: in place); global/new_global [s, n]; masks and weights
// [s, m].  One launch, gridDim.y = s (at most 65,535).
int safa_aggregate_fleet_f32(const float* cache, const float* trained,
                             const float* global, const bool* picked,
                             const bool* undrafted, const bool* deprecated,
                             const float* weights, float* new_global,
                             float* new_cache, int s, int m, long long n,
                             cudaStream_t stream) {
  return launch_f32(cache, trained, global, picked, undrafted, deprecated,
                    weights, new_global, new_cache, s, m, n, stream);
}

// q: [m, n] int8; scales: [m, n / 128] f32; base/cache/new_local: [m, n]
// f32, the new cache written over cache; global/new_global: [n] f32;
// masks: [m] bool; weights: [m] f32.  n must be a multiple of 128.
int safa_aggregate_q8_f32(const int8_t* q, const float* scales,
                          const float* base, float* cache,
                          const float* global, const bool* picked,
                          const bool* undrafted, const bool* deprecated,
                          const bool* completed, const float* weights,
                          float* new_global, float* new_local, int m,
                          long long n, cudaStream_t stream) {
  return launch_q8(q, scales, base, cache, global, picked, undrafted,
                   deprecated, completed, weights, new_global, new_local, 1,
                   m, n, stream);
}

// The fleet form: q [s, m, n] int8; scales [s, m, n / 128];
// base/cache/new_local [s, m, n] f32, the cache written in place;
// global/new_global [s, n]; masks and weights [s, m].  gridDim.y = s.
int safa_aggregate_q8_fleet_f32(const int8_t* q, const float* scales,
                                const float* base, float* cache,
                                const float* global, const bool* picked,
                                const bool* undrafted, const bool* deprecated,
                                const bool* completed, const float* weights,
                                float* new_global, float* new_local, int s,
                                int m, long long n, cudaStream_t stream) {
  return launch_q8(q, scales, base, cache, global, picked, undrafted,
                   deprecated, completed, weights, new_global, new_local, s,
                   m, n, stream);
}

}  // extern "C"
