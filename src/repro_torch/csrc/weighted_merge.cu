// One-shot weighted server merge of the staleness-adaptive aggregation
// family (SEAFL, CSAFL, folded FedAsync) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ops.py:
// _weighted_merge_kernel (weighted_merge_packed) -> weighted_merge_f32
// below.  The JAX package vmaps that kernel for fleets; here the fleet form
// is its own entry, weighted_merge_fleet_f32: every operand gains a leading
// member axis ([S, m, N] trained, [S, N] globals, [S, m] weight rows) and
// the grid a second dimension, blockIdx.y = s.  A block of member s runs
// exactly the single-run code on member s's slices, so its result is bit
// for bit what the single-run launch gives on them.
//
// Math, per column j of the [m, N] pack buffer of client uploads:
//   out[j] = (1 - sum_k w_k) * global[j] + sum_k w_k * trained[k, j]
// The weight row w carries the whole scheme: SEAFL's adaptive weights
// arrive normalised, CSAFL's per-cluster sub-aggregates pre-folded and
// FedAsync's sequential merges folded; it is zero off the committed set.
//
// Bound: device-memory bytes.  2 floating-point operations per weighted
// value against 4 bytes read, far below the card's ~20 FLOP/byte balance
// point.  A row whose weight is exactly 0 contributes nothing, so it is
// never read (about 30 % of the rows at crash probability 0.3): the bytes
// are nnz * N * 4 for the weighted rows, N * 4 for the global read, N * 4
// for the new global written and m * 4 for the weights.  The weight of a
// row is the same for the whole block, so the skip costs no divergence.
//
// Design: the TPU kernel holds a full [m, 2048] column tile in VMEM; a
// Hopper block cannot, and need not.  As in safa_aggregate.cu, a block owns
// 128 adjacent columns: each of its 32 lanes 4 of them (16-byte loads,
// neighbouring lanes on neighbouring addresses), and each of its 8 warps
// every 8th client, streamed through registers with the partial sum in an
// f32 register.  A thread issues the loads of kGroup of its clients before
// their multiply-adds, so several loads are in flight.  The warps' partial
// sums are added in warp order in shared memory, so the result does not
// depend on scheduling.  The weights are staged in shared memory in chunks
// of 256, so any m works.  Warp 0 of every block adds the weights in one
// fixed order (per chunk: lane-strided sums, then an xor butterfly, which
// gives every lane the same bits), so all blocks agree on the residual
// 1 - sum(w).  The output is a fresh buffer (the JAX call has no alias),
// so every pointer is __restrict__.  Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;       // threads across columns (4 floats each)
constexpr int kSlices = 8;       // warps across clients
constexpr int kThreads = kLanes * kSlices;
constexpr int kChunk = 256;      // weights staged in shared memory at a time
constexpr int kGroup = 4;        // clients whose loads go together

__device__ __forceinline__ void fma4(float4& acc, float4 v, float w) {
  acc.x = fmaf(v.x, w, acc.x);
  acc.y = fmaf(v.y, w, acc.y);
  acc.z = fmaf(v.z, w, acc.z);
  acc.w = fmaf(v.w, w, acc.w);
}

// Sum of s_w[0, kn) in one fixed order, the same bits on every lane of the
// calling warp (all 32 lanes must call it).
__device__ __forceinline__ float chunk_sum(const float* s_w, int kn) {
  float s = 0.f;
  for (int i = threadIdx.x; i < kn; i += kLanes) s += s_w[i];
  for (int d = kLanes / 2; d > 0; d >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, d);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
weighted_merge_kernel(const float* __restrict__ trained,
                      const float* __restrict__ global,
                      const float* __restrict__ wrow,
                      float* __restrict__ out, int m, long long n4) {
  __shared__ float s_w[kChunk];
  __shared__ float4 s_acc[kSlices][kLanes];
  // member s = blockIdx.y: its [m, n] rows, its [n] global and out rows
  // (in float4s) and its [m] weights
  const float4* t4 = reinterpret_cast<const float4*>(trained) +
                     (long long)blockIdx.y * m * n4;
  const long long row = (long long)blockIdx.y * n4;
  wrow += (long long)blockIdx.y * m;
  const long long col = (long long)blockIdx.x * kLanes + threadIdx.x;
  const bool active = col < n4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = zero;
  float wsum = 0.f;                  // read by warp 0 only
  for (int k0 = 0; k0 < m; k0 += kChunk) {
    const int kn = min(kChunk, m - k0);
    __syncthreads();   // the previous chunk's readers are done
    for (int i = threadIdx.y * kLanes + threadIdx.x; i < kn; i += kThreads) {
      s_w[i] = wrow[k0 + i];
    }
    __syncthreads();
    if (threadIdx.y == 0) wsum += chunk_sum(s_w, kn);
    if (!active) continue;
    for (int i0 = threadIdx.y; i0 < kn; i0 += kSlices * kGroup) {
      float w[kGroup];
      float4 v[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u * kSlices;
        w[u] = i < kn ? s_w[i] : 0.f;
        v[u] = w[u] != 0.f ? t4[(long long)(k0 + i) * n4 + col] : zero;
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (w[u] != 0.f) fma4(acc, v[u], w[u]);
      }
    }
  }
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
  const float r = 1.f - wsum;
  const float4 g = reinterpret_cast<const float4*>(global)[row + col];
  reinterpret_cast<float4*>(out)[row + col] =
      make_float4(fmaf(r, g.x, sum.x), fmaf(r, g.y, sum.y),
                  fmaf(r, g.z, sum.z), fmaf(r, g.w, sum.w));
}

int launch(const float* trained, const float* global, const float* wrow,
           float* out, int s, int m, long long n, cudaStream_t stream) {
  const long long n4 = n / 4;
  if (n4 == 0 || s == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned int)((n4 + kLanes - 1) / kLanes),
                  (unsigned int)s);
  weighted_merge_kernel<<<grid, dim3(kLanes, kSlices), 0, stream>>>(
      trained, global, wrow, out, m, n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// trained: [m, n] f32; global/out: [n] f32 (out a fresh buffer); wrow: [m]
// f32.  n must be a multiple of 4.  Returns the launch's cudaError_t.
int weighted_merge_f32(const float* trained, const float* global,
                       const float* wrow, float* out, int m, long long n,
                       cudaStream_t stream) {
  return launch(trained, global, wrow, out, 1, m, n, stream);
}

// The fleet form: trained [s, m, n] f32; global/out [s, n]; wrow [s, m].
// One launch, gridDim.y = s (at most 65,535).
int weighted_merge_fleet_f32(const float* trained, const float* global,
                             const float* wrow, float* out, int s, int m,
                             long long n, cudaStream_t stream) {
  return launch(trained, global, wrow, out, s, m, n, stream);
}

}  // extern "C"
