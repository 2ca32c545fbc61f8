// Row gather and row scatter on pack buffers for Hopper (sm_90a): how the
// sparse schedules' engines move the K active clients' rows in and out of
// the carried [R, N] local and cache buffers.
//
// Replaces four Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/ops.py:_copy_kernel (gather_rows)
//     -> gather_rows_f32 below: out[j, :] = buf[rows[j], :];
//   * src/repro/kernels/ops.py:_scatter_kernel (scatter_rows)
//     -> scatter_rows_f32 below: buf[rows[j], :] = vals[j, :], in place
//     (the TPU call aliases buf to its output), the last slot winning
//     where slots share a row;
//   * src/repro/kernels/ops.py:_copy_fleet_kernel (gather_rows_fleet)
//     -> gather_rows_fleet_f32 below;
//   * src/repro/kernels/ops.py:_scatter_fleet_kernel (scatter_rows_fleet)
//     -> scatter_rows_fleet_f32 below.
//
// The fleet forms move the rows of S members in one launch: buf [S, R, N],
// rows [S, K], values [S, K, N], and the grid gains a dimension for the
// member, blockIdx.z = s (blockIdx.y already holds the gather's slot, and
// gridDim.y stops at 65,535).  A block of member s runs exactly the
// single-run code on member s's slices, row indices outside [0, R) going
// to member s's row R - 1, so member s gets the single-run launch's bits;
// a single run is the fleet of one (gridDim.z = 1).
//
// Rows: a row index outside [0, R) reads and writes row R - 1.  The
// engines' buffers are [m + 1, N] with a trailing scratch row, and a
// sparse schedule pads its slots with the sentinel index m, so every
// sentinel slot lands in the scratch row; no index can reach past the
// buffer, whatever the caller passes.
//
// Bound: device-memory bytes; there is no arithmetic.  The gather reads
// each distinct source row once and writes K rows; the scatter reads the
// value row of the last slot of each distinct destination row and writes
// that row once.  Rows of N = 342,016 floats are 1.37 MB, so each slot's
// copy is long and contiguous.
//
// Design.  The TPU grid walks (slot, 2048-column tile) pairs with the row
// index prefetched; here a thread moves 16-byte vectors, neighbouring
// threads on neighbouring addresses.
//   * Gather: blockIdx.y is the slot, blockIdx.x a 1024-vector tile of its
//     row; each thread issues its kPerThread loads before its stores.
//     Slots are independent, so any block order gives the same result.
//   * Scatter: a block owns one 256-vector column tile and walks the K
//     slots in slot order; K blocks never race on a shared row.  Before a
//     chunk of slots, the block marks each slot that a later slot
//     overwrites (same destination row) and skips it, so the slots it
//     writes have distinct rows: their writes cannot conflict, the last
//     slot wins by construction, and a thread may issue kGroup slots'
//     loads before their stores.  The result is the same on every launch.
// buf and the values are distinct buffers (the wrapper allocates every
// value buffer fresh), so the pointers are __restrict__.  Offsets are
// 64-bit: a fleet's S * R * N (4 x 1001 x 342,016) exceeds int32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;    // gather: vectors each thread copies
constexpr int kChunk = 256;      // scatter: slots staged at a time
constexpr int kGroup = 4;        // scatter: slots whose loads go together

__device__ __forceinline__ long long fix_row(int r, int n_rows) {
  return (r >= 0 && r < n_rows) ? r : n_rows - 1;
}

// Member s = blockIdx.z's slices: its [R, n] buffer, [K] rows and [K, n]
// values (in float4s and ints).
struct Member {
  long long buf, slots, vals;
  __device__ Member(int n_rows, int k, long long n4)
      : buf((long long)blockIdx.z * n_rows * n4),
        slots((long long)blockIdx.z * k),
        vals((long long)blockIdx.z * k * n4) {}
};

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ buf,
                   const int* __restrict__ rows, float4* __restrict__ out,
                   int n_rows, int k, long long n4) {
  const Member mb(n_rows, k, n4);
  buf += mb.buf;
  rows += mb.slots;
  out += mb.vals;
  const long long src = fix_row(rows[blockIdx.y], n_rows) * n4;
  const long long dst = (long long)blockIdx.y * n4;
  const long long c0 =
      (long long)blockIdx.x * kThreads * kPerThread + threadIdx.x;
  float4 v[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long c = c0 + (long long)u * kThreads;
    if (c < n4) v[u] = buf[src + c];
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long c = c0 + (long long)u * kThreads;
    if (c < n4) out[dst + c] = v[u];
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(float4* __restrict__ buf, const int* __restrict__ rows,
                    const float4* __restrict__ vals, int n_rows, int k,
                    long long n4) {
  // destination offset of each staged slot, -1 where a later slot writes
  // the same row
  __shared__ long long s_dst[kChunk];
  const Member mb(n_rows, k, n4);
  buf += mb.buf;
  rows += mb.slots;
  vals += mb.vals;
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (int j0 = 0; j0 < k; j0 += kChunk) {
    const int kn = min(kChunk, k - j0);
    __syncthreads();   // the previous chunk's readers are done
    for (int i = threadIdx.x; i < kn; i += kThreads) {
      const int j = j0 + i;
      const long long r = fix_row(rows[j], n_rows);
      bool last = true;
      for (int l = j + 1; l < k && last; ++l) {
        last = fix_row(rows[l], n_rows) != r;
      }
      s_dst[i] = last ? r * n4 : -1;
    }
    __syncthreads();
    if (c >= n4) continue;
    for (int i0 = 0; i0 < kn; i0 += kGroup) {
      float4 v[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u;
        if (i < kn && s_dst[i] >= 0) v[u] = vals[(long long)(j0 + i) * n4 + c];
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = i0 + u;
        if (i < kn && s_dst[i] >= 0) buf[s_dst[i] + c] = v[u];
      }
    }
  }
}

inline int launch_gather(const float* buf, const int* rows, float* out,
                         int s, int r, int k, long long n,
                         cudaStream_t stream) {
  const long long n4 = n / 4;
  if (n4 == 0 || k == 0 || s == 0) return (int)cudaSuccess;
  const long long per_block = (long long)kThreads * kPerThread;
  const dim3 grid((unsigned int)((n4 + per_block - 1) / per_block),
                  (unsigned int)k, (unsigned int)s);
  gather_rows_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(buf), rows,
      reinterpret_cast<float4*>(out), r, k, n4);
  return (int)cudaGetLastError();
}

inline int launch_scatter(float* buf, const int* rows, const float* vals,
                          int s, int r, int k, long long n,
                          cudaStream_t stream) {
  const long long n4 = n / 4;
  if (n4 == 0 || k == 0 || s == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned int)((n4 + kThreads - 1) / kThreads), 1,
                  (unsigned int)s);
  scatter_rows_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<float4*>(buf), rows,
      reinterpret_cast<const float4*>(vals), r, k, n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// buf: [r, n] f32; rows: [k] int32; out: [k, n] f32, a fresh buffer.
// n must be a multiple of 4 and k at most 65,535.  Returns the launch's
// cudaError_t.
int gather_rows_f32(const float* buf, const int* rows, float* out, int r,
                    int k, long long n, cudaStream_t stream) {
  return launch_gather(buf, rows, out, 1, r, k, n, stream);
}

// buf: [r, n] f32, written in place; rows: [k] int32; vals: [k, n] f32,
// not overlapping buf.  n must be a multiple of 4.
int scatter_rows_f32(float* buf, const int* rows, const float* vals, int r,
                     int k, long long n, cudaStream_t stream) {
  return launch_scatter(buf, rows, vals, 1, r, k, n, stream);
}

// The fleet forms: buf [s, r, n] f32; rows [s, k] int32; out/vals
// [s, k, n] f32.  gridDim.z = s (at most 65,535).
int gather_rows_fleet_f32(const float* buf, const int* rows, float* out,
                          int s, int r, int k, long long n,
                          cudaStream_t stream) {
  return launch_gather(buf, rows, out, s, r, k, n, stream);
}

int scatter_rows_fleet_f32(float* buf, const int* rows, const float* vals,
                           int s, int r, int k, long long n,
                           cudaStream_t stream) {
  return launch_scatter(buf, rows, vals, s, r, k, n, stream);
}

}  // extern "C"
