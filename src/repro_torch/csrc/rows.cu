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
//     -> gather_rows_fleet_f32 below (the same kernel over every
//     member's slots);
//   * src/repro/kernels/ops.py:_scatter_fleet_kernel (scatter_rows_fleet)
//     -> scatter_rows_fleet_f32 below.
//
// The fleet forms move the rows of S members in one launch: buf [S, R, N],
// rows [S, K], values [S, K, N].  The scatter's grid gains a dimension
// for the member, blockIdx.z = s, and a block of member s runs exactly
// the single-run code on member s's slices; the gather's work items run
// over the S x K slots of [S, K, N] as over one run's K, each reading its
// own member's row.  Row indices outside [0, R) go to member s's row
// R - 1, so member s gets the single-run launch's bits; a single run is
// the fleet of one.
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
// index prefetched.
//   * Gather (kernels 11 and 13): a copy on Hopper's bulk-copy engine (the
//     non-tensor form of TMA), with no data in registers.  The output
//     [S, K, N] is one contiguous byte range; the launch cuts it into
//     runs of kMaxRun bytes, one a block (shorter, down to kMinRun, where
//     kMaxRun would leave an SM without a block; always a multiple of
//     kRunAlign).  A block walks its run as work items (member, slot,
//     column segment): a segment ends at the run's end, at its row's end
//     or at the next multiple of kStageBytes within the row, so every
//     item is at most one stage, and a row's ragged last segment and a
//     run that starts or ends inside a row are items like the others.
//     One thread of the block does all the copying, through a ring of
//     kStages stages in shared memory: it loads an item's segment with
//     one 1-D cp.async.bulk into the next stage, completing on that
//     stage's mbarrier (expect_tx of the segment's bytes); once the
//     mbarrier's phase completes it stores the stage to out with one
//     cp.async.bulk ... bulk_group and commits the group; before a stage
//     is loaded again, cp.async.bulk.wait_group.read 1 waits until the
//     store before the one just issued has read its stage (so kStages - 1
//     loads stay in flight); and the block waits for every store to read
//     its stage before it exits.  At the wrapper's widths (N a multiple
//     of 2048: rows of 8 KB or more) a 16 KB run spans at most three
//     items, so its loads all go out at once and the ring does not wrap;
//     it wraps where rows are narrower than a stage.
//     Bulk copies take 16-byte multiples at 16-byte-aligned addresses: N
//     is a multiple of 4 floats (the entry returns cudaErrorInvalidValue
//     otherwise), every row starts at a multiple of 16 bytes and every
//     cut is one, and the entry refuses a buf or out that is not 16-byte
//     aligned (cudaErrorMisalignedAddress).
//     Proxy fences: every staged byte is written and read by the async
//     proxy (the bulk load writes the stage, the bulk store reads it),
//     and the thread itself reads and writes none.  After the mbarrier
//     inits, fence.mbarrier_init.release.cluster makes them visible to
//     the bulk copies; after each stage's mbarrier wait, and before the
//     bulk store that reads the stage, fence.proxy.async.shared::cta
//     orders the completed load (observed through the mbarrier) before
//     the store's async-proxy read.  The PTX ISA asks for a proxy fence
//     where one proxy's access follows another's; this one is a guard
//     for the mbarrier's generic-proxy view of the completion, and costs
//     nothing measurable.  A stage is loaded again only after
//     wait_group.read, so a load never overwrites bytes a store still
//     reads.
//     Why short runs and not one persistent block an SM: with each block
//     walking an equal share of the copy, the launch ends when the
//     slowest SM does, and on the card that ran slower than the register
//     kernel it replaced at every ring depth, stage size and block count
//     tried; blocks of one short run each, handed out by the hardware as
//     SMs free up, balance themselves (PERF.md, the row gather's
//     findings).
//     Resources (nvcc -Xptxas -v, sm_90a): 46 registers, no spills,
//     49,280 bytes of dynamic shared memory (three 16 KB stages and the
//     barriers) and 32 threads a block, four blocks an SM.  On an H100
//     80GB HBM3 at 700 W, at R 1001, K 124, N 342,016 (339.3 MB), a
//     launch takes 0.114 ms on the device, 89 % of its byte bound, as the
//     register kernel it replaced does; index_select 0.117 ms.
//     Slots are independent and every output byte is written once, by
//     one copy of its source byte, so any order gives the same bits.
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

constexpr int kThreads = 256;    // scatter: threads a block
constexpr int kChunk = 256;      // scatter: slots staged at a time
constexpr int kGroup = 4;        // scatter: slots whose loads go together

__device__ __forceinline__ long long fix_row(int r, int n_rows) {
  return (r >= 0 && r < n_rows) ? r : n_rows - 1;
}

// Member s = blockIdx.z's slices of the scatter: its [R, n] buffer, [K]
// rows and [K, n] values (in float4s and ints).
struct Member {
  long long buf, slots, vals;
  __device__ Member(int n_rows, int k, long long n4)
      : buf((long long)blockIdx.z * n_rows * n4),
        slots((long long)blockIdx.z * k),
        vals((long long)blockIdx.z * k * n4) {}
};

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


// ---------------------------------------------------------------------------
// The gather on a ring of 1-D bulk copies (kernels 11 and 13; see the note
// at the top).  Its own copies of the mbarrier and bulk-copy helpers keep
// this file self-contained.
namespace gather {

constexpr int kStageBytes = 16384;         // bytes of a stage: a copy at most
constexpr int kStages = 3;                 // ring depth
constexpr long long kMaxRun = 16384;       // bytes a block copies at most
constexpr long long kMinRun = 512;         // and at least (but the last)
constexpr long long kRunAlign = 128;       // a run's bytes: a multiple
constexpr int kBarBytes = 128;             // the stages' mbarriers
constexpr int kSmem = kBarBytes + kStages * kStageBytes;
constexpr int kThreads = 32;               // one warp; lane 0 copies
static_assert(kStages >= 2, "a store and a load in flight");
static_assert(kStages * 8 <= kBarBytes, "the barriers fit");
static_assert(kStageBytes % 16 == 0 && kRunAlign % 16 == 0 &&
                  kMaxRun % kRunAlign == 0 && kMinRun % kRunAlign == 0,
              "bulk copies move 16-byte multiples");

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

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
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

// `bytes` bytes from shared `src` to global `dst`, in this thread's
// current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
          "l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// End of the work item that starts at output byte `o`, `off` bytes into
// its row: the run's end `hi`, the row's end, or the next multiple of
// kStageBytes within the row, whichever comes first.
__device__ __forceinline__ long long item_end(long long o, long long off,
                                              long long row, long long hi) {
  const long long next = (off / kStageBytes + 1) * kStageBytes;
  return min(hi, o - off + min(row, next));
}

// out [s, k, n] = buf [s, r, n] at rows [s, k], as bytes: `row` bytes a
// row, `total` = s * k * row, `run` bytes a block (the last block's run
// ends at `total`).
__global__ void __launch_bounds__(kThreads)
gather_rows_ring_kernel(const char* __restrict__ buf,
                        const int* __restrict__ rows, char* __restrict__ out,
                        int n_rows, int k, long long row, long long total,
                        long long run) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const uint32_t ring = smem_u32(smem + kBarBytes);
  for (int i = 0; i < kStages; ++i) mbar_init(smem_u32(full + i), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const long long lo = (long long)blockIdx.x * run;
  const long long hi = min(lo + run, total);
  // the load side: the next item's first output byte, the slot whose
  // source row `src` holds, and the count of loads issued
  long long ld = lo, slot = -1;
  const char* src = nullptr;
  uint32_t n_ld = 0;
  auto load_next = [&]() {
    const long long q = ld / row, off = ld - q * row;
    if (q != slot) {   // slot q = s * k + j of member s = q / k
      slot = q;
      src = buf + ((q / k) * n_rows + fix_row(rows[q], n_rows)) * row;
    }
    const long long end = item_end(ld, off, row, hi);
    const uint32_t st = n_ld % kStages, bar = smem_u32(full + st);
    mbar_expect_tx(bar, (uint32_t)(end - ld));
    bulk_load(ring + st * kStageBytes, src + off, (uint32_t)(end - ld), bar);
    ld = end;
    ++n_ld;
  };
  while (n_ld < kStages && ld < hi) load_next();
  // the store side: the next item's first output byte and the count of
  // stores issued; after store i the stage of store i - 1 takes load
  // i - 1 + kStages
  long long so = lo;
  for (uint32_t n_st = 0; so < hi; ++n_st) {
    const uint32_t st = n_st % kStages;
    mbar_wait(smem_u32(full + st), (n_st / kStages) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const long long end = item_end(so, so % row, row, hi);
    bulk_store(out + so, ring + st * kStageBytes, (uint32_t)(end - so));
    bulk_commit();
    so = end;
    if (n_st >= 1 && ld < hi) {
      bulk_wait_read<1>();
      load_next();
    }
  }
  bulk_wait_read<0>();
}

// The launch's shape for s members of k slots of width n: {stage bytes,
// stages, shared bytes a block, blocks an SM, blocks, bytes a block}.
struct Grid {
  long long stage, stages, smem, per_sm, blocks, run;
};

int grid_of(int s, int k, long long n, Grid* out) {
  constexpr int kMaxDevices = 64;
  static int per_sm[kMaxDevices], sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(gather_rows_ring_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    int blocks = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, gather_rows_ring_kernel, kThreads, kSmem);
    }
    if (err != cudaSuccess) return (int)err;
    if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
    per_sm[dev] = blocks;
  }
  // runs of kMaxRun bytes, shorter (down to kMinRun) where that leaves
  // an SM idle
  const long long total = (long long)s * k * n * 4;
  const long long places = (long long)per_sm[dev] * sms[dev];
  long long run = ((total + places - 1) / places + kRunAlign - 1) /
                  kRunAlign * kRunAlign;
  run = run < kMinRun ? kMinRun : run > kMaxRun ? kMaxRun : run;
  out->stage = kStageBytes;
  out->stages = kStages;
  out->smem = kSmem;
  out->per_sm = per_sm[dev];
  out->run = run;
  out->blocks = (total + run - 1) / run;
  return (int)cudaSuccess;
}

}  // namespace gather

inline int launch_gather(const float* buf, const int* rows, float* out,
                         int s, int r, int k, long long n,
                         cudaStream_t stream) {
  if (n % 4) return (int)cudaErrorInvalidValue;
  if (n == 0 || k == 0 || s == 0) return (int)cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(buf) | reinterpret_cast<uintptr_t>(out)) &
      15) {
    return (int)cudaErrorMisalignedAddress;
  }
  gather::Grid g;
  const int err = gather::grid_of(s, k, n, &g);
  if (err != (int)cudaSuccess) return err;
  gather::gather_rows_ring_kernel<<<(unsigned int)g.blocks, gather::kThreads,
                                    gather::kSmem, stream>>>(
      reinterpret_cast<const char*>(buf), rows, reinterpret_cast<char*>(out),
      r, k, n * 4, (long long)s * k * n * 4, g.run);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// buf: [r, n] f32; rows: [k] int32; out: [k, n] f32, a fresh buffer.
// n must be a multiple of 4, buf and out 16-byte aligned
// (cudaErrorMisalignedAddress otherwise).  Returns the launch's
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
// [s, k, n] f32.  The scatter's gridDim.z = s (at most 65,535).
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

// How the gather launches for s members of k slots of width n on the
// current device: out[0..5] = {stage bytes, stages, shared bytes a block,
// blocks an SM, blocks, bytes a block}.  Returns a cudaError_t.
int gather_rows_grid(int s, int k, long long n, long long* out) {
  gather::Grid g;
  const int err = gather::grid_of(s, k, n, &g);
  if (err != (int)cudaSuccess) return err;
  const long long v[6] = {g.stage, g.stages, g.smem, g.per_sm, g.blocks,
                          g.run};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return (int)cudaSuccess;
}

}  // extern "C"
