// Causal attention with an optional sliding window and grouped KV heads,
// for Hopper (sm_90a): kernel 21 of the port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention.py:
// _kernel (pallas_call in swa_attention) -> swa_attention_f32 and
// swa_attention_bf16 below.
//
// Math, for query row i of head h (KV head h / (H / KH)) and every key j
// of its band (j <= i and, with a window, i - j < window):
//   s_ij = scale * (q_i . k_j)      scale = D^-0.5, in f32
//   o_i  = sum_j softmax_j(s_ij) v_j
// with f32 sums whatever the operands' type, the output cast back to it.
// As in the reference, masked scores take the finite -1e30, the running
// max starts there, and the denominator is floored at 1e-30.  A row whose
// first band tile holds none of its keys (a window's left edge) then adds
// exp(0) = 1 for each masked key, exactly as the reference does, and the
// tile that holds its first key rescales that by exp(-1e30 - m) = 0; the
// row's own key (the diagonal) always lies in a tile the loop visits, so
// no row ends on such a sum.  With -inf the same step would be
// exp(-inf + inf) = NaN.
//
// Bound: operations.  A call does 4 D flops for every (query, key) pair of
// the band (two products of D), sum_i min(i + 1, window) pairs per head,
// against 2 (S H + 2 S KH) D bytes of bf16 operands and output: at the
// smoke's prefill shape (S = 8192, H = 32, KH = 8, D = 120, window 4096)
// 386.6 GFLOP against 157.3 MB, 0.391 ms at the bf16 tensor-core rate
// (989 TFLOP/s) against 0.047 ms of bytes.
//
// swa_attention_bf16 (tc::swa_tc_kernel) works toward that bound on the
// tensor cores, in the shape the Hopper guide gives a fast kernel:
// - Both products are wgmma with bf16 operands and f32 sums.  A block owns
//   128 query rows of one (batch, head): two consumer warpgroups of 64 rows
//   each, and a producer warpgroup of which one thread issues TMA.
//   S = Q K^T takes K (K-major) from shared memory and Q from registers
//   (A fragments, read once with ldmatrix) where they fit beside O, at
//   D <= 128; above, Q too comes from shared memory.  The scale D^-0.5
//   (times log2 e, for exp2) multiplies the f32 scores, so Q is rounded
//   once, as an operand.  O += P V takes P from registers (the scores'
//   accumulator layout is the A fragment's, so no shuffle) rounded to
//   bf16, as the models' 'flash_jnp' path rounds it; the Pallas kernel
//   keeps P in f32, hence the bf16 tolerance.  V [keys, D] is the B operand
//   MN-major, as wgmma takes 16-bit types: one m64nNk16 a 16-key step,
//   N = 64 NCB.
// - D is the depth of Q K^T: the tiles hold D in NCB 64-column TMA boxes
//   (the 128-byte swizzle's span), and TMA's out-of-bounds fill gives the
//   zero columns past D (120 -> 128) and the zero rows past S: no byte past
//   column D - 1 or row S - 1 is read.  The kernel is templated on the
//   padded D, a whole number of boxes (NCB = ceil(D / 64), four
//   instantiations): Q K^T takes KS = 4 NCB k-steps, 8 at D 120 and 128,
//   so a D that is not a multiple of 64 pays zero columns there only; P V
//   is 64 NCB wide (the columns past D are zeros and never stored).  O is
//   32 NCB f32 registers a thread, 128 at D = 256, so tiles are 128 keys
//   at D <= 128 and 64 above; setmaxnreg gives the consumers 240 registers
//   and the producer 24.
// - K and V arrive through a ring of key tiles (3 stages at D 120, up to 4;
//   2 at D > 192), each with a full and an empty mbarrier: the producer
//   loads the next tiles while the consumers compute.
// - Each warpgroup runs a two-tile software pipeline: tile t's Q K^T is
//   issued with tile t - 1's P V, and tile t's softmax runs on the CUDA
//   cores while that P V holds the tensor cores.  The two warpgroups take
//   turns to issue (ping-pong, named barriers 1 and 2), so one's softmax
//   also runs under the other's products.
// - A block walks only its band's key tiles, [max(0, q0 - window + 1),
//   min(q0 + 127, S - 1)]; a warpgroup computes only the tiles that hold
//   some of its rows' keys (it passes the others on the barriers), and
//   masks only on the diagonal tiles, the window's left edge and the
//   ragged end of S: the softmax is a template on masking, chosen once a
//   tile, because a per-score test costs every tile.  Rows at or past S
//   are never written.
// - Blocks run heaviest query tile first (blockIdx reversed over tiles),
//   so the light tiles near position 0 fill the last wave; the H / KH
//   heads that share a K/V head are adjacent, so their tiles meet in L2.
// ptxas -v (sm_90a): 168 registers a thread at entry for every padded D
// (the consumers then take 240), 0 bytes of spills and stack; dynamic
// shared memory 230,400 bytes at D 120 (Q 32 KB, 3 stages of 2 x 32 KB,
// 1 KB of alignment) plus 112 bytes of barriers.  The mbarrier waits spin
// without a timeout: a clock read and a trap in that loop cost ptxas the
// consumers' 240 registers, and the pipeline then spills.
//
// swa_attention_f32 keeps the CUDA-core kernel (swa_kernel<float, NC>):
// its 2e-5 tolerance cannot be met with bf16 or TF32 operands.  One block
// of 256 threads owns 64 query rows of one (batch, head) and walks only
// the 64-key tiles of the rows' band, [max(0, q0 - window + 1), min(q0 +
// 63, S - 1)], so the work is O(S window).  Q (scaled), K and V tiles are
// staged in shared memory in f32; thread (ty, tx) of the 16 x 16 grid
// holds the scores of rows ty + 16 i and keys tx + 16 j (i, j < 4) in
// registers, and the output accumulators of rows ty + 16 i and columns
// 64 c + 4 tx .. + 3 (c < NC = ceil(D / 64)).  Row maxima and sums are
// reduced over the 16 lanes of a half-warp with xor shuffles.  The
// probabilities go through shared memory (over the K tile, which is dead
// by then) to the second product.  Q and K rows are padded to D + 4
// floats, so 16-byte reads of 16 different rows by a half-warp fall in
// distinct banks (D % 8 == 0).  The edge of a ragged S is masked: no byte
// past row S - 1 is read or written.  Offsets are 64-bit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;        // query rows per block
constexpr int kKeys = 64;        // keys per KV tile
constexpr int kSide = 16;        // threads per side of the 16 x 16 grid
constexpr int kThreads = kSide * kSide;
constexpr int kPer = kRows / kSide;   // rows (and keys) per thread: 4
constexpr int kLdP = kKeys + 4;       // probability row stride (floats)
constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ float half_warp_max(float x) {
  for (int d = kSide / 2; d > 0; d >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, d));
  }
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int d = kSide / 2; d > 0; d >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, d);
  }
  return x;
}

// Shared memory of one block, in floats: Q [64][D + 4]; K [64][D + 4],
// also the probabilities [64][68] once the scores are taken; V [64][64 NC].
__host__ __device__ inline int smem_floats(int d, int nc) {
  const int kp = kKeys * (d + 4) > kRows * kLdP ? kKeys * (d + 4)
                                                 : kRows * kLdP;
  return kRows * (d + 4) + kp + kKeys * 64 * nc;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int S, int H, int KH,
           int D, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 4;
  const int ldv = 64 * NC;
  float* sQ = smem;
  float* sK = sQ + kRows * ld;
  float* sP = sK;   // the probabilities overwrite the K tile
  const int kp = kKeys * ld > kRows * kLdP ? kKeys * ld : kRows * kLdP;
  float* sV = sK + kp;

  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const long long qs = (long long)H * D;    // stride between positions
  const long long ks = (long long)KH * D;
  const T* qb = q + (long long)b * S * qs + (long long)h * D;
  const T* kb = k + (long long)b * S * ks + (long long)kh * D;
  const T* vb = v + (long long)b * S * ks + (long long)kh * D;
  T* ob = o + (long long)b * S * qs + (long long)h * D;

  // the query tile, scaled in f32; rows past S are zeros
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int pos = q0 + r;
    sQ[r * ld + d] = pos < S ? to_f32(qb[pos * qs + d]) * scale : 0.f;
  }
  // V's columns past D are never loaded: zeros, once
  for (int i = tid; i < kKeys * (ldv - D); i += kThreads) {
    const int r = i / (ldv - D);
    sV[r * ldv + D + (i - r * (ldv - D))] = 0.f;
  }

  float m[kPer], l[kPer], acc[kPer][NC][4];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
    }
  }

  // the band of this tile's rows, in whole KV tiles
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = min(q0 + kRows - 1, S - 1);
  for (int k0 = lo / kKeys * kKeys; k0 <= hi; k0 += kKeys) {
    __syncthreads();   // the last tile's readers of sP and sV are done
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int pos = k0 + r;
      const bool in = pos < S;
      sK[r * ld + d] = in ? to_f32(kb[pos * ks + d]) : 0.f;
      sV[r * ldv + d] = in ? to_f32(vb[pos * ks + d]) : 0.f;
    }
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < D; d += 4) {
      float4 qv[kPer], kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty + kSide * i) * ld + d]);
        kv[i] = *reinterpret_cast<const float4*>(&sK[(tx + kSide * i) * ld + d]);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
      }
    }
    __syncthreads();   // every thread's reads of sK are done: sP may go there

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qpos = q0 + ty + kSide * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kpos = k0 + tx + kSide * j;
        const bool ok = kpos <= qpos && kpos < S &&
                        (window <= 0 || qpos - kpos < window);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + kSide * i) * kLdP + tx + kSide * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + half_warp_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
      }
    }
    __syncthreads();

    for (int j = 0; j < kKeys; j += 4) {
      float4 pv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(&sP[(ty + kSide * i) * kLdP + j]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &sV[(j + u) * ldv + 64 * c + 4 * tx]);
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z : pv[i].w;
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int pos = q0 + ty + kSide * i;
    if (pos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < D) store(&ob[pos * qs + col], acc[i][c][e] / den);
      }
    }
  }
}

template <typename T, int NC>
int launch_nc(const T* q, const T* k, const T* v, T* o, int B, int S, int H,
              int KH, int D, int window, float scale, cudaStream_t stream) {
  const int bytes = smem_floats(D, NC) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((S + kRows - 1) / kRows), (unsigned int)H,
                  (unsigned int)B);
  swa_kernel<T, NC><<<grid, kThreads, bytes, stream>>>(q, k, v, o, S, H, KH,
                                                       D, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int B, int S, int H,
           int KH, int D, int window, float scale, cudaStream_t stream) {
  if (D <= 0 || D % 8 != 0 || D > kMaxD || KH <= 0 || H % KH != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  switch ((D + 63) / 64) {
    case 1: return launch_nc<T, 1>(q, k, v, o, B, S, H, KH, D, window, scale, stream);
    case 2: return launch_nc<T, 2>(q, k, v, o, B, S, H, KH, D, window, scale, stream);
    case 3: return launch_nc<T, 3>(q, k, v, o, B, S, H, KH, D, window, scale, stream);
    default: return launch_nc<T, 4>(q, k, v, o, B, S, H, KH, D, window, scale, stream);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 entry: a tensor-core flash-attention kernel for Hopper.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;     // query rows per block: two consumer warpgroups
constexpr int kBox = 64;       // columns per TMA box: 128 bytes, the swizzle span
constexpr int kThreads = 384;  // warpgroups 0-1 consume, warpgroup 2 produces
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemOptIn = 232448;   // a block's shared memory, opted in

// KS = 4 NCB k-steps of 16 columns hold the head dim padded to NCB whole
// 64-column boxes (TMA fills the columns past D with zeros); tiles take 128
// keys while O's registers (32 NCB a thread) and shared memory allow, else
// 64, and the ring takes what the 227 KB of shared memory leave after Q.
template <int KS>
struct Cfg {
  static constexpr int kNcb = (KS + 3) / 4;
  static constexpr int kKeys = kNcb <= 2 ? 128 : 64;
  static constexpr int kQBytes = kRows * kBox * 2 * kNcb;      // 16 KB a box
  static constexpr int kTileBytes = kKeys * kBox * 2 * kNcb;
  // stages that fit beside Q, 1 KB of alignment and 256 B of barriers
  static constexpr int kFit =
      (kSmemOptIn - 1024 - 256 - kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes;
  static_assert(kStages >= 2, "the K/V ring needs two stages");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed.  (No timeout:
// a clock read and a trap in this loop cost ptxas the consumers' 240
// registers, and the pipelined loop then spills.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One 4-d TMA box (columns, head, positions, batch) into shared memory,
// completing on `bar`; columns and positions past the tensor read as 0.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma operand in shared memory laid out as TMA's 128-byte swizzle
// writes it: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO
// is the stride between 64-column boxes (MN-major) and unused K-major.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Named barrier `id` over `count` threads: wait for it, or only arrive.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// After a wait: the compiler must not read the accumulators earlier.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] B[16 x N], A in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory: 64-column
// boxes LBO bytes apart.
template <int N>
__device__ void wgmma_rs_mn(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_mn<64>(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<128>(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<192>(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<256>(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A in registers, B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


// The four 8 x 8 bf16 matrices at the rows whose addresses lanes 0-7,
// 8-15, 16-23 and 24-31 give, as an m16n8k16 A fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One consumer warpgroup's registers and steps: 64 query rows of O, the
// scores of one K/V tile, the last tile's probabilities as A fragments.
template <int KS>
struct Rows {
  static constexpr int NCB = Cfg<KS>::kNcb;
  static constexpr int BN = Cfg<KS>::kKeys;
  // Q K^T takes Q from registers (A fragments, 4 KS a thread) where they
  // fit beside O, else from shared memory: from registers it reads only K
  // from shared memory, which TMA is writing at the same time.
  static constexpr bool kQRegs = NCB <= 2;
  static_assert(kQRegs ? BN == 128 : BN == 64, "Q K^T is n128 RS or n64 SS");
  float acc[32 * NCB];   // O [64, 64 NCB]: columns past D stay 0
  float sc[BN / 2];      // scores, then probabilities, of one K/V tile
  uint32_t pa[BN / 4];   // the probabilities as bf16 A fragments
  uint32_t qf[kQRegs ? 4 * KS : 1];   // Q as bf16 A fragments
  float m0, m1, l0, l1;  // running max and (per-thread) sum of rows r, r + 8
  float c0, c1;          // the rescale of O that the last softmax asks

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 32 * NCB; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    m0 = m1 = kNeg;
    l0 = l1 = 0.f;
  }

  // Q's A fragments from its swizzled tile: rows qrow .. qrow + 15 of the
  // block's 128 (this warp's), lane l addressing row (l / 8 % 2) 8 + l % 8
  // of the 16-byte chunk 2 (kk % 4) + l / 16 of box kk / 4.
  __device__ __forceinline__ void load_q(uint32_t sq, int qrow, int lane) {
    if constexpr (kQRegs) {
      const int row = qrow + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int chunk = (kk & 3) * 2 + (lane >> 4);
        ldmatrix_x4(&qf[4 * kk], sq + (kk >> 2) * kRows * 128 + row * 128 +
                                     ((chunk ^ (lane & 7)) << 4));
      }
    }
  }

  // S = Q K^T, issued as one wgmma group (K in shared memory)
  __device__ __forceinline__ void issue_qk(uint32_t qa, uint32_t ka) {
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      const uint64_t kd = sw128_desc(ka + (kk >> 2) * BN * 128 + off, 16);
      if constexpr (kQRegs) {
        wgmma_rs_n128(sc, &qf[4 * kk], kd, kk > 0);
      } else {
        wgmma_ss_n64(sc, sw128_desc(qa + (kk >> 2) * kRows * 128 + off, 16),
                     kd, kk > 0);
      }
    }
    wgmma_commit();
  }

  // O += P V, issued as one wgmma group (P in registers, V in shared memory)
  __device__ __forceinline__ void issue_pv(uint32_t va) {
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wgmma_rs_mn<64 * NCB>(acc, &pa[4 * kk],
                            sw128_desc(va + kk * 16 * 128, BN * 128));
    }
    wgmma_commit();
  }

  // The online softmax of the scores of keys k0 .. k0 + BN - 1, in place,
  // for rows row0 and row0 + 8 of the warpgroup's rows wr0 .. wr0 + 63.
  // Scores are scaled by D^-0.5 log2 e in f32 (the max and the running max
  // live in that scale); MASKED tiles first scale and mask (masked scores
  // take the finite -1e30, as the reference's), the others fold the scale
  // into the exponent's FFMA.
  template <bool MASKED>
  __device__ __forceinline__ void softmax_tile(int k0, int row0, int lane, int S,
                                          int window, float scale_log2) {
    if (MASKED) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = row0 + ((i & 2) ? 8 : 0);
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const bool ok = key <= r && key < S &&
                        (window <= 0 || r - key < window);
        sc[i] = ok ? sc[i] * scale_log2 : kNeg;
      }
    }
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
    // a row's scores lie in the four lanes of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    if (!MASKED) {
      mx0 *= scale_log2;
      mx1 *= scale_log2;
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    c0 = ex2(m0 - n0);
    c1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    const float sl = MASKED ? 1.f : scale_log2;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const float p = ex2(fmaf(sc[i], sl, -((i & 2) ? n1 : n0)));
      sc[i] = p;
      if (i & 2) s1 += p;
      else s0 += p;
    }
    // per-thread partial sums: the quad's are added at the end
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
  }

  // Some (row, key) pair of the tile is masked only on the diagonal tiles,
  // the window's left edge and the ragged end of S.
  __device__ __forceinline__ void softmax(int k0, int wr0, int row0, int lane,
                                          int S, int window,
                                          float scale_log2) {
    if (k0 + BN - 1 > wr0 || k0 + BN > S ||
        (window > 0 && wr0 + 63 - k0 >= window)) {
      softmax_tile<true>(k0, row0, lane, S, window, scale_log2);
    } else {
      softmax_tile<false>(k0, row0, lane, S, window, scale_log2);
    }
  }

  // Once the last P V is done: rescale O, and keep this tile's P as A
  // fragments (the scores' accumulator layout is the A fragment's: keys
  // 16 kk .. 16 kk + 15 are sc[8 kk .. 8 kk + 7]).
  __device__ __forceinline__ void rescale_and_pack() {
#pragma unroll
    for (int j = 0; j < 8 * NCB; ++j) {
      acc[4 * j] *= c0;
      acc[4 * j + 1] *= c0;
      acc[4 * j + 2] *= c1;
      acc[4 * j + 3] *= c1;
    }
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
  }
};

template <int KS>
__global__ void __launch_bounds__(kThreads, 1)
swa_tc_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
              int B, int S, int H, int KH, int D, int window,
              float scale_log2) {
  using C = Cfg<KS>;
  constexpr int NCB = C::kNcb;
  constexpr int BN = C::kKeys;
  constexpr int NS = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  // q_full; k_full[NS]; v_full[NS]; k_empty[NS]; v_empty[NS]
  __shared__ __align__(8) uint64_t bars[1 + 4 * NS];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::kQBytes;
  const uint32_t sV = sK + NS * C::kTileBytes;
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t q_full = bar0;
  auto k_full = [&](int s) { return bar0 + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar0 + 8u * (1 + NS + s); };
  auto k_empty = [&](int s) { return bar0 + 8u * (1 + 2 * NS + s); };
  auto v_empty = [&](int s) { return bar0 + 8u * (1 + 3 * NS + s); };

  // Heaviest query tiles first: the last tiles walk the whole band, the
  // first ones little, so the light ones fill the last wave.  Heads of a
  // batch are adjacent, so the H / KH heads that share K/V run together.
  const int n_q = (S + kRows - 1) / kRows;
  const int hb = H * B;
  const int tile = n_q - 1 - static_cast<int>(blockIdx.x / hb);
  const int rest = static_cast<int>(blockIdx.x % hb);
  const int h = rest % H, b = rest / H;
  const int kh = h / (H / KH);
  const int q0 = tile * kRows;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = min(q0 + kRows - 1, S - 1);
  const int kt0 = lo / BN;
  const int n_tiles = hi / BN - kt0 + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);   // one arrival per consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the K/V ring full with TMA ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < NCB; ++c) {
        tma_load(sQ + c * kRows * 128, &tq, q_full, c * kBox, h, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NS;
        const uint32_t ph = (t / NS) & 1;
        const int k0 = (kt0 + t) * BN;
        mbar_wait(k_empty(s), ph ^ 1);   // passes at once on the first lap
        mbar_expect_tx(k_full(s), C::kTileBytes);
        for (int c = 0; c < NCB; ++c) {
          tma_load(sK + s * C::kTileBytes + c * BN * 128, &tk, k_full(s),
                   c * kBox, kh, k0, b);
        }
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), C::kTileBytes);
        for (int c = 0; c < NCB; ++c) {
          tma_load(sV + s * C::kTileBytes + c * BN * 128, &tv, v_full(s),
                   c * kBox, kh, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    setmaxnreg_inc<240>();
    const int warp = (threadIdx.x & 127) >> 5;
    const int lane = threadIdx.x & 31;
    const int wr0 = q0 + 64 * wg;
    // the two rows of this thread's accumulator fragments: row0, row0 + 8
    const int row0 = wr0 + 16 * warp + (lane >> 2);
    const uint32_t qa = sQ + wg * 64 * 128;
    // This warpgroup's tiles: from the one holding its first row's first
    // key to the one holding its last row's own key.  The block's other
    // tiles (at most one at each end) hold none of its keys: it only
    // passes them on the barriers.
    const int kmin = window > 0 ? max(0, wr0 - window + 1) : 0;
    const int t_first = wr0 < S ? kmin / BN - kt0 : n_tiles;
    const int t_last = wr0 < S ? min(wr0 + 63, S - 1) / BN - kt0 : n_tiles - 1;
    // Ping-pong: the two warpgroups take turns to issue a tile's products
    // (named barriers 1 and 2), so one's softmax runs while the other's
    // products hold the tensor cores.  Every tile is one turn of each, so
    // the turns stay paired whatever tiles a warpgroup skips.
    auto turn_begin = [&]() { named_bar_sync(1 + wg, 256); };
    auto turn_end = [&](int t) {
      if (!(wg == 1 && t == n_tiles - 1)) named_bar_arrive(2 - wg, 256);
    };
    if (wg == 1) named_bar_arrive(1, 256);   // warpgroup 0 goes first
    auto pass = [&](int t) {
      const int s = t % NS;
      const uint32_t ph = (t / NS) & 1;
      mbar_wait(k_full(s), ph);
      mbar_wait(v_full(s), ph);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(k_empty(s));
        mbar_arrive(v_empty(s));
      }
      turn_begin();
      turn_end(t);
    };
    Rows<KS> r;
    r.init();
    mbar_wait(q_full, 0);
    r.load_q(sQ, wg * 64 + warp * 16, lane);
    for (int t = 0; t < t_first; ++t) pass(t);
    if (t_first <= t_last) {
      // Software pipeline: tile t's Q K^T is issued with tile t - 1's P V,
      // and tile t's softmax runs on the CUDA cores while that P V runs on
      // the tensor cores.
      int s = t_first % NS;
      mbar_wait(k_full(s), (t_first / NS) & 1);
      turn_begin();
      r.issue_qk(qa, sK + s * C::kTileBytes);
      turn_end(t_first);
      wgmma_wait<0>();
      fence_regs(r.sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(s));
      r.softmax((kt0 + t_first) * BN, wr0, row0, lane, S, window, scale_log2);
      r.rescale_and_pack();
      for (int t = t_first + 1; t <= t_last; ++t) {
        const int sp = s;
        s = t % NS;
        mbar_wait(k_full(s), (t / NS) & 1);
        mbar_wait(v_full(sp), ((t - 1) / NS) & 1);
        turn_begin();
        r.issue_qk(qa, sK + s * C::kTileBytes);
        r.issue_pv(sV + sp * C::kTileBytes);
        turn_end(t);
        wgmma_wait<1>();   // S of tile t; tile t - 1's P V runs on
        fence_regs(r.sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty(s));
        r.softmax((kt0 + t) * BN, wr0, row0, lane, S, window, scale_log2);
        wgmma_wait<0>();
        fence_regs(r.acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(v_empty(sp));
        r.rescale_and_pack();
      }
      mbar_wait(v_full(s), (t_last / NS) & 1);
      r.issue_pv(sV + s * C::kTileBytes);
      wgmma_wait<0>();
      fence_regs(r.acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty(s));
    }
    for (int t = t_last + 1; t < n_tiles; ++t) pass(t);

    float l0 = r.l0, l1 = r.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
    const long long qs = static_cast<long long>(H) * D;
    bf16* ob = o + static_cast<long long>(b) * S * qs +
               static_cast<long long>(h) * D;
#pragma unroll
    for (int j = 0; j < 8 * NCB; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < D) {
        if (row0 < S) {
          *reinterpret_cast<__nv_bfloat162*>(ob + row0 * qs + col) =
              __floats2bfloat162_rn(r.acc[4 * j] * i0, r.acc[4 * j + 1] * i0);
        }
        if (row0 + 8 < S) {
          *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * qs + col) =
              __floats2bfloat162_rn(r.acc[4 * j + 2] * i1, r.acc[4 * j + 3] * i1);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// [B, S, heads, D] bf16, boxes of 64 columns x `rows` positions of one
// (batch, head), 128-byte swizzled; reads past D or S fill zeros.
bool encode(CUtensorMap* map, const bf16* base, int B, int S, int heads,
            int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<bf16*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KS>
int launch_ks(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
              int S, int H, int KH, int D, int window, float scale,
              cudaStream_t stream) {
  using C = Cfg<KS>;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, S, H, D, kRows) ||
      !encode(&tk, k, B, S, KH, D, C::kKeys) ||
      !encode(&tv, v, B, S, KH, D, C::kKeys)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      swa_tc_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((S + kRows - 1) / kRows) * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swa_tc_kernel<KS><<<(unsigned int)blocks, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, o, B, S, H, KH, D, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
           int S, int H, int KH, int D, int window, float scale,
           cudaStream_t stream) {
  if (D <= 0 || D % 8 != 0 || D > 256 || KH <= 0 || H % KH != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  switch ((D + 63) / 64) {   // NCB boxes of 64 columns: KS = 4 NCB
    case 1: return launch_ks<4>(q, k, v, o, B, S, H, KH, D, window, scale, stream);
    case 2: return launch_ks<8>(q, k, v, o, B, S, H, KH, D, window, scale, stream);
    case 3: return launch_ks<12>(q, k, v, o, B, S, H, KH, D, window, scale, stream);
    default: return launch_ks<16>(q, k, v, o, B, S, H, KH, D, window, scale, stream);
  }
}

}  // namespace tc

extern "C" {

// q/o: [B, S, H, D]; k/v: [B, S, KH, D]; all contiguous, o a fresh buffer.
// H % KH == 0, D % 8 == 0, D <= 256; window <= 0 means none; scale is
// D^-0.5 as f32.  Returns the launch's cudaError_t.
int swa_attention_f32(const float* q, const float* k, const float* v,
                      float* o, int B, int S, int H, int KH, int D,
                      int window, float scale, cudaStream_t stream) {
  return launch(q, k, v, o, B, S, H, KH, D, window, scale, stream);
}

// The same on bf16 operands and output, on the tensor cores; every base
// pointer 16-byte aligned (cudaErrorMisalignedAddress otherwise).
int swa_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, __nv_bfloat16* o, int B,
                       int S, int H, int KH, int D, int window, float scale,
                       cudaStream_t stream) {
  return tc::launch(q, k, v, o, B, S, H, KH, D, window, scale, stream);
}

}  // extern "C"
