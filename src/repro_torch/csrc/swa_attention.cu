// Causal attention with an optional sliding window and grouped KV heads,
// for Hopper (sm_90a): kernel 21 of the port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swa_attention.py:
// _kernel (pallas_call in swa_attention) -> swa_attention_f32 and
// swa_attention_bf16 below.
//
// Math, for query row i of head h (KV head h / (H / KH)) and every key j
// of its band (j <= i and, with a window, i - j < window):
//   s_ij = (scale * q_i) . k_j      scale = D^-0.5, applied to q in f32
//   o_i  = sum_j softmax_j(s_ij) v_j
// in f32 whatever the operands' type, the output cast back to it.  As in
// the reference, masked scores take the finite -1e30, the running max
// starts there, and the denominator is floored at 1e-30.  A row whose first
// band tile holds none of its keys (a window's left edge) then adds
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
// Design: simple and right first.  The Pallas grid's sequential fourth
// axis (KV blocks accumulated in VMEM scratch) becomes a loop inside the
// block.  One block of 256 threads owns 64 query rows of one (batch, head)
// and walks only the 64-key tiles of the rows' band, [max(0, q0 - window
// + 1), min(q0 + 63, S - 1)], so the work is O(S window).  Q (scaled), K
// and V tiles are staged in shared memory in f32; thread (ty, tx) of the
// 16 x 16 grid holds the scores of rows ty + 16 i and keys tx + 16 j
// (i, j < 4) in registers, and the output accumulators of rows ty + 16 i
// and columns 64 c + 4 tx .. + 3 (c < NC = ceil(D / 64)).  Row maxima and
// sums are reduced over the 16 lanes of a half-warp with xor shuffles.
// The probabilities go through shared memory (over the K tile, which is
// dead by then) to the second product.  Q and K rows are padded to D + 4
// floats, so 16-byte reads of 16 different rows by a half-warp fall in
// distinct banks (D % 8 == 0).  All products are f32 FMAs on the CUDA
// cores: no tensor cores yet (a later redesign's).  The edge of a ragged
// S is masked here: no byte past row S - 1 is read or written.  Offsets
// are 64-bit.
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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

extern "C" {

// q/o: [B, S, H, D]; k/v: [B, S, KH, D]; all contiguous, o a fresh buffer.
// H % KH == 0, D % 8 == 0, D <= 256; window <= 0 means none; scale is
// D^-0.5 as f32.  Returns the launch's cudaError_t.
int swa_attention_f32(const float* q, const float* k, const float* v,
                      float* o, int B, int S, int H, int KH, int D,
                      int window, float scale, cudaStream_t stream) {
  return launch(q, k, v, o, B, S, H, KH, D, window, scale, stream);
}

// The same on bf16 operands and output; f32 inside.
int swa_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, __nv_bfloat16* o, int B,
                       int S, int H, int KH, int D, int window, float scale,
                       cudaStream_t stream) {
  return launch(q, k, v, o, B, S, H, KH, D, window, scale, stream);
}

}  // extern "C"
