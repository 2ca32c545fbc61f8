// Int8 per-block quantisation of upload values, and its inverse, for
// Hopper (sm_90a): of packed [m, N] upload buffers, and of one flat [n]
// vector (one leaf of one client's upload).
//
// Replaces five Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/comm_quant.py:_quant_packed_kernel (quantize_packed)
//     -> quantize_packed_f32 below;
//   * src/repro/kernels/comm_quant.py:_quant_fleet_kernel
//     (quantize_packed_fleet) -> quantize_packed_fleet_f32 below.  The
//     quantisation is row by row, so an [S, m, N] fleet buffer is an
//     [S * m, N] one: the fleet entry launches the same kernel over S * m
//     rows, and each member's q and scales are bit for bit the single-run
//     kernel's on its rows;
//   * src/repro/kernels/comm_quant.py:_dequant_packed_kernel
//     (dequantize_packed) -> dequantize_packed_f32 and, for a fleet's
//     [S, m, N] buffer (the JAX package vmaps the single-buffer kernel),
//     dequantize_packed_fleet_f32: the same kernel over S * m rows;
//   * src/repro/kernels/comm_quant.py:_quant_kernel (quantize, the
//     per-leaf reference path) -> quantize_f32 below;
//   * src/repro/kernels/comm_quant.py:_dequant_kernel (dequantize)
//     -> dequantize_f32 below.
// The per-leaf path calls the last two through quantize_rows_f32 and
// dequantize_rows_f32, which launch them once per client row of a leaf.
// For every client row and every block of 128 values:
//   scale = max(amax, 1e-30) / 127        (amax = max |x| over the block)
//   q     = clip(round_half_even(x / scale), -127, 127)  as int8
//
// Bound: device-memory bytes.  4 bytes read and 1 written per value (plus
// one f32 scale per 128), a handful of operations each; at the main path's
// m = 100, N = 342,016 that is ~172 MB.
//
// The inverse: x = float(q) * scale for every value of the block, one f32
// multiply, so x equals the plain PyTorch version bit for bit.  It moves
// 1 byte read and 4 written per value (plus the block's scale): ~172 MB at
// m = 100, N = 342,016, the same bytes as the quantisation.
//
// Design: one warp per (row, block).  Each lane loads 4 adjacent floats
// (16 bytes; the warp reads the block's 512 bytes in one coalesced pass),
// the block's |x| max comes from a warp-shuffle reduction, and each lane
// writes its 4 int8 values as one char4.  Both divisions are IEEE divisions
// (this file must never be built with --use_fast_math) and rintf rounds
// half to even, so q and scale equal the plain PyTorch version bit for bit.
// The inverse mirrors it: each lane reads its 4 int8 values as one char4
// and the block's scale (one address for the whole warp), and writes one
// float4.
//
// The flat-vector forms serve the per-leaf path, which hands them row k of
// a client's [m, n] leaf: any n >= 1, so the last block may be partial, and
// a base address only 4-byte aligned (row k of a 13-value leaf starts at
// byte 52 k).  Vector loads need neither, so there one warp per block
// reads its values with scalar loads, lane l taking values l, l + 32,
// l + 64 and l + 96 of the block (each load instruction coalesced over 128
// contiguous bytes), and the lanes past n take no part in the max (the
// JAX kernel's zero padding cannot raise it either).  The cost of this
// path is the launch, not the bytes: the CNN's largest leaf (n = 313,600)
// moves ~1.6 MB, 0.47 us at the memory rate, and its smallest 10 values.
// So the rows entries issue a leaf's m launches from one C loop: the
// Python work of a call (operand checks, allocation, the ctypes call) is
// paid once a leaf and not once a row, and each row keeps its own launch,
// as the reference's "2 dispatches per leaf per client" has it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQBlock = 128;
constexpr int kLanes = 32;

__device__ __forceinline__ signed char quant(float x, float scale) {
  const float r = fminf(fmaxf(rintf(x / scale), -127.0f), 127.0f);
  return (signed char)r;
}

__global__ void __launch_bounds__(kThreads)
quantize_packed_kernel(const float* x, int8_t* q, float* scales,
                       long long n_blocks) {
  const long long blk =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (blk >= n_blocks) return;          // whole warps leave together
  const long long v = blk * kLanes + lane;   // float4 index
  const float4 xv = reinterpret_cast<const float4*>(x)[v];
  float amax = fmaxf(fmaxf(fabsf(xv.x), fabsf(xv.y)),
                     fmaxf(fabsf(xv.z), fabsf(xv.w)));
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = fmaxf(amax, 1e-30f) / 127.0f;
  char4 out;
  out.x = quant(xv.x, scale);
  out.y = quant(xv.y, scale);
  out.z = quant(xv.z, scale);
  out.w = quant(xv.w, scale);
  reinterpret_cast<char4*>(q)[v] = out;
  if (lane == 0) scales[blk] = scale;
}

__global__ void __launch_bounds__(kThreads)
dequantize_packed_kernel(const int8_t* q, const float* scales, float* x,
                         long long n_blocks) {
  const long long blk =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (blk >= n_blocks) return;
  const long long v = blk * kLanes + lane;   // char4 / float4 index
  const char4 qv = reinterpret_cast<const char4*>(q)[v];
  const float scale = scales[blk];           // one address for the warp
  float4 out;
  out.x = (float)qv.x * scale;
  out.y = (float)qv.y * scale;
  out.z = (float)qv.z * scale;
  out.w = (float)qv.w * scale;
  reinterpret_cast<float4*>(x)[v] = out;
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* x, int8_t* q, float* scales, long long n) {
  const long long blk =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  const long long n_blocks = (n + kQBlock - 1) / kQBlock;
  if (blk >= n_blocks) return;          // whole warps leave together
  const long long base = blk * kQBlock + lane;
  float v[kQBlock / kLanes];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kQBlock / kLanes; ++j) {
    const long long i = base + j * kLanes;
    v[j] = i < n ? x[i] : 0.0f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = fmaxf(amax, 1e-30f) / 127.0f;
#pragma unroll
  for (int j = 0; j < kQBlock / kLanes; ++j) {
    const long long i = base + j * kLanes;
    if (i < n) q[i] = quant(v[j], scale);
  }
  if (lane == 0) scales[blk] = scale;
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* q, const float* scales, float* x,
                  long long n) {
  const long long blk =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  const long long n_blocks = (n + kQBlock - 1) / kQBlock;
  if (blk >= n_blocks) return;
  const float scale = scales[blk];           // one address for the warp
  const long long base = blk * kQBlock + lane;
#pragma unroll
  for (int j = 0; j < kQBlock / kLanes; ++j) {
    const long long i = base + j * kLanes;
    if (i < n) x[i] = (float)q[i] * scale;
  }
}

// Grid of one warp per 128-value block over rows * n / 128 blocks.
unsigned int grid_for(long long n_blocks) {
  return (unsigned int)((n_blocks * kLanes + kThreads - 1) / kThreads);
}

int launch(const float* x, int8_t* q, float* scales, long long rows,
           long long n, cudaStream_t stream) {
  const long long n_blocks = rows * (n / kQBlock);
  if (n_blocks == 0) return (int)cudaSuccess;
  quantize_packed_kernel<<<grid_for(n_blocks), kThreads, 0, stream>>>(
      x, q, scales, n_blocks);
  return (int)cudaGetLastError();
}

int launch_dequant(const int8_t* q, const float* scales, float* x,
                   long long rows, long long n, cudaStream_t stream) {
  const long long n_blocks = rows * (n / kQBlock);
  if (n_blocks == 0) return (int)cudaSuccess;
  dequantize_packed_kernel<<<grid_for(n_blocks), kThreads, 0, stream>>>(
      q, scales, x, n_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [m, n] f32; q: [m, n] int8; scales: [m, n / 128] f32; n must be a
// multiple of 128.  Returns the launch's cudaError_t.
int quantize_packed_f32(const float* x, int8_t* q, float* scales, int m,
                        long long n, cudaStream_t stream) {
  return launch(x, q, scales, m, n, stream);
}

// The fleet form: x [s, m, n] f32; q [s, m, n] int8; scales
// [s, m, n / 128] f32.  One launch over the s * m rows.
int quantize_packed_fleet_f32(const float* x, int8_t* q, float* scales, int s,
                              int m, long long n, cudaStream_t stream) {
  return launch(x, q, scales, (long long)s * m, n, stream);
}

// The inverse: q [m, n] int8 and scales [m, n / 128] f32 -> x [m, n] f32.
int dequantize_packed_f32(const int8_t* q, const float* scales, float* x,
                          int m, long long n, cudaStream_t stream) {
  return launch_dequant(q, scales, x, m, n, stream);
}

// Its fleet form: q [s, m, n], scales [s, m, n / 128] -> x [s, m, n].  One
// launch over the s * m rows.
int dequantize_packed_fleet_f32(const int8_t* q, const float* scales,
                                float* x, int s, int m, long long n,
                                cudaStream_t stream) {
  return launch_dequant(q, scales, x, (long long)s * m, n, stream);
}

// A flat vector: x [n] f32 -> q [n] int8, scales [ceil(n / 128)] f32; any
// n >= 1 and any 4-byte-aligned x.  Returns the launch's cudaError_t.
int quantize_f32(const float* x, int8_t* q, float* scales, long long n,
                 cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long n_blocks = (n + kQBlock - 1) / kQBlock;
  quantize_kernel<<<grid_for(n_blocks), kThreads, 0, stream>>>(x, q, scales,
                                                                n);
  return (int)cudaGetLastError();
}

// Its inverse: q [n] int8 and scales [ceil(n / 128)] f32 -> x [n] f32.
int dequantize_f32(const int8_t* q, const float* scales, float* x,
                   long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long n_blocks = (n + kQBlock - 1) / kQBlock;
  dequantize_kernel<<<grid_for(n_blocks), kThreads, 0, stream>>>(q, scales,
                                                                  x, n);
  return (int)cudaGetLastError();
}

// The rows entries: every row of a contiguous [m, n] stack (one leaf of m
// clients' uploads) through the flat kernels, one launch per row, all
// from this one call: x [m, n] f32 -> q [m, n] int8, scales
// [m, ceil(n / 128)] f32.  Row k's launch is quantize_f32's on row k's
// pointers, so its bits are the flat entry's; only the host's loop moves
// from Python into C.  Returns the first non-zero cudaError_t, and
// launches no row after it.
int quantize_rows_f32(const float* x, int8_t* q, float* scales, int m,
                      long long n, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long n_scales = (n + kQBlock - 1) / kQBlock;
  for (long long k = 0; k < m; ++k) {
    const int err = quantize_f32(x + k * n, q + k * n, scales + k * n_scales,
                                 n, stream);
    if (err != (int)cudaSuccess) return err;
  }
  return (int)cudaSuccess;
}

// Its inverse: q [m, n] int8 and scales [m, ceil(n / 128)] f32 -> x [m, n]
// f32, one dequantize_f32 launch per row.
int dequantize_rows_f32(const int8_t* q, const float* scales, float* x, int m,
                        long long n, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long n_scales = (n + kQBlock - 1) / kQBlock;
  for (long long k = 0; k < m; ++k) {
    const int err = dequantize_f32(q + k * n, scales + k * n_scales,
                                   x + k * n, n, stream);
    if (err != (int)cudaSuccess) return err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
