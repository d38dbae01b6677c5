// Hand-written Hopper kernel of the quantized acting forward: the int8
// weight-only dense product.
//
// Plain C interface, loaded with ctypes (r2d2_tpu_torch/ops/_build.py and
// ops/quant_kernels.py). The entry point launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() so the wrapper can raise
// on a refused launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libquant_kernels.so quant_kernels.cu
//
// ---------------------------------------------------------------------------
// int8_linear: y[m, n] = (sum_k x[m, k] * q[n, k]) * scale[n] + bias[n]
//
// No Pallas site: it is what the JAX package's quantized forward
// (r2d2_tpu/models/network.py quantized_inference_apply, which dequantizes
// per channel in front of each matmul) leaves to XLA, which fuses the
// dequantization into the matmul's operand read so that the weights cross
// memory as int8. Here the weights stay int8 in device memory and are
// widened in registers; the sum is kept in f32 and the per-channel scale
// and the bias are applied once, in the epilogue.
//
// Shapes: M = 1..64 rows (the server's dispatch buckets, an actor's lanes),
// K up to a few thousand, N up to a few thousand output channels: every
// dense layer of the acting forward (torso dense 3136 -> 1024, the LSTM's
// input projection (1024 + A) -> 2048 and recurrent product 512 -> 2048,
// the head's 512 -> 512 and its outputs).
//
// Bound: bytes. At M <= 64 the product is a few hundred MFLOP while the
// weights are read once: the least time is (int8 weights + f32 scales + x +
// y) bytes at 3.35 TB/s, ~1 us for the torso dense. The design is the
// simple one that streams those bytes once:
// - one warp per output channel, kWarps channels a block, so the grid has a
//   block per kWarps channels (128 blocks for N = 1024);
// - each lane loads 16 int8 weights of its channel in one 16-byte load, 32
//   lanes cover kChunk = 512 consecutive k a pass, so a warp reads whole
//   512-byte runs of its weight row;
// - the block stages x[0:M, k0:k0 + kChunk] in shared memory (zeros past K),
//   once for its kWarps channels, and every lane keeps the M row sums of its
//   16 k in registers (MT, M rounded up to a power of two, a template
//   argument);
// - the epilogue reduces each row's sum over the warp with shuffles and
//   writes y = sum * scale + bias in the output type.
// The weight rows are padded to ldq, a multiple of 16 (the wrapper's
// layout, ops/quant_kernels.py pad_int8_weight), so a 16-wide group that
// starts below K stays inside its row; the staged x is zero past K, so what
// the pad holds does not matter. A tensor-core design would need int8
// activations (mma's s8 operands), which is not the JAX package's numerics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 512;          // k a warp covers a pass: 32 lanes x 16
constexpr int kMaxRows = 64;

__device__ __forceinline__ void load16(const float* p, float v[16]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = p4[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float v[16]) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 raw = p4[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename TX>
__device__ __forceinline__ TX zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename TX, typename TY, int MT>
__global__ void __launch_bounds__(kThreads)
    int8_linear_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
                       int ldq, const float* __restrict__ scale,
                       const float* __restrict__ bias, TY* __restrict__ y,
                       int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TX* xs = reinterpret_cast<TX*>(smem_raw);  // [M][kChunk]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const bool active = n < N;
  const int8_t* qrow = q + static_cast<size_t>(active ? n : 0) * ldq;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int i = threadIdx.x; i < M * kChunk; i += kThreads) {
      const int m = i / kChunk;
      const int k = k0 + (i - m * kChunk);
      xs[i] = k < K ? x[static_cast<size_t>(m) * K + k] : zero_of<TX>();
    }
    __syncthreads();
    const int kk = k0 + lane * 16;
    if (active && kk < K) {
      const int4 raw = *reinterpret_cast<const int4*>(qrow + kk);
      const int8_t* qb = reinterpret_cast<const int8_t*>(&raw);
      float qf[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) qf[j] = static_cast<float>(qb[j]);
      const TX* xr = xs + lane * 16;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          float xv[16];
          load16(xr + m * kChunk, xv);
          float s = acc[m];
#pragma unroll
          for (int j = 0; j < 16; ++j) s = fmaf(xv[j], qf[j], s);
          acc[m] = s;
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  const float sc = scale[n];
  const float b = bias != nullptr ? bias[n] : 0.f;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < M) {
      float v = acc[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == (m & 31)) {
        store_out(y + static_cast<size_t>(m) * N + n, v * sc + b);
      }
    }
  }
}

template <typename TX, typename TY, int MT>
static int launch_rows(const void* x, const int8_t* q, int ldq,
                       const float* scale, const float* bias, void* y, int M,
                       int N, int K, cudaStream_t s) {
  auto kernel = int8_linear_kernel<TX, TY, MT>;
  const size_t smem = static_cast<size_t>(M) * kChunk * sizeof(TX);
  // the attribute once per instantiation, at its largest (MT rows)
  static bool raised = false;
  const size_t most = static_cast<size_t>(MT) * kChunk * sizeof(TX);
  if (!raised && most > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const unsigned grid = static_cast<unsigned>((N + kWarps - 1) / kWarps);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const TX*>(x), q, ldq,
                                      scale, bias, static_cast<TY*>(y), M, N,
                                      K);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TY>
static int launch_types(const void* x, const int8_t* q, int ldq,
                        const float* scale, const float* bias, void* y, int M,
                        int N, int K, cudaStream_t s) {
  if (M <= 1) return launch_rows<TX, TY, 1>(x, q, ldq, scale, bias, y, M, N, K, s);
  if (M <= 2) return launch_rows<TX, TY, 2>(x, q, ldq, scale, bias, y, M, N, K, s);
  if (M <= 4) return launch_rows<TX, TY, 4>(x, q, ldq, scale, bias, y, M, N, K, s);
  if (M <= 8) return launch_rows<TX, TY, 8>(x, q, ldq, scale, bias, y, M, N, K, s);
  if (M <= 16) return launch_rows<TX, TY, 16>(x, q, ldq, scale, bias, y, M, N, K, s);
  if (M <= 32) return launch_rows<TX, TY, 32>(x, q, ldq, scale, bias, y, M, N, K, s);
  return launch_rows<TX, TY, 64>(x, q, ldq, scale, bias, y, M, N, K, s);
}

// x (M, K) f32 or bf16, contiguous; q (N, ldq) int8, ldq >= K and a
// multiple of 16, 16-byte aligned; scale (N,) f32; bias (N,) f32 or null;
// y (M, N) f32 or bf16, contiguous.
extern "C" int int8_linear(const void* x, int x_bf16, const void* q,
                           int64_t ldq, const void* scale, const void* bias,
                           void* y, int y_bf16, int64_t M, int64_t N,
                           int64_t K, void* stream) {
  if (M < 1 || M > kMaxRows || N < 1 || K < 1 || ldq < K || ldq % 16 ||
      N > 2147483647 || ldq > 2147483647 ||
      reinterpret_cast<uintptr_t>(q) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(M), n = static_cast<int>(N);
  const int k = static_cast<int>(K), l = static_cast<int>(ldq);
  if (x_bf16) {
    return y_bf16
               ? launch_types<__nv_bfloat16, __nv_bfloat16>(x, qp, l, sp, bp, y, m, n, k, s)
               : launch_types<__nv_bfloat16, float>(x, qp, l, sp, bp, y, m, n, k, s);
  }
  return y_bf16 ? launch_types<float, __nv_bfloat16>(x, qp, l, sp, bp, y, m, n, k, s)
                : launch_types<float, float>(x, qp, l, sp, bp, y, m, n, k, s);
}
