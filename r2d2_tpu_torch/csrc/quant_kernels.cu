// Hand-written Hopper kernel of the quantized acting forward: the int8
// weight-only dense product.
//
// Plain C interface, loaded with ctypes (r2d2_tpu_torch/ops/_build.py and
// ops/quant_kernels.py). The entry point launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (or the launch's own
// error) so the wrapper can raise on a refused launch.
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
// y) bytes at 3.35 TB/s, ~1 us for the torso dense. Such a read is over
// before one SM could stream it, so the design puts every SM to work at
// once, with every weight load in flight from the start:
// - Tensor cores, swap-AB. mma.sync m16n8k16 (bf16 in, f32 sums) with the
//   weights as operand A (16 output channels x 16 k) and x as operand B
//   (16 k x 8 rows of x): M = 1..8 fills one n8 tile, M = 64 eight (NT, a
//   template argument: 1, 2, 4, 8). |q| <= 127 is exact in bf16, so the
//   weights, widened in registers, multiply exactly; the f32 sums differ
//   from the plain version's only in their order. (Tensor cores do not need
//   int8 activations for an int8 weight: the s8 mma would, the bf16 one
//   takes the widened weights as they are.)
// - The k order inside an mma is free as long as A and B agree. A lane
//   (group g = lane / 4, t = lane % 4) takes the 16 k [16t, 16t + 16) of a
//   64-k chunk: one 16-byte load of weight row g and one of row g + 8 give
//   its A fragments for the chunk's four k16 steps (step s: bytes 4s..4s+3),
//   and the same 16 k of x row g (two 16-byte shared-memory loads) its B
//   fragments. So q keeps nn.Linear's row-major layout, padded to ldq (a
//   multiple of 16, ops/quant_kernels.py pad_int8_weight), and each lane's
//   weight reads are 16-byte loads, 64 contiguous bytes for four lanes.
// - Split K over a thread-block cluster. A block of `warps` warps covers
//   warps m16 channel tiles (a warp each) and one K slice: chunks
//   [s * C / S, (s + 1) * C / S) of the C = ceil(K / 64) chunks, s its rank
//   in a cluster of S <= 8 blocks (the portable cluster size) along grid x.
//   The grid is (S, channel blocks): the torso's 1,024 channels fill 128
//   SMs (16 blocks x 8 slices). Blocks stay small (at most 128 threads;
//   with bf16 x at most ~74 KiB of shared memory at the model's shapes), so
//   two fit an SM and a cluster finds room at once: blocks that each take
//   a whole SM left clusters of 8 waiting for a second wave.
// - Weights in flight from the start. Each warp loads all of its slice's
//   weights of a round (up to kMaxChunks chunks; the plan gives the
//   model's shapes one round) into registers before it waits on anything;
//   they arrive while x is staged.
// - x staged once a K slice, by asynchronous copies: the block's x rows
//   land in shared memory by cp.async, 16 bytes a copy where rows are
//   16-byte aligned, else 4 (bf16) or 8 (f32) bytes: the LSTM input
//   projection's rows (1024 + A bf16 values, 2,060 bytes) are only 4-byte
//   aligned. Only a bf16 row of odd K falls back to 2-byte loads. No copy
//   kernel runs in front of the launch. The staged x is zero past K and
//   past M, so what q's pad holds never reaches a sum. Rows are padded by
//   16 bytes, so a warp's fragment loads hit every bank once.
// - Sums: each chunk's products start from zero (two n8 tiles at a time,
//   their mmas interleaved) and join the lane's running f32 sums by an
//   add, so at most 64 products go through the tensor cores' own
//   accumulation at a time.
// - Deterministic reduction. Each block leaves its f32 partial sums in
//   its shared memory; after a cluster barrier, block s sums its share of
//   the tile's outputs over the S blocks' partials in rank order through
//   distributed shared memory (four outputs a thread, the S loads issued
//   together; the scales and biases loaded before the barrier), applies
//   the epilogue and stores; a second barrier keeps every block's partials
//   alive until they are read. One launch, no workspace, no atomics: two
//   launches on the same inputs give the same bits, which the graph-vs-
//   eager checks need.
// - The f32 route keeps f32's accuracy: x is split once, in shared memory,
//   into three bf16 terms (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
//   hi - mid); ops/quant_kernels.py split_bf16x3), which sum back to x
//   exactly for |x| >= 2^-110, and three mmas into the same sums make the
//   f32 product up to the order of summation.
// - Few instantiations: NT x {bf16, f32} x. y's type is an argument that
//   only the epilogue's stores read (the same for every thread).
// The plan (ops/quant_kernels.py int8_linear_plan) chooses the grid (S x
// channel blocks), the warps a block and the chunks a round; the C entry
// lays out the block's shared memory (int8_smem_bytes) and refuses
// (cudaErrorInvalidValue) a plan whose blocks miss a channel or whose
// shared memory would pass kMaxSmem.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int kChunk = 64;           // k a warp covers a step: 4 lanes x 16
constexpr int kMaxChunks = 8;        // chunks a round holds in registers
constexpr int kMaxWarps = 4;         // m16 channel tiles a block
constexpr int kMaxSplit = 8;         // K slices: the portable cluster size
constexpr int kMaxRows = 64;
constexpr int kRowPad = 8;           // bf16 values past each staged row
constexpr int kRawPad = 4;           // f32 values past each raw staged row
constexpr int kPartPad = 4;          // f32 values past each partial row
constexpr int kMaxSmem = 160 * 1024;

// Shared memory of a launch: the staged x (3 bf16 planes for f32 x, and
// the raw f32 rows they are split from), then the partial sums when K is
// split. (ops/quant_kernels.py int8_linear_plan estimates the same to
// choose chunks a round.)
static int64_t int8_smem_bytes(int rows, int warps, int split, int chunks,
                               bool x_f32) {
  const int64_t width = static_cast<int64_t>(chunks) * kChunk;
  int64_t bytes = (x_f32 ? 3 : 1) * rows * (width + kRowPad) * 2;
  if (x_f32) bytes += rows * (width + kRawPad) * 4;
  if (split > 1) bytes += rows * (warps * 16 + kPartPad) * 4;
  return bytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16, 8 or 4 bytes; src-size 0 zero-fills.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(kBytes), "r"(in ? kBytes : 0));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// c += a . b on the tensor cores: 16x16 bf16 A (row), 16x8 bf16 B (col),
// f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Signed byte `kByte` of w as an exact f32: 2^23 + (q + 128) built from its
// bits, less 2^23 + 128.
template <int kByte>
__device__ __forceinline__ float byte_to_f32(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | kByte)) -
         8388736.f;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The four int8 weights of a 32-bit word as two bf16x2 registers: bytes
// (0, 1) and (2, 3), exact.
__device__ __forceinline__ void widen(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t b = w ^ 0x80808080u;
  lo = pack_bf16x2(byte_to_f32<0>(b), byte_to_f32<1>(b));
  hi = pack_bf16x2(byte_to_f32<2>(b), byte_to_f32<3>(b));
}

__device__ __forceinline__ uint4 load_weights(const int8_t* p, bool in) {
  if (!in) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// y[i] = v in y's type (bf16 or f32; the same for every thread).
__device__ __forceinline__ void store_out(void* y, size_t i, float v,
                                          bool y_bf16) {
  if (y_bf16) {
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(y)[i] = v;
  }
}

// x[0:M, k0:k0 + width] -> shared rows [rows][ld] of kElem-byte values,
// zero past K and past M, kBytes a copy.
template <int kElem, int kBytes>
__device__ __forceinline__ void stage_rows(const unsigned char* x,
                                           unsigned char* dst, int ld, int M,
                                           int K, int rows, int k0,
                                           int width) {
  constexpr int vec = kBytes / kElem;
  const int per_row = width / vec;
  const int valid = min(width, K - k0);            // columns inside K
  // (r, v): row and vector of this thread's copy, stepped by blockDim
  // without a division in the loop
  int r = threadIdx.x / per_row, v = threadIdx.x - r * per_row;
  const int dr = blockDim.x / per_row, dv = blockDim.x - dr * per_row;
  while (r < rows) {
    const int col = v * vec;
    const bool in = r < M && col < valid;
    const unsigned char* src =
        in ? x + (static_cast<size_t>(r) * K + k0 + col) * kElem : x;
    cp_async<kBytes>(dst + (static_cast<size_t>(r) * ld + col) * kElem, src,
                     in);
    v += dv;
    r += dr;
    if (v >= per_row) {
      v -= per_row;
      ++r;
    }
  }
}

// bf16 rows of odd K: 2-byte values, four loads in flight a thread.
__device__ __forceinline__ void stage_rows_b16(const __nv_bfloat16* x,
                                               __nv_bfloat16* dst, int ld,
                                               int M, int K, int rows,
                                               int k0, int width) {
  const int total = rows * width;
  for (int i0 = threadIdx.x; i0 < total; i0 += 4 * blockDim.x) {
    __nv_bfloat16 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      const int r = i / width, col = i - r * width;
      v[u] = i < total && r < M && k0 + col < K
                 ? x[static_cast<size_t>(r) * K + k0 + col]
                 : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < total) {
        const int r = i / width;
        dst[r * ld + (i - r * width)] = v[u];
      }
    }
  }
}

// hi, mid, lo: three bf16 terms whose sum is v (ops/quant_kernels.py
// split_bf16x3, the same roundings).
__device__ __forceinline__ void split3(float v, float& hi, float& mid,
                                       float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(v));
  const float r = v - hi;
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = __bfloat162float(__float2bfloat16_rn(r - mid));
}


// Block of `warps` warps, warp w on the m16 channel tile w of the block's
// 16 x warps channels; x rows: NT n8 tiles.
template <int NT, bool XF32>
__global__ void __launch_bounds__(kMaxWarps * 32)
    int8_linear_kernel(const void* __restrict__ xv,
                       const int8_t* __restrict__ q, int ldq,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, void* __restrict__ y,
                       int y_bf16, int M, int N, int K, int chunks,
                       int xbytes) {
  constexpr int kRows = NT * 8;
  constexpr int kPlanes = XF32 ? 3 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int split = gridDim.x;
  const int s = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ldx = chunks * kChunk + kRowPad;
  const int plane = kRows * ldx;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* after = smem + static_cast<size_t>(kPlanes) * plane * 2;
  float* raw = reinterpret_cast<float*>(after);            // XF32 only
  const int ldr = chunks * kChunk + kRawPad;
  if constexpr (XF32) after += static_cast<size_t>(kRows) * ldr * 4;
  float* part = reinterpret_cast<float*>(after);           // split > 1
  const int tn = warps * 16;
  const int ldp = tn + kPartPad;

  const int total = (K + kChunk - 1) / kChunk;
  const int c_lo = s * total / split, c_hi = (s + 1) * total / split;
  const int n_tile = blockIdx.y * tn;
  const int row0 = n_tile + warp * 16 + g;                 // and row0 + 8
  const bool in0 = row0 < N, in1 = row0 + 8 < N;
  const int8_t* q0 = q + static_cast<size_t>(in0 ? row0 : 0) * ldq + 16 * t;
  const int8_t* q1 =
      q + static_cast<size_t>(in1 ? row0 + 8 : 0) * ldq + 16 * t;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  for (int c0 = c_lo; c0 < c_hi; c0 += chunks) {
    const int nc = min(chunks, c_hi - c0);
    // every weight load of the round first: they land while x is staged
    uint4 w0[kMaxChunks], w1[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int k = (c0 + c) * kChunk + 16 * t;
      const bool in = c < nc && k < K;
      w0[c] = load_weights(q0 + (c0 + c) * kChunk, in && in0);
      w1[c] = load_weights(q1 + (c0 + c) * kChunk, in && in1);
    }
    const int k0 = c0 * kChunk, width = nc * kChunk;
    const unsigned char* xb = static_cast<const unsigned char*>(xv);
    if constexpr (XF32) {
      unsigned char* rb = reinterpret_cast<unsigned char*>(raw);
      if (xbytes == 16) {
        stage_rows<4, 16>(xb, rb, ldr, M, K, kRows, k0, width);
      } else if (xbytes == 8) {
        stage_rows<4, 8>(xb, rb, ldr, M, K, kRows, k0, width);
      } else {
        stage_rows<4, 4>(xb, rb, ldr, M, K, kRows, k0, width);
      }
      cp_async_wait_all();
      __syncthreads();
      // split each staged value once into the three bf16 planes
      const int quads = width / 4;
      for (int i = threadIdx.x; i < kRows * quads; i += blockDim.x) {
        const int r = i / quads;
        const int col = (i - r * quads) * 4;
        const float4 v =
            *reinterpret_cast<const float4*>(raw + r * ldr + col);
        float h[4], m[4], l[4];
        split3(v.x, h[0], m[0], l[0]);
        split3(v.y, h[1], m[1], l[1]);
        split3(v.z, h[2], m[2], l[2]);
        split3(v.w, h[3], m[3], l[3]);
        __nv_bfloat16* d = xs + r * ldx + col;
        *reinterpret_cast<uint2*>(d) =
            make_uint2(pack_bf16x2(h[0], h[1]), pack_bf16x2(h[2], h[3]));
        *reinterpret_cast<uint2*>(d + plane) =
            make_uint2(pack_bf16x2(m[0], m[1]), pack_bf16x2(m[2], m[3]));
        *reinterpret_cast<uint2*>(d + 2 * plane) =
            make_uint2(pack_bf16x2(l[0], l[1]), pack_bf16x2(l[2], l[3]));
      }
    } else {
      unsigned char* xsb = reinterpret_cast<unsigned char*>(xs);
      if (xbytes == 16) {
        stage_rows<2, 16>(xb, xsb, ldx, M, K, kRows, k0, width);
      } else if (xbytes == 4) {
        stage_rows<2, 4>(xb, xsb, ldx, M, K, kRows, k0, width);
      } else {
        stage_rows_b16(static_cast<const __nv_bfloat16*>(xv), xs, ldx, M, K,
                       kRows, k0, width);
      }
      cp_async_wait_all();
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < nc) {
        // A of step st: rows g and g + 8, k 16t + 4st + (0, 1) and (2, 3)
        // of the chunk
        uint32_t a[4][4];
        const uint32_t r0[4] = {w0[c].x, w0[c].y, w0[c].z, w0[c].w};
        const uint32_t r1[4] = {w1[c].x, w1[c].y, w1[c].z, w1[c].w};
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          widen(r0[st], a[st][0], a[st][2]);
          widen(r1[st], a[st][1], a[st][3]);
        }
        // two n8 tiles at a time, their mmas interleaved; each chunk's sums
        // start from zero and join the running f32 sums by an add
#pragma unroll
        for (int j0 = 0; j0 < NT; j0 += 2) {
          constexpr int kPair = NT > 1 ? 2 : 1;
          float d[kPair][4] = {};
#pragma unroll
          for (int p = 0; p < kPlanes; ++p) {
            uint4 b[kPair][2];
#pragma unroll
            for (int jj = 0; jj < kPair; ++jj) {
              // B of step st: x row 8j + g, the same k
              const __nv_bfloat16* src = xs + p * plane +
                                         (8 * (j0 + jj) + g) * ldx +
                                         c * kChunk + 16 * t;
              b[jj][0] = *reinterpret_cast<const uint4*>(src);
              b[jj][1] = *reinterpret_cast<const uint4*>(src + 8);
            }
#pragma unroll
            for (int st = 0; st < 4; ++st) {
#pragma unroll
              for (int jj = 0; jj < kPair; ++jj) {
                const uint4& bb = b[jj][st >> 1];
                mma_bf16(d[jj], a[st], st & 1 ? bb.z : bb.x,
                         st & 1 ? bb.w : bb.y);
              }
            }
          }
#pragma unroll
          for (int jj = 0; jj < kPair; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j0 + jj][e] += d[jj][e];
          }
        }
      }
    }
    if (c0 + chunks < c_hi) __syncthreads();   // the next round restages
  }

  // acc[j][e]: channel row0 + 8 (e / 2), x row 8j + 2t + e % 2
  if (split == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = row0 + 8 * (e >> 1);
        const int m = 8 * j + 2 * t + (e & 1);
        if (n < N && m < M) {
          store_out(y, static_cast<size_t>(m) * N + n,
                    acc[j][e] * scale[n] + (bias != nullptr ? bias[n] : 0.f),
                    y_bf16);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      part[(8 * j + 2 * t + (e & 1)) * ldp + warp * 16 + g + 8 * (e >> 1)] =
          acc[j][e];
    }
  }
  // block s: quads [s * Q / S, (s + 1) * Q / S) of the tile's Q groups of
  // four outputs, each the sum of the S blocks' partials in rank order;
  // (m, cl) steps with o without a division
  const int quads = tn / 4;
  const int outs = M * quads;
  const int o_hi = (s + 1) * outs / split;
  int o = s * outs / split + threadIdx.x;
  int m = o / quads;
  int cl = (o - m * quads) * 4;
  // the first quad's scales and biases, loaded across the barrier
  float sc[4], bi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = n_tile + cl + e;
    const bool in = o < o_hi && n < N;
    sc[e] = in ? scale[n] : 0.f;
    bi[e] = in && bias != nullptr ? bias[n] : 0.f;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int dm = blockDim.x / quads, dq = (blockDim.x - dm * quads) * 4;
  for (bool first = true; o < o_hi; o += blockDim.x, first = false) {
    if (!first) {
      m += dm;
      cl += dq;
      if (cl >= tn) {
        cl -= tn;
        ++m;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n_tile + cl + e;
        sc[e] = n < N ? scale[n] : 0.f;
        bi[e] = n < N && bias != nullptr ? bias[n] : 0.f;
      }
    }
    const int at = m * ldp + cl;
    float4 v[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < split) {
        v[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, r) + at);
      }
    }
    float sum[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
    for (int r = 1; r < kMaxSplit; ++r) {
      if (r < split) {
        sum[0] += v[r].x;
        sum[1] += v[r].y;
        sum[2] += v[r].z;
        sum[3] += v[r].w;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n_tile + cl + e;
      if (n < N) {
        store_out(y, static_cast<size_t>(m) * N + n, sum[e] * sc[e] + bi[e],
                  y_bf16);
      }
    }
  }
  cluster.sync();   // no block leaves while another reads its partials
}

template <int NT, bool XF32>
static int launch(const void* x, const int8_t* q, int ldq, const float* scale,
                  const float* bias, void* y, int y_bf16, int M, int N, int K,
                  int warps, int split, int blocks, int chunks, int smem,
                  int xbytes, cudaStream_t s) {
  auto kernel = int8_linear_kernel<NT, XF32>;
  // the attribute once per instantiation, at the most any launch asks
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(split),
                     static_cast<unsigned>(blocks), 1);
  cfg.blockDim = dim3(static_cast<unsigned>(warps * 32), 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, x, q, ldq, scale, bias, y, y_bf16, M,
                         N, K, chunks, xbytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool XF32>
static int launch_rows(const void* x, const int8_t* q, int ldq,
                       const float* scale, const float* bias, void* y,
                       int y_bf16, int M, int N, int K, int warps, int split,
                       int blocks, int chunks, int smem, int xbytes,
                       cudaStream_t s) {
  if (M <= 8)
    return launch<1, XF32>(x, q, ldq, scale, bias, y, y_bf16, M, N, K, warps,
                           split, blocks, chunks, smem, xbytes, s);
  if (M <= 16)
    return launch<2, XF32>(x, q, ldq, scale, bias, y, y_bf16, M, N, K, warps,
                           split, blocks, chunks, smem, xbytes, s);
  if (M <= 32)
    return launch<4, XF32>(x, q, ldq, scale, bias, y, y_bf16, M, N, K, warps,
                           split, blocks, chunks, smem, xbytes, s);
  return launch<8, XF32>(x, q, ldq, scale, bias, y, y_bf16, M, N, K, warps,
                         split, blocks, chunks, smem, xbytes, s);
}

// The widest copy a staged row takes: 16 bytes where every row starts
// 16-byte aligned, else 4 (bf16) or 8 or 4 (f32); 2 for a bf16 row of odd
// K.
static int copy_bytes(const void* x, int64_t K, int esize) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(x);
  const int64_t row = K * esize;
  if (row % 16 == 0 && at % 16 == 0) return 16;
  if (esize == 4 && row % 8 == 0 && at % 8 == 0) return 8;
  if (row % 4 == 0 && at % 4 == 0) return 4;
  return 2;
}

// x (M, K) f32 or bf16, contiguous; q (N, ldq) int8, ldq >= K and a
// multiple of 16, 16-byte aligned; scale (N,) f32; bias (N,) f32 or null;
// y (M, N) f32 or bf16, contiguous. warps, split, blocks and chunks: the
// plan's (ops/quant_kernels.py int8_linear_plan), launched on a grid of
// (split, blocks); the shared memory follows from them here.
extern "C" int int8_linear(const void* x, int x_bf16, const void* q,
                           int64_t ldq, const void* scale, const void* bias,
                           void* y, int y_bf16, int64_t M, int64_t N,
                           int64_t K, int warps, int split, int blocks,
                           int chunks, void* stream) {
  const int rows = M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64;
  if (M < 1 || M > kMaxRows || N < 1 || K < 1 || ldq < K || ldq % 16 ||
      N > (1 << 20) || ldq > 2147483647 ||
      reinterpret_cast<uintptr_t>(q) % 16 || warps < 1 ||
      warps > kMaxWarps || split < 1 || split > kMaxSplit || chunks < 1 ||
      chunks > kMaxChunks || static_cast<int64_t>(blocks) * warps * 16 < N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = int8_smem_bytes(rows, warps, split, chunks, !x_bf16);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int xbytes = copy_bytes(x, K, x_bf16 ? 2 : 4);
  if (!x_bf16 && xbytes < 4) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(M), n = static_cast<int>(N);
  const int k = static_cast<int>(K), l = static_cast<int>(ldq);
  const int b = static_cast<int>(smem);
  return x_bf16 ? launch_rows<false>(x, qp, l, sp, bp, y, y_bf16, m, n, k,
                                     warps, split, blocks, chunks, b, xbytes,
                                     s)
                : launch_rows<true>(x, qp, l, sp, bp, y, y_bf16, m, n, k,
                                    warps, split, blocks, chunks, b, xbytes,
                                    s);
}
