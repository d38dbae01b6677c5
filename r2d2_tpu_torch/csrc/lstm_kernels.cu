// Hand-written Hopper kernels for the LSTM time scan: the residual forward,
// the lean forward and the reverse-time backward.
//
// Replaces r2d2_tpu/ops/pallas_lstm.py:
//   * _fwd_call (K4; bodies _fwd_kernel and _fwd_kernel_lean) by lstm_fwd;
//   * _bwd_call (K5; body _bwd_kernel) by lstm_bwd.
// Plain C interface, loaded with ctypes (r2d2_tpu_torch/ops/_build.py and
// ops/lstm_kernels.py). Every entry point launches on the caller's stream,
// allocates nothing (outputs and the barrier counter come from the wrapper)
// and returns the CUDA error of the launch so the wrapper can raise.
//
// Layout is the JAX package's: xpb (T, B, 4H) with the bias folded in, Wh
// (H, 4H), c0/h0 (B, H), gate order i, f, g, o. All inputs share one type,
// float32 or bfloat16, which is both the storage and the compute type.
//
// Arithmetic (the Pallas kernels'): gates = f32(xpb_t) + cd(h) @ Wh summed in
// f32; gate math and the c/h carries in f32; every output rounded once to
// the storage type. The backward reads its gate grads back through the
// storage type for both products, h_prev from hseq[t-1] (h0 at t = 0), and
// sums dWh in f32.
//
// What bounds it: the serial chain. At the reference shape (T=55, B=128,
// H=512) the whole scan is 14.8 GFLOP forward and 29.5 backward, ~38-87 MB
// of traffic: 15-30 us of roofline in bf16, but every step waits for the
// previous one's h (forward) or gate grads (backward), so 55 dependencies
// between blocks set the floor, and the time of a step is what sits on it:
// the wait, the rows a block must pull through L2 and its share of the
// products.
//
// Both kernels are ONE persistent cooperative launch (every block resident,
// one per SM) on the same partition (ScanTile<T>: bf16 16 rows x 32 units,
// f32 32 x 16): block slot * groups + group owns hidden units [units group,
// units (group + 1)) of the batch tiles slot, slot + slots, ... A step of
// batch row b needs only row b of the previous step's plane, so the blocks
// of one slot wait only on each other, on their own barrier counter (an
// atomic arrive and a volatile spin on a global counter, no -rdc needed).
//
// Forward, the counterpart of "Wh resident, carries never in HBM": a block
// keeps in shared memory, for the whole scan, its Wh columns (4 gates x its
// units, all H rows of k; 130 KB bf16 at H=512) and its f32 c carries. Per
// step it stages only its tile's rows of h_{t-1} (hseq[t-1] as stored, which
// is exactly the cd(h) the product consumes; 2 MB across the grid in bf16)
// by cp.async.cg, runs the product on the tensor cores in bf16 (mma.sync
// m16n8k16, operands by ldmatrix, the columns laid out so that a lane's
// accumulators hold the four gates of one unit: gate math and carries stay
// in registers; f32 keeps FMAs), stores h_t, arrives, and only then stores
// the residuals and loads the next step's xpb values. What bounds it now is
// latency on the chain, not work: on an H100 SXM (700 W) a bf16 step at the
// reference shape takes ~5 us, of which ~1 the wait, ~1 the L2 round trip
// of the staging, ~0.7 the product and ~1.7-2.2 the gate math, the h_t
// stores and the fence before arriving.
//
// Backward: the chain holds only what the next step needs. dWh, which no
// step needs, is one tensor-core product over all T*B rows after the scan.
// Per step a block reads its rows of dxpb[t] (8 MB across the grid in bf16)
// into a per-warp cp.async ring and runs dh on the tensor cores in bf16
// (f32 keeps FMAs).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o liblstm_kernels.so lstm_kernels.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <mutex>
#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilePairs = 512;  // (row, unit) pairs a block owns per tile
constexpr int kPadK = 16;        // the forward's k padded to the mma's depth

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Loads through L2 only: for data other blocks wrote during this launch (the
// SM's L1 is not coherent with their stores).
__device__ __forceinline__ float ldcg_raw(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ldcg_raw(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Barrier on a global counter, split so that a block can do local work
// between arriving and waiting. The blocks that share a counter arrive once
// per barrier; ``target`` = those blocks x barriers so far. The counter only grows (the wrapper zeroes it
// per launch), so no sense flag is needed. Every thread fences its own
// stores before the block arrives; the spin reads through a volatile
// pointer.
__device__ __forceinline__ void grid_arrive(unsigned int* counter) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(counter, 1u);
}

__device__ __forceinline__ void grid_wait(unsigned int* counter,
                                          unsigned int target) {
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<volatile unsigned int*>(counter) < target) {
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The partition of both kernels: batch rows of a tile and hidden units of a
// group. bf16: 16 x 32, so a block reads 16 rows of h (forward) or dxpb[t]
// (backward) a step and its share of Wh is 128 KB at H=512; f32: 32 x 16
// (f32 Wh of 32 units would not fit).
template <typename T>
struct ScanTile {
  static constexpr int rows = sizeof(T) == 2 ? 16 : 32;
  static constexpr int units = kTilePairs / rows;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte chunk of a row (16 / sizeof(T) values) into shared memory:
// the first ``count`` values from ``src`` through L2, the rest zero. kVec:
// cp.async.cg (count is 0 or the whole chunk; src-size 0 zero-fills), else
// element by element.
template <typename T, bool kVec>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int count) {
  if constexpr (kVec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(count > 0 ? 16 : 0));
  } else {
    constexpr int n = 16 / sizeof(T);
#pragma unroll
    for (int e = 0; e < n; ++e) {
      dst[e] = e < count ? ldcg_raw(src + e) : from_f<T>(0.f);
    }
  }
}

// Bring the line of ``p`` into L1 (data no block writes during the launch).
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores: 16x16 bf16 A (row), 16x8 bf16 B (col),
// f32 sums.
// ``c`` points at four accumulators (indexed at compile time, so they stay
// in registers).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Forward, t = 0 .. T-1.
//
// Block (slot, group) = blockIdx.x / groups, blockIdx.x % groups (the
// partition above). Shared memory (FwdSmem): the block's Wh share, 4 gates
// x its units, all H rows of k padded to 16 (fwd_w_index: bf16 [column][k
// + one 16-byte chunk] in the column order of fwd_column, f32 [gate][k / 4]
// [unit][4]); one staged tile of h_{t-1} [rows][k + a chunk]; the c
// carries [tiles][2 pairs x kThreads] f32; f32 only, the two k halves'
// partial sums exchanged [8][kThreads]; the first tile's xpb values of a
// step [4 gates][rows][units]. A thread owns two (row, unit) pairs
// of each tile (fwd_row, fwd_pair_unit). Per step:
//   wait: the slot's blocks have written hseq[t-1] (not at t = 0: h0);
//   per tile: its rows of h_{t-1} staged, the product, the gate math, h_t
//     stored;
//   arrive at the slot's counter; then, off the chain, the last tile's
//   residuals (cseq, acts) and the next step's xpb values of the own pairs:
//   the first tile's into shared memory by cp.async (they land by the next
//   staging's wait), the others' into L1.
// hseq[t] is a plane of its own that no later step writes, so one counter
// per slot and one staging buffer are enough. The lean variant writes c_fin
// from its own carries after the last step.
//
// bf16 product: warp w owns 16 columns = units 4w .. 4w+3 x 4 gates, n tile
// 2w holding their (i, f) pairs and n tile 2w+1 their (g, o) pairs, so that
// a lane's accumulators hold the four gates of one unit for rows lane/4 and
// lane/4 + 8: gate math and carries need no exchange. The B operands of the
// first kRegSlices 16-slices of k stay in registers for the whole scan (a
// step reads only the h rows from shared memory); k in two accumulator
// chains of alternate slices. f32 product: FMAs, thread (k half, row
// quad, unit) computing 4 rows x the unit's 4 gates over its half of k
// (the Wh reads of a warp are 16 consecutive 16-byte chunks, its h reads two
// broadcasts); the halves then swap the two rows the other owns.

constexpr int kRegSlices = 32;   // bf16 16-slices of k whose B is in registers

// bf16: the column of (unit, gate) in the block's Wh share (the interleaved
// order described above).
__host__ __device__ constexpr int fwd_column(int unit, int gate) {
  return unit / 4 * 16 + gate / 2 * 8 + unit % 4 * 2 + gate % 2;
}

// Where value k of (unit, gate) of the block's Wh share lies in w_s: bf16
// [fwd_column][stride], f32 [gate][k / 4][unit][4].
template <typename T>
__device__ __forceinline__ int fwd_w_index(int unit, int gate, int k, int kp,
                                           int stride) {
  if constexpr (sizeof(T) == 2) {
    return fwd_column(unit, gate) * stride + k;
  } else {
    return ((gate * (kp / 4) + k / 4) * 16 + unit) * 4 + k % 4;
  }
}

// Value e of a 16-byte chunk held raw.
template <typename T>
__device__ __forceinline__ T chunk_value(const uint4& v, int e) {
  const int i = e * (int)sizeof(T) / 4;
  const unsigned int w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w);
  } else {
    return __ushort_as_bfloat16(
        static_cast<unsigned short>(e % 2 ? w >> 16 : w & 0xffffu));
  }
}

// Pair p (0 or 1) of thread ``tid`` in a tile: its row and its unit within
// the group. bf16: the accumulator rows lane/4 and lane/4 + 8 of unit
// 4 warp + lane % 4; f32: rows (tid % 128) / 16 + 8 (2 (tid / 128) + p)
// of unit tid % 16.
template <typename T>
__device__ __forceinline__ int fwd_row(int tid, int p) {
  return sizeof(T) == 2 ? tid % 32 / 4 + 8 * p
                        : tid % 128 / 16 + 8 * (2 * (tid / 128) + p);
}
template <typename T>
__device__ __forceinline__ int fwd_pair_unit(int tid, int) {
  return sizeof(T) == 2 ? tid / 32 * 4 + tid % 4 : tid % 16;
}

// Byte offsets into the forward's dynamic shared memory; ``end`` is its
// size (the wrapper's fwd_geometry computes the same number).
template <typename T>
struct FwdSmem {
  int64_t w, h, c, red, x, end;
  __host__ __device__ FwdSmem(int hidden, int tiles) {
    constexpr int64_t n = 16 / sizeof(T), e = sizeof(T);
    const int64_t kp = (hidden + kPadK - 1) / kPadK * kPadK;
    constexpr int64_t cols = 4 * ScanTile<T>::units;
    w = 0;
    h = w + cols * (sizeof(T) == 2 ? kp + n : kp) * e;
    c = h + (int64_t)ScanTile<T>::rows * (kp + n) * e;
    red = c + (int64_t)tiles * kTilePairs * 4;
    x = red + (sizeof(T) == 2 ? 0 : 8LL * kThreads * 4);
    end = x + 4LL * kTilePairs * e;
  }
};

// Rows b0 .. b0 + rows of a (batch, hidden) plane that other blocks wrote,
// as stored, into h_s [rows][stride] through L2: k padded with zeros to kp,
// rows past the batch zero. Returns once every thread's copies landed.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_tile(const T* src, int b0, int batch,
                                           int hidden, int kp, T* h_s,
                                           int stride) {
  constexpr int n = 16 / sizeof(T), rows = ScanTile<T>::rows;
  const int per_row = kp / n;
  for (int c = threadIdx.x; c < rows * per_row; c += kThreads) {
    const int r = c / per_row, k = c % per_row * n, b = b0 + r;
    const int count = b < batch ? max(0, min(n, hidden - k)) : 0;
    copy_chunk<T, kVec>(h_s + r * stride + k,
                        count > 0 ? src + (int64_t)b * hidden + k : src,
                        count);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// pre[p][gate] = cd(h_s rows) . the Wh share for the thread's two pairs,
// summed in f32 (the header above says how). ``wreg``: bf16, the warp's B
// operands of the first kRegSlices slices; ``red``: f32, the exchange.
template <typename T, int R>
__device__ __forceinline__ void fwd_product(const T* h_s, const T* w_s,
                                            int stride, int kp,
                                            const uint32_t (&wreg)[R][4],
                                            float* red, float (&pre)[2][4]) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if constexpr (sizeof(T) == 2) {
    const int r8 = lane % 8, j = lane / 8;
    const T* a = h_s + (r8 + j % 2 * 8) * stride + j / 2 * 8;
    float acc[2][8];   // [chain][n tile * 4 + accumulator]
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[0][i] = acc[1][i] = 0.f;
    auto slice = [&](float* c, int s, const uint32_t (&bf)[4]) {
      uint32_t af[4];
      ldsm_x4(af, a + s * kPadK);
      mma_bf16(c, af, bf[0], bf[1]);
      mma_bf16(c + 4, af, bf[2], bf[3]);
    };
    const int slices = kp / kPadK;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (s < slices) slice(acc[s % 2], s, wreg[s]);
    }
    // slices past the registers: their B from shared memory
    const T* b = w_s + (warp * 16 + r8 + j / 2 * 8) * stride + j % 2 * 8;
    for (int s = R; s < slices; s += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + s * kPadK);
      slice(acc[0], s, bf);
      if (s + 1 < slices) {
        ldsm_x4(bf, b + (s + 1) * kPadK);
        slice(acc[1], s + 1, bf);
      }
    }
    // n tile 0: rows g, g+8 x (i, f); n tile 1: the same rows x (g, o)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      pre[p][0] = acc[0][2 * p] + acc[1][2 * p];
      pre[p][1] = acc[0][2 * p + 1] + acc[1][2 * p + 1];
      pre[p][2] = acc[0][4 + 2 * p] + acc[1][4 + 2 * p];
      pre[p][3] = acc[0][5 + 2 * p] + acc[1][5 + 2 * p];
    }
  } else {
    const int half = tid / 128, uu = tid % 16, rq = tid % 128 / 16;
    const int kh = kp / 2, k0 = half * kh;
    const float* h = reinterpret_cast<const float*>(h_s) + rq * stride;
    const float* w = reinterpret_cast<const float*>(w_s) + uu * 4;
    float acc[4][4];   // [row rq + 8 i][gate]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;
    }
#pragma unroll 2
    for (int k = k0; k < k0 + kh; k += 4) {
      float4 x[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = *reinterpret_cast<const float4*>(h + 8 * i * stride + k);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        v[g] = *reinterpret_cast<const float4*>(w + (g * (kp / 4) + k / 4) *
                                                        64);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[i][g] = fmaf(x[i].x, v[g].x, acc[i][g]);
          acc[i][g] = fmaf(x[i].y, v[g].y, acc[i][g]);
          acc[i][g] = fmaf(x[i].z, v[g].z, acc[i][g]);
          acc[i][g] = fmaf(x[i].w, v[g].w, acc[i][g]);
        }
      }
    }
    // this thread keeps rows i = 2 half + p; thread tid ^ 128, the other
    // half of k for the same (row quad, unit), keeps the other two
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        red[(p * 4 + g) * kThreads + (tid ^ 128)] =
            half ? acc[p][g] : acc[2 + p][g];
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        pre[p][g] = (half ? acc[2 + p][g] : acc[p][g]) +
                    red[(p * 4 + g) * kThreads + tid];
      }
    }
  }
}

// One block per SM: without the 1, ptxas would squeeze the f32 variants
// into 128 registers (room for a second block that shared memory forbids)
// and spill.
template <typename T, bool kVec, bool kResiduals>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_fwd_kernel(const T* __restrict__ xpb, const T* __restrict__ wh,
                    const T* __restrict__ c0, const T* __restrict__ h0,
                    T* hseq, T* __restrict__ cseq, T* __restrict__ acts,
                    T* __restrict__ cfin, unsigned int* barrier, int steps,
                    int batch, int hidden, int slots) {
  constexpr int rows = ScanTile<T>::rows, units = ScanTile<T>::units;
  constexpr int cols = 4 * units;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int gdim = 4 * hidden;
  const int kp = (hidden + kPadK - 1) / kPadK * kPadK;
  const int stride = kp + 16 / (int)sizeof(T);
  const int64_t plane = (int64_t)batch * hidden;
  const int groups = gridDim.x / slots;
  const int slot = blockIdx.x / groups, u0 = blockIdx.x % groups * units;
  const int ntiles = (batch + rows - 1) / rows;
  // the block's tiles that lie inside the batch (its last may not)
  const int mine = (ntiles - slot + slots - 1) / slots;
  const FwdSmem<T> lay(hidden, (ntiles + slots - 1) / slots);
  T* w_s = reinterpret_cast<T*>(smem + lay.w);
  T* h_s = reinterpret_cast<T*>(smem + lay.h);
  float* c_s = reinterpret_cast<float*>(smem + lay.c);
  float* red_s = reinterpret_cast<float*>(smem + lay.red);
  T* x_s = reinterpret_cast<T*>(smem + lay.x);
  const int tid = threadIdx.x;

  // the own Wh share, k padded with zeros. kVec: chunks of n units of one
  // gate at one k, one 16-byte load each, eight in flight per thread
  constexpr int n = 16 / sizeof(T), per_k = cols / n;
  if constexpr (kVec) {
    for (int q0 = tid; q0 < kp * per_k; q0 += 8 * kThreads) {
      uint4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = q0 + i * kThreads, k = q / per_k;
        const int gate = q % per_k / (units / n), uu = q % (units / n) * n;
        v[i] = make_uint4(0u, 0u, 0u, 0u);
        if (q < kp * per_k && k < hidden && u0 + uu < hidden) {
          v[i] = __ldg(reinterpret_cast<const uint4*>(
              wh + (int64_t)k * gdim + gate * hidden + u0 + uu));
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = q0 + i * kThreads, k = q / per_k;
        const int gate = q % per_k / (units / n), uu = q % (units / n) * n;
        if (q >= kp * per_k) break;
#pragma unroll
        for (int e = 0; e < n; ++e) {
          w_s[fwd_w_index<T>(uu + e, gate, k, kp, stride)] =
              chunk_value<T>(v[i], e);
        }
      }
    }
  } else {
    for (int idx = tid; idx < cols * kp; idx += kThreads) {
      const int uu = idx % units, gate = idx / units % 4, k = idx / cols;
      const int u = u0 + uu;
      w_s[fwd_w_index<T>(uu, gate, k, kp, stride)] =
          k < hidden && u < hidden ? wh[(int64_t)k * gdim + gate * hidden + u]
                                   : from_f<T>(0.f);
    }
  }
  int prow[2], pu[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    prow[p] = fwd_row<T>(tid, p);
    pu[p] = u0 + fwd_pair_unit<T>(tid, p);
  }
  // pair p of tile j: row (slot + j slots) rows + prow[p], unit pu[p]; its c
  // carry is c_s[(j kThreads + tid) 2 + p]
  auto row_of = [&](int j, int p) {
    return (slot + j * slots) * rows + prow[p];
  };
  for (int j = 0; j < mine; ++j) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int b = row_of(j, p);
      c_s[(j * kThreads + tid) * 2 + p] =
          b < batch && pu[p] < hidden
              ? to_f(c0[(int64_t)b * hidden + pu[p]])
              : 0.f;
    }
  }
  __syncthreads();
  // bf16: the warp's B operands of the first kRegSlices slices of k
  uint32_t wreg[sizeof(T) == 2 ? kRegSlices : 1][4];
  if constexpr (sizeof(T) == 2) {
    const int lane = tid % 32, r8 = lane % 8, j = lane / 8;
    const T* b = w_s + (tid / 32 * 16 + r8 + j / 2 * 8) * stride + j % 2 * 8;
#pragma unroll
    for (int s = 0; s < kRegSlices; ++s) {
      if (s * kPadK < kp) ldsm_x4(wreg[s], b + s * kPadK);
    }
  }

  // cseq and acts of one pair: v = (i, f, g, o, c)
  auto residuals = [&](int64_t row, int u, const float* v) {
    cseq[row * hidden + u] = from_f<T>(v[4]);
    T* a = acts + row * gdim + u;
#pragma unroll
    for (int g = 0; g < 4; ++g) a[g * hidden] = from_f<T>(v[g]);
  };
  // the xpb values of tile j's pairs at step t
  auto load_x = [&](int t, int j, float (&x)[2][4]) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int b = row_of(j, p);
      const T* xp = xpb + ((int64_t)t * batch + b) * gdim + pu[p];
      const bool own = b < batch && pu[p] < hidden;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[p][g] = own ? to_f(xp[g * hidden]) : 0.f;
    }
  };
  // the first tile's xpb values at step t into x_s [gate][rows][units],
  // 16-byte chunks; they land by the next cp_async_wait
  auto stage_x = [&](int t) {
    constexpr int per_row = units / n;
    const int b0 = slot * rows;
    for (int c = tid; c < 4 * rows * per_row; c += kThreads) {
      const int g = c / (rows * per_row), r = c / per_row % rows;
      const int uu = c % per_row * n, b = b0 + r;
      const int count = b < batch ? max(0, min(n, hidden - u0 - uu)) : 0;
      const T* src = xpb + ((int64_t)t * batch + b) * gdim + g * hidden + u0 + uu;
      copy_chunk<T, kVec>(x_s + (g * rows + r) * units + uu,
                          count > 0 ? src : xpb, count);
    }
    cp_async_commit();
  };
  float keep[2][5];   // the last tile's gates and c, stored after arriving
  stage_x(0);
  for (int t = 0; t < steps; ++t) {
    if (t > 0) {
      grid_wait(barrier + slot, (unsigned int)t * groups);
    }
    const T* hprev = t == 0 ? h0 : hseq + (int64_t)(t - 1) * plane;
    for (int j = 0; j < mine; ++j) {
      const int b0 = (slot + j * slots) * rows;
      float x[2][4];
      if (j > 0) load_x(t, j, x);
      stage_tile<T, kVec>(hprev, b0, batch, hidden, kp, h_s, stride);
      float pre[2][4];
      fwd_product<T>(h_s, w_s, stride, kp, wreg, red_s, pre);
      if (j + 1 < mine) __syncthreads();   // h_s is restaged for tile j + 1
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int b = row_of(j, p);
        if (b >= batch || pu[p] >= hidden) continue;
        if (j == 0) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            x[p][g] = to_f(x_s[(g * rows + prow[p]) * units + pu[p] - u0]);
          }
        }
        float* v = keep[p];
        v[0] = sigmoid(x[p][0] + pre[p][0]);
        v[1] = sigmoid(x[p][1] + pre[p][1]);
        v[2] = tanhf(x[p][2] + pre[p][2]);
        v[3] = sigmoid(x[p][3] + pre[p][3]);
        float* cc = c_s + (j * kThreads + tid) * 2 + p;
        v[4] = v[1] * *cc + v[0] * v[2];
        *cc = v[4];
        const int64_t row = (int64_t)t * batch + b;
        hseq[row * hidden + pu[p]] = from_f<T>(v[3] * tanhf(v[4]));
        if (kResiduals && j + 1 < mine) residuals(row, pu[p], v);
      }
    }
    if (t + 1 < steps) grid_arrive(barrier + slot);
    // off the chain
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int b = row_of(mine - 1, p);
      if (kResiduals && b < batch && pu[p] < hidden) {
        residuals((int64_t)t * batch + b, pu[p], keep[p]);
      }
    }
    if (t + 1 < steps) stage_x(t + 1);
    for (int j = 1; t + 1 < steps && j < mine; ++j) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int b = row_of(j, p);
        if (b >= batch || pu[p] >= hidden) continue;
        const T* xp = xpb + ((int64_t)(t + 1) * batch + b) * gdim + pu[p];
#pragma unroll
        for (int g = 0; g < 4; ++g) prefetch_l1(xp + g * hidden);
      }
    }
  }  // next forward step
  if (!kResiduals) {
    for (int j = 0; j < mine; ++j) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int b = row_of(j, p);
        if (b < batch && pu[p] < hidden) {
          cfin[(int64_t)b * hidden + pu[p]] =
              from_f<T>(c_s[(j * kThreads + tid) * 2 + p]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, t = T-1 .. 0, then dWh.
//
// Partition (ScanTile<T>: bf16 16 rows x 32 units, f32 32 x 16): block
// (slot, group) = blockIdx.x / groups, blockIdx.x % groups owns hidden units
// [units group, units (group + 1)) of the batch tiles (``rows`` rows each)
// slot, slot + slots, ...: a step of batch row b needs only row b of
// dxpb[t], so the blocks of one slot wait only on each other, on their own
// barrier counter (counter ``slot``; counter ``slots`` is the grid's, for
// dWh). ``slots`` is chosen by the wrapper so that the grid is resident.
// Shared memory (BwdSmem): the block's Wh rows [units][4H padded to 16, +
// one 16-byte chunk]; per warp a ring of dx slices [rows][16 k, + a chunk];
// partial dh per warp [rows][units] f32; the dh and dc carries per tile
// [rows][units] f32. Per step:
//   A. thread (row, unit) turns dh/dc into the pre-activation gate grads of
//      its rows, writes them to dxpb[t] (storage type); the block arrives at
//      its slot's barrier;
//   wait: the slot's rows of dxpb[t] are written;
//   B. dh[rows, units] = cd(dxpb[t][rows, :]) . Wh[units, :]^T, the
//      4H of k split over the warps, each streaming 16-wide slices through
//      its ring by cp.async.cg; bf16 on the tensor cores (mma.sync
//      m16n8k16, operands by ldmatrix), f32 as FMAs; the warps' partials are
//      summed through shared memory in a fixed order.
// Step t-1 writes other rows of dxpb, so one barrier per step is enough.
// After the last step a grid barrier, then dWh = sum over rows (t, b) of
// cd(h_prev)[row, :]^T cd(dxpb)[row, :], h_prev = [h0; hseq[:-1]]: one
// product of (T B) rows, (128 x 128 output tile, half of the rows) items
// walked by the blocks, rows streamed 32 at a time through a 4-deep ring
// (both operands with the rows as the reduction dimension:
// ldmatrix.trans); each half adds its sum to the zeroed dWh.

constexpr int kDhK = 16;         // k of one staged dx slice
constexpr int kTail = 128;       // dWh output tile kTail x kTail
constexpr int kTailK = 32;       // rows (t, b) per staged dWh slice
constexpr int kTailStages = 4;

// dx slices in flight per warp (shared memory sets the f32 depth)
template <typename T>
__host__ __device__ constexpr int dh_stages() {
  return sizeof(T) == 2 ? 8 : 3;
}

// Byte offsets into the backward's dynamic shared memory; ``end`` is its
// size (the wrapper's bwd_geometry computes the same number).
template <typename T>
struct BwdSmem {
  int64_t w, ring, red, dh, dc, end;
  __host__ __device__ BwdSmem(int hidden, int tiles) {
    constexpr int64_t n = 16 / sizeof(T), e = sizeof(T);
    const int64_t kp = (4LL * hidden + kDhK - 1) / kDhK * kDhK;
    const int64_t rows = ScanTile<T>::rows, pairs = kTilePairs;
    w = 0;
    ring = w + ScanTile<T>::units * (kp + n) * e;
    red = ring + (int64_t)kWarps * dh_stages<T>() * rows * (kDhK + n) * e;
    dh = red + kWarps * pairs * 4;
    dc = dh + tiles * pairs * 4;
    const int64_t steps_end = dc + tiles * pairs * 4;
    const int64_t tail_end =
        (int64_t)kTailStages * kTailK * 2 * (kTail + n) * e;
    end = steps_end > tail_end ? steps_end : tail_end;
  }
};

// This warp's share of dh[rows, units] = cd(dx[rows b0.., :]) .
// W[units, :]^T (ScanTile<T>), where dx is dxpb[t] (batch, gdim) and w_s the
// block's Wh rows [units][wstride]: k slices warp, warp + kWarps, ... of 16
// each, staged through ``ring`` (dh_stages slices, all but one in flight).
// The partial sums go to red [rows][units]. bf16: one 16-row m tile x four
// 8-unit n tiles per slice on the tensor cores; f32: lane = row, FMAs.
template <typename T, bool kVec>
__device__ __forceinline__ void dh_partial(const T* dx, int b0, int batch,
                                           int gdim, int ksteps,
                                           const T* w_s, int wstride,
                                           T* ring, float* red) {
  constexpr int rows = ScanTile<T>::rows, units = ScanTile<T>::units;
  constexpr int n = 16 / sizeof(T), per_row = kDhK / n;
  constexpr int sstride = kDhK + n, stages = dh_stages<T>();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mine = (ksteps - warp + kWarps - 1) / kWarps;
  auto load = [&](int i) {
    if (i < mine) {
      const int k0 = (warp + i * kWarps) * kDhK;
      T* slot = ring + (i % stages) * rows * sstride;
#pragma unroll
      for (int q = 0; q < rows * per_row / 32; ++q) {
        const int c = q * 32 + lane, r = c / per_row;
        const int col = (c % per_row) * n, b = b0 + r, k = k0 + col;
        const int count = b < batch ? max(0, min(n, gdim - k)) : 0;
        copy_chunk<T, kVec>(slot + r * sstride + col,
                            count > 0 ? dx + (int64_t)b * gdim + k : dx,
                            count);
      }
    }
    cp_async_commit();
  };

  float acc[16];   // bf16: [4 n tiles][4]; f32: one per unit
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < stages - 1; ++i) load(i);
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<stages - 2>();
    __syncwarp();                 // slice i landed; slice i-1 is consumed
    load(i + stages - 1);
    const T* a = ring + (i % stages) * rows * sstride;
    const int k0 = (warp + i * kWarps) * kDhK;
    if constexpr (sizeof(T) == 2) {
      const int r8 = lane % 8, j = lane / 8;
      uint32_t af[4], bf[2][4];
      ldsm_x4(af, a + (r8 + (j % 2) * 8) * sstride + (j / 2) * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        ldsm_x4(bf[p], w_s + (p * 16 + r8 + (j / 2) * 8) * wstride + k0 +
                           (j % 2) * 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_bf16(acc + nt * 4, af, bf[nt / 2][(nt % 2) * 2],
                 bf[nt / 2][(nt % 2) * 2 + 1]);
      }
    } else {
      const float* row = reinterpret_cast<const float*>(a) + lane * sstride;
      const float* w = reinterpret_cast<const float*>(w_s) + k0;
#pragma unroll
      for (int kk = 0; kk < kDhK; kk += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + kk);
#pragma unroll
        for (int uu = 0; uu < units; ++uu) {
          const float4 v =
              *reinterpret_cast<const float4*>(w + uu * wstride + kk);
          acc[uu] = fmaf(x.x, v.x, acc[uu]);
          acc[uu] = fmaf(x.y, v.y, acc[uu]);
          acc[uu] = fmaf(x.z, v.z, acc[uu]);
          acc[uu] = fmaf(x.w, v.w, acc[uu]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (sizeof(T) == 2) {
    // accumulator nt: rows lane/4 (+8), units nt*8 + 2(lane%4) (+1)
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* c = acc + nt * 4;
      float* o = red + g * units + nt * 8 + 2 * q;
      o[0] = c[0];
      o[1] = c[1];
      o[8 * units] = c[2];
      o[8 * units + 1] = c[3];
    }
  } else {
    float4* o = reinterpret_cast<float4*>(red + lane * units);
#pragma unroll
    for (int q = 0; q < units / 4; ++q) {
      o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                         acc[4 * q + 3]);
    }
  }
}

// One half of dWh[m0 + 128, n0 + 128]: the sum over rows (t, b) in
// [r0, r1) of cd(h_prev)[row, m] cd(dxpb)[row, n], with h_prev row =
// h0[row] for row < batch, else hseq[row - batch], added to dwh (zeroed;
// the other half of the rows adds the other term, and a sum of two terms
// onto zero does not depend on their order). Rows are staged kTailK at a
// time through a ring of kTailStages in ``smem``. bf16: warp (wm, wn) of
// 2 x 4 owns 64 x 32 of the tile as 4 x 4 mma tiles; f32: thread (tm, tn)
// of 16 x 16 owns 8 x 8 outputs as FMAs.
template <typename T, bool kVec>
__device__ void dwh_tile(const T* hseq, const T* h0, const T* dxpb,
                         float* dwh, int r0, int r1, int batch, int hidden,
                         int m0, int n0, T* smem) {
  constexpr int n = 16 / sizeof(T), s = kTail + n;   // staged row stride
  constexpr int per_row = kTail / n, half = kTailK * per_row;
  T* ring_a = smem;
  T* ring_b = smem + kTailStages * kTailK * s;
  const int gdim = 4 * hidden, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int slices = (r1 - r0 + kTailK - 1) / kTailK;
  auto load = [&](int i) {
    if (i < slices) {
      T* da = ring_a + (i % kTailStages) * kTailK * s;
      T* db = ring_b + (i % kTailStages) * kTailK * s;
      for (int c = tid; c < 2 * half; c += kThreads) {
        const int cc = c % half, r = cc / per_row, col = (cc % per_row) * n;
        const int row = r0 + i * kTailK + r;
        if (c < half) {
          const int m = m0 + col;
          const int count = row < r1 ? max(0, min(n, hidden - m)) : 0;
          const T* src = count == 0 ? h0
                         : row < batch
                             ? h0 + (int64_t)row * hidden + m
                             : hseq + (int64_t)(row - batch) * hidden + m;
          copy_chunk<T, kVec>(da + r * s + col, src, count);
        } else {
          const int nn = n0 + col;
          const int count = row < r1 ? max(0, min(n, gdim - nn)) : 0;
          copy_chunk<T, kVec>(
              db + r * s + col,
              count > 0 ? dxpb + (int64_t)row * gdim + nn : dxpb, count);
        }
      }
    }
    cp_async_commit();
  };

  float acc[64];   // bf16: [4 m tiles][4 n tiles][4]; f32: [8 m][8 n]
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTailStages - 1; ++i) load(i);
  for (int i = 0; i < slices; ++i) {
    cp_async_wait<kTailStages - 2>();
    __syncthreads();              // slice i landed; slice i-1 is consumed
    load(i + kTailStages - 1);
    const T* a = ring_a + (i % kTailStages) * kTailK * s;
    const T* b = ring_b + (i % kTailStages) * kTailK * s;
    if constexpr (sizeof(T) == 2) {
      const int wm = warp / 4, wn = warp % 4, r8 = lane % 8, j = lane / 8;
#pragma unroll
      for (int ks = 0; ks < kTailK / 16; ++ks) {
        uint32_t af[4][4], bfr[2][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          ldsm_x4_trans(af[mt], a + (ks * 16 + r8 + (j / 2) * 8) * s +
                                    wm * 64 + mt * 16 + (j % 2) * 8);
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          ldsm_x4_trans(bfr[p], b + (ks * 16 + r8 + (j % 2) * 8) * s +
                                    wn * 32 + p * 16 + (j / 2) * 8);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_bf16(acc + (mt * 4 + nt) * 4, af[mt],
                     bfr[nt / 2][(nt % 2) * 2],
                     bfr[nt / 2][(nt % 2) * 2 + 1]);
          }
        }
      }
    } else {
      // rows (tid / 16) * 4 and 64 + that, columns likewise with tid % 16:
      // the float4 reads of 8 lanes cover 128 contiguous bytes
      const float* af = reinterpret_cast<const float*>(a) + (tid / 16) * 4;
      const float* bf = reinterpret_cast<const float*>(b) + (tid % 16) * 4;
#pragma unroll 2
      for (int kk = 0; kk < kTailK; ++kk) {
        const float4 x0 = *reinterpret_cast<const float4*>(af + kk * s);
        const float4 x1 = *reinterpret_cast<const float4*>(af + kk * s + 64);
        const float4 y0 = *reinterpret_cast<const float4*>(bf + kk * s);
        const float4 y1 = *reinterpret_cast<const float4*>(bf + kk * s + 64);
        const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float ys[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int p = 0; p < 8; ++p) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            acc[p * 8 + q] = fmaf(xs[p], ys[q], acc[p * 8 + q]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                // the ring is refilled by the next tile
  if constexpr (sizeof(T) == 2) {
    const int wm = warp / 4, wn = warp % 4, g = lane / 4, q = lane % 4;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* c = acc + (mt * 4 + nt) * 4;
        const int nn = n0 + wn * 32 + nt * 8 + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * 64 + mt * 16 + g + 8 * h;
          if (m >= hidden) continue;
          float* o = dwh + (int64_t)m * gdim + nn;
          if (nn < gdim) atomicAdd(o, c[2 * h]);
          if (nn + 1 < gdim) atomicAdd(o + 1, c[2 * h + 1]);
        }
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int m = m0 + p / 4 * 64 + (tid / 16) * 4 + p % 4;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int nn = n0 + q / 4 * 64 + (tid % 16) * 4 + q % 4;
        if (m < hidden && nn < gdim) {
          atomicAdd(dwh + (int64_t)m * gdim + nn, acc[p * 8 + q]);
        }
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(const T* __restrict__ dhseq, const T* __restrict__ acts,
                    const T* __restrict__ cseq, const T* __restrict__ hseq,
                    const T* __restrict__ wh, const T* __restrict__ c0,
                    const T* __restrict__ h0, const T* __restrict__ dcfin,
                    const T* __restrict__ dhfin, T* dxpb,
                    float* __restrict__ dwh, float* __restrict__ dc0,
                    float* __restrict__ dh0, unsigned int* barrier,
                    int steps, int batch, int hidden, int slots) {
  constexpr int n = 16 / sizeof(T);
  constexpr int rows = ScanTile<T>::rows, units = ScanTile<T>::units;
  constexpr int kPairs = kTilePairs;   // per tile; kPairs % units == 0
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int gdim = 4 * hidden;
  const int kp = (gdim + kDhK - 1) / kDhK * kDhK, wstride = kp + n;
  const int64_t plane = (int64_t)batch * hidden;
  const int groups = gridDim.x / slots;
  const int slot = blockIdx.x / groups, u0 = blockIdx.x % groups * units;
  const int tiles = ((batch + rows - 1) / rows + slots - 1) / slots;
  const BwdSmem<T> lay(hidden, tiles);
  T* w_s = reinterpret_cast<T*>(smem + lay.w);
  float* red_s = reinterpret_cast<float*>(smem + lay.red);
  float* dh_s = reinterpret_cast<float*>(smem + lay.dh);
  float* dc_s = reinterpret_cast<float*>(smem + lay.dc);
  const int tid = threadIdx.x, warp = tid / 32;
  T* ring = reinterpret_cast<T*>(smem + lay.ring) +
            warp * dh_stages<T>() * rows * (kDhK + n);

  // the own Wh rows, k padded with zeros
  for (int c = tid; c < units * wstride / n; c += kThreads) {
    const int uu = c / (wstride / n), k = (c % (wstride / n)) * n;
    const int count = u0 + uu < hidden ? max(0, min(n, gdim - k)) : 0;
    copy_chunk<T, kVec>(w_s + uu * wstride + k,
                        count > 0 ? wh + (int64_t)(u0 + uu) * gdim + k : wh,
                        count);
  }
  cp_async_commit();
  // pair idx of the block: tile j = idx / kPairs, its pair p = idx % kPairs
  // at batch row (slot + j slots) rows + p / units, unit u0 + p % units
  auto row_of = [&](int idx) {
    return (slot + idx / kPairs * slots) * rows + idx % kPairs / units;
  };
  auto unit_of = [&](int idx) { return u0 + idx % units; };
  for (int idx = tid; idx < tiles * kPairs; idx += kThreads) {
    const int b = row_of(idx), u = unit_of(idx);
    const bool own = b < batch && u < hidden;
    const int64_t o = (int64_t)b * hidden + u;
    dh_s[idx] = own ? to_f(dhfin[o]) : 0.f;
    dc_s[idx] = own ? to_f(dcfin[o]) : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int t = steps - 1; t >= 0; --t) {
    // A. gate grads of the own (row, unit) pairs
    for (int idx = tid; idx < tiles * kPairs; idx += kThreads) {
      const int b = row_of(idx), u = unit_of(idx);
      if (b >= batch || u >= hidden) continue;
      const int64_t row = (int64_t)t * batch + b;
      const int64_t o = row * hidden + u;
      const T* a = acts + row * gdim + u;
      const float ig = to_f(a[0]), fg = to_f(a[hidden]);
      const float gg = to_f(a[2 * hidden]), og = to_f(a[3 * hidden]);
      const float c_prev =
          t > 0 ? to_f(cseq[o - plane]) : to_f(c0[(int64_t)b * hidden + u]);
      const float dh_total = to_f(dhseq[o]) + dh_s[idx];
      const float tc = tanhf(to_f(cseq[o]));
      const float d_o = dh_total * tc;
      const float dc = dc_s[idx] + dh_total * og * (1.0f - tc * tc);
      const float di = dc * gg, dg = dc * ig, df = dc * c_prev;
      T* dx = dxpb + row * gdim + u;
      dx[0] = from_f<T>(di * ig * (1.0f - ig));
      dx[hidden] = from_f<T>(df * fg * (1.0f - fg));
      dx[2 * hidden] = from_f<T>(dg * (1.0f - gg * gg));
      dx[3 * hidden] = from_f<T>(d_o * og * (1.0f - og));
      dc_s[idx] = dc * fg;
    }
    grid_arrive(barrier + slot);
    // step t-1's inputs of the own pairs into L1 while the slot arrives
    for (int idx = tid; t > 0 && idx < tiles * kPairs; idx += kThreads) {
      const int b = row_of(idx), u = unit_of(idx);
      if (b >= batch || u >= hidden) continue;
      const int64_t row = (int64_t)(t - 1) * batch + b;
      const int64_t o = row * hidden + u;
      const T* a = acts + row * gdim + u;
      prefetch_l1(a);
      prefetch_l1(a + hidden);
      prefetch_l1(a + 2 * hidden);
      prefetch_l1(a + 3 * hidden);
      prefetch_l1(cseq + o);
      prefetch_l1(dhseq + o);
      prefetch_l1(t > 1 ? cseq + (o - plane) : c0 + (int64_t)b * hidden + u);
    }
    grid_wait(barrier + slot, (unsigned int)(steps - t) * groups);

    // B. dh of the own pairs from the slot's rows of dxpb[t]
    const T* dxt = dxpb + (int64_t)t * batch * gdim;
    for (int j = 0; j < tiles; ++j) {
      const int b0 = (slot + j * slots) * rows;
      if (b0 >= batch) break;
      dh_partial<T, kVec>(dxt, b0, batch, gdim, kp / kDhK, w_s, wstride, ring,
                          red_s + warp * kPairs);
      __syncthreads();
      for (int p = tid; p < kPairs; p += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red_s[w * kPairs + p];
        dh_s[j * kPairs + p] = s;
      }
      __syncthreads();     // red_s is rewritten by the next tile
    }
  }  // next step

  for (int idx = tid; idx < tiles * kPairs; idx += kThreads) {
    const int b = row_of(idx), u = unit_of(idx);
    if (b < batch && u < hidden) {
      dh0[(int64_t)b * hidden + u] = dh_s[idx];
      dc0[(int64_t)b * hidden + u] = dc_s[idx];
    }
  }

  // dWh: zeroed, then, once every block's dxpb is written, each tile the
  // sum of its two halves of the rows
  const int64_t dwh_size = (int64_t)hidden * gdim;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < dwh_size;
       i += (int64_t)gridDim.x * kThreads) {
    dwh[i] = 0.f;
  }
  grid_arrive(barrier + slots);
  grid_wait(barrier + slots, gridDim.x);
  const int rows_all = steps * batch;
  const int mid =
      min(rows_all, (rows_all / 2 + kTailK - 1) / kTailK * kTailK);
  const int mtiles = (hidden + kTail - 1) / kTail;
  const int ntiles = (gdim + kTail - 1) / kTail;
  for (int w = blockIdx.x; w < 2 * mtiles * ntiles; w += gridDim.x) {
    const int tile = w / 2;
    dwh_tile<T, kVec>(hseq, h0, dxpb, dwh, w % 2 ? mid : 0,
                      w % 2 ? rows_all : mid, batch, hidden,
                      tile / ntiles * kTail, tile % ntiles * kTail,
                      reinterpret_cast<T*>(smem));
  }  // dWh tiles
}

// How many blocks of ``kernel`` with ``smem`` bytes of dynamic shared memory
// can be resident at once on the current device. The shared-memory limit is
// one attribute per kernel, so it is set once per (kernel, device), to the
// card's opt-in maximum: a launch of one size never lowers it below that of
// another. The SM count and the occupancy query run once per (kernel,
// bytes, device) and are cached, so a launch makes no other runtime call
// and can be captured into a CUDA graph.
struct ResidentLimit {
  const void* kernel;
  size_t smem;
  int device;
  int blocks;
};
std::mutex g_limits_mutex;
std::vector<ResidentLimit> g_limits;

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(g_limits_mutex);
  bool limit_set = false;
  for (const ResidentLimit& limit : g_limits) {
    if (limit.kernel != key || limit.device != device) continue;
    if (limit.smem == smem) {
      *blocks = limit.blocks;
      return cudaSuccess;
    }
    limit_set = true;
  }
  int sms = 0, optin = 0, per_sm = 0;
  if (!limit_set) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  g_limits.push_back({key, smem, device, per_sm * sms});
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// Launch ``blocks`` co-resident blocks or return an error: the barrier would
// deadlock if one block waited for another that has no SM. Under stream
// capture the launch becomes a cooperative kernel node of the graph.
template <typename Kernel>
int launch_cooperative(Kernel kernel, int blocks, size_t smem, void** args,
                       void* stream) {
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, smem, &resident);
  if (err != cudaSuccess) return (int)err;
  if (resident < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int fwd(const void* xpb, const void* wh, const void* c0, const void* h0,
        void* hseq, void* cseq, void* acts, void* cfin, void* barrier,
        int steps, int batch, int hidden, int slots, int smem, int residuals,
        void* stream) {
  const T* x = static_cast<const T*>(xpb);
  const T* w = static_cast<const T*>(wh);
  const T* c = static_cast<const T*>(c0);
  const T* h = static_cast<const T*>(h0);
  T* hs = static_cast<T*>(hseq);
  T* cs = static_cast<T*>(cseq);
  T* as = static_cast<T*>(acts);
  T* cf = static_cast<T*>(cfin);
  unsigned int* bar = static_cast<unsigned int*>(barrier);
  void* args[] = {&x,  &w,  &c,   &h,     &hs,     &cs,     &as,
                  &cf, &bar, &steps, &batch, &hidden, &slots};
  // the wrapper's geometry (ops/lstm_kernels.py fwd_geometry) must be this
  // source's: ``slots`` batch-tile groups of whole tiles, and their bytes
  constexpr int rows = ScanTile<T>::rows, units = ScanTile<T>::units;
  const int ntiles = (batch + rows - 1) / rows;
  if (slots < 1 || slots > ntiles) return (int)cudaErrorInvalidValue;
  const int tiles = (ntiles + slots - 1) / slots;
  if ((int64_t)smem != FwdSmem<T>(hidden, tiles).end) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = slots * ((hidden + units - 1) / units);
  // rows of xpb, Wh, h0 and hseq as 16-byte chunks where the width allows
  const bool vec = (hidden * sizeof(T)) % 16 == 0 && aligned16(xpb) &&
                   aligned16(wh) && aligned16(h0) && aligned16(hseq);
  if (residuals) {
    return vec ? launch_cooperative(lstm_fwd_kernel<T, true, true>, blocks,
                                    smem, args, stream)
               : launch_cooperative(lstm_fwd_kernel<T, false, true>, blocks,
                                    smem, args, stream);
  }
  return vec ? launch_cooperative(lstm_fwd_kernel<T, true, false>, blocks,
                                  smem, args, stream)
             : launch_cooperative(lstm_fwd_kernel<T, false, false>, blocks,
                                  smem, args, stream);
}

template <typename T>
int bwd(const void* dhseq, const void* acts, const void* cseq,
        const void* hseq, const void* wh, const void* c0, const void* h0,
        const void* dcfin, const void* dhfin, void* dxpb, void* dwh,
        void* dc0, void* dh0, void* barrier, int steps, int batch,
        int hidden, int slots, int smem, void* stream) {
  const T* p_dhseq = static_cast<const T*>(dhseq);
  const T* p_acts = static_cast<const T*>(acts);
  const T* p_cseq = static_cast<const T*>(cseq);
  const T* p_hseq = static_cast<const T*>(hseq);
  const T* p_wh = static_cast<const T*>(wh);
  const T* p_c0 = static_cast<const T*>(c0);
  const T* p_h0 = static_cast<const T*>(h0);
  const T* p_dcfin = static_cast<const T*>(dcfin);
  const T* p_dhfin = static_cast<const T*>(dhfin);
  T* p_dxpb = static_cast<T*>(dxpb);
  float* p_dwh = static_cast<float*>(dwh);
  float* p_dc0 = static_cast<float*>(dc0);
  float* p_dh0 = static_cast<float*>(dh0);
  unsigned int* bar = static_cast<unsigned int*>(barrier);
  void* args[] = {&p_dhseq, &p_acts, &p_cseq, &p_hseq, &p_wh,  &p_c0,
                  &p_h0,    &p_dcfin, &p_dhfin, &p_dxpb, &p_dwh, &p_dc0,
                  &p_dh0,   &bar,    &steps,  &batch,  &hidden, &slots};
  // the wrapper's geometry (ops/lstm_kernels.py bwd_geometry) must be this
  // source's: ``slots`` batch-tile groups of whole tiles, and their bytes
  constexpr int rows = ScanTile<T>::rows, units = ScanTile<T>::units;
  const int ntiles = (batch + rows - 1) / rows;
  if (slots < 1 || slots > ntiles) return (int)cudaErrorInvalidValue;
  const int tiles = (ntiles + slots - 1) / slots;
  if ((int64_t)smem != BwdSmem<T>(hidden, tiles).end) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = slots * ((hidden + units - 1) / units);
  // rows of Wh, h0, hseq and dxpb as 16-byte chunks where the width allows
  const bool vec = (hidden * sizeof(T)) % 16 == 0 && aligned16(wh) &&
                   aligned16(h0) && aligned16(hseq) && aligned16(dxpb);
  return vec ? launch_cooperative(lstm_bwd_kernel<T, true>, blocks, smem,
                                  args, stream)
             : launch_cooperative(lstm_bwd_kernel<T, false>, blocks, smem,
                                  args, stream);
}

}  // namespace

extern "C" int lstm_fwd(const void* xpb, const void* wh, const void* c0,
                        const void* h0, void* hseq, void* cseq, void* acts,
                        void* cfin, void* barrier, int steps, int batch,
                        int hidden, int slots, int smem, int bf16,
                        int residuals, void* stream) {
  if (steps < 1 || batch < 1 || hidden < 1) return (int)cudaErrorInvalidValue;
  if (bf16) {
    return fwd<__nv_bfloat16>(xpb, wh, c0, h0, hseq, cseq, acts, cfin,
                              barrier, steps, batch, hidden, slots, smem,
                              residuals, stream);
  }
  return fwd<float>(xpb, wh, c0, h0, hseq, cseq, acts, cfin, barrier, steps,
                    batch, hidden, slots, smem, residuals, stream);
}

extern "C" int lstm_bwd(const void* dhseq, const void* acts, const void* cseq,
                        const void* hseq, const void* wh, const void* c0,
                        const void* h0, const void* dcfin, const void* dhfin,
                        void* dxpb, void* dwh, void* dc0, void* dh0,
                        void* barrier, int steps, int batch, int hidden,
                        int slots, int smem, int bf16, void* stream) {
  if (steps < 1 || batch < 1 || hidden < 1) return (int)cudaErrorInvalidValue;
  if (bf16) {
    return bwd<__nv_bfloat16>(dhseq, acts, cseq, hseq, wh, c0, h0, dcfin,
                              dhfin, dxpb, dwh, dc0, dh0, barrier, steps,
                              batch, hidden, slots, smem, stream);
  }
  return bwd<float>(dhseq, acts, cseq, hseq, wh, c0, h0, dcfin, dhfin, dxpb,
                    dwh, dc0, dh0, barrier, steps, batch, hidden, slots,
                    smem, stream);
}
