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
// the rows a block must pull through L2 and its share of the products.
//
// Forward: ONE persistent launch, the counterpart of "Wh resident, carries
// never in HBM". Block q owns hidden units [4q, 4q+4) (H/4 = 128 blocks at
// H=512, one per SM, launched cooperatively so all are co-resident) and
// keeps in shared memory, for the whole scan, its slice of Wh and its f32
// carries. A step reads every block's h_{t-1} from L2 (hseq itself: it is
// exactly the cd(h) the product consumes; 16 MB a step across the grid),
// stages it in shared memory in a bank-conflict-free order, runs the
// product as f32 FMAs and ends in a grid-wide barrier on a global counter
// (no -rdc needed).
//
// Backward: ONE persistent launch as well, but the chain holds only what
// the next step needs. dWh, which no step needs, is one tensor-core product
// over all T*B rows after the scan. A step of batch row b needs only row b
// of dxpb[t], so a block owns a tile of rows x a group of units (bf16 16 x
// 32, f32 32 x 16) and waits only on the blocks of its batch tiles (one
// counter each): per step it reads its rows of dxpb[t] (8 MB across the
// grid in bf16, not 64) into a per-warp cp.async ring and runs dh on the
// tensor cores in bf16 (mma.sync m16n8k16, operands by ldmatrix; f32 keeps
// FMAs).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o liblstm_kernels.so lstm_kernels.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnits = 4;                    // hidden units a block owns
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileB = kThreads / kUnits;    // batch rows per forward tile
constexpr int kSplitK = kWarps / (kTileB / 32);  // forward k parts (4)
constexpr int kStage = 8;      // chunk loads in flight per thread, h staging

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

// Consecutive values of a row read as one access through L2: 16 bytes
// (kVec; the row width and the base must allow it) or one element.
// get(e) gives element e in f32; held raw until then, so that a thread can
// have several loads in flight before it uses the first.
template <typename T, bool kVec>
struct Chunk;

template <typename T>
struct Chunk<T, false> {
  static constexpr int n = 1;
  T v;
  __device__ __forceinline__ void load_cg(const T* p) { v = ldcg_raw(p); }
  __device__ __forceinline__ void zero() { v = from_f<T>(0.f); }
  __device__ __forceinline__ float get(int) const { return to_f(v); }
};

template <typename T>
struct Chunk<T, true> {
  static constexpr int n = 16 / sizeof(T);
  uint4 v;
  __device__ __forceinline__ void load_cg(const T* p) {
    v = __ldcg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { v = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ float get(int e) const {
    constexpr int per_word = 4 / sizeof(T);
    const int i = e / per_word;
    const unsigned int w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
    if (per_word == 1) return __uint_as_float(w);
    // bfloat16 is the high half of a float32: widen by a shift
    return __uint_as_float((e % 2 ? w >> 16 : w & 0xffffu) << 16);
  }
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Grid-wide barrier, split so that a block can do local work between
// arriving and waiting. All blocks arrive once per barrier; ``target`` =
// blocks x barriers so far. The counter only grows (the wrapper zeroes it
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

// Copy ``rows`` rows of a (., hidden) plane (written by other blocks) into
// shared memory as f32 rows of stride hidden + 1. A warp reads 8 rows x 4
// consecutive chunks at a time: the loads are whole 32-byte sectors, and
// the stores of a warp fall in 32 different banks.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_rows(const T* src, int rows, int hidden,
                                           float* dst) {
  using V = Chunk<T, kVec>;
  const int per_row = hidden / V::n;
  const int col_groups = (per_row + 3) / 4;
  const int groups = ((rows + 7) / 8) * col_groups;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int g0 = warp; g0 < groups; g0 += kWarps * kStage) {
    V v[kStage];
    int off[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int g = g0 + i * kWarps;
      const int rr = (g / col_groups) * 8 + lane / 4;
      const int c = (g % col_groups) * 4 + lane % 4;
      off[i] = -1;
      if (g < groups && rr < rows && c < per_row) {
        v[i].load_cg(src + (int64_t)rr * hidden + c * V::n);
        off[i] = rr * (hidden + 1) + c * V::n;
      }
    }
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      if (off[i] >= 0) {
#pragma unroll
        for (int e = 0; e < V::n; ++e) dst[off[i] + e] = v[i].get(e);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward. Shared memory: Wh slice as float4 (i, f, g, o) per (k, unit)
// [H][kUnits]; partial products [kSplitK][kTileB][kUnits] float4; a tile
// of h_{t-1} [kTileB][H + 1] (the +1 keeps the 32 rows a warp reads in
// different banks); the c carry [B][kUnits].
// Product: warp w sums k over part w % kSplitK of H for the rows
// (w / kSplitK) * 32 + lane of the tile and all 16 gate columns: the Wh
// row of a k is one broadcast read for the whole warp, and a lane does 16
// FMAs for each h value it reads. Epilogue: thread (r, uu) adds the
// kSplitK partials of row b0 + r, unit u0 + uu and computes its four gates.

template <typename T, bool kVec, bool kResiduals>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const T* __restrict__ xpb, const T* __restrict__ wh,
                    const T* __restrict__ c0, const T* __restrict__ h0,
                    T* hseq, T* __restrict__ cseq, T* __restrict__ acts,
                    T* __restrict__ cfin, unsigned int* barrier, int steps,
                    int batch, int hidden) {
  extern __shared__ float4 smem4[];
  float4* w_s = smem4;
  float4* part_s = w_s + (size_t)hidden * kUnits;
  float* h_s = reinterpret_cast<float*>(part_s + kSplitK * kTileB * kUnits);
  float* c_s = h_s + (size_t)kTileB * (hidden + 1);
  const int64_t gdim = 4LL * hidden;
  const int64_t plane = (int64_t)batch * hidden;
  const int u0 = blockIdx.x * kUnits;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < hidden * kUnits; idx += kThreads) {
    const int k = idx / kUnits, u = u0 + idx % kUnits;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < hidden) {
      const T* row = wh + k * gdim + u;
      v = make_float4(to_f(row[0]), to_f(row[hidden]), to_f(row[2 * hidden]),
                      to_f(row[3 * hidden]));
    }
    w_s[idx] = v;
  }
  for (int idx = tid; idx < batch * kUnits; idx += kThreads) {
    const int b = idx / kUnits, u = u0 + idx % kUnits;
    c_s[idx] = u < hidden ? to_f(c0[(int64_t)b * hidden + u]) : 0.f;
  }

  const int uu = tid % kUnits, r = tid / kUnits, u = u0 + uu;
  const int hstride = hidden + 1;
  const int part = (tid / 32) % kSplitK;
  const int rp = (tid / 32) / kSplitK * 32 + tid % 32;
  const int kspan = (hidden + kSplitK - 1) / kSplitK;
  const int k_lo = part * kspan, k_hi = min(hidden, k_lo + kspan);
  for (int t = 0; t < steps; ++t) {
    const T* hprev = t == 0 ? h0 : hseq + (t - 1) * plane;
    for (int b0 = 0; b0 < batch; b0 += kTileB) {
      const int rows = min(kTileB, batch - b0);
      const bool active = r < rows && u < hidden;
      const int b = b0 + r;
      const int64_t row = (int64_t)t * batch + b;
      // this step's input projection, loaded ahead of the product
      float xi = 0.f, xf = 0.f, xg = 0.f, xo = 0.f;
      if (active) {
        const T* xp = xpb + row * gdim + u;
        xi = to_f(xp[0]);
        xf = to_f(xp[hidden]);
        xg = to_f(xp[2 * hidden]);
        xo = to_f(xp[3 * hidden]);
      }
      __syncthreads();               // the previous tile's readers are done
      stage_rows<T, kVec>(hprev + (int64_t)b0 * hidden, rows, hidden, h_s);
      __syncthreads();
      if (rp < rows) {
        const float* hrow = h_s + rp * hstride;
        float4 acc[kUnits];
#pragma unroll
        for (int q = 0; q < kUnits; ++q) {
          acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll 4
        for (int k = k_lo; k < k_hi; ++k) {
          const float hv = hrow[k];
          const float4* w = w_s + k * kUnits;
#pragma unroll
          for (int q = 0; q < kUnits; ++q) {
            const float4 wq = w[q];
            acc[q].x = fmaf(hv, wq.x, acc[q].x);
            acc[q].y = fmaf(hv, wq.y, acc[q].y);
            acc[q].z = fmaf(hv, wq.z, acc[q].z);
            acc[q].w = fmaf(hv, wq.w, acc[q].w);
          }
        }
        float4* dst = part_s + (part * kTileB + rp) * kUnits;
#pragma unroll
        for (int q = 0; q < kUnits; ++q) dst[q] = acc[q];
      }
      __syncthreads();
      if (active) {
        float4 s = part_s[r * kUnits + uu];
#pragma unroll
        for (int p = 1; p < kSplitK; ++p) {
          const float4 v = part_s[(p * kTileB + r) * kUnits + uu];
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        const float gi = sigmoid(xi + s.x);
        const float gf = sigmoid(xf + s.y);
        const float gg = tanhf(xg + s.z);
        const float go = sigmoid(xo + s.w);
        float* cc = c_s + b * kUnits + uu;
        const float c = gf * *cc + gi * gg;
        const float h = go * tanhf(c);
        *cc = c;
        const int64_t o = row * hidden + u;
        hseq[o] = from_f<T>(h);
        if (kResiduals) {
          cseq[o] = from_f<T>(c);
          T* a = acts + row * gdim + u;
          a[0] = from_f<T>(gi);
          a[hidden] = from_f<T>(gf);
          a[2 * hidden] = from_f<T>(gg);
          a[3 * hidden] = from_f<T>(go);
        } else if (t == steps - 1) {
          cfin[(int64_t)b * hidden + u] = from_f<T>(c);
        }
      }
    }
    if (t + 1 < steps) {
      const unsigned int target = (unsigned int)(t + 1) * gridDim.x;
      grid_arrive(barrier);
      grid_wait(barrier, target);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, t = T-1 .. 0, then dWh.
//
// Partition (BwdTile<T>: bf16 16 rows x 32 units, f32 32 x 16): block
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

constexpr int kBwdPairs = 512;   // (row, unit) pairs a block owns per tile
constexpr int kDhK = 16;         // k of one staged dx slice
constexpr int kTail = 128;       // dWh output tile kTail x kTail
constexpr int kTailK = 32;       // rows (t, b) per staged dWh slice
constexpr int kTailStages = 4;

// Batch rows of a tile and hidden units of a group. bf16: 16 x 32, so a
// block reads 16 rows of dxpb[t] a step (its Wh rows are 128 KB at H=512);
// f32: 32 x 16 (f32 Wh rows of 32 units would not fit).
template <typename T>
struct BwdTile {
  static constexpr int rows = sizeof(T) == 2 ? 16 : 32;
  static constexpr int units = kBwdPairs / rows;
};

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
    const int64_t rows = BwdTile<T>::rows, pairs = kBwdPairs;
    w = 0;
    ring = w + BwdTile<T>::units * (kp + n) * e;
    red = ring + (int64_t)kWarps * dh_stages<T>() * rows * (kDhK + n) * e;
    dh = red + kWarps * pairs * 4;
    dc = dh + tiles * pairs * 4;
    const int64_t steps_end = dc + tiles * pairs * 4;
    const int64_t tail_end =
        (int64_t)kTailStages * kTailK * 2 * (kTail + n) * e;
    end = steps_end > tail_end ? steps_end : tail_end;
  }
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

// This warp's share of dh[rows, units] = cd(dx[rows b0.., :]) .
// W[units, :]^T (BwdTile<T>), where dx is dxpb[t] (batch, gdim) and w_s the
// block's Wh rows [units][wstride]: k slices warp, warp + kWarps, ... of 16
// each, staged through ``ring`` (dh_stages slices, all but one in flight).
// The partial sums go to red [rows][units]. bf16: one 16-row m tile x four
// 8-unit n tiles per slice on the tensor cores; f32: lane = row, FMAs.
template <typename T, bool kVec>
__device__ __forceinline__ void dh_partial(const T* dx, int b0, int batch,
                                           int gdim, int ksteps,
                                           const T* w_s, int wstride,
                                           T* ring, float* red) {
  constexpr int rows = BwdTile<T>::rows, units = BwdTile<T>::units;
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
  constexpr int rows = BwdTile<T>::rows, units = BwdTile<T>::units;
  constexpr int kPairs = kBwdPairs;   // per tile; kPairs % units == 0
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

// Launch ``blocks`` co-resident blocks or return an error: the barrier would
// deadlock if one block waited for another that has no SM.
template <typename Kernel>
int launch_cooperative(Kernel kernel, int blocks, size_t smem, void** args,
                       void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
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
        int steps, int batch, int hidden, int residuals, void* stream) {
  const T* x = static_cast<const T*>(xpb);
  const T* w = static_cast<const T*>(wh);
  const T* c = static_cast<const T*>(c0);
  const T* h = static_cast<const T*>(h0);
  T* hs = static_cast<T*>(hseq);
  T* cs = static_cast<T*>(cseq);
  T* as = static_cast<T*>(acts);
  T* cf = static_cast<T*>(cfin);
  unsigned int* bar = static_cast<unsigned int*>(barrier);
  void* args[] = {&x, &w, &c, &h, &hs, &cs, &as, &cf, &bar,
                  &steps, &batch, &hidden};
  const int blocks = (hidden + kUnits - 1) / kUnits;
  const size_t smem = (size_t)hidden * kUnits * sizeof(float4) +
                      (size_t)kSplitK * kTileB * kUnits * sizeof(float4) +
                      (size_t)kTileB * (hidden + 1) * sizeof(float) +
                      (size_t)batch * kUnits * sizeof(float);
  // h rows (h0, hseq) as 16-byte chunks where the row width allows
  const bool vec = (hidden * sizeof(T)) % 16 == 0 && aligned16(h0) &&
                   aligned16(hseq);
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
  constexpr int rows = BwdTile<T>::rows, units = BwdTile<T>::units;
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
                        int hidden, int bf16, int residuals, void* stream) {
  if (steps < 1 || batch < 1 || hidden < 1) return (int)cudaErrorInvalidValue;
  if (bf16) {
    return fwd<__nv_bfloat16>(xpb, wh, c0, h0, hseq, cseq, acts, cfin,
                              barrier, steps, batch, hidden, residuals,
                              stream);
  }
  return fwd<float>(xpb, wh, c0, h0, hseq, cseq, acts, cfin, barrier, steps,
                    batch, hidden, residuals, stream);
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
