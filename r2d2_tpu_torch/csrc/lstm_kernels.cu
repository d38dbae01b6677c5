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
// previous one's full h (forward) or gate grads (backward), so 55 grid-wide
// dependencies set the floor. Inside a step, every block reads the whole
// h_{t-1} (forward, and backward for dWh) or dxpb[t] (backward, for dh)
// through L2 (16 and 64 MB a step across the grid at the reference shape)
// and does its share of the products as f32 FMAs; those two, not device
// memory, set the time of a step.
//
// Design: ONE persistent launch per scan direction, the counterpart of
// "Wh resident, carries never in HBM". Block q owns hidden units
// [4q, 4q+4) (H/4 = 128 blocks at H=512, one per SM, launched cooperatively
// so all are co-resident) and keeps in shared memory, for the whole scan,
// its slice of Wh and its f32 carries. A step reads the other blocks'
// h_{t-1} (forward) or gate grads (backward) from L2 and ends in a
// grid-wide barrier on a global counter (no -rdc needed). The forward's h
// exchange is hseq itself: hseq[t-1] is exactly the cd(h) the product
// consumes. Against the load latency: rows are read as 16-byte chunks where
// the row width allows, several loads are in flight per thread before any
// is used, h rows are staged in shared memory in a bank-conflict-free
// order, and the backward's dWh update, which needs only the block's own
// gate grads, runs between arriving at the barrier and waiting on it. The
// products are plain f32 FMAs on operands converted to f32 (the tensor
// cores, and cluster multicast of the rows every block reads, are work for
// a later kernel).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o liblstm_kernels.so lstm_kernels.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnits = 4;                    // hidden units a block owns
constexpr int kCols = 4 * kUnits;            // its gate columns (16)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileB = kThreads / kUnits;    // batch rows per forward tile
constexpr int kSplitK = kWarps / (kTileB / 32);  // forward k parts (4)
constexpr int kStage = 8;      // chunk loads in flight per thread, h staging
constexpr int kRowsB = 8;      // rows per warp pass of the backward's dh
constexpr int kTileC = 32;     // h_prev rows per tile of the backward's dWh

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
// Backward, t = T-1 .. 0. Shared memory: the block's rows of Wh as float4
// over its units [4H][kUnits]; its dWh columns in f32 [kCols][H]; this
// step's gate grads of its columns [B][kCols]; the dh and dc carries
// [B][kUnits] each; a tile of h_prev [kTileC][H + 1]. Per step:
//   A. thread (r, uu) turns dh/dc into the pre-activation gate grads of its
//      rows, writes them to dxpb[t] (storage type) and keeps them, read back
//      through that type, in shared memory; the block arrives at the
//      barrier;
//   C. thread k: dWh[k, own cols] += sum_b cd(h_prev[b, k]) dxpb[t][b, col]
//      over tiles of h_prev staged in shared memory (own gate grads only,
//      so before the wait);
//   wait: all of dxpb[t] is written;
//   B. warp w, 8 rows at a time: dh[b, own units] = dxpb[t][b, :] .
//      Wh[own units, :] (lanes stride the 4H columns, then a shuffle sum).
// Step t-1 writes other rows of dxpb, so one barrier per step is enough.

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(const T* __restrict__ dhseq, const T* __restrict__ acts,
                    const T* __restrict__ cseq, const T* __restrict__ hseq,
                    const T* __restrict__ wh, const T* __restrict__ c0,
                    const T* __restrict__ h0, const T* __restrict__ dcfin,
                    const T* __restrict__ dhfin, T* dxpb,
                    float* __restrict__ dwh, float* __restrict__ dc0,
                    float* __restrict__ dh0, unsigned int* barrier,
                    int steps, int batch, int hidden) {
  using V = Chunk<T, kVec>;
  extern __shared__ float4 smem4[];
  const int gdim = 4 * hidden;
  const int64_t plane = (int64_t)batch * hidden;
  float4* wr_s = smem4;
  float* dwh_s = reinterpret_cast<float*>(wr_s + gdim);
  float* dx_s = dwh_s + (size_t)kCols * hidden;
  float* dh_s = dx_s + (size_t)batch * kCols;
  float* dc_s = dh_s + (size_t)batch * kUnits;
  float* hc_s = dc_s + (size_t)batch * kUnits;
  const float4* dx_s4 = reinterpret_cast<const float4*>(dx_s);
  const int u0 = blockIdx.x * kUnits;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  float* wr_f = reinterpret_cast<float*>(wr_s);
  for (int idx = tid; idx < kUnits * gdim; idx += kThreads) {
    const int uu = idx / gdim, j = idx - uu * gdim, u = u0 + uu;
    wr_f[j * kUnits + uu] = u < hidden ? to_f(wh[(int64_t)u * gdim + j]) : 0.f;
  }
  for (int idx = tid; idx < kCols * hidden; idx += kThreads) dwh_s[idx] = 0.f;
  for (int idx = tid; idx < batch * kUnits; idx += kThreads) {
    const int b = idx / kUnits, u = u0 + idx % kUnits;
    const int64_t o = (int64_t)b * hidden + u;
    dh_s[idx] = u < hidden ? to_f(dhfin[o]) : 0.f;
    dc_s[idx] = u < hidden ? to_f(dcfin[o]) : 0.f;
  }
  __syncthreads();

  const int uu = tid % kUnits, r = tid / kUnits, u = u0 + uu;
  const int chunks = gdim / V::n;
  const int passes = (batch + kRowsB - 1) / kRowsB;
  for (int t = steps - 1; t >= 0; --t) {
    // A. gate grads of the own units
    for (int b = r; b < batch; b += kTileB) {
      float* dxo = dx_s + b * kCols + uu;
      if (u >= hidden) {
        dxo[0] = dxo[kUnits] = dxo[2 * kUnits] = dxo[3 * kUnits] = 0.f;
        continue;
      }
      const int64_t row = (int64_t)t * batch + b;
      const int64_t o = row * hidden + u;
      const T* a = acts + row * gdim + u;
      const float ig = to_f(a[0]), fg = to_f(a[hidden]);
      const float gg = to_f(a[2 * hidden]), og = to_f(a[3 * hidden]);
      const float c_prev =
          t > 0 ? to_f(cseq[o - plane]) : to_f(c0[(int64_t)b * hidden + u]);
      const int s = b * kUnits + uu;
      const float dh_total = to_f(dhseq[o]) + dh_s[s];
      const float tc = tanhf(to_f(cseq[o]));
      const float d_o = dh_total * tc;
      const float dc = dc_s[s] + dh_total * og * (1.0f - tc * tc);
      const float di = dc * gg, dg = dc * ig, df = dc * c_prev;
      const T xi = from_f<T>(di * ig * (1.0f - ig));
      const T xf = from_f<T>(df * fg * (1.0f - fg));
      const T xg = from_f<T>(dg * (1.0f - gg * gg));
      const T xo = from_f<T>(d_o * og * (1.0f - og));
      T* dx = dxpb + row * gdim + u;
      dx[0] = xi;
      dx[hidden] = xf;
      dx[2 * hidden] = xg;
      dx[3 * hidden] = xo;
      dxo[0] = to_f(xi);
      dxo[kUnits] = to_f(xf);
      dxo[2 * kUnits] = to_f(xg);
      dxo[3 * kUnits] = to_f(xo);
      dc_s[s] = dc * fg;
    }
    const unsigned int target = (unsigned int)(steps - t) * gridDim.x;
    grid_arrive(barrier);

    // C. dWh columns of the own units, while the other blocks arrive
    const T* hprev = t > 0 ? hseq + (t - 1) * plane : h0;
    for (int b0 = 0; b0 < batch; b0 += kTileC) {
      const int rows = min(kTileC, batch - b0);
      if (b0 > 0) __syncthreads();   // the previous tile's readers are done
      stage_rows<T, kVec>(hprev + (int64_t)b0 * hidden, rows, hidden, hc_s);
      __syncthreads();
      for (int k = tid; k < hidden; k += kThreads) {
        float acc[kCols];
#pragma unroll
        for (int lc = 0; lc < kCols; ++lc) acc[lc] = dwh_s[lc * hidden + k];
#pragma unroll 4
        for (int i = 0; i < rows; ++i) {
          const float hv = hc_s[i * (hidden + 1) + k];
          const float4* d = dx_s4 + (b0 + i) * (kCols / 4);
#pragma unroll
          for (int q = 0; q < kCols / 4; ++q) {
            const float4 x = d[q];
            acc[4 * q] = fmaf(hv, x.x, acc[4 * q]);
            acc[4 * q + 1] = fmaf(hv, x.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(hv, x.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(hv, x.w, acc[4 * q + 3]);
          }
        }
#pragma unroll
        for (int lc = 0; lc < kCols; ++lc) dwh_s[lc * hidden + k] = acc[lc];
      }
    }
    grid_wait(barrier, target);

    // B. dh for the own units from every block's gate grads
    const T* dxt = dxpb + (int64_t)t * batch * gdim;
    for (int p = warp; p < passes; p += kWarps) {
      const int b0 = p * kRowsB;
      float acc[kRowsB][kUnits];
#pragma unroll
      for (int i = 0; i < kRowsB; ++i) {
#pragma unroll
        for (int q = 0; q < kUnits; ++q) acc[i][q] = 0.f;
      }
      for (int g = lane; g < chunks; g += 32) {
        V x[kRowsB];
#pragma unroll
        for (int i = 0; i < kRowsB; ++i) {
          if (b0 + i < batch) {
            x[i].load_cg(dxt + (int64_t)(b0 + i) * gdim + g * V::n);
          } else {
            x[i].zero();
          }
        }
#pragma unroll
        for (int e = 0; e < V::n; ++e) {
          const float4 w = wr_s[g * V::n + e];
#pragma unroll
          for (int i = 0; i < kRowsB; ++i) {
            const float xv = x[i].get(e);
            acc[i][0] = fmaf(xv, w.x, acc[i][0]);
            acc[i][1] = fmaf(xv, w.y, acc[i][1]);
            acc[i][2] = fmaf(xv, w.z, acc[i][2]);
            acc[i][3] = fmaf(xv, w.w, acc[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsB; ++i) {
#pragma unroll
        for (int q = 0; q < kUnits; ++q) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            acc[i][q] += __shfl_xor_sync(0xffffffffu, acc[i][q], off);
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kRowsB; ++i) {
          if (b0 + i < batch) {
#pragma unroll
            for (int q = 0; q < kUnits; ++q) {
              dh_s[(b0 + i) * kUnits + q] = acc[i][q];
            }
          }
        }
      }
    }
    __syncthreads();       // dx_s and dh_s are rewritten by the next step
  }

  for (int idx = tid; idx < batch * kUnits; idx += kThreads) {
    const int b = idx / kUnits, u = u0 + idx % kUnits;
    if (u < hidden) {
      dh0[(int64_t)b * hidden + u] = dh_s[idx];
      dc0[(int64_t)b * hidden + u] = dc_s[idx];
    }
  }
  for (int idx = tid; idx < kCols * hidden; idx += kThreads) {
    const int lc = idx / hidden, k = idx - lc * hidden;
    const int u = u0 + lc % kUnits;
    if (u < hidden) dwh[(int64_t)k * gdim + (lc / kUnits) * hidden + u] =
        dwh_s[idx];
  }
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
        int hidden, void* stream) {
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
                  &p_dh0,   &bar,    &steps,  &batch,  &hidden};
  const int blocks = (hidden + kUnits - 1) / kUnits;
  const size_t smem = (size_t)4 * hidden * sizeof(float4) +
                      (size_t)kCols * hidden * sizeof(float) +
                      (size_t)batch * kCols * sizeof(float) +
                      (size_t)2 * batch * kUnits * sizeof(float) +
                      (size_t)kTileC * (hidden + 1) * sizeof(float);
  // h and dxpb rows as 16-byte chunks where the row width allows
  const bool vec = (hidden * sizeof(T)) % 16 == 0 && aligned16(h0) &&
                   aligned16(hseq) && aligned16(dxpb);
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
                        int bf16, void* stream) {
  if (steps < 1 || batch < 1 || hidden < 1) return (int)cudaErrorInvalidValue;
  if (bf16) {
    return bwd<__nv_bfloat16>(dhseq, acts, cseq, hseq, wh, c0, h0, dcfin,
                              dhfin, dxpb, dwh, dc0, dh0, barrier, steps,
                              batch, hidden, stream);
  }
  return bwd<float>(dhseq, acts, cseq, hseq, wh, c0, h0, dcfin, dhfin, dxpb,
                    dwh, dc0, dh0, barrier, steps, batch, hidden, stream);
}
