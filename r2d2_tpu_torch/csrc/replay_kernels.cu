// Hand-written Hopper kernels for the learner's replay data path.
//
// Plain C interface, loaded with ctypes (r2d2_tpu_torch/ops/_build.py and
// ops/replay_kernels.py). Every entry point launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() so the wrapper can raise
// on a refused launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libreplay_kernels.so replay_kernels.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// gather_windows: out[i] = ring[block_idx[i], start[i] : start[i] + window]
//
// Replaces r2d2_tpu/ops/pallas_kernels.py gather_rows_pallas (K1, reads the
// whole ring row into VMEM) and gather_rows_exact_pallas (K2, one HBM->HBM
// async copy of the window over tile-padded storage).
//
// Bound: bytes. Pure data movement, B * window * Hs * Ws bytes read and as
// many written (104.8 MB at B=128, window 58, 84x84: ~31 us at 3.35 TB/s).
// A sampled window is ONE contiguous run of the ring, so the kernel is a
// batched memcpy. The work is cut into items (ops/replay_kernels.py
// gather_plan): item k is bytes [c * chunk, c * chunk + chunk) of sample
// k % batch's window, c = k / batch, the last chunk of a window shorter.
// The grid is persistent: CTA g walks items [g * per, (g + 1) * per), which
// are the same chunk of neighbouring samples. (Walking items g, g + grid,
// ... instead puts every CTA on the same chunk at once, and the writes land
// a window's bytes apart: 3-5% slower on the card.)
// - gather_windows_bulk_kernel (frame bytes a multiple of 16): one thread
//   moves the bytes with Hopper's bulk copies (the counterpart of K2's
//   HBM->HBM async copy), through a ring of kBulkStages shared-memory
//   buffers, each with an mbarrier, loads kBulkAhead items ahead of the
//   stores. The warp first resolves the CTA's item addresses into a table
//   in shared memory, in parallel, so the copying thread never waits on an
//   index load. A load cp.async.bulk's an item into its stage; once the
//   stage's barrier completes, a bulk store writes it to `out` in a bulk
//   group; a stage is refilled once its store has read it
//   (cp.async.bulk.wait_group.read). No thread touches the bytes. Both sides
//   carry an L2 evict_first policy: the 0.8 GB ring never stays in the 50
//   MB L2, and evict_first stores made the gather 4% faster on the card
//   with the decode that reads `out` next no slower (evict_last stores made
//   that decode 1% faster and the gather 4% slower).
// - gather_windows_bytes_kernel: bulk copies need 16-byte addresses and
//   sizes, so a frame whose size is not a multiple of 16 takes this kernel
//   over the same items: every thread copies bytes, kBytesUnroll loads in
//   flight before the stores.
// Indices come as int32 or int64 (the sampler's own dtype; no cast kernel
// before the gather). Off-contract indices follow lax.dynamic_slice / jnp
// indexing in the reference: a negative index counts from the end, then
// start clamps to [0, row_len - window] and the block index to
// [0, num_rows - 1].

constexpr int kBulkStages = 12;
constexpr int kBulkAhead = 10;
constexpr int kBytesThreads = 256;
constexpr int kBytesUnroll = 8;

struct GatherArgs {
  const uint8_t* ring;
  const void* block_idx;
  const void* start;
  uint8_t* out;
  int64_t batch, num_rows, row_len, frame_bytes, window;
  int64_t chunk;       // bytes of an item (a multiple of 16)
  int64_t items;       // batch * chunks of a window
  int64_t per;         // items of a CTA
  int idx64, start64;  // index dtypes: int64 (1) or int32 (0)
};

struct GatherItem {
  const uint8_t* src;
  uint8_t* dst;
  uint32_t bytes;
};

__device__ __forceinline__ int64_t load_index(const void* p, int is64,
                                              int64_t i) {
  return is64 ? (int64_t)__ldg(static_cast<const long long*>(p) + i)
              : (int64_t)__ldg(static_cast<const int32_t*>(p) + i);
}

__device__ __forceinline__ GatherItem gather_item(const GatherArgs& a,
                                                  int64_t k) {
  const int64_t i = k % a.batch;
  const int64_t offset = (k / a.batch) * a.chunk;
  const int64_t window_bytes = a.window * a.frame_bytes;
  int64_t bi = load_index(a.block_idx, a.idx64, i);
  if (bi < 0) bi += a.num_rows;
  bi = bi < 0 ? 0 : (bi >= a.num_rows ? a.num_rows - 1 : bi);
  int64_t st = load_index(a.start, a.start64, i);
  if (st < 0) st += a.row_len;
  const int64_t max_start = a.row_len - a.window;
  st = st < 0 ? 0 : (st > max_start ? max_start : st);
  const int64_t rest = window_bytes - offset;
  return {a.ring + (bi * a.row_len + st) * a.frame_bytes + offset,
          a.out + i * window_bytes + offset,
          (uint32_t)(rest < a.chunk ? rest : a.chunk)};
}

// this CTA's items: [blockIdx.x * per, min(items, (blockIdx.x + 1) * per))
__device__ __forceinline__ int64_t first_item(const GatherArgs& a) {
  return (int64_t)blockIdx.x * a.per;
}

__device__ __forceinline__ int64_t item_count(const GatherArgs& a) {
  const int64_t left = a.items - first_item(a);
  return left < a.per ? left : a.per;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Dynamic shared memory: the stages, then the CTA's item table.
__global__ void __launch_bounds__(32)
gather_windows_bulk_kernel(const GatherArgs a) {
  static_assert(kBulkAhead >= 1 && kBulkAhead < kBulkStages,
                "loads run ahead of stores");
  extern __shared__ __align__(128) uint8_t stage_buf[];
  __shared__ __align__(8) uint64_t full[kBulkStages];
  const int64_t mine = item_count(a);
  GatherItem* table = reinterpret_cast<GatherItem*>(
      stage_buf + (int64_t)kBulkStages * a.chunk);
  for (int64_t q = threadIdx.x; q < mine; q += 32) {
    table[q] = gather_item(a, first_item(a) + q);
  }
  __syncwarp();
  if (threadIdx.x != 0) return;
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  for (int s = 0; s < kBulkStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_addr(&full[s]))
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  auto load = [&](int64_t q) {
    const GatherItem it = table[q];
    const int s = (int)(q % kBulkStages);
    const uint32_t bar = smem_addr(&full[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(it.bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
        ::"r"(smem_addr(stage_buf + (int64_t)s * a.chunk)), "l"(it.src),
        "r"(it.bytes), "r"(bar), "l"(policy)
        : "memory");
  };
  for (int64_t q = 0; q < kBulkAhead && q < mine; ++q) load(q);
  for (int64_t q = 0; q < mine; ++q) {
    const int s = (int)(q % kBulkStages);
    mbar_wait(smem_addr(&full[s]), (uint32_t)((q / kBulkStages) & 1));
    const GatherItem it = table[q];
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
        " [%0], [%1], %2, %3;"
        ::"l"(it.dst), "r"(smem_addr(stage_buf + (int64_t)s * a.chunk)),
        "r"(it.bytes), "l"(policy)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (q + kBulkAhead < mine) {
      // the stage of item q + ahead last held item q + ahead - stages,
      // whose store is older than the last stages - ahead groups
      asm volatile("cp.async.bulk.wait_group.read %0;"
                   ::"n"(kBulkStages - kBulkAhead) : "memory");
      load(q + kBulkAhead);
    }
  }
  // the stages must outlive the stores' reads of them; the writes complete
  // before the grid does
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__global__ void __launch_bounds__(kBytesThreads)
gather_windows_bytes_kernel(const GatherArgs a) {
  const int64_t first = first_item(a), last = first + item_count(a);
  for (int64_t k = first; k < last; ++k) {
    const GatherItem it = gather_item(a, k);
    const int n = (int)it.bytes;
    for (int base = threadIdx.x; base < n;
         base += kBytesThreads * kBytesUnroll) {
      uint8_t r[kBytesUnroll];
#pragma unroll
      for (int u = 0; u < kBytesUnroll; ++u) {
        const int j = base + u * kBytesThreads;
        if (j < n) r[u] = __ldcs(it.src + j);
      }
#pragma unroll
      for (int u = 0; u < kBytesUnroll; ++u) {
        const int j = base + u * kBytesThreads;
        if (j < n) __stcs(it.dst + j, r[u]);
      }
    }
  }
}

extern "C" int gather_windows(const void* ring, const void* block_idx,
                              int idx64, const void* start, int start64,
                              void* out, int64_t batch, int64_t num_rows,
                              int64_t row_len, int64_t frame_bytes,
                              int64_t window, int64_t chunk, int64_t per,
                              int64_t grid, void* stream) {
  const int64_t window_bytes = window * frame_bytes;
  const int64_t items =
      chunk > 0 ? batch * ((window_bytes + chunk - 1) / chunk) : 0;
  const bool bulk = frame_bytes % 16 == 0;
  // the plan's geometry: 16-byte chunks that fit a 32-bit size, and CTAs
  // that each walk at least one item and together cover them all
  if (chunk <= 0 || chunk % 16 || chunk > 2147483647 || per <= 0 ||
      grid <= 0 || grid > 2147483647 || grid * per < items ||
      (grid - 1) * per >= items ||
      (bulk && (reinterpret_cast<uintptr_t>(ring) % 16 ||
                reinterpret_cast<uintptr_t>(out) % 16))) {
    return (int)cudaErrorInvalidValue;
  }
  const GatherArgs a{static_cast<const uint8_t*>(ring), block_idx, start,
                     static_cast<uint8_t*>(out), batch, num_rows, row_len,
                     frame_bytes, window, chunk, items, per, idx64, start64};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bulk) {
    gather_windows_bytes_kernel<<<(unsigned)grid, kBytesThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  // the stages and the item table; the attribute is raised when a launch
  // needs more than the last one set (once for a shape), not on every
  // launch, and refused past 227 KB (at 16 KB chunks, past ~1,480 items a
  // CTA)
  static int64_t allowed = 48 * 1024;
  const int64_t smem = kBulkStages * chunk + per * (int64_t)sizeof(GatherItem);
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_windows_bulk_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  gather_windows_bulk_kernel<<<(unsigned)grid, 32, (size_t)smem, s>>>(a);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// stack_frames: the frame decode, in two output layouts
//   standard:       out[b, t, h, w, k] = obs[b, t + k, h, w] * f32(1/255)
//   space-to-depth: out[b, t, ph, pw, (dh*2 + dw)*K + k]
//                       = obs[b, t + k, 2ph + dh, 2pw + dw] * f32(1/255)
// The second is space_to_depth_2x2 of the first for each (b, t): the input
// of the first conv rewritten as a conv of half the kernel and stride over
// 4K channels, which fill cuDNN's tensor-core tiles where K = 4 do not.
//
// Replaces r2d2_tpu/ops/pallas_kernels.py stack_frames_pallas (K3, :194;
// bodies _stack_kernel, _stack_kernel_nhwc32, _stack_kernel_nhwc16). Each
// value is f32(obs) * f32(1/255) rounded once into the output type, the
// Pallas kernel's arithmetic. Only the out_h x out_w window of a padded
// stored frame is read.
//
// Bound: bytes. 52.4 MB read + 397.4 MB bf16 written at the reference shape
// (B=128, T=55, K=4, 84x84; ~134 us at 3.35 TB/s), the same in both layouts.
// Design: the TPU kernel's input block is constant in t (one DMA of a row,
// every t stacked from it). Here a thread owns one 16-byte piece of the
// output frame, at the same place in every t, and walks t:
// - its source bytes are the same pixels of every frame, so the index math
//   runs once per thread, in 32 bits;
// - it keeps its pixels' K frames in a register ring and loads only frame
//   t+K-1 at each step (a step ahead), so an input byte is read once per
//   chunk of t (a chunk re-reads K-1 frames; chunks of >= 8 steps, as few
//   as give ~16 waves of blocks: 7 chunks of 8 at the reference shape);
// - lane i stores piece i, so every warp store is 512 contiguous bytes
//   (streaming stores: the 397 MB output cannot stay in the 50 MB L2), and
//   a warp's loads are 32-128 contiguous bytes of a source row (whole 32-byte
//   sectors), 1 to 8 bytes a lane.
// A piece is V = 16 / sizeof(out) values: V/K pixels of the standard layout,
// or V/K of the four 2x2 slots of a space-to-depth pixel (bf16, K=4: one
// source row dh, two columns). Shapes the pieces do not tile (K not
// dividing V, a frame width or row not aligned to the piece's loads) take
// stack_frames_any_kernel, one thread per output value: right, not fast.

enum StackLayout { kStandard = 0, kSpaceToDepth = 1 };

constexpr float kInv255 = 1.0f / 255.0f;

template <int BYTES> struct LoadWord;
template <> struct LoadWord<1> { using T = uint8_t; };
template <> struct LoadWord<2> { using T = uint16_t; };
template <> struct LoadWord<4> { using T = uint32_t; };
template <> struct LoadWord<8> { using T = unsigned long long; };

template <typename OutT, int LAYOUT, int K>
struct Piece {
  static constexpr int V = 16 / (int)sizeof(OutT);   // values in 16 bytes
  static_assert(V % K == 0, "a piece holds whole stacks");
  static constexpr int C = V / K;        // pixels, or 2x2 slots of pixels
  static constexpr bool kOneRow = LAYOUT == kStandard || C <= 2;
  static constexpr int ROWS = kOneRow ? 1 : 2;         // source rows
  static constexpr int BYTES = kOneRow ? C : C / 2;    // source bytes a row
  // source row and byte of value j of the piece; its frame is t + j % K
  __host__ __device__ static constexpr int row(int j) {
    return kOneRow ? 0 : ((j / K) % 4) / 2;
  }
  __host__ __device__ static constexpr int byte(int j) {
    return kOneRow ? j / K : 2 * ((j / K) / 4) + (j / K) % 2;
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename OutT> __device__ uint4 pack16(const float* v);

template <> __device__ __forceinline__ uint4 pack16<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

template <>
__device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* v) {
  return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

template <typename Word, int ROWS>
__device__ __forceinline__ void load_rows(Word (&dst)[ROWS],
                                          const uint8_t* src, int stride) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    dst[r] = __ldg(reinterpret_cast<const Word*>(src + r * stride));
  }
}

template <typename OutT, int LAYOUT, int K>
__global__ void __launch_bounds__(256)
stack_frames_kernel(const uint8_t* __restrict__ obs, uint4* __restrict__ out,
                    int pieces, int seq_window, int t_chunk, int row_len,
                    int stored_w, int out_w, int64_t frame_bytes) {
  using P = Piece<OutT, LAYOUT, K>;
  using Word = typename LoadWord<P::BYTES>::T;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pieces) return;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * t_chunk;
  const int t1 = min(seq_window, t0 + t_chunk);
  int offset;                    // of the piece's first source byte
  if (LAYOUT == kStandard) {
    const int q = p * P::C, h = q / out_w;
    offset = h * stored_w + (q - h * out_w);
  } else {
    const int slot = p * P::C, pix = slot >> 2, half = out_w >> 1;
    const int ph = pix / half, pw = pix - ph * half;
    offset = (2 * ph + ((slot >> 1) & 1)) * stored_w + 2 * pw + (slot & 1);
  }
  const uint8_t* src =
      obs + ((int64_t)b * row_len + t0) * frame_bytes + offset;
  uint4* dst = out + ((int64_t)b * seq_window + t0) * pieces + p;

  Word ring[K + 1][P::ROWS];     // frames t .. t+K-1, then t+K in flight
#pragma unroll
  for (int k = 0; k < K; ++k) {
    load_rows(ring[k], src + k * frame_bytes, stored_w);
  }
  for (int t = t0; t < t1; ++t) {
    if (t + 1 < t1) load_rows(ring[K], src + K * frame_bytes, stored_w);
    float v[P::V];
#pragma unroll
    for (int j = 0; j < P::V; ++j) {
      const uint32_t u8 =
          (uint32_t)(ring[j % K][P::row(j)] >> (8 * P::byte(j))) & 0xffu;
      v[j] = __fmul_rn((float)u8, kInv255);
    }
    __stcs(dst, pack16<OutT>(v));      // streamed: no reuse in L2
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int r = 0; r < P::ROWS; ++r) ring[k][r] = ring[k + 1][r];
    }
    src += frame_bytes;
    dst += pieces;
  }
}

__device__ __forceinline__ void store_value(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void store_value(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// Any shape: one thread per output value, its indices decomposed in 64 bits.
template <typename OutT>
__global__ void stack_frames_any_kernel(
    const uint8_t* __restrict__ obs, OutT* __restrict__ out, int64_t total,
    int space_to_depth, int64_t seq_window, int64_t k, int64_t row_len,
    int64_t stored_h, int64_t stored_w, int64_t out_h, int64_t out_w) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    int64_t rest = i, h, w, j;
    if (space_to_depth) {
      const int64_t c = rest % (4 * k);
      rest /= 4 * k;
      const int64_t pw = rest % (out_w / 2);
      rest /= out_w / 2;
      const int64_t ph = rest % (out_h / 2);
      rest /= out_h / 2;
      j = c % k;
      h = 2 * ph + c / (2 * k);
      w = 2 * pw + (c / k) % 2;
    } else {
      j = rest % k;
      rest /= k;
      w = rest % out_w;
      rest /= out_w;
      h = rest % out_h;
      rest /= out_h;
    }
    const int64_t t = rest % seq_window, b = rest / seq_window;
    const uint8_t byte =
        __ldg(obs + ((b * row_len + t + j) * stored_h + h) * stored_w + w);
    store_value(out + i, __fmul_rn((float)byte, kInv255));
  }
}

struct StackShape {
  int64_t batch, seq_window, k, row_len, stored_h, stored_w, out_h, out_w;
};

static int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

template <typename OutT>
int launch_any(const void* obs, void* out, const StackShape& s, int layout,
               cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = s.batch * s.seq_window * s.out_h * s.out_w * s.k;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  stack_frames_any_kernel<OutT><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const uint8_t*>(obs), static_cast<OutT*>(out), total,
      layout == kSpaceToDepth, s.seq_window, s.k, s.row_len, s.stored_h,
      s.stored_w, s.out_h, s.out_w);
  return (int)cudaGetLastError();
}

// Whether the pieces tile this output and their loads are aligned.
template <typename OutT, int LAYOUT, int K>
bool pieces_tile(const void* obs, const void* out, const StackShape& s) {
  using P = Piece<OutT, LAYOUT, K>;
  const int64_t frame = s.stored_h * s.stored_w;
  const int64_t cols = LAYOUT == kStandard ? P::C : (P::C == 8 ? 4 : 2);
  return s.out_w % cols == 0 && s.stored_w % P::BYTES == 0 &&
         frame % P::BYTES == 0 &&
         reinterpret_cast<uintptr_t>(obs) % P::BYTES == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0 && s.batch <= 65535 &&
         frame < (1LL << 31) && s.row_len < (1LL << 31);
}

template <typename OutT, int LAYOUT, int K>
int launch_pieces(const void* obs, void* out, const StackShape& s,
                  cudaStream_t stream) {
  if (!pieces_tile<OutT, LAYOUT, K>(obs, out, s)) {
    return launch_any<OutT>(obs, out, s, LAYOUT, stream);
  }
  using P = Piece<OutT, LAYOUT, K>;
  const int threads = 256;
  const int64_t pieces = s.out_h * s.out_w / P::C;
  const int64_t blocks_x = (pieces + threads - 1) / threads;
  // split t into as few chunks as give ~16 waves of 8 blocks a SM
  int64_t chunks = (16LL * 8 * sm_count() + blocks_x * s.batch - 1) /
                   (blocks_x * s.batch);
  const int64_t most = (s.seq_window + 7) / 8;        // >= 8 steps a chunk
  chunks = chunks < 1 ? 1 : (chunks > most ? most : chunks);
  const int64_t t_chunk = (s.seq_window + chunks - 1) / chunks;
  chunks = (s.seq_window + t_chunk - 1) / t_chunk;
  dim3 grid((unsigned)blocks_x, (unsigned)chunks, (unsigned)s.batch);
  stack_frames_kernel<OutT, LAYOUT, K><<<grid, threads, 0, stream>>>(
      static_cast<const uint8_t*>(obs), static_cast<uint4*>(out),
      (int)pieces, (int)s.seq_window, (int)t_chunk, (int)s.row_len,
      (int)s.stored_w, (int)s.out_w, s.stored_h * s.stored_w);
  return (int)cudaGetLastError();
}

template <typename OutT, int LAYOUT>
int launch_layout(const void* obs, void* out, const StackShape& s,
                  cudaStream_t stream) {
  switch (s.k) {
    case 1: return launch_pieces<OutT, LAYOUT, 1>(obs, out, s, stream);
    case 2: return launch_pieces<OutT, LAYOUT, 2>(obs, out, s, stream);
    case 4: return launch_pieces<OutT, LAYOUT, 4>(obs, out, s, stream);
    case 8:
      if constexpr (16 / sizeof(OutT) % 8 == 0) {
        return launch_pieces<OutT, LAYOUT, 8>(obs, out, s, stream);
      }
      break;
    default:
      break;
  }
  return launch_any<OutT>(obs, out, s, LAYOUT, stream);
}

template <typename OutT>
int launch_type(const void* obs, void* out, int space_to_depth,
                const StackShape& s, cudaStream_t stream) {
  return space_to_depth
             ? launch_layout<OutT, kSpaceToDepth>(obs, out, s, stream)
             : launch_layout<OutT, kStandard>(obs, out, s, stream);
}

extern "C" int stack_frames(const void* obs, void* out, int out_bf16,
                            int space_to_depth, int64_t batch,
                            int64_t seq_window, int64_t frame_stack,
                            int64_t row_len, int64_t stored_h,
                            int64_t stored_w, int64_t out_h, int64_t out_w,
                            void* stream) {
  if (frame_stack < 1 || (space_to_depth && (out_h % 2 || out_w % 2))) {
    return (int)cudaErrorInvalidValue;
  }
  const StackShape s{batch,    seq_window, frame_stack, row_len,
                     stored_h, stored_w,   out_h,       out_w};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_type<__nv_bfloat16>(obs, out, space_to_depth, s, st)
                  : launch_type<float>(obs, out, space_to_depth, s, st);
}
