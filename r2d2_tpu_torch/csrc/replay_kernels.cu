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
// Design: a sampled window is ONE contiguous run of the ring, so the kernel
// is a batched memcpy. Grid (chunks, B): each block loads its own sample's
// block index and start (the scalar prefetch of the TPU kernel) and copies
// with 16-byte vector loads/stores in a grid-stride loop. Hs*Ws = 7056 and
// 96*128 are multiples of 16, so the vector path covers every byte; the
// wrapper picks the byte-wide instantiation for frame sizes that are not.
// Off-contract indices follow lax.dynamic_slice / jnp indexing in the
// reference: a negative index counts from the end, then start clamps to
// [0, row_len - window] and the block index to [0, num_rows - 1].

template <typename V>
__global__ void gather_windows_kernel(const uint8_t* __restrict__ ring,
                                      const int32_t* __restrict__ block_idx,
                                      const int32_t* __restrict__ start,
                                      uint8_t* __restrict__ out,
                                      int64_t num_rows, int64_t row_len,
                                      int64_t frame_bytes, int64_t window) {
  const int64_t i = blockIdx.y;
  int64_t bi = block_idx[i];
  if (bi < 0) bi += num_rows;
  bi = bi < 0 ? 0 : (bi >= num_rows ? num_rows - 1 : bi);
  int64_t st = start[i];
  if (st < 0) st += row_len;
  const int64_t max_start = row_len - window;
  st = st < 0 ? 0 : (st > max_start ? max_start : st);

  const int64_t n = window * frame_bytes / sizeof(V);
  const V* src = reinterpret_cast<const V*>(
      ring + (bi * row_len + st) * frame_bytes);
  V* dst = reinterpret_cast<V*>(out + i * window * frame_bytes);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    dst[j] = __ldg(src + j);
  }
}

extern "C" int gather_windows(const void* ring, const void* block_idx,
                              const void* start, void* out, int64_t batch,
                              int64_t num_rows, int64_t row_len,
                              int64_t frame_bytes, int64_t window, int vec16,
                              void* stream) {
  const int threads = 256;
  const int64_t bytes = window * frame_bytes;
  const int64_t units = vec16 ? bytes / 16 : bytes;
  // ~4 units per thread per pass; enough blocks in flight to fill 132 SMs
  int64_t chunks = (units + threads * 4 - 1) / (threads * 4);
  if (chunks < 1) chunks = 1;
  if (chunks > 65535) chunks = 65535;
  dim3 grid((unsigned)chunks, (unsigned)batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec16) {
    gather_windows_kernel<uint4><<<grid, threads, 0, s>>>(
        static_cast<const uint8_t*>(ring),
        static_cast<const int32_t*>(block_idx),
        static_cast<const int32_t*>(start), static_cast<uint8_t*>(out),
        num_rows, row_len, frame_bytes, window);
  } else {
    gather_windows_kernel<uint8_t><<<grid, threads, 0, s>>>(
        static_cast<const uint8_t*>(ring),
        static_cast<const int32_t*>(block_idx),
        static_cast<const int32_t*>(start), static_cast<uint8_t*>(out),
        num_rows, row_len, frame_bytes, window);
  }
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
