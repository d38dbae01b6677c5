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
// stack_frames: out[b, t, h, w, k] = obs[b, t + k, h, w] * (1/255)
//
// Replaces r2d2_tpu/ops/pallas_kernels.py stack_frames_pallas (K3: bodies
// _stack_kernel, _stack_kernel_nhwc32, _stack_kernel_nhwc16).
//
// Bound: bytes. 52.4 MB read + 397.4 MB bf16 written at the reference shape
// (~134 us at 3.35 TB/s). Design: one thread per output pixel (b, t, h, w)
// reads its K uint8 values (one per frame; neighbouring threads read
// neighbouring w, so each frame read is coalesced), scales each in f32 by
// f32(1/255) (the Pallas kernel's multiply), rounds once into the output
// type, and writes K contiguous values (8 bytes for K=4 bf16, one vector
// store). Only the out_height x out_width window of a padded stored frame
// is read. The output is the public (B, T, H, W, K) layout, which viewed as
// (B*T, H, W, K) and permuted to (B*T, K, H, W) is already a channels_last
// NCHW tensor: the conv torso takes it with no copy, so the TPU kernel's
// planar/NHWC split (a Mosaic layout workaround) has no counterpart here.

__device__ __forceinline__ void store_k(float* dst, const float* v, int k) {
  if (k == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < k; ++j) dst[j] = v[j];
  }
}

__device__ __forceinline__ void store_k(__nv_bfloat16* dst, const float* v,
                                        int k) {
  if (k == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
  } else {
    for (int j = 0; j < k; ++j) dst[j] = __float2bfloat16_rn(v[j]);
  }
}

constexpr int kMaxStack = 16;

template <typename OutT>
__global__ void stack_frames_kernel(const uint8_t* __restrict__ obs,
                                    OutT* __restrict__ out, int64_t total,
                                    int64_t seq_window, int64_t k,
                                    int64_t row_len, int64_t stored_h,
                                    int64_t stored_w, int64_t out_h,
                                    int64_t out_w) {
  const float inv = 1.0f / 255.0f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < total;
       p += stride) {
    const int64_t w = p % out_w;
    int64_t rest = p / out_w;
    const int64_t h = rest % out_h;
    rest /= out_h;
    const int64_t t = rest % seq_window;
    const int64_t b = rest / seq_window;
    const uint8_t* src =
        obs + ((b * row_len + t) * stored_h + h) * stored_w + w;
    const int64_t frame = stored_h * stored_w;
    float v[kMaxStack];
    for (int j = 0; j < k; ++j) {
      v[j] = __fmul_rn((float)__ldg(src + j * frame), inv);
    }
    store_k(out + p * k, v, (int)k);
  }
}

extern "C" int stack_frames(const void* obs, void* out, int out_bf16,
                            int64_t batch, int64_t seq_window,
                            int64_t frame_stack, int64_t row_len,
                            int64_t stored_h, int64_t stored_w, int64_t out_h,
                            int64_t out_w, void* stream) {
  if (frame_stack < 1 || frame_stack > kMaxStack) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  const int64_t total = batch * seq_window * out_h * out_w;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    stack_frames_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(obs), static_cast<__nv_bfloat16*>(out),
        total, seq_window, frame_stack, row_len, stored_h, stored_w, out_h,
        out_w);
  } else {
    stack_frames_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(obs), static_cast<float*>(out), total,
        seq_window, frame_stack, row_len, stored_h, stored_w, out_h, out_w);
  }
  return (int)cudaGetLastError();
}
