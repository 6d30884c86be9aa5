// Tile scoring, dense variant: the BM25 scoring hot loop on Hopper.
//
// Replaces: elasticsearch_tpu/ops/pallas_scoring.py, score_tiles /
// _make_kernel (raw codec, q_batch = 1, dense, with and without counts).
// On the TPU the scatter "acc[doc - base] += w * frac" became a radix
// one-hot MXU matmul because a scatter runs serially there; a GPU has
// cheap shared-memory scatters, so this kernel does the scatter directly.
//
// What bounds it on an H100: bytes. Per call it must read the query
// lanes' posting rows (8 bytes a posting: doc i32 + frac f32), the live
// mask (4 * nd_pad bytes) and write 4 * nd_pad bytes of scores (twice that
// with counts). The arithmetic is one multiply and one add per posting.
//
// What the design does about it: one thread block owns one tile of
// W = sub * 128 docs. Its accumulator (and the match counts) live in
// shared memory for the whole tile, so device memory sees each output
// exactly once. Lanes run in order with a barrier between them; inside a
// lane the threads read the lane's posting rows coalesced (128 postings a
// row) and, because one term's postings hit distinct docs, update the
// accumulator without atomics. The adds are __fmul_rn/__fadd_rn (no FMA
// contraction), so the result equals the plain PyTorch version bit for
// bit. Each 128-float row of the accumulator is padded by one float so the
// epilogue's transposed read (the JAX output layout) is free of bank
// conflicts.

#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 512;

__device__ __forceinline__ int padded(int local) { return local + (local >> 7); }

__global__ void __launch_bounds__(kThreads) tile_scoring_dense_kernel(
    const int* __restrict__ docs, const float* __restrict__ frac,
    const float* __restrict__ live_t, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, const float* __restrict__ weights,
    float* __restrict__ out_scores, float* __restrict__ out_counts,
    int t_pad, int sub, int n_rows) {
  extern __shared__ float smem[];
  const int w = sub * kLane;
  const int w_padded = w + sub;
  float* acc = smem;
  float* cnt = smem + w_padded;
  const bool with_counts = out_counts != nullptr;
  const int t = blockIdx.x;

  for (int i = threadIdx.x; i < w_padded; i += blockDim.x) {
    acc[i] = 0.0f;
    if (with_counts) cnt[i] = 0.0f;
  }
  __syncthreads();

  const long long base = static_cast<long long>(t) * w;
  for (int j = 0; j < t_pad; ++j) {
    const int rlo = row_lo[t * t_pad + j];
    const int rhi = min(row_hi[t * t_pad + j], n_rows);
    if (rhi > rlo) {
      const float wj = weights[j];
      const long long p_end = static_cast<long long>(rhi) * kLane;
      for (long long p = static_cast<long long>(rlo) * kLane + threadIdx.x;
           p < p_end; p += blockDim.x) {
        const long long local = static_cast<long long>(__ldg(docs + p)) - base;
        const float f = __ldg(frac + p);
        if (local >= 0 && local < w && f > 0.0f) {
          const int k = padded(static_cast<int>(local));
          acc[k] = __fadd_rn(acc[k], __fmul_rn(wj, f));
          if (with_counts) cnt[k] = __fadd_rn(cnt[k], 1.0f);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: element o = lane * sub + s of this tile's [128, sub] block
  // holds local doc s * 128 + lane
  const long long out_base = static_cast<long long>(t) * w;
  for (int o = threadIdx.x; o < w; o += blockDim.x) {
    const int lane = o / sub;
    const int s = o - lane * sub;
    const int k = padded(s * kLane + lane);
    const bool alive = live_t[out_base + o] > 0.0f;
    out_scores[out_base + o] = alive ? acc[k] : 0.0f;
    if (with_counts) out_counts[out_base + o] = alive ? cnt[k] : 0.0f;
  }
}

}  // namespace

extern "C" int estpu_tile_scoring_dense(
    const void* docs, const void* frac, const void* live_t,
    const void* row_lo, const void* row_hi, const void* weights,
    void* out_scores, void* out_counts, int n_tiles, int t_pad, int sub,
    int n_rows, void* stream) {
  if (n_tiles <= 0) return 0;
  const int w_padded = sub * kLane + sub;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(w_padded) * (out_counts ? 2 : 1);
  cudaError_t err = cudaFuncSetAttribute(
      tile_scoring_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_scoring_dense_kernel<<<n_tiles, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(docs), static_cast<const float*>(frac),
      static_cast<const float*>(live_t), static_cast<const int*>(row_lo),
      static_cast<const int*>(row_hi), static_cast<const float*>(weights),
      static_cast<float*>(out_scores), static_cast<float*>(out_counts), t_pad,
      sub, n_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* estpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
