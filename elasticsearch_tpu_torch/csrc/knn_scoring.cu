// Kernel 3: dense-vector (kNN) scoring with a fused per-tile top-k, on
// Hopper.
//
// Replaces: elasticsearch_tpu/ops/pallas_knn.py, knn_score_tiles /
// _make_knn_kernel (launch count "knn_scoring"). Per tile of W = sub * 128
// docs and per query q: s = ((dot(x, q) * scale) * 0.5) + 0.5 for every
// doc x of the tile (scale = the doc's inverse norm for cosine; none for
// dot_product), -inf for a doc at or beyond n_rows or with mask <= 0, then
// the tile's k best (score descending, doc ascending), empty slots -inf /
// -1. Outputs [n_tiles, Q, k] f32 scores and i32 docs.
//
// What bounds it on an H100: bytes at small Q, the f32 arithmetic at large
// Q. A call must read the bf16 embeddings of its rows once (2 * d_pad bytes
// a doc), the mask (and the scale for cosine) and the queries, and write
// the candidates; it does one multiply and one add per doc, dimension and
// query. At 1,048,576 docs, d = 128, Q = 16 that is 276.8 MB (0.083 ms at
// 3.35 TB/s) against 4.29 GFLOP (0.064 ms at 67 TFLOP/s).
//
// What the design does about it: one thread block owns one (tile, query)
// pair, blocks ordered tile-major (block = tile * Q + query), as in kernel
// 1c: the Q blocks of a tile run side by side, so the tile's embedding
// rows come from device memory about once and from L2 for the other
// queries. The block keeps its query row (at most 4 KB) and its W scores
// (32 KB at W = 8192) in shared memory, so no score reaches device memory.
// A thread scores one doc at a time, reading its row 16 bytes (8 bf16) a
// load. The tensor cores (a 3 x bf16 split of the f32 query against the
// exact bf16 embeddings, through wgmma) and TMA tile loads are left for a
// later, faster version.
//
// Arithmetic, and why it equals the plain PyTorch version bit for bit: a
// doc's dot runs over j in ascending order, acc = __fadd_rn(acc,
// __fmul_rn(x_j, q_j)) from acc = 0, so no FMA contraction; then
// __fmul_rn by the scale (skipped for dot_product, where the JAX package
// multiplies by exactly 1), __fmul_rn by 0.5 and __fadd_rn of 0.5, each
// rounded on its own. The plain version makes the same f32 operations in
// the same order (elementwise tensor ops round every step). The selection
// (block_topk.cuh) is kernel 1c's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "block_topk.cuh"
#include "launch.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct IdentityAt {
  __device__ int operator()(int local) const { return local; }
};

// Shared memory: qs [d_pad] f32, sc [w] f32, red_v [kWarps] f32,
// red_i [kWarps] i32, sel_v f32.
__global__ void __launch_bounds__(kThreads) knn_score_tiles_kernel(
    const __nv_bfloat16* __restrict__ emb, const float* __restrict__ scale,
    const float* __restrict__ mask, const float* __restrict__ qvecs,
    float* __restrict__ out_scores, int* __restrict__ out_docs, int sub,
    int d_pad, int n_rows, int q_batch, int k) {
  extern __shared__ float smem[];
  const int w = sub * kLane;
  float* qs = smem;
  float* sc = qs + d_pad;
  float* red_v = sc + w;
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);
  float* sel_v = reinterpret_cast<float*>(red_i + kWarps);
  const int t = blockIdx.x / q_batch;
  const int q = blockIdx.x - t * q_batch;

  for (int j = threadIdx.x; j < d_pad; j += blockDim.x)
    qs[j] = qvecs[static_cast<long long>(q) * d_pad + j];
  __syncthreads();

  const long long base = static_cast<long long>(t) * w;
  const int chunks = d_pad / 8;
  for (int local = threadIdx.x; local < w; local += blockDim.x) {
    const long long doc = base + local;
    float v = -CUDART_INF_F;
    if (doc < n_rows && mask[doc] > 0.0f) {
      const uint4* row = reinterpret_cast<const uint4*>(emb + doc * d_pad);
      float acc = 0.0f;
      for (int c = 0; c < chunks; ++c) {
        const uint4 u = __ldg(row + c);
        const __nv_bfloat162* pair =
            reinterpret_cast<const __nv_bfloat162*>(&u);
        const float* qc = qs + c * 8;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 x = __bfloat1622float2(pair[h]);
          acc = __fadd_rn(acc, __fmul_rn(x.x, qc[2 * h]));
          acc = __fadd_rn(acc, __fmul_rn(x.y, qc[2 * h + 1]));
        }
      }
      if (scale != nullptr) acc = __fmul_rn(acc, scale[doc]);
      v = __fadd_rn(__fmul_rn(acc, 0.5f), 0.5f);
    }
    sc[local] = v;
  }
  __syncthreads();

  const long long row = static_cast<long long>(t) * q_batch + q;
  estpu::block_topk<kWarps>(sc, IdentityAt(), w, k, static_cast<int>(base),
                            out_scores + row * k, out_docs + row * k, red_v,
                            red_i, sel_v);
}

}  // namespace

extern "C" int estpu_knn_score_tiles(const void* emb, const void* scale,
                                     const void* mask, const void* qvecs,
                                     void* out_scores, void* out_docs,
                                     int n_tiles, int sub, int d_pad,
                                     int n_rows, int q_batch, int k,
                                     void* stream) {
  if (n_tiles <= 0 || q_batch <= 0 || k <= 0) return 0;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(d_pad) +
                       static_cast<size_t>(sub) * kLane) +
      (sizeof(float) + sizeof(int)) * kWarps + sizeof(float);
  cudaError_t err = estpu::allow_max_dynamic_smem(knn_score_tiles_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_score_tiles_kernel<<<n_tiles * q_batch, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(emb),
      static_cast<const float*>(scale), static_cast<const float*>(mask),
      static_cast<const float*>(qvecs), static_cast<float*>(out_scores),
      static_cast<int*>(out_docs), sub, d_pad, n_rows, q_batch, k);
  return static_cast<int>(cudaGetLastError());
}
