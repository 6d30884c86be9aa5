// Block-wide top-k selection shared by the fused top-k kernels
// (tile_scoring.cu's tile_scoring_topk_kernel, knn_scoring.cu).
//
// k rounds of a block-wide argmax by (score descending, local doc
// ascending) over one tile's scores in shared memory: each thread scans
// its strided share, the warps reduce by shuffles, thread 0 reduces the
// warp winners, writes the winner, and masks it to -inf. Once a round finds
// nothing but -inf, the remaining slots are filled empty (-inf, -1) and
// the loop ends. Doc ids are doc_base + local.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace estpu {

__device__ __forceinline__ bool topk_better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// vals[at(local)] holds the score of local doc ``local`` in [0, w).
// Shared scratch: red_v [kWarps] f32, red_i [kWarps] i32, sel_v f32.
// Ends on a barrier; the caller's blockDim.x is kWarps * 32.
template <int kWarps, typename At>
__device__ void block_topk(float* vals, At at, int w, int k, int doc_base,
                           float* s_out, int* d_out, float* red_v, int* red_i,
                           float* sel_v) {
  const int warp = threadIdx.x >> 5;
  const int lane_id = threadIdx.x & 31;
  for (int r = 0; r < k; ++r) {
    float bv = -CUDART_INF_F;
    int bi = w;  // loses every tie against a real doc
    for (int local = threadIdx.x; local < w; local += blockDim.x) {
      const float v = vals[at(local)];
      if (topk_better(v, local, bv, bi)) {
        bv = v;
        bi = local;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (topk_better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane_id == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = red_v[0];
      int i = red_i[0];
      for (int x = 1; x < kWarps; ++x) {
        if (topk_better(red_v[x], red_i[x], v, i)) {
          v = red_v[x];
          i = red_i[x];
        }
      }
      if (v == -CUDART_INF_F) {
        for (int rr = r; rr < k; ++rr) {
          s_out[rr] = -CUDART_INF_F;
          d_out[rr] = -1;
        }
      } else {
        s_out[r] = v;
        d_out[r] = doc_base + i;
        vals[at(i)] = -CUDART_INF_F;
      }
      *sel_v = v;
    }
    __syncthreads();
    if (*sel_v == -CUDART_INF_F) break;
  }
}

}  // namespace estpu
