// Tile scoring: the BM25 scoring hot loop on Hopper.
//
// Replaces: elasticsearch_tpu/ops/pallas_scoring.py, score_tiles /
// _make_kernel, in these forms:
//   - dense, q_batch = 1, with and without counts (launch count
//     "tile_scoring");
//   - dense, q_batch = Q > 1 over the union of Q queries' lanes, with and
//     without counts ("tile_scoring_batched");
//   - fused per-tile top-k, q_batch = Q >= 1 ("tile_scoring_topk");
//   - each of those over the packed codec (codec="packed", pallas_scoring.py
//     :656-669): one i32 word a posting, doc << 12 | frac_q, decoded with a
//     logical shift, a mask and frac_q * PACK_FRAC_SCALE in f32
//     ("tile_scoring_packed", "tile_scoring_batched_packed",
//     "tile_scoring_topk_packed");
//   - the top-k form over a tile subset (tile_ids "sel mode",
//     pallas_scoring.py:770-804, driven by score_tiles_pruned), raw and
//     packed ("tile_scoring_topk_sel", "tile_scoring_topk_sel_packed").
// On the TPU the scatter "acc[doc - base] += w * frac" became a radix
// one-hot MXU matmul because a scatter runs serially there; a GPU has
// cheap shared-memory scatters, so these kernels scatter directly.
//
// What bounds it on an H100: bytes. A call must read the lanes' posting
// rows (8 bytes a posting: doc i32 + frac f32; 4 for a packed word) and
// the live mask, and write the outputs: 4 * nd_pad bytes of scores per query for the dense
// forms (twice that with counts), k scores + k docs + 1 hit count per
// (tile, query) for the top-k form. The arithmetic is one multiply and
// one add per posting and query.
//
// What the design does about it: one thread block owns one (tile, query)
// pair, blocks ordered tile-major (block = tile * Q + query). The block
// keeps that query's tile accumulator of W = sub * 128 floats (and its
// match counts) in shared memory, so device memory sees each output once.
// Shared memory is the reason for one query per block: Q accumulators of
// W floats (1 MB at Q = 16, W = 16,384) do not fit the 227 KB a block may
// use, one (64 KB, 128 KB with counts) does. The Q blocks of a tile run
// next to each other, so a union lane's posting rows come from device
// memory about once and from L2 for the other queries; a block reads only
// the lanes its query weights (w_q != 0), so a query never pays for
// another's terms.
//
// Arithmetic, and why a batched member equals its serial result bit for
// bit: thread 0 lists the block's lanes that have rows and a nonzero
// weight, sorted by their first posting row (stable). Different terms own
// disjoint posting-row runs, so this order is the same in every tile and
// does not depend on where a lane sits in the table: the serial table (a
// query's own lanes) and the batched table (the union of Q queries'
// lanes) give each query the same lanes in the same order. Lanes then run
// in that order with a barrier between lanes; inside a lane the threads
// read the lane's rows coalesced (128 postings a row) and, because one
// term's postings hit distinct docs, update the accumulator without
// atomics: acc = __fadd_rn(acc, __fmul_rn(w_q, frac)), no FMA contraction.
// The plain PyTorch versions make the same adds in the same order. A count
// is added only where w_q > 0 (a dead lane adds no count).
//
// Top-k epilogue, per (tile, query): matched = acc > 0 && live; the hit
// count; then k rounds of a block-wide argmax by (score descending, local
// doc ascending), each winner masked out, empty slots -inf / -1, doc ids
// tile * W + local. Once a round finds nothing the rest are filled empty.
// The selection lives in block_topk.cuh, shared with the kNN kernel.
//
// Packed codec: the decode sits in the posting loop, so the packed forms
// read half the posting bytes and are otherwise the raw kernels. doc =
// (unsigned)word >> 12 (a doc at or above 2^19 sets the word's sign bit,
// which an arithmetic shift would smear), f = __fmul_rn(frac_q as f32,
// scale), where scale is np.float32(PACK_FRAC_SCALE) passed from Python: the
// plain version and the JAX kernel multiply by the same f32. f > 0 stays
// the validity test (frac_q == 0 marks padding).
//
// Sel mode: block b scores tile tile_ids[b / Q] from table row b / Q (the
// doc base and the live rows come from the real tile id, the outputs go to
// subset position b / Q). A row whose windows are all empty (the pruned
// orchestration zeroes the rows of the tiles it skips) writes -inf / -1 /
// 0, what the kernel gives for an empty tile, and returns before the lane
// sort and the accumulator clear: the work a pruned tile saves.
//
// Each 128-float row of the accumulator is padded by one float so the
// transposed reads of the epilogue (the JAX output layout [n_tiles * 128,
// sub], local doc s * 128 + lane at row lane, column s) are free of bank
// conflicts.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "block_topk.cuh"
#include "launch.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPackFracBits = 12;
constexpr int kPackFracMask = (1 << kPackFracBits) - 1;

__device__ __forceinline__ int padded(int local) { return local + (local >> 7); }

// Thread 0 lists the live lanes of this (tile, query) in ascending order of
// their first posting row (stable); returns the count to every thread.
__device__ int lane_order(const int* __restrict__ row_lo_t,
                          const int* __restrict__ row_hi_t,
                          const float* __restrict__ w_q, int t_pad, int n_rows,
                          int* order, int* key, int* n_live) {
  if (threadIdx.x == 0) {
    int n = 0;
    for (int j = 0; j < t_pad; ++j) {
      const int lo = row_lo_t[j];
      const int hi = min(row_hi_t[j], n_rows);
      if (hi <= lo || w_q[j] == 0.0f) continue;
      int i = n++;
      while (i > 0 && key[i - 1] > lo) {
        key[i] = key[i - 1];
        order[i] = order[i - 1];
        --i;
      }
      key[i] = lo;
      order[i] = j;
    }
    *n_live = n;
  }
  __syncthreads();
  return *n_live;
}

// Adds every live lane's postings of tile [base, base + w) into acc (and
// cnt, where given) in lane order; ends on a barrier. kPacked: ``docs``
// holds packed words and ``frac`` is unused.
template <bool kPacked>
__device__ void accumulate(const int* __restrict__ docs,
                           const float* __restrict__ frac, float scale,
                           const int* __restrict__ row_lo_t,
                           const int* __restrict__ row_hi_t,
                           const float* __restrict__ w_q, const int* order,
                           int n_live, long long base, int w, int n_rows,
                           float* acc, float* cnt) {
  for (int i = 0; i < n_live; ++i) {
    const int j = order[i];
    const long long p_end =
        static_cast<long long>(min(row_hi_t[j], n_rows)) * kLane;
    const float wj = w_q[j];
    const bool count = cnt != nullptr && wj > 0.0f;
    for (long long p = static_cast<long long>(row_lo_t[j]) * kLane +
                       threadIdx.x;
         p < p_end; p += blockDim.x) {
      int doc;
      float f;
      if (kPacked) {
        const int word = __ldg(docs + p);
        doc = static_cast<int>(static_cast<unsigned>(word) >> kPackFracBits);
        f = __fmul_rn(__int2float_rn(word & kPackFracMask), scale);
      } else {
        doc = __ldg(docs + p);
        f = __ldg(frac + p);
      }
      const long long local = static_cast<long long>(doc) - base;
      if (local >= 0 && local < w && f > 0.0f) {
        const int k = padded(static_cast<int>(local));
        acc[k] = __fadd_rn(acc[k], __fmul_rn(wj, f));
        if (count) cnt[k] = __fadd_rn(cnt[k], 1.0f);
      }
    }
    __syncthreads();
  }
}

// Shared memory: acc [w + sub] f32, cnt [w + sub] f32 (with counts),
// order [t_pad] i32, key [t_pad] i32, n_live i32.
template <bool kPacked>
__global__ void __launch_bounds__(kThreads) tile_scoring_dense_kernel(
    const int* __restrict__ docs, const float* __restrict__ frac, float scale,
    const float* __restrict__ live_t, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, const float* __restrict__ weights,
    float* __restrict__ out_scores, float* __restrict__ out_counts,
    int n_tiles, int t_pad, int sub, int n_rows, int q_batch) {
  extern __shared__ float smem[];
  const int w = sub * kLane;
  const int w_padded = w + sub;
  const bool with_counts = out_counts != nullptr;
  float* acc = smem;
  float* cnt = with_counts ? smem + w_padded : nullptr;
  int* order = reinterpret_cast<int*>(smem + w_padded * (with_counts ? 2 : 1));
  int* key = order + t_pad;
  int* n_live_slot = key + t_pad;
  const int t = blockIdx.x / q_batch;
  const int q = blockIdx.x - t * q_batch;

  for (int i = threadIdx.x; i < w_padded; i += blockDim.x) {
    acc[i] = 0.0f;
    if (with_counts) cnt[i] = 0.0f;
  }
  const int* rl = row_lo + static_cast<long long>(t) * t_pad;
  const int* rh = row_hi + static_cast<long long>(t) * t_pad;
  const float* wq = weights + static_cast<long long>(q) * t_pad;
  const int n_live = lane_order(rl, rh, wq, t_pad, n_rows, order, key,
                                n_live_slot);
  const long long base = static_cast<long long>(t) * w;
  accumulate<kPacked>(docs, frac, scale, rl, rh, wq, order, n_live, base, w,
                      n_rows, acc, cnt);

  // epilogue: element o = lane * sub + s of this tile's [128, sub] block
  // holds local doc s * 128 + lane
  const long long out_base = (static_cast<long long>(q) * n_tiles + t) * w;
  for (int o = threadIdx.x; o < w; o += blockDim.x) {
    const int lane = o / sub;
    const int s = o - lane * sub;
    const int k = padded(s * kLane + lane);
    const bool alive = live_t[base + o] > 0.0f;
    out_scores[out_base + o] = alive ? acc[k] : 0.0f;
    if (with_counts) out_counts[out_base + o] = alive ? cnt[k] : 0.0f;
  }
}

// the accumulator position of local doc ``local`` (rows padded by one)
struct PaddedAt {
  __device__ int operator()(int local) const { return padded(local); }
};

// Shared memory: acc [w + sub] f32, order [t_pad] i32, key [t_pad] i32,
// n_live i32, red_v [kWarps] f32, red_i [kWarps] i32, sel_v f32 (and one
// spare i32). tile_ids: nullptr, or the sel-mode subset [n_tiles].
template <bool kPacked>
__global__ void __launch_bounds__(kThreads) tile_scoring_topk_kernel(
    const int* __restrict__ docs, const float* __restrict__ frac, float scale,
    const float* __restrict__ live_t, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, const float* __restrict__ weights,
    const int* __restrict__ tile_ids, float* __restrict__ out_scores,
    int* __restrict__ out_docs, float* __restrict__ out_hits, int n_tiles,
    int t_pad, int sub, int n_rows, int q_batch, int k) {
  extern __shared__ float smem[];
  const int w = sub * kLane;
  const int w_padded = w + sub;
  float* acc = smem;
  int* order = reinterpret_cast<int*>(smem + w_padded);
  int* key = order + t_pad;
  int* n_live_slot = key + t_pad;
  float* red_v = reinterpret_cast<float*>(n_live_slot + 1);
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);
  float* sel_v = reinterpret_cast<float*>(red_i + kWarps);
  // pos: the table row (the subset position in sel mode); t: its tile
  const int pos = blockIdx.x / q_batch;
  const int q = blockIdx.x - pos * q_batch;
  const int warp = threadIdx.x >> 5;
  const int lane_id = threadIdx.x & 31;
  const int* rl = row_lo + static_cast<long long>(pos) * t_pad;
  const int* rh = row_hi + static_cast<long long>(pos) * t_pad;
  const long long row = static_cast<long long>(pos) * q_batch + q;
  int t = pos;
  if (tile_ids != nullptr) {
    bool scored = false;
    for (int j = 0; j < t_pad; ++j) scored = scored || rh[j] > rl[j];
    if (!scored) {
      for (int i = threadIdx.x; i < k; i += blockDim.x) {
        out_scores[row * k + i] = -CUDART_INF_F;
        out_docs[row * k + i] = -1;
      }
      if (threadIdx.x == 0) out_hits[row] = 0.0f;
      return;
    }
    t = tile_ids[pos];
  }

  for (int i = threadIdx.x; i < w_padded; i += blockDim.x) acc[i] = 0.0f;
  const float* wq = weights + static_cast<long long>(q) * t_pad;
  const int n_live = lane_order(rl, rh, wq, t_pad, n_rows, order, key,
                                n_live_slot);
  const long long base = static_cast<long long>(t) * w;
  accumulate<kPacked>(docs, frac, scale, rl, rh, wq, order, n_live, base, w,
                      n_rows, acc, nullptr);

  // matched = acc > 0 && live; unmatched slots become -inf in place
  int my_hits = 0;
  for (int o = threadIdx.x; o < w; o += blockDim.x) {
    const int lane = o / sub;
    const int s = o - lane * sub;
    const int kk = padded(s * kLane + lane);
    if (acc[kk] > 0.0f && live_t[base + o] > 0.0f) {
      ++my_hits;
    } else {
      acc[kk] = -CUDART_INF_F;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    my_hits += __shfl_down_sync(0xffffffffu, my_hits, off);
  if (lane_id == 0) red_i[warp] = my_hits;
  __syncthreads();
  if (threadIdx.x == 0) {
    int hits = 0;
    for (int i = 0; i < kWarps; ++i) hits += red_i[i];
    out_hits[row] = static_cast<float>(hits);
  }
  __syncthreads();

  estpu::block_topk<kWarps>(acc, PaddedAt(), w, k, static_cast<int>(t) * w,
                            out_scores + row * k, out_docs + row * k, red_v,
                            red_i, sel_v);
}

}  // namespace

extern "C" int estpu_tile_scoring_dense(
    const void* docs, const void* frac, const void* live_t,
    const void* row_lo, const void* row_hi, const void* weights,
    void* out_scores, void* out_counts, int n_tiles, int t_pad, int sub,
    int n_rows, int q_batch, int packed, float scale, void* stream) {
  if (n_tiles <= 0 || q_batch <= 0) return 0;
  const size_t w_padded = static_cast<size_t>(sub) * kLane + sub;
  const size_t smem = sizeof(float) * w_padded * (out_counts ? 2 : 1) +
                      sizeof(int) * (2 * static_cast<size_t>(t_pad) + 1);
  auto kernel = packed ? tile_scoring_dense_kernel<true>
                       : tile_scoring_dense_kernel<false>;
  cudaError_t err = estpu::allow_max_dynamic_smem(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_tiles * q_batch, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(docs), static_cast<const float*>(frac), scale,
      static_cast<const float*>(live_t), static_cast<const int*>(row_lo),
      static_cast<const int*>(row_hi), static_cast<const float*>(weights),
      static_cast<float*>(out_scores), static_cast<float*>(out_counts),
      n_tiles, t_pad, sub, n_rows, q_batch);
  return static_cast<int>(cudaGetLastError());
}

// tile_ids: nullptr, or the sel-mode subset (n_tiles = its length)
extern "C" int estpu_tile_scoring_topk(
    const void* docs, const void* frac, const void* live_t,
    const void* row_lo, const void* row_hi, const void* weights,
    const void* tile_ids, void* out_scores, void* out_docs, void* out_hits,
    int n_tiles, int t_pad, int sub, int n_rows, int q_batch, int k,
    int packed, float scale, void* stream) {
  if (n_tiles <= 0 || q_batch <= 0 || k <= 0) return 0;
  const size_t w_padded = static_cast<size_t>(sub) * kLane + sub;
  const size_t smem = sizeof(float) * w_padded +
                      sizeof(int) * (2 * static_cast<size_t>(t_pad) + 1) +
                      (sizeof(float) + sizeof(int)) * (kWarps + 1);
  auto kernel = packed ? tile_scoring_topk_kernel<true>
                       : tile_scoring_topk_kernel<false>;
  cudaError_t err = estpu::allow_max_dynamic_smem(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_tiles * q_batch, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(docs), static_cast<const float*>(frac), scale,
      static_cast<const float*>(live_t), static_cast<const int*>(row_lo),
      static_cast<const int*>(row_hi), static_cast<const float*>(weights),
      static_cast<const int*>(tile_ids), static_cast<float*>(out_scores),
      static_cast<int*>(out_docs), static_cast<float*>(out_hits), n_tiles,
      t_pad, sub, n_rows, q_batch, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* estpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
