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
// 3.35 TB/s) against 4.29 GFLOP (0.064 ms at 67 TFLOP/s). The 67 TFLOP/s
// count an FMA as two operations; a separately rounded multiply and add
// (the arithmetic below) are two instructions, so the CUDA cores reach at
// most half of it: about 0.128 ms at Q = 16 on 1M x 128.
//
// The design (tile_scoring.topk_cluster_plan picks C and G):
//   1. A tile's docs split into C bands of D = W / C docs, one CTA each,
//      the C bands of a tile one thread-block cluster; a CTA holds a group
//      of G <= 16 queries (all Q where they fit), so the grid is n_tiles *
//      ceil(Q / G) * C CTAs. A 262,144-doc slot (32 tiles of 8,192) at Q =
//      1 with C = 8 is 256 CTAs, where one CTA per (tile, query) made 32.
//   2. Each embedding byte leaves device memory once per query group: the
//      band's bf16 rows stream through a 2-stage shared-memory ring, 256
//      rows by 64 columns (one 128-byte line of a row) a stage, copied
//      with cp.async 16 bytes a thread (neighbouring threads on
//      neighbouring addresses of one row); the next stage is in flight
//      while the current one is multiplied. Each stored row is padded by
//      16 bytes, so 32 threads reading 32 rows at one column (16 bytes
//      each) hit no bank twice in a quarter warp. (A deeper ring or three
//      CTAs an SM did not win at every main-path shape on the card.)
//   3. A thread owns one doc of the 256 in flight and keeps its G dots in
//      registers; the group's query rows sit in shared memory (8 KB at Q
//      = 16, d_pad 128), read as broadcasts.
//   4. The selection is block_topk.cuh's: a one-pass-per-digit radix
//      select per band and query, then rank 0 of the cluster merges the
//      bands' candidates over distributed shared memory.
// Tensor cores are left out: a 3 x bf16 wgmma split of the f32 query
// changes every score's bits against the plain version, and the
// bit-for-bit contract of the mesh rung and of chip_smoke.py's kNN phases
// rests on those bits (ROADMAP: the tensor-core design, with its
// tolerance, is a later item).
//
// Arithmetic, and why it equals the plain PyTorch version bit for bit: a
// doc's dot runs over j in ascending order, acc = __fadd_rn(acc,
// __fmul_rn(x_j, q_j)) from acc = 0, so no FMA contraction; then
// __fmul_rn by the scale (skipped for dot_product, where the JAX package
// multiplies by exactly 1), __fmul_rn by 0.5 and __fadd_rn of 0.5, each
// rounded on its own. The plain version makes the same f32 operations in
// the same order (elementwise tensor ops round every step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "block_topk.cuh"
#include "launch.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kLane = 128;
constexpr int kThreads = estpu::kSelectThreads;
constexpr int kMaxGroup = 16;     // queries a CTA holds (registers)
constexpr int kRowGroup = 256;    // docs in flight: one a thread
constexpr int kChunkCols = 64;    // bf16 columns of a stage: 128-byte rows
constexpr int kRowStride = kChunkCols + 8;  // bf16 a stored row, padded
constexpr int kStages = 2;
constexpr int kRingWords = kStages * kRowGroup * kRowStride / 2;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

struct IdentityAt {
  __device__ int operator()(int b) const { return b; }
};

// Shared memory of one CTA in 4-byte words: the selection's, the ring,
// the group's queries [G][d_pad] f32 and its keys [G][D]. Kept in step
// with tile_scoring.topk_knn_smem.
__host__ __device__ inline size_t knn_smem_words(int cluster, int group,
                                                 int k, int sub, int d_pad) {
  const int band = sub * kLane / cluster;
  return estpu::topk_select_words(cluster, group, k, band) + kRingWords +
         static_cast<size_t>(group) * d_pad +
         static_cast<size_t>(group) * band;
}

// Block = (tile t, group z, band): band fastest, the C = cluster bands of
// one (tile, group) one thread-block cluster.
__global__ void __launch_bounds__(kThreads, 2) knn_score_tiles_kernel(
    const __nv_bfloat16* __restrict__ emb, const float* __restrict__ scale,
    const float* __restrict__ mask, const float* __restrict__ qvecs,
    float* __restrict__ out_scores, int* __restrict__ out_docs, int sub,
    int d_pad, int n_rows, int q_batch, int k, int cluster, int group) {
  extern __shared__ __align__(16) unsigned knn_smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x;
  const int C = cluster;
  const int w = sub * kLane;
  const int d = w / C;
  const int n_groups = (q_batch + group - 1) / group;
  const int band = blockIdx.x % C;
  const int z = (blockIdx.x / C) % n_groups;
  const int t = blockIdx.x / C / n_groups;
  const int q0 = z * group;
  const int gn = min(group, q_batch - q0);
  const int kp = min(k, d);
  const int p = estpu::next_pow2_int(kp);

  // carve: gather (u64), lists, scratch, counts, the ranks' counts, ring,
  // queries, keys (see knn_smem_words)
  auto* gather = reinterpret_cast<unsigned long long*>(knn_smem);
  size_t off = estpu::align4(C > 1 ? 2 * static_cast<size_t>(group) * C * kp
                                   : 0);
  auto* wlists = reinterpret_cast<unsigned long long*>(knn_smem + off);
  unsigned* list = knn_smem + off;
  off += estpu::align4(kp <= estpu::kWarpK
                           ? 2 * estpu::kWarpK *
                                 (group + 4 * estpu::kSelectWarps)
                           : static_cast<size_t>(p));
  const estpu::SelectScratch scr(knn_smem + off);
  int* counts_s = reinterpret_cast<int*>(knn_smem + off + estpu::kSelectWords);
  int* ncs_all = counts_s + 2 * group;  // [G][C], filled by every rank
  off += estpu::align4(estpu::kSelectWords + 2 * static_cast<size_t>(group) +
                       2 * static_cast<size_t>(group) * C);
  auto* ring = reinterpret_cast<__nv_bfloat16*>(knn_smem + off);
  off += kRingWords;
  float* qs = reinterpret_cast<float*>(knn_smem + off);
  off += static_cast<size_t>(group) * d_pad;
  unsigned* keys = knn_smem + off;
  if (C > 1) estpu::cluster_arrive_relaxed();

  const long long tile_base = static_cast<long long>(t) * w;
  const long long band_base = tile_base + static_cast<long long>(band) * d;
  const int n_cc = (d_pad + kChunkCols - 1) / kChunkCols;
  const int n_rg = (d + kRowGroup - 1) / kRowGroup;
  const int steps = n_rg * n_cc;

  // stage st: rows [rg * 256, + 256) of the band, columns [cc * 32, + 32)
  auto issue = [&](int st) {
    if (st < steps) {
      const int rg = st / n_cc, cc = st - (st / n_cc) * n_cc;
      const int col0 = cc * kChunkCols;
      const int pieces = min(kChunkCols, d_pad - col0) / 8;
      __nv_bfloat16* dst = ring + (st % kStages) * kRowGroup * kRowStride;
      for (int i = tid; i < kRowGroup * (kChunkCols / 8); i += kThreads) {
        const int r = i / (kChunkCols / 8);
        const int pc = i - r * (kChunkCols / 8);
        const int b = rg * kRowGroup + r;
        const long long doc = band_base + b;
        if (pc < pieces && b < d && doc < n_rows)
          cp_async16(dst + r * kRowStride + pc * 8,
                     emb + doc * d_pad + col0 + pc * 8);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int st = 0; st < kStages - 1; ++st) issue(st);

  for (int i = tid; i < gn * d_pad; i += kThreads)
    qs[i] = qvecs[static_cast<long long>(q0) * d_pad + i];

  float acc[kMaxGroup];
  bool live = false;
  float sc = 1.0f;
  for (int st = 0; st < steps; ++st) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    issue(st + kStages - 1);
    const int rg = st / n_cc, cc = st - (st / n_cc) * n_cc;
    const int b = rg * kRowGroup + tid;
    const long long doc = band_base + b;
    if (cc == 0) {
      // two independent loads, first used when the row group ends
      const bool in = b < d && doc < n_rows;
      live = in && mask[doc] > 0.0f;
      sc = (in && scale != nullptr) ? scale[doc] : 1.0f;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.0f;
    }
    const __nv_bfloat16* row =
        ring + (st % kStages) * kRowGroup * kRowStride + tid * kRowStride;
    const int col0 = cc * kChunkCols;
    const int pieces = min(kChunkCols, d_pad - col0) / 8;
    for (int pc = 0; pc < pieces; ++pc) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + pc * 8);
      const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&u);
      float x[8];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 f = __bfloat1622float2(pair[h]);
        x[2 * h] = f.x;
        x[2 * h + 1] = f.y;
      }
      const float* qc = qs + col0 + pc * 8;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < gn) {
          const float4 qa = *reinterpret_cast<const float4*>(qc + g * d_pad);
          const float4 qb =
              *reinterpret_cast<const float4*>(qc + g * d_pad + 4);
          float a = acc[g];
          a = __fadd_rn(a, __fmul_rn(x[0], qa.x));
          a = __fadd_rn(a, __fmul_rn(x[1], qa.y));
          a = __fadd_rn(a, __fmul_rn(x[2], qa.z));
          a = __fadd_rn(a, __fmul_rn(x[3], qa.w));
          a = __fadd_rn(a, __fmul_rn(x[4], qb.x));
          a = __fadd_rn(a, __fmul_rn(x[5], qb.y));
          a = __fadd_rn(a, __fmul_rn(x[6], qb.z));
          a = __fadd_rn(a, __fmul_rn(x[7], qb.w));
          acc[g] = a;
        }
      }
    }
    if (cc == n_cc - 1 && b < d) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < gn) {
          float v = acc[g];
          if (scale != nullptr) v = __fmul_rn(v, sc);
          v = __fadd_rn(__fmul_rn(v, 0.5f), 0.5f);
          keys[g * d + b] = live ? estpu::score_key(v) : 0u;
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const IdentityAt at{};
  const long long rows0 = static_cast<long long>(t) * q_batch + q0;
  auto keys_of = [&](int g) { return keys + g * d; };
  unsigned long long* wscratch = wlists + group * estpu::kWarpK;
  if (kp <= estpu::kWarpK)
    estpu::warp_select(
        [&](int g, int b) -> unsigned long long {
          const unsigned key = keys_of(g)[at(b)];
          return key ? estpu::cand_word(key, static_cast<unsigned>(b)) : 0ull;
        },
        d, gn, k, wlists, wscratch, counts_s);
  if (C > 1) estpu::cluster_wait();  // every rank has started
  for (int g = 0; g < gn; ++g) {
    int n;
    if (kp <= estpu::kWarpK) {
      n = counts_s[g];
    } else {
      n = estpu::band_select(keys_of(g), at, d, k, list, scr);
    }
    auto cand = [&](int j) -> unsigned long long {
      if (kp <= estpu::kWarpK) return wlists[g * estpu::kWarpK + j];
      return estpu::cand_word(keys[g * d + list[j]], list[j]);
    };
    if (C == 1) {
      estpu::write_row(cand, n, k, tile_base, out_scores + (rows0 + g) * k,
                       out_docs + (rows0 + g) * k);
    } else {
      estpu::push_to_rank0(cl, cand, n, band_base, gather, ncs_all, nullptr,
                           g, band, C, kp, -1);
    }
  }
  if (C == 1) return;

  // the cluster merge: rank 0 holds every band's candidates
  cl.sync();
  if (band != 0) return;
  if (kp <= estpu::kWarpK)
    estpu::merge_small(gather, ncs_all, gn, C, kp, k, wlists, wscratch,
                       counts_s, out_scores, out_docs, rows0);
  for (int g = 0; g < gn && kp > estpu::kWarpK; ++g)
    estpu::merge_lists(gather + static_cast<size_t>(g) * C * kp,
                       ncs_all + g * C, C, kp, k,
                       out_scores + (rows0 + g) * k,
                       out_docs + (rows0 + g) * k);
}

// Checks a plan (tile_scoring.topk_cluster_plan): C a power of two of at
// most 16 and at most sub (bands of >= 128 docs), 1 <= G <= 16, k in [1,
// W], d_pad a multiple of 8; returns a block's shared bytes, 0 for a plan
// it refuses.
size_t knn_plan_smem(int sub, int d_pad, int k, int cluster, int group) {
  if (sub <= 0 || cluster < 1 || cluster > estpu::kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || cluster > sub || sub % cluster != 0 ||
      group < 1 || group > kMaxGroup || k < 1 || k > sub * kLane ||
      d_pad <= 0 || d_pad % 8 != 0)
    return 0;
  return sizeof(unsigned) * knn_smem_words(cluster, group, k, sub, d_pad);
}

}  // namespace

// How many clusters of a plan the device holds at once (0: the plan cannot
// be scheduled); the plan asks before it picks a cluster size.
extern "C" int estpu_knn_max_clusters(int sub, int d_pad, int k, int cluster,
                                      int group, int* out) {
  *out = 0;
  const size_t smem = knn_plan_smem(sub, d_pad, k, cluster, group);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(estpu::max_active_clusters(
      knn_score_tiles_kernel, kThreads, smem, cluster, out));
}

// cluster (C) and group (G): tile_scoring.topk_cluster_plan; a plan this
// kernel cannot run, or a cluster the device cannot schedule, is refused.
extern "C" int estpu_knn_score_tiles(const void* emb, const void* scale,
                                     const void* mask, const void* qvecs,
                                     void* out_scores, void* out_docs,
                                     int n_tiles, int sub, int d_pad,
                                     int n_rows, int q_batch, int k,
                                     int cluster, int group, void* stream) {
  if (n_tiles <= 0 || q_batch <= 0) return 0;
  const size_t smem = knn_plan_smem(sub, d_pad, k, cluster, group);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(n_tiles) * cluster *
                           ((q_batch + group - 1) / group);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(estpu::launch_clusters(
      knn_score_tiles_kernel, static_cast<int>(blocks), kThreads, smem,
      cluster, static_cast<cudaStream_t>(stream),
      static_cast<const __nv_bfloat16*>(emb),
      static_cast<const float*>(scale), static_cast<const float*>(mask),
      static_cast<const float*>(qvecs), static_cast<float*>(out_scores),
      static_cast<int*>(out_docs), sub, d_pad, n_rows, q_batch, k, cluster,
      group));
}


