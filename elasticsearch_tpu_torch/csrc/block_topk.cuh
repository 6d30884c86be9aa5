// Top-k selection shared by the fused top-k kernels (tile_scoring.cu's
// tile_scoring_topk_kernel, knn_scoring.cu's knn_score_tiles_kernel).
//
// Replaces the k rounds of a block-wide argmax of the first port (the
// Pallas kernels' structure: pallas_scoring.py:612-620, pallas_knn.py:
// 180-188), which scanned every score k times with two barriers and a
// serial reduce a round. Here the number of passes over the scores does
// not depend on k.
//
// Order: score descending, then doc ascending; -inf (and NaN) is never a
// candidate; empty slots are (-inf, -1). A score becomes an order-keeping
// 32-bit key (sign flipped for positives, all bits flipped for negatives,
// -0.0 folded into +0.0 so that both tie, as the plain versions' sorts
// make them); key 0 means "no candidate". A candidate is one 64-bit word,
// key << 32 | ~doc, so one unsigned compare orders by (key desc, doc asc).
// The folding would turn a -0.0 score into +0.0 on output; neither kernel
// can make one (a matched tile score is > 0, and a kNN score ends in a
// round-to-nearest add of +0.5, which never gives -0.0).
//
// 1. A band's top-k' (k' = min(k, band docs)), two ways:
//    - warp_select, k' <= 32: a warp takes a segment of at least 1,024
//      words of a query's band (the whole band up to 2,048) in two passes
//      (warp_topk): the k-th largest of its 32 lanes' maxima bounds the
//      k-th largest word from below; the words at or above it are
//      appended in order to a buffer by ballots, and each 32 of them merge
//      into the 32 register slots by counting ranks over broadcasts. With
//      several segments, one warp a query then takes the top-k of their
//      lists the same way.
//    - band_select, k' > 32: a radix select over the key's four bytes.
//      Each digit is one pass building a 256-bin histogram in shared
//      memory (warp-aggregated atomics) of the keys that share the digits
//      chosen so far, then one scan finds the digit of the k'-th key; it
//      stops once every key of the chosen bin is taken. Then one counting
//      pass and one writing pass compact every key above the threshold T
//      and the lowest-doc keys equal to T: warp w owns the w-th slice and
//      reads it 32 consecutive keys a round, so ballots give the in-order
//      ranks without bank conflicts. The <= k' candidates (band-local
//      indices) are sorted by counting ranks up to 64, by a bitonic sort
//      in shared memory above that.
// 2. The cluster merge. The bands of one tile are the CTAs of one
//    thread-block cluster. Every rank arrives on the cluster barrier
//    (relaxed) at its start and waits on it before its first remote
//    access, so no rank writes to a CTA that has not started. Each rank
//    then sends its sorted candidates, as global-doc words, and its
//    counts into rank 0's shared memory (push_to_rank0), and a second
//    cluster barrier (release / acquire) hands them over. The other ranks
//    then exit: rank 0 reads only its own shared memory. Rank 0 merges by
//    the warp path (merge_small) for k' <= 32. Above that, each candidate
//    goes to its own index plus, in every other list, the number of
//    candidates that beat it (merge_lists); topk_cluster_plan keeps C * k
//    <= 512 there.
//
// Shared memory of the selection: topk_select_words;
// tile_scoring.topk_select_smem mirrors it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace estpu {

namespace cg = cooperative_groups;

constexpr unsigned kNone = 0xffffffffu;  // an empty list slot
constexpr int kSelectThreads = 256;       // the kernels' block size
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kWarpK = 32;  // the largest k the warp path takes
constexpr int kWarpSegment = 1024;  // the fewest words a warp takes
// hist [256], warp sums [2][kSelectWarps], scalars [16]
constexpr int kSelectWords = 256 + 2 * kSelectWarps + 16;

struct SelectScratch {
  unsigned* hist;
  int* wsum;  // [2][kSelectWarps]
  int* sc;    // scalars
  __device__ explicit SelectScratch(unsigned* base)
      : hist(base),
        wsum(reinterpret_cast<int*>(base + 256)),
        sc(reinterpret_cast<int*>(base + 256 + 2 * kSelectWarps)) {}
};

__host__ __device__ inline int next_pow2_int(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline size_t align4(size_t words) {
  return (words + 3) & ~static_cast<size_t>(3);
}

// The selection's shared memory in 4-byte words, shared by both top-k
// kernels (k' = min(k, band docs)):
//   - rank 0's gather buffer [G][C][k'] u64 (clusters only), which every
//     rank fills over distributed shared memory;
//   - k' <= kWarpK: the queries' lists [G][kWarpK], the segments' lists
//     and the warps' scratch [4][kSelectWarps][kWarpK] u64; else one list of
//     next_pow2(k') u32;
//   - the scratch, each query's list count and hit count [2][G], and the
//     ranks' counts and hit counts [2][G][C] (rank 0's to fill).
// Kept in step with tile_scoring.topk_select_smem.
__host__ __device__ inline size_t topk_select_words(int cluster, int group,
                                                    int k, int band_docs) {
  const int kp = k < band_docs ? k : band_docs;
  const size_t g = static_cast<size_t>(group);
  const size_t gather = cluster > 1 ? 2 * g * cluster * kp : 0;
  const size_t lists = kp <= kWarpK ? 2 * kWarpK * (g + 4 * kSelectWarps)
                                    : static_cast<size_t>(next_pow2_int(kp));
  return align4(gather) + align4(lists) +
         align4(kSelectWords + 2 * g + 2 * g * cluster);
}

// the order-keeping key of a score; 0 for -inf and NaN (never selected)
__device__ __forceinline__ unsigned score_key(float v) {
  if (!(v > -CUDART_INF_F)) return 0u;
  unsigned u = __float_as_uint(v);
  if (v == 0.0f) u = 0u;  // -0.0 ties +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned key) {
  const unsigned u = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  return __uint_as_float(u);
}

// (key, doc) as one word ordered like the selection: key descending, then
// doc ascending. 0 (no candidate) loses to everything.
__device__ __forceinline__ unsigned long long cand_word(unsigned key,
                                                        unsigned doc) {
  return (static_cast<unsigned long long>(key) << 32) | (~doc);
}

// Inclusive scan of one int per thread over the block (kSelectThreads);
// ``buf`` is [kSelectWarps]; ends on a barrier. Returns (inclusive, total).
__device__ __forceinline__ int2 block_scan(int v, int* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kSelectWarps; ++w) {
    const int s = buf[w];
    if (w < warp) before += s;
    total += s;
  }
  __syncthreads();
  return make_int2(before + x, total);
}

// keys[at(b)] for band-local index b in [0, n) (n a multiple of 32): the
// key of doc doc_base + b. Writes the sorted top-min(k, candidates)
// band-local indices to list[0, m) (list holds next_pow2(min(k, n))
// entries) and returns m to every thread. Ends on a barrier.
template <typename At>
__device__ int band_select(const unsigned* keys, At at, int n, int k,
                           unsigned* list, const SelectScratch& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  unsigned* hist = s.hist;
  int* sc = s.sc;
  // sc[1] the chosen bin, sc[2] the keys above it, sc[3] its count
  unsigned pref = 0u;  // the chosen digits above ``shift``
  int need = 0, tshift = 32, take_eq = 0;
  bool all_eq = false;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0u;  // kSelectThreads == 256 bins
    __syncthreads();
    for (int b = tid; b < n; b += kSelectThreads) {
      const unsigned key = keys[at(b)];
      const bool in = key != 0u &&
                      (shift == 24 || (key >> (shift + 8)) == pref);
      const unsigned active = __ballot_sync(0xffffffffu, in);
      if (in) {
        const unsigned digit = (key >> shift) & 0xffu;
        const unsigned peers = __match_any_sync(active, digit);
        if (lane == __ffs(peers) - 1) atomicAdd(hist + digit, __popc(peers));
      }
    }
    __syncthreads();
    // bins in descending digit order: thread i holds bin 255 - i
    const int v = static_cast<int>(hist[255 - tid]);
    const int2 sc_in = block_scan(v, s.wsum);
    if (shift == 24) need = min(k, sc_in.y);  // every valid key counted
    else need = take_eq;
    if (need == 0) break;
    const int excl = sc_in.x - v;
    if (excl < need && need <= sc_in.x) {
      sc[1] = 255 - tid;
      sc[2] = excl;
      sc[3] = v;
    }
    __syncthreads();
    pref = (pref << 8) | static_cast<unsigned>(sc[1]);
    take_eq = need - sc[2];
    tshift = shift;
    all_eq = sc[3] == take_eq;
    __syncthreads();
    if (all_eq) break;
  }
  if (tshift == 32) return 0;  // no candidate at all
  // counting pass: per warp, keys above T and keys equal to T, in order
  const int per_warp = n / kSelectWarps;  // n is a multiple of 256 or less
  const int seg = (n >= kSelectThreads) ? per_warp : (warp == 0 ? n : 0);
  const int seg_lo = (n >= kSelectThreads) ? warp * per_warp : 0;
  int gt = 0, eq = 0;
  for (int r = 0; r < seg; r += 32) {
    const unsigned key = keys[at(seg_lo + r + lane)];
    const unsigned hi = key >> tshift;
    gt += __popc(__ballot_sync(0xffffffffu, key != 0u && hi > pref));
    eq += __popc(__ballot_sync(0xffffffffu, key != 0u && hi == pref));
  }
  int* wgt = s.wsum;
  int* weq = s.wsum + kSelectWarps;
  if (lane == 0) {
    wgt[warp] = gt;
    weq[warp] = eq;
  }
  __syncthreads();
  int gt_base = 0, eq_base = 0, gt_total = 0;
#pragma unroll
  for (int w = 0; w < kSelectWarps; ++w) {
    if (w < warp) {
      gt_base += wgt[w];
      eq_base += weq[w];
    }
    gt_total += wgt[w];
  }
  // writing pass: above T at gt_base + ..., equal to T at gt_total +
  // their rank among the ties while that rank is below take_eq
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int r = 0; r < seg; r += 32) {
    const int b = seg_lo + r + lane;
    const unsigned key = keys[at(b)];
    const unsigned hi = key >> tshift;
    const unsigned mg = __ballot_sync(0xffffffffu, key != 0u && hi > pref);
    const unsigned me = __ballot_sync(0xffffffffu, key != 0u && hi == pref);
    if ((mg >> lane) & 1u) {
      list[gt_base + __popc(mg & lt_mask)] = static_cast<unsigned>(b);
    } else if ((me >> lane) & 1u) {
      const int rank = eq_base + __popc(me & lt_mask);
      if (all_eq || rank < take_eq)
        list[gt_total + rank] = static_cast<unsigned>(b);
    }
    gt_base += __popc(mg);
    eq_base += __popc(me);
  }
  const int count = gt_total + take_eq;
  __syncthreads();

  // sort the candidates by (key desc, index asc)
  auto word = [&](unsigned idx) -> unsigned long long {
    return idx == kNone ? 0ull : cand_word(keys[at(idx)], idx);
  };
  if (count <= 64) {
    unsigned mine = kNone;
    unsigned long long mw = 0ull;
    int rank = 0;
    if (tid < count) {
      mine = list[tid];
      mw = word(mine);
      for (int j = 0; j < count; ++j) rank += word(list[j]) > mw;
    }
    __syncthreads();
    if (tid < count) list[rank] = mine;
    __syncthreads();
  } else {
    int p = 1;
    while (p < count) p <<= 1;
    for (int i = count + tid; i < p; i += kSelectThreads) list[i] = kNone;
    __syncthreads();
    for (int size = 2; size <= p; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < (p >> 1); i += kSelectThreads) {
          const int lo = 2 * i - (i & (stride - 1));
          const int hi = lo + stride;
          const unsigned a = list[lo], c = list[hi];
          const unsigned long long wa = word(a), wc = word(c);
          const bool desc = (lo & size) == 0;
          if (desc ? (wa < wc) : (wa > wc)) {
            list[lo] = c;
            list[hi] = a;
          }
        }
        __syncthreads();
      }
    }
  }
  return count;
}

// The number of entries of the descending list l[0, n) above w.
__device__ __forceinline__ int count_above(const unsigned long long* l, int n,
                                           unsigned long long w) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (l[mid] > w) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One warp's top-k (k <= 32) of the words word(i), i in [lo, lo + len)
// (0: no candidate), in two passes: lane j ends holding the j-th best word
// (0 = empty slot), which is returned.
//   1. Each lane's largest word; the k-th largest of these 32 is a lower
//      bound of the k-th largest word (the k largest lane maxima are k
//      words at or above it), so nothing below it is a candidate.
//   2. The words at or above that bound (and above the running k-th) are
//      appended to a buffer in order, by ballots; each 32 of them merge
//      into the slots: every such word and every slot counts, over
//      broadcasts, the entries that beat it, which is its new place.
// ``tmp`` is this warp's shared scratch of 3 * kWarpK words.
template <typename Word>
__device__ unsigned long long warp_topk(Word word, int lo, int len, int k,
                                        unsigned long long* tmp) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  unsigned long long* place = tmp;     // [32]: the merged list
  unsigned long long* buf = tmp + 32;  // [64]: candidates in order
  unsigned long long lm = 0ull;
#pragma unroll 4
  for (int i = lane; i < len; i += 32) {
    const unsigned long long w = word(lo + i);
    lm = w > lm ? w : lm;
  }
  int rk = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) rk += __shfl_sync(0xffffffffu, lm, j) > lm;
  const unsigned at_k = __ballot_sync(0xffffffffu, lm != 0ull && rk == k - 1);
  const unsigned long long cut =
      at_k ? __shfl_sync(0xffffffffu, lm, __ffs(at_k) - 1) : 0ull;
  unsigned long long slot = 0ull;
  unsigned long long thr = cut ? cut - 1ull : 0ull;  // candidates: w > thr
  int filled = 0, n_buf = 0;
  // merges buf[0, c) (c <= 32) into the slots
  auto merge = [&](int c) {
    const unsigned long long w = lane < c ? buf[lane] : 0ull;
    int rc = 0, rs = lane;
#pragma unroll 8
    for (int i = 0; i < c; ++i) {
      const unsigned long long ci = __shfl_sync(0xffffffffu, w, i);
      rc += ci > w;
      rs += ci > slot;
    }
#pragma unroll 8
    for (int j = 0; j < filled; ++j)
      rc += __shfl_sync(0xffffffffu, slot, j) > w;
    if (slot != 0ull && rs < k) place[rs] = slot;
    if (w != 0ull && rc < k) place[rc] = w;
    filled = min(k, filled + c);
    __syncwarp();
    slot = lane < filled ? place[lane] : 0ull;
    if (filled == k) {
      const unsigned long long kth = __shfl_sync(0xffffffffu, slot, k - 1);
      thr = kth > thr ? kth : thr;
    }
  };
  for (int r = 0; r < len; r += 32) {
    const unsigned long long w = r + lane < len ? word(lo + r + lane) : 0ull;
    const unsigned m = __ballot_sync(0xffffffffu, w > thr);
    if (w > thr) buf[n_buf + __popc(m & lt_mask)] = w;
    n_buf += __popc(m);
    if (n_buf >= 32) {
      __syncwarp();
      merge(32);
      const unsigned long long rest = lane < n_buf - 32 ? buf[32 + lane] : 0ull;
      __syncwarp();
      if (lane < n_buf - 32) buf[lane] = rest;
      n_buf -= 32;
      __syncwarp();
    }
  }
  __syncwarp();
  if (n_buf > 0) merge(n_buf);
  __syncwarp();
  return slot;
}

// The warp path (k <= kWarpK) for gn queries at once: word_of(g, i) gives
// query g's candidate i in [0, n) (0: none). Each query's n words split
// into nseg segments of at least kWarpSegment words, as many as fill the
// warps; warp u % kSelectWarps takes unit u (query u / nseg); with several
// segments, warp g then takes the top-k of query g's segment lists the
// same way. (Shorter segments were slower on the card: more warps then
// contend for the shuffle unit, and the second pass grows.) Writes query
// g's sorted words to words[g * kWarpK + j], j < counts[g]. ``scratch``
// holds 4 * kSelectWarps * kWarpK words. Ends on a barrier.
template <typename WordOf>
__device__ void warp_select(WordOf word_of, int n, int gn, int k,
                            unsigned long long* words,
                            unsigned long long* scratch, int* counts) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long* units = scratch;  // [kSelectWarps][kWarpK]
  unsigned long long* tmp =
      scratch + kSelectWarps * kWarpK + warp * 3 * kWarpK;
  int nseg = 1;
  while (2 * nseg * gn <= kSelectWarps && n / (2 * nseg) >= kWarpSegment)
    nseg <<= 1;
  const int seg = (n + nseg - 1) / nseg;
  auto publish = [&](int g, unsigned long long slot) {
    words[g * kWarpK + lane] = slot;
    const int c = __popc(__ballot_sync(0xffffffffu, slot != 0ull));
    if (lane == 0) counts[g] = c;
  };
  for (int u = warp; u < gn * nseg; u += kSelectWarps) {
    const int g = u / nseg;
    const int lo = (u - g * nseg) * seg;
    const unsigned long long slot = warp_topk(
        [&](int i) { return word_of(g, i); }, lo, max(0, min(seg, n - lo)), k,
        tmp);
    if (nseg == 1) {
      publish(g, slot);
    } else {
      units[u * kWarpK + lane] = slot;
    }
  }
  __syncthreads();
  if (nseg > 1) {
    for (int g = warp; g < gn; g += kSelectWarps) {
      const unsigned long long* lists = units + g * nseg * kWarpK;
      publish(g, warp_topk([&](int i) { return lists[i]; }, 0,
                           nseg * kWarpK, k, tmp));
    }
    __syncthreads();
  }
}

// Writes one output row of k slots from ``m`` sorted candidates (a cluster
// of one): cand(j) gives candidate j's word, band-local index in the low
// half; the rest of the row is empty.
template <typename Cand>
__device__ void write_row(Cand cand, int m, int k, long long doc_base,
                          float* s_out, int* d_out) {
  for (int i = threadIdx.x; i < k; i += kSelectThreads) {
    if (i < m) {
      const unsigned long long w = cand(i);
      s_out[i] = key_score(static_cast<unsigned>(w >> 32));
      d_out[i] = static_cast<int>(doc_base + (~static_cast<unsigned>(w)));
    } else {
      s_out[i] = -CUDART_INF_F;
      d_out[i] = -1;
    }
  }
}

// Arrive on the cluster barrier without waiting (relaxed): paired with
// cluster_wait before the first access to another rank's shared memory,
// which must not come before every rank has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Rank ``band`` of a cluster sends its m sorted candidates of query g
// (cand(j): word with the band-local index) to rank 0's gather buffer
// [g][band][kp] as words with global docs (doc_base + index), and its list
// count; hits (hits >= 0) likewise.
template <typename Cand>
__device__ void push_to_rank0(cg::cluster_group& cluster, Cand cand, int m,
                              long long doc_base, unsigned long long* gather,
                              int* ncs, int* hits_all, int g, int band,
                              int n_ranks, int kp, int hits) {
  unsigned long long* dst =
      cluster.map_shared_rank(gather, 0) +
      (static_cast<size_t>(g) * n_ranks + band) * kp;
  for (int j = threadIdx.x; j < m; j += kSelectThreads) {
    const unsigned long long w = cand(j);
    const unsigned doc =
        static_cast<unsigned>(doc_base + (~static_cast<unsigned>(w)));
    dst[j] = cand_word(static_cast<unsigned>(w >> 32), doc);
  }
  if (threadIdx.x == 0) {
    *cluster.map_shared_rank(ncs + g * n_ranks + band, 0) = m;
    if (hits >= 0)
      *cluster.map_shared_rank(hits_all + g * n_ranks + band, 0) = hits;
  }
}

// Rank 0, after the cluster barrier that follows every push, for k' =
// kp <= kWarpK: the C * kp gathered words of each query ([g][c][kp], list
// c holding ncs[g * C + c]) go through the warp path once more, and each
// query's row is written. ``lists`` / ``scratch`` / ``counts`` as for
// warp_select. Ends on a barrier.
__device__ inline void merge_small(const unsigned long long* gather,
                                   const int* ncs, int gn, int n_ranks,
                                   int kp, int k, unsigned long long* lists,
                                   unsigned long long* scratch, int* counts,
                                   float* s_out, int* d_out, long long row0) {
  const int n = n_ranks * kp;
  warp_select(
      [&](int g, int i) -> unsigned long long {
        const int c = i / kp;
        return i - c * kp < ncs[g * n_ranks + c]
                   ? gather[static_cast<size_t>(g) * n + i]
                   : 0ull;
      },
      n, gn, k, lists, scratch, counts);
  for (int g = 0; g < gn; ++g)
    write_row([&](int j) { return lists[g * kWarpK + j]; }, counts[g], k, 0,
              s_out + (row0 + g) * k, d_out + (row0 + g) * k);
}

// Rank 0, after the cluster barrier that follows every push: merges the
// n_ranks sorted lists of gather [n_ranks][kp] (counts ncs) into one row of
// k slots. Each candidate's place is its own index plus, in every other
// list, the number of candidates that beat it. Ends on a barrier.
__device__ inline void merge_lists(const unsigned long long* gather,
                                   const int* ncs, int n_ranks, int kp, int k,
                                   float* s_out, int* d_out) {
  int total = 0;
  for (int c = 0; c < n_ranks; ++c) total += ncs[c];
  for (int i = threadIdx.x; i < n_ranks * kp; i += kSelectThreads) {
    const int c = i / kp, j = i - (i / kp) * kp;
    if (j >= ncs[c]) continue;
    const unsigned long long w = gather[i];
    int rank = j;
    for (int o = 0; o < n_ranks; ++o)
      if (o != c) rank += count_above(gather + o * kp, ncs[o], w);
    if (rank < k) {
      s_out[rank] = key_score(static_cast<unsigned>(w >> 32));
      d_out[rank] = static_cast<int>(~static_cast<unsigned>(w));
    }
  }
  for (int i = total + threadIdx.x; i < k; i += kSelectThreads) {
    s_out[i] = -CUDART_INF_F;
    d_out[i] = -1;
  }
  __syncthreads();
}

}  // namespace estpu
