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
// Arithmetic, shared by every form, and why a batched member equals its
// serial result bit for bit: a query's lanes (those with rows in the tile
// and a nonzero weight) are added in ascending order of their first
// posting row, ties by table index. Different terms own disjoint
// posting-row runs, so this order is the same in every tile and does not
// depend on where a lane sits in the table: the serial table (a query's
// own lanes) and the batched table (the union of Q queries' lanes) give
// each query the same lanes in the same order. One term's postings hit
// distinct docs, so inside a lane the adds need no order and no atomics,
// and a barrier between lanes orders them across lanes: acc =
// __fadd_rn(acc, __fmul_rn(w_q, frac)), no FMA contraction. The plain
// PyTorch versions make the same adds in the same order. A count is added
// only where w_q > 0 (a dead lane adds no count).
//
// ---- The dense forms (tile_scoring_dense_kernel) ----
//
// What bounds it on an H100: bytes. A call must read the live mask (4
// bytes a doc of the geometry) and the lanes' posting rows (8 bytes a
// posting raw, 4 packed), and write 4 bytes a doc per query (twice that
// with counts). At q_batch 1 the mask read and the scores written are
// about 70 % of those bytes (2^20 docs: 8 of 11.4 MB); at Q > 1 the Q
// output slabs are. The arithmetic is one multiply and one add per
// posting and query.
//
// The design, against what held the first version (one 512-thread block
// per (tile, query): 64 blocks at 2^20 docs, a serial prologue, one
// dependent load per lane, scalar epilogue, Q re-reads of every row):
//   1. Bands fill the card. A block owns one band of D = S * 128
//      consecutive local docs of one tile (columns [s0, s0 + S) of the
//      tile's [128, sub] output block, every row) and a group of G
//      queries. The grid is n_tiles * (sub / S) * ceil(Q / G) blocks, band
//      fastest, so the blocks of one tile run together and share its rows
//      in L2. (S, G) comes from tile_scoring.dense_band_plan: 256 threads
//      and at most 64 registers a thread, and shared memory sized for four
//      blocks an SM; the widest band that still gives 2 * 132 blocks, then
//      as many queries as fit beside it. At 2^20 docs: Q = 1 gets D = 2048
//      and 512 blocks; Q = 16 gets D = 4096 with two queries a block (2048
//      blocks), one with counts (4096 blocks).
//   2. One posting read serves every query of the group. The block walks
//      the lanes its queries weight in the order above, reads each posting
//      once, decodes it once and adds w_q * f for each query whose weight
//      is nonzero (a 32-bit lane mask): the JAX kernel's "contribution
//      once, one scale-add per query". The barrier between lanes is paid
//      by the whole block, so a block holding the whole batch walks every
//      lane of the union in every band; as batched queries share few terms,
//      wide bands with few queries a block walk each lane over more docs
//      and come out faster on the card, which is why G is what fits beside
//      the widest band and not Q. (Staging each lane's f in a slot of its
//      own and folding the slots per doc removes the barriers, but the fold
//      over every slot cost more than they did.) A band reads only the rows
//      that can hold its docs: one term's postings ascend by doc (every
//      staging packs them so), so the first doc of each window row bounds
//      the rows a band needs, found by one parallel probe of those first
//      docs; a row is re-read from L2 only where it straddles a band edge.
//      (A thread-block cluster per tile scattering into the owning block's
//      shared memory over DSMEM would need a cluster barrier per lane and
//      cap the bands of a tile at the cluster size; the probe keeps blocks
//      independent.) The fused top-k kernel below reuses this band body.
//   3. The prologue is parallel and stays in shared memory: one coalesced
//      pass loads the tile's row_lo / row_hi and the group's weights, a
//      thread per lane builds its query masks and ranks it by (first row,
//      index) among the live lanes; prefix sums are warp scans.
//   4. Latency is overlapped. The band's live mask slice is issued as
//      cp.async copies (16 bytes a thread) at block start and waited for
//      only before the epilogue. Postings are read 16 bytes a thread, 1024
//      postings of any lanes in flight per chunk, and the next chunk's
//      loads are issued before the current one is added. The epilogue
//      writes scores and counts with 16-byte stores: a band is S
//      contiguous floats of each output row. S < 4 (segments under 512
//      docs) takes a scalar mask copy and epilogue.
// The accumulator keeps local-doc order, row s of the band padded by P =
// 32 / S floats (S <= 32), so the scatter of a run of consecutive docs
// and the epilogue's (row, 4 columns) reads are both free of bank
// conflicts. Inputs: docs, frac and live_t start on 16-byte boundaries
// (the wrapper checks).
//
// ---- The fused top-k forms (tile_scoring_topk_kernel) ----
//
// What bounds them on an H100: bytes (posting rows, the mask, k scores +
// k docs + 1 hit count per (tile, query)), but their time went to the
// grid and the selection: the first version ran one 512-thread block per
// (tile, query), 8 blocks for the pruned program's 8-tile passes at Q = 1,
// and selected by k block-wide argmax rounds. The design now:
//   1. A tile's bands are the CTAs of one thread-block cluster. CTA =
//      (table row, query group, band), band fastest; C bands of S = sub /
//      C columns a tile and G queries a CTA come from
//      tile_scoring.topk_cluster_plan (8 tiles of 16,384 docs at Q = 1:
//      C = 16, 128 CTAs). The launch uses cudaLaunchKernelEx with a
//      cluster dimension (16 is the non-portable size) and is refused
//      when cudaOccupancyMaxActiveClusters says the cluster cannot be
//      scheduled.
//   2. A CTA runs the dense kernel's band body (band_issue_mask,
//      band_accumulate: the parallel prologue, the first-doc probe, the
//      cp.async mask slice, 16-byte posting chunks, one posting read for
//      the whole group); then matched = acc > 0 && live becomes an
//      order-keeping key in place of each score, and the band's hits are
//      summed exactly in i32.
//   3. block_topk.cuh selects each query's band top-k' in passes that do
//      not depend on k. Each CTA sends its candidates (as global-doc
//      words), its list counts and its hits into rank 0's shared memory
//      over DSMEM. After one cluster barrier the other CTAs exit, and
//      rank 0 merges and writes the rows. A cluster of one writes its rows
//      itself.
// The outputs keep their layout ([n_tiles, Q, k] scores and docs, hits
// [n_tiles, Q]), the tie rule (score descending, then doc ascending) and
// the empty slots (-inf / -1); each score keeps its bits (the lane order
// above), so the plain version is unchanged.
//
// Packed codec: the decode sits in the posting loop, so the packed forms
// read half the posting bytes and are otherwise the raw kernels. doc =
// (unsigned)word >> 12 (a doc at or above 2^19 sets the word's sign bit,
// which an arithmetic shift would smear), f = __fmul_rn(frac_q as f32,
// scale), where scale is np.float32(PACK_FRAC_SCALE) passed from Python: the
// plain version and the JAX kernel multiply by the same f32. f > 0 stays
// the validity test (frac_q == 0 marks padding).
//
// Sel mode: the CTAs of table row p score tile tile_ids[p] from that row
// (the doc base and the live rows come from the real tile id, the outputs
// go to subset position p). A row whose windows are all empty (the pruned
// orchestration zeroes the rows of the tiles it skips) writes -inf / -1 /
// 0, what the kernel gives for an empty tile, before any other work: the
// work a pruned tile saves. The test depends on the row alone, so every
// CTA of the cluster leaves before the cluster barrier.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "block_topk.cuh"
#include "launch.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kLane = 128;
constexpr int kPackFracBits = 12;
constexpr int kPackFracMask = (1 << kPackFracBits) - 1;

// the dense kernel: threads a block, queries a block may hold (one bit each
// in a lane's query mask), groups of four postings a thread holds per chunk
constexpr int kDenseThreads = 256;
constexpr int kDenseMaxGroup = 32;
constexpr int kChunkVec = 1;
static_assert(kDenseThreads == estpu::kSelectThreads,
              "the top-k kernel's selection runs on its band blocks");

__device__ __forceinline__ int decode_doc(int word) {
  return static_cast<int>(static_cast<unsigned>(word) >> kPackFracBits);
}

__device__ __forceinline__ float decode_frac(int word, float scale) {
  return __fmul_rn(__int2float_rn(word & kPackFracMask), scale);
}

// ---------------------------------------------------------------------
// The band body, shared by the dense and the top-k kernels
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Padding of one accumulator row of a band of S columns (see the note).
__host__ __device__ inline int band_pad(int band_sub) {
  return band_sub < 4 ? 0 : (band_sub <= 32 ? 32 / band_sub : 1);
}

// Shared memory of one dense block in 4-byte words: the mask slice
// [128][S], the accumulators [G][S][128 + P] (twice with counts), the
// weights [G][t_pad], seven lane tables of t_pad, a prefix of t_pad + 1
// and two scalars. Kept in step with tile_scoring.dense_band_smem.
__host__ __device__ inline size_t dense_smem_words(int band_sub, int group,
                                                   int t_pad, bool counts) {
  const size_t acc = static_cast<size_t>(group) * band_sub *
                     (kLane + band_pad(band_sub));
  return static_cast<size_t>(band_sub) * kLane + acc * (counts ? 2 : 1) +
         static_cast<size_t>(group) * t_pad + 8 * static_cast<size_t>(t_pad) +
         3;
}

// out[i] = value(0) + ... + value(i - 1) for i in [0, n]: warp 0 scans 32
// entries at a time; ends on a barrier.
template <typename F>
__device__ void block_exclusive_scan(F value, int n, int* out) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int b0 = 0; b0 < n; b0 += 32) {
      const int i = b0 + lane;
      const int v = i < n ? value(i) : 0;
      int x = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      if (i < n) out[i] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) out[n] = carry;
  }
  __syncthreads();
}

// The last lane rank L in [0, n) with pre[L] <= i: the lane whose range of
// the flattened list holds entry i (lanes with empty ranges are skipped).
__device__ __forceinline__ int find_lane(const int* pre, int n, int i) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Postings a thread holds between their load and their add: kChunkVec
// groups of four consecutive postings of one row, and each group's lane
// rank (-1: none).
struct PostingChunk {
  int4 doc[kChunkVec];
  float4 frac[kChunkVec];
  int lane[kChunkVec];
};

// The shared memory of one band block, carved as dense_smem_words counts
// it: the band's mask slice [128][S] in output order, the accumulators
// [G][S][128 + P] (local doc s * 128 + lane; twice with counts), the
// weights [G][t_pad], the lane tables and the probe's counters.
struct BandSmem {
  float* mask;
  float* acc;
  float* cnt;
  float* wsm;
  int* lo_s;
  int* hi_s;
  unsigned* qm_s;  // w != 0: the group's queries that weight the lane
  unsigned* cm_s;  // w > 0: counted
  int* order;      // rank -> lane
  int* n_le;       // probe: window rows starting at or below the band's
  int* n_lt;       // first doc / below its end
  int* pre;        // [t_pad + 1] prefix over ranks
  int* n_live_s;
  int stride;  // one accumulator row
  int slab;    // one query's accumulator
};

// What one band block scores: table row ``row`` (the tile's own row, or
// the subset position in sel mode) of tile ``t``, the band's S columns
// from s0, and the queries [q0, q0 + gn) in a group of ``group`` slots.
struct Band {
  int t;
  int row;
  int S;
  int s0;
  int q0;
  int gn;
  int group;
  bool with_counts;
};

__device__ BandSmem carve_band(float* base, const Band& bd, int t_pad) {
  BandSmem m;
  const int d = bd.S * kLane;
  m.stride = kLane + band_pad(bd.S);
  m.slab = bd.S * m.stride;
  m.mask = base;
  m.acc = m.mask + d;
  m.cnt = m.acc + bd.group * m.slab;
  m.wsm = m.acc + bd.group * m.slab * (bd.with_counts ? 2 : 1);
  m.lo_s = reinterpret_cast<int*>(m.wsm + bd.group * t_pad);
  m.hi_s = m.lo_s + t_pad;
  m.qm_s = reinterpret_cast<unsigned*>(m.hi_s + t_pad);
  m.cm_s = m.qm_s + t_pad;
  m.order = reinterpret_cast<int*>(m.cm_s + t_pad);
  m.n_le = m.order + t_pad;
  m.n_lt = m.n_le + t_pad;
  m.pre = m.n_lt + t_pad;
  m.n_live_s = m.pre + t_pad + 1;
  return m;
}

// 1. The band's mask slice, issued as cp.async copies; the caller waits
// (cp_async_wait_all and a barrier) before it reads the slice.
__device__ void band_issue_mask(const float* __restrict__ live_t, int sub,
                                const Band& bd, const BandSmem& m) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int S = bd.S;
  const float* live_rows = live_t + static_cast<long long>(bd.t) * kLane * sub;
  if (S >= 4) {
    const int lt = __ffs(S >> 2) - 1;  // log2(S / 4)
    for (int i = tid; i < (kLane << lt); i += nth) {
      const int lane = i >> lt;
      const int c = i & ((1 << lt) - 1);
      cp_async16(m.mask + lane * S + 4 * c,
                 live_rows + static_cast<long long>(lane) * sub + bd.s0 +
                     4 * c);
    }
  } else {
    for (int i = tid; i < S * kLane; i += nth) {
      const int lane = i / S;
      const int s = i - lane * S;
      cp_async4(m.mask + i,
                live_rows + static_cast<long long>(lane) * sub + bd.s0 + s);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// 2-7. Clears the band's accumulators and adds every posting of the
// group's lanes that falls in the band, each posting read once for the
// whole group, lanes in canonical order with a barrier after each. Ends on
// a barrier.
template <bool kPacked>
__device__ void band_accumulate(const int* __restrict__ docs,
                                const float* __restrict__ frac, float scale,
                                const int* __restrict__ row_lo,
                                const int* __restrict__ row_hi,
                                const float* __restrict__ weights, int t_pad,
                                int sub, int n_rows, const Band& bd,
                                const BandSmem& m) {
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int w = sub * kLane;
  const int d = bd.S * kLane;     // docs in the band
  const int blo = bd.s0 * kLane;  // and its first local doc
  const long long base = static_cast<long long>(bd.t) * w;
  const int group = bd.group, gn = bd.gn;
  const bool with_counts = bd.with_counts;
  float* acc = m.acc;
  float* cnt = m.cnt;
  float* wsm = m.wsm;
  int* lo_s = m.lo_s;
  int* hi_s = m.hi_s;
  unsigned* qm_s = m.qm_s;
  unsigned* cm_s = m.cm_s;
  int* order = m.order;
  int* n_le = m.n_le;
  int* n_lt = m.n_lt;
  int* pre = m.pre;
  const int stride = m.stride, slab = m.slab;

  // 2. clear the accumulators; the tile's windows and the group's weights
  float4* acc4 = reinterpret_cast<float4*>(acc);
  for (int i = tid; i < group * slab * (with_counts ? 2 : 1) / 4; i += nth)
    acc4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int* rl = row_lo + static_cast<long long>(bd.row) * t_pad;
  const int* rh = row_hi + static_cast<long long>(bd.row) * t_pad;
  for (int j = tid; j < t_pad; j += nth) {
    lo_s[j] = rl[j];
    hi_s[j] = min(rh[j], n_rows);
    n_le[j] = 0;
    n_lt[j] = 0;
  }
  const float* wq = weights + static_cast<long long>(bd.q0) * t_pad;
  for (int i = tid; i < gn * t_pad; i += nth) wsm[i] = wq[i];
  if (tid == 0) *m.n_live_s = 0;
  __syncthreads();

  // 3. per lane: which of the group's queries weight it, which count it;
  // a lane is live with rows in this tile and some query's weight
  for (int j = tid; j < t_pad; j += nth) {
    unsigned qm = 0u, cm = 0u;
    for (int g = 0; g < gn; ++g) {
      const float x = wsm[g * t_pad + j];
      if (x != 0.0f) qm |= 1u << g;
      if (x > 0.0f) cm |= 1u << g;
    }
    if (hi_s[j] <= lo_s[j]) qm = 0u;
    qm_s[j] = qm;
    cm_s[j] = cm;
    if (qm) atomicAdd(m.n_live_s, 1);
  }
  __syncthreads();
  const int n_live = *m.n_live_s;
  if (n_live == 0) return;

  // 4. rank each live lane by (first row, index)
  for (int j = tid; j < t_pad; j += nth) {
    if (!qm_s[j]) continue;
    const int lo = lo_s[j];
    int rank = 0;
    for (int k = 0; k < t_pad; ++k)
      rank += (qm_s[k] != 0u) && (lo_s[k] < lo || (lo_s[k] == lo && k < j));
    order[rank] = j;
  }
  __syncthreads();

  // 5. probe the first doc of every window row: the rows that can hold
  // the band's docs are [lo + max(n_le - 1, 0), lo + n_lt)
  block_exclusive_scan(
      [&](int L) { return hi_s[order[L]] - lo_s[order[L]]; }, n_live, pre);
  const int n_probe = pre[n_live];
  for (int i0 = tid; i0 < n_probe; i0 += 4 * nth) {
    int first[4], lane_of[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nth;
      lane_of[u] = -1;
      if (i < n_probe) {
        const int L = find_lane(pre, n_live, i);
        const long long row = lo_s[order[L]] + (i - pre[L]);
        const int word = __ldg(docs + row * kLane);
        first[u] = kPacked ? decode_doc(word) : word;
        lane_of[u] = L;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (lane_of[u] < 0) continue;
      const long long local = first[u] - base;
      if (local <= blo) atomicAdd(n_le + lane_of[u], 1);
      if (local < blo + d) atomicAdd(n_lt + lane_of[u], 1);
    }
  }
  __syncthreads();

  // 6. the band's candidate postings, flattened in rank order
  block_exclusive_scan(
      [&](int L) { return max(0, n_lt[L] - max(n_le[L] - 1, 0)) * kLane; },
      n_live, pre);
  const int n_vec = pre[n_live] >> 2;
  const int per_chunk = nth * kChunkVec;
  const int n_chunks = (n_vec + per_chunk - 1) / per_chunk;

  auto load = [&](int c, PostingChunk& pc) {
#pragma unroll
    for (int k = 0; k < kChunkVec; ++k) {
      const int v = c * per_chunk + k * nth + tid;
      pc.lane[k] = -1;
      if (v < n_vec) {
        const int i = v << 2;
        const int L = find_lane(pre, n_live, i);
        const long long p =
            (static_cast<long long>(lo_s[order[L]]) + max(n_le[L] - 1, 0)) *
                kLane +
            (i - pre[L]);
        pc.doc[k] = __ldg(reinterpret_cast<const int4*>(docs + p));
        if (!kPacked)
          pc.frac[k] = __ldg(reinterpret_cast<const float4*>(frac + p));
        pc.lane[k] = L;
      }
    }
  };
  auto add = [&](int doc, float f, int j, unsigned qm, unsigned cm) {
    const long long bl = static_cast<long long>(doc) - base - blo;
    if (bl < 0 || bl >= d || !(f > 0.0f)) return;
    const int b = static_cast<int>(bl);
    const int idx = (b >> 7) * stride + (b & (kLane - 1));
    while (qm) {
      const int g = __ffs(qm) - 1;
      qm &= qm - 1u;
      float* a = acc + g * slab + idx;
      *a = __fadd_rn(*a, __fmul_rn(wsm[g * t_pad + j], f));
      if ((cm >> g) & 1u) {
        float* cc = cnt + g * slab + idx;
        *cc = __fadd_rn(*cc, 1.0f);
      }
    }
  };
  // the chunk's lanes in rank order, a barrier after each
  auto apply = [&](int c, const PostingChunk& pc) {
    const int v_first = c * per_chunk;
    const int v_last = min(v_first + per_chunk, n_vec) - 1;
    const int l_first = find_lane(pre, n_live, v_first << 2);
    const int l_last = find_lane(pre, n_live, v_last << 2);
    for (int L = l_first; L <= l_last; ++L) {
      const int j = order[L];
      const unsigned qm = qm_s[j];
      const unsigned cm = with_counts ? cm_s[j] : 0u;
#pragma unroll
      for (int k = 0; k < kChunkVec; ++k) {
        if (pc.lane[k] != L) continue;
        const int4 dw = pc.doc[k];
        if (kPacked) {
          add(decode_doc(dw.x), decode_frac(dw.x, scale), j, qm, cm);
          add(decode_doc(dw.y), decode_frac(dw.y, scale), j, qm, cm);
          add(decode_doc(dw.z), decode_frac(dw.z, scale), j, qm, cm);
          add(decode_doc(dw.w), decode_frac(dw.w, scale), j, qm, cm);
        } else {
          const float4 fv = pc.frac[k];
          add(dw.x, fv.x, j, qm, cm);
          add(dw.y, fv.y, j, qm, cm);
          add(dw.z, fv.z, j, qm, cm);
          add(dw.w, fv.w, j, qm, cm);
        }
      }
      __syncthreads();
    }
  };

  // 7. the next chunk's loads go out before the current chunk's adds
  PostingChunk cur, nxt;
  if (n_chunks > 0) load(0, cur);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load(c + 1, nxt);
    apply(c, cur);
    cur = nxt;
  }
}

// Block = (tile t, group z, band): band fastest. Shared memory: see
// dense_smem_words.
template <bool kPacked>
__global__ void __launch_bounds__(kDenseThreads, 4) tile_scoring_dense_kernel(
    const int* __restrict__ docs, const float* __restrict__ frac, float scale,
    const float* __restrict__ live_t, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, const float* __restrict__ weights,
    float* __restrict__ out_scores, float* __restrict__ out_counts,
    int n_tiles, int t_pad, int sub, int n_rows, int q_batch, int band_sub,
    int group) {
  extern __shared__ __align__(16) float dense_smem[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int S = band_sub;
  const int n_bands = sub / S;
  const int n_groups = (q_batch + group - 1) / group;
  const int band = blockIdx.x % n_bands;
  const int z = (blockIdx.x / n_bands) % n_groups;
  const int t = blockIdx.x / n_bands / n_groups;
  const int q0 = z * group;
  const Band bd{t, t, S, band * S, q0, min(group, q_batch - q0), group,
                out_counts != nullptr};
  const BandSmem m = carve_band(dense_smem, bd, t_pad);
  band_issue_mask(live_t, sub, bd, m);
  band_accumulate<kPacked>(docs, frac, scale, row_lo, row_hi, weights, t_pad,
                           sub, n_rows, bd, m);

  // 8. epilogue: row lane, columns s0 + [4c, 4c + 4) of query q0 + g's
  // tile block hold local docs (s0 + 4c + e) * 128 + lane
  cp_async_wait_all();
  __syncthreads();
  const int w = sub * kLane;
  const int d = S * kLane;
  const int gn = bd.gn;
  const int stride = m.stride, slab = m.slab;
  const float* mask = m.mask;
  const float* acc = m.acc;
  const float* cnt = m.cnt;
  const bool with_counts = bd.with_counts;
  const long long tile_out = static_cast<long long>(t) * w + bd.s0;
  if (S >= 4) {
    const int lt = __ffs(S >> 2) - 1;  // log2(S / 4)
    const int per_g = kLane << lt;  // 16-byte chunks of one query's band
    for (int i = tid; i < gn * per_g; i += nth) {
      const int g = i >> (7 + lt);
      const int r = i & (per_g - 1);
      const int lane = r >> lt;
      const int c = r & ((1 << lt) - 1);
      const float4 mk =
          *reinterpret_cast<const float4*>(mask + lane * S + 4 * c);
      const int at = g * slab + 4 * c * stride + lane;
      const long long o = static_cast<long long>(q0 + g) * n_tiles * w +
                          tile_out + static_cast<long long>(lane) * sub + 4 * c;
      const float* a = acc + at;
      *reinterpret_cast<float4*>(out_scores + o) = make_float4(
          mk.x > 0.0f ? a[0] : 0.0f, mk.y > 0.0f ? a[stride] : 0.0f,
          mk.z > 0.0f ? a[2 * stride] : 0.0f,
          mk.w > 0.0f ? a[3 * stride] : 0.0f);
      if (with_counts) {
        const float* n = cnt + at;
        *reinterpret_cast<float4*>(out_counts + o) = make_float4(
            mk.x > 0.0f ? n[0] : 0.0f, mk.y > 0.0f ? n[stride] : 0.0f,
            mk.z > 0.0f ? n[2 * stride] : 0.0f,
            mk.w > 0.0f ? n[3 * stride] : 0.0f);
      }
    }
  } else {
    for (int i = tid; i < gn * d; i += nth) {
      const int g = i / d;
      const int r = i - g * d;
      const int lane = r / S;
      const int s = r - lane * S;
      const bool alive = mask[r] > 0.0f;
      const int at = g * slab + s * stride + lane;
      const long long o = static_cast<long long>(q0 + g) * n_tiles * w +
                          tile_out + static_cast<long long>(lane) * sub + s;
      out_scores[o] = alive ? acc[at] : 0.0f;
      if (with_counts) out_counts[o] = alive ? cnt[at] : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------
// The fused top-k kernel
// ---------------------------------------------------------------------

// a band's key of local doc b = s * 128 + lane: row s of its accumulator
struct BandAt {
  int stride;
  __device__ int operator()(int b) const {
    return (b >> 7) * stride + (b & (kLane - 1));
  }
};

// Shared memory of one top-k band block in 4-byte words: the selection's,
// then a dense block's without counts. Kept in step with
// tile_scoring.topk_tile_smem.
__host__ __device__ inline size_t topk_smem_words(int cluster, int group,
                                                  int k, int sub, int t_pad) {
  const int band_sub = sub / cluster;
  return estpu::topk_select_words(cluster, group, k, band_sub * kLane) +
         dense_smem_words(band_sub, group, t_pad, false);
}

// Block = (table row pos, group z, band): band fastest, the C = cluster
// bands of one (row, group) one thread-block cluster. tile_ids: nullptr,
// or the sel-mode subset.
template <bool kPacked>
__global__ void __launch_bounds__(kDenseThreads, 2) tile_scoring_topk_kernel(
    const int* __restrict__ docs, const float* __restrict__ frac, float scale,
    const float* __restrict__ live_t, const int* __restrict__ row_lo,
    const int* __restrict__ row_hi, const float* __restrict__ weights,
    const int* __restrict__ tile_ids, float* __restrict__ out_scores,
    int* __restrict__ out_docs, float* __restrict__ out_hits, int t_pad,
    int sub, int n_rows, int q_batch, int k, int cluster, int group) {
  extern __shared__ __align__(16) float topk_smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int C = cluster;
  const int S = sub / C;
  const int n_groups = (q_batch + group - 1) / group;
  const int band = blockIdx.x % C;
  const int z = (blockIdx.x / C) % n_groups;
  const int pos = blockIdx.x / C / n_groups;
  const int q0 = z * group;
  const int gn = min(group, q_batch - q0);
  const int w = sub * kLane;
  const int d = S * kLane;
  const int kp = min(k, d);
  const int p = estpu::next_pow2_int(kp);

  // carve: gather (u64), lists, scratch, counts, hits, the ranks' counts
  // and hits, band (see topk_smem_words)
  unsigned* words = reinterpret_cast<unsigned*>(topk_smem);
  auto* gather = reinterpret_cast<unsigned long long*>(words);
  size_t off = estpu::align4(C > 1 ? 2 * static_cast<size_t>(group) * C * kp
                                   : 0);
  auto* wlists = reinterpret_cast<unsigned long long*>(words + off);
  unsigned* list = words + off;
  off += estpu::align4(kp <= estpu::kWarpK
                           ? 2 * estpu::kWarpK *
                                 (group + 4 * estpu::kSelectWarps)
                           : static_cast<size_t>(p));
  const estpu::SelectScratch scr(words + off);
  int* counts_s = reinterpret_cast<int*>(words + off + estpu::kSelectWords);
  int* hits_s = counts_s + group;
  int* ncs_all = hits_s + group;      // [G][C], filled by every rank
  int* hits_all = ncs_all + group * C;
  off += estpu::align4(estpu::kSelectWords + 2 * static_cast<size_t>(group) +
                       2 * static_cast<size_t>(group) * C);

  // sel mode: a row whose windows are all empty gives what an empty tile
  // gives, before any work; the row is the same for every band of the
  // cluster, so all of them leave before the cluster barrier
  int t = pos;
  if (tile_ids != nullptr) {
    const int* rl = row_lo + static_cast<long long>(pos) * t_pad;
    const int* rh = row_hi + static_cast<long long>(pos) * t_pad;
    int any = 0;
    for (int j = tid; j < t_pad; j += nth) any |= rh[j] > rl[j];
    if (!__syncthreads_or(any)) {
      if (band == 0) {
        for (int i = tid; i < gn * k; i += nth) {
          const long long o =
              (static_cast<long long>(pos) * q_batch + q0) * k + i;
          out_scores[o] = -CUDART_INF_F;
          out_docs[o] = -1;
        }
        for (int g = tid; g < gn; g += nth)
          out_hits[static_cast<long long>(pos) * q_batch + q0 + g] = 0.0f;
      }
      return;
    }
    t = tile_ids[pos];
  }
  if (C > 1) estpu::cluster_arrive_relaxed();

  for (int g = tid; g < group; g += nth) hits_s[g] = 0;
  const Band bd{t, pos, S, band * S, q0, gn, group, false};
  const BandSmem m = carve_band(topk_smem + off, bd, t_pad);
  band_issue_mask(live_t, sub, bd, m);
  band_accumulate<kPacked>(docs, frac, scale, row_lo, row_hi, weights, t_pad,
                           sub, n_rows, bd, m);
  cp_async_wait_all();
  __syncthreads();

  // matched = acc > 0 && live: its key replaces the score in place
  // (unmatched: key 0); hits summed exactly in i32. Thread i takes column
  // i % S of row i / S: the mask slice is read in order and the
  // accumulator without bank conflicts.
  const int ls = __ffs(S) - 1;  // log2(S)
  for (int g = 0; g < gn; ++g) {
    int h = 0;
    for (int i = tid; i < d; i += nth) {
      const int lane = i >> ls;
      const int s = i & (S - 1);
      const int at = g * m.slab + s * m.stride + lane;
      const float a = m.acc[at];
      const bool matched = a > 0.0f && m.mask[i] > 0.0f;
      h += matched;
      reinterpret_cast<unsigned*>(m.acc)[at] =
          matched ? estpu::score_key(a) : 0u;
    }
    for (int o = 16; o > 0; o >>= 1) h += __shfl_down_sync(0xffffffffu, h, o);
    if ((tid & 31) == 0 && h) atomicAdd(hits_s + g, h);
  }
  __syncthreads();

  const BandAt at{m.stride};
  const long long tile_base = static_cast<long long>(t) * w;
  const long long band_base = tile_base + static_cast<long long>(band) * d;
  auto keys_of = [&](int g) {
    return reinterpret_cast<const unsigned*>(m.acc + g * m.slab);
  };
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
    const long long row = static_cast<long long>(pos) * q_batch + q0 + g;
    const unsigned* keys = keys_of(g);
    int n;
    if (kp <= estpu::kWarpK) {
      n = counts_s[g];
    } else {
      n = estpu::band_select(keys, at, d, k, list, scr);
    }
    auto cand = [&](int j) -> unsigned long long {
      if (kp <= estpu::kWarpK) return wlists[g * estpu::kWarpK + j];
      return estpu::cand_word(keys[at(list[j])], list[j]);
    };
    if (C == 1) {
      estpu::write_row(cand, n, k, tile_base, out_scores + row * k,
                       out_docs + row * k);
      if (tid == 0) out_hits[row] = static_cast<float>(hits_s[g]);
    } else {
      estpu::push_to_rank0(cl, cand, n, band_base, gather, ncs_all, hits_all,
                           g, band, C, kp, hits_s[g]);
    }
  }
  if (C == 1) return;

  // the cluster merge: rank 0 holds every band's candidates and hits
  cl.sync();
  if (band != 0) return;
  const long long row0 = static_cast<long long>(pos) * q_batch + q0;
  if (kp <= estpu::kWarpK)
    estpu::merge_small(gather, ncs_all, gn, C, kp, k, wlists, wscratch,
                       counts_s, out_scores, out_docs, row0);
  for (int g = 0; g < gn; ++g) {
    const long long row = row0 + g;
    if (kp > estpu::kWarpK)
      estpu::merge_lists(gather + static_cast<size_t>(g) * C * kp,
                         ncs_all + g * C, C, kp, k, out_scores + row * k,
                         out_docs + row * k);
    if (tid == 0) {
      int hits = 0;
      for (int c = 0; c < C; ++c) hits += hits_all[g * C + c];
      out_hits[row] = static_cast<float>(hits);
    }
  }
}

}  // namespace


// band_sub (S) and group (G): tile_scoring.dense_band_plan. S is a power
// of two dividing sub, 1 <= G <= 32; anything else is refused.
extern "C" int estpu_tile_scoring_dense(
    const void* docs, const void* frac, const void* live_t,
    const void* row_lo, const void* row_hi, const void* weights,
    void* out_scores, void* out_counts, int n_tiles, int t_pad, int sub,
    int n_rows, int q_batch, int band_sub, int group, int packed, float scale,
    void* stream) {
  if (n_tiles <= 0 || q_batch <= 0) return 0;
  if (sub <= 0 || band_sub <= 0 || (band_sub & (band_sub - 1)) != 0 ||
      sub % band_sub != 0 || group < 1 || group > kDenseMaxGroup || t_pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(n_tiles) *
                           (sub / band_sub) *
                           ((q_batch + group - 1) / group);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * dense_smem_words(band_sub, group, t_pad, out_counts);
  auto kernel = packed ? tile_scoring_dense_kernel<true>
                       : tile_scoring_dense_kernel<false>;
  cudaError_t err = estpu::allow_max_dynamic_smem(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kDenseThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(docs), static_cast<const float*>(frac), scale,
      static_cast<const float*>(live_t), static_cast<const int*>(row_lo),
      static_cast<const int*>(row_hi), static_cast<const float*>(weights),
      static_cast<float*>(out_scores), static_cast<float*>(out_counts),
      n_tiles, t_pad, sub, n_rows, q_batch, band_sub, group);
  return static_cast<int>(cudaGetLastError());
}

// Checks a top-k plan (tile_scoring.topk_cluster_plan): C a power of two
// of at most 16 dividing sub, 1 <= G <= 32, k >= 1; returns the bytes of
// shared memory a block takes, 0 for a plan it refuses.
static size_t topk_plan_smem(int sub, int t_pad, int k, int cluster,
                             int group) {
  if (sub <= 0 || cluster < 1 || cluster > estpu::kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || sub % cluster != 0 || group < 1 ||
      group > kDenseMaxGroup || k < 1 || t_pad < 0)
    return 0;
  return sizeof(float) * topk_smem_words(cluster, group, k, sub, t_pad);
}

// How many clusters of a top-k plan the device holds at once (0: the plan
// cannot be scheduled); the plan asks before it picks a cluster size.
extern "C" int estpu_tile_topk_max_clusters(int sub, int t_pad, int k,
                                            int cluster, int group,
                                            int packed, int* out) {
  *out = 0;
  const size_t smem = topk_plan_smem(sub, t_pad, k, cluster, group);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      packed ? estpu::max_active_clusters(tile_scoring_topk_kernel<true>,
                                          kDenseThreads, smem, cluster, out)
             : estpu::max_active_clusters(tile_scoring_topk_kernel<false>,
                                          kDenseThreads, smem, cluster, out));
}

// tile_ids: nullptr, or the sel-mode subset (n_tiles = its length).
// cluster (C) and group (G): tile_scoring.topk_cluster_plan; a plan this
// kernel cannot run, or a cluster the device cannot schedule, is refused.
extern "C" int estpu_tile_scoring_topk(
    const void* docs, const void* frac, const void* live_t,
    const void* row_lo, const void* row_hi, const void* weights,
    const void* tile_ids, void* out_scores, void* out_docs, void* out_hits,
    int n_tiles, int t_pad, int sub, int n_rows, int q_batch, int k,
    int cluster, int group, int packed, float scale, void* stream) {
  if (n_tiles <= 0 || q_batch <= 0) return 0;
  const size_t smem = topk_plan_smem(sub, t_pad, k, cluster, group);
  if (smem == 0 || k > sub * kLane)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(n_tiles) * cluster *
                           ((q_batch + group - 1) / group);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = packed ? tile_scoring_topk_kernel<true>
                       : tile_scoring_topk_kernel<false>;
  return static_cast<int>(estpu::launch_clusters(
      kernel, static_cast<int>(blocks), kDenseThreads, smem, cluster,
      static_cast<cudaStream_t>(stream), static_cast<const int*>(docs),
      static_cast<const float*>(frac), scale,
      static_cast<const float*>(live_t), static_cast<const int*>(row_lo),
      static_cast<const int*>(row_hi), static_cast<const float*>(weights),
      static_cast<const int*>(tile_ids), static_cast<float*>(out_scores),
      static_cast<int*>(out_docs), static_cast<float*>(out_hits), t_pad, sub,
      n_rows, q_batch, k, cluster, group));
}

extern "C" const char* estpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}


