// Segment sum: per-bucket counts and value sums for bucketed aggregations.
//
// Replaces: elasticsearch_tpu/ops/pallas_aggs.py:128 segment_aggregate
// (kernel body _make_segsum_kernel, :50; pallas_call, :213), and the
// gathers that elasticsearch_tpu/ops/aggs.py runs in XLA before it
// (ordinal_counts, :76-81; ordinal_sums, :105-111). For every ordinal
// o < n_ords
//   count[o] = sum_d [mask[d] > 0] [0 <= ord[d] < n_ords] [ord[d] == o]
//   total[o] = sum_d [mask[d] > 0] [0 <= ord[d] < n_ords] [ord[d] == o]
//              * sanitize(value[d])
// where sanitize maps NaN to 0 and clips to +-bf16-max, as the JAX wrapper
// does (pallas_aggs.py:170-179). The input comes in two forms:
//   - the f32-mask form (ords i32, mask f32, values f32), which is
//     segment_aggregate's contract;
//   - the gather form, the ordinal CSR column as it is staged: doc_index
//     [nd] i32 (flat_docs, whose padding points at the sentinel doc), ords
//     [nd] i32, match [nd1] bytes and values_by_doc [nd1] f64. There
//     mask[d] is match[doc_index[d]] and value[d] is
//     values_by_doc[doc_index[d]] rounded to f32; a doc_index outside
//     [0, nd1) contributes nothing and reads nothing. Sums are f32 and are
//     stored widened to f64.
//
// What bounds it on an H100: bytes. The f32-mask form reads nd * (4 + 4
// [+ 4 values]) bytes, the gather form nd * 8 + nd1 [+ nd1 * 8]; the
// outputs are n_ords * (4 [+ 4 or 8]) bytes. At 2^20 docs that is 2.5 to
// 3.8 us at 3.35 TB/s, so a launch's fixed costs weigh as much as the
// stream.
//
// What the design does about it (the causes PERF.md lists for the first
// port of this kernel):
//   - The grid fits the work. ops/segment_sum.py segment_sum_plan gives
//     each CTA a contiguous run of 16-byte units (4 docs): one CTA an SM
//     at most, at least 4,096 docs a CTA (one CTA for a small segment),
//     and as many warps, up to 16, as one step of its docs needs. A lane
//     issues kUnroll 16-byte loads of each array at once; the next step's
//     loads go out before this step's rounds, and the first step's before
//     the histograms are zeroed. The gather form's match and value loads
//     depend on doc_index alone and go out together.
//   - Only valid docs cost a round. A warp queues its valid (ordinal,
//     value) entries in shared memory in a fixed order (ballot and
//     prefix count), and then takes them 32 at a time.
//   - Hot buckets are combined in the warp first: lanes with the same
//     ordinal are grouped with __match_any_sync, the group's lowest lane
//     sums its values in lane order and adds once.
//   - The shared path (the histograms fit in shared memory): counts go to
//     one int32 histogram a CTA through shared atomics, exact in any
//     order. Sums go to a private f32 histogram a warp, written only by
//     that warp's group leaders in the warp's fixed order; the CTA adds
//     its warps' histograms in warp order. With one CTA it writes the
//     outputs; otherwise each CTA writes its whole partial histogram once,
//     without atomics, into scratch, and segment_sum_combine_kernel adds
//     the partials in a fixed order (kCombineSlices contiguous slices of
//     CTAs, then the slices in order) into every output bucket. So the
//     same inputs give the same sums, bit for bit, from launch to launch,
//     no output needs zeroing first, and no bucket takes a device-memory
//     atomic.
//   - The global path (high cardinality, histograms too large for shared
//     memory): the combine kernel zeroes the outputs, then the main pass
//     adds each warp group's count and sum with one device-memory atomic:
//     one a distinct ordinal in a round of 32 valid docs, not one a
//     matched doc. Counts stay exact; sums go through float atomics, so
//     their last bits change from run to run (within 1e-4 * sum |value| +
//     1e-3 of the plain version).
//   - A call launches at most two kernels, the second with programmatic
//     dependent launch, so its launch overlaps the first kernel's run.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kUnroll = 4;          // 16-byte units a lane loads per array
constexpr int kMaxWarps = 16;       // warps of a main-pass CTA
// a warp's queue of valid (ordinal, value) entries: one step's 512 docs
// on top of fewer than 32 left over from the step before
constexpr int kQueue = 32 * kUnroll * 4 + 32;
constexpr int kCombineSlices = 32;  // warps of a combine block
constexpr int kCombineOrds = 32;    // ordinals of a combine block: a lane each
constexpr int kPathShared = 0;
constexpr int kPathGlobal = 1;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kBf16Max = 3.3895313892515355e38f;

static_assert(kCombineOrds == 32, "a combine lane takes one ordinal");

__device__ __forceinline__ float sanitize(float v) {
  if (isnan(v)) return 0.0f;
  return fminf(fmaxf(v, -kBf16Max), kBf16Max);
}

// Docs 4u .. 4u+3 of p as one vector: a 16-byte load when all four lie
// below lim, else one load per doc below lim and ``fill`` above it.
template <typename T, typename V>
__device__ __forceinline__ V load_unit(const T* __restrict__ p, long long u,
                                       long long lim, T fill) {
  const long long d = u * 4;
  if (d + 4 <= lim) return __ldg(reinterpret_cast<const V*>(p) + u);
  T x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = d + e < lim ? __ldg(p + d + e) : fill;
  return V{x[0], x[1], x[2], x[3]};
}

__device__ __forceinline__ void lanes4(const int4& v, int* out) {
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void lanes4(const float4& v, float* out) {
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ float4 add4(float4 a, const float4& b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
  return a;
}

// Programmatic dependent launch (Hopper): a kernel lets the next kernel of
// its stream launch early, and that kernel waits here for this one to
// finish and its writes to show before it reads them. Without the launch
// attribute the wait returns at once.
__device__ __forceinline__ void let_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The f32-mask form: ords, mask and values side by side.
struct MaskForm {
  const int* ords;
  const float* mask;
  const float* values;  // null without sums

  struct Raw {
    int4 o;
    float4 m;
    float4 v;
  };

  __device__ __forceinline__ void load(Raw& r, long long u, long long lim,
                                       bool sums) const {
    r.o = load_unit<int, int4>(ords, u, lim, 0);
    r.m = load_unit<float, float4>(mask, u, lim, 0.0f);
    r.v = sums ? load_unit<float, float4>(values, u, lim, 0.0f)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  __device__ __forceinline__ void fetch(Raw&, bool) const {}

  __device__ __forceinline__ void resolve(const Raw& r, int n_ords, int* key,
                                          float* val) const {
    int o[4];
    float m[4], v[4];
    lanes4(r.o, o);
    lanes4(r.m, m);
    lanes4(r.v, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      key[e] = m[e] > 0.0f && o[e] >= 0 && o[e] < n_ords ? o[e] : -1;
      val[e] = sanitize(v[e]);
    }
  }
};

// The gather form: the ordinal CSR column and the per-doc match bytes and
// f64 values it points into.
struct GatherForm {
  const int* doc_index;
  const int* ords;
  const unsigned char* match;
  const double* values;  // null without sums
  long long nd1;

  struct Raw {
    int4 j;
    int4 o;
    unsigned char m[4];
    double v[4];
  };

  __device__ __forceinline__ void load(Raw& r, long long u, long long lim,
                                       bool) const {
    r.j = load_unit<int, int4>(doc_index, u, lim, -1);
    r.o = load_unit<int, int4>(ords, u, lim, 0);
  }

  // the loads that depend on doc_index, all issued before any is used
  __device__ __forceinline__ void fetch(Raw& r, bool sums) const {
    int j[4];
    lanes4(r.j, j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = j[e] >= 0 && j[e] < nd1;
      r.m[e] = in ? __ldg(match + j[e]) : 0;
      r.v[e] = in && sums ? __ldg(values + j[e]) : 0.0;
    }
  }

  __device__ __forceinline__ void resolve(const Raw& r, int n_ords, int* key,
                                          float* val) const {
    int o[4];
    lanes4(r.o, o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      key[e] = r.m[e] != 0 && o[e] >= 0 && o[e] < n_ords ? o[e] : -1;
      val[e] = sanitize(static_cast<float>(r.v[e]));
    }
  }
};

// Dynamic shared bytes of a main-pass CTA of ``warps`` warps; mirrored by
// ops/segment_sum.py segment_sum_smem. Layout: on the shared path the
// count histogram and one sum histogram a warp, each padded to 4 words;
// then a queue of kQueue ordinals a warp, and of kQueue values a warp
// with sums.
size_t plan_smem(int n_ords, int warps, bool counts, bool sums, int path) {
  const size_t n4 = (static_cast<size_t>(n_ords) + 3) & ~static_cast<size_t>(3);
  size_t words = static_cast<size_t>(warps) * kQueue * (sums ? 2 : 1);
  if (path == kPathShared)
    words += (counts ? n4 : 0) + (sums ? static_cast<size_t>(warps) * n4 : 0);
  return words * sizeof(float);
}

template <class Form, bool kShared, typename TotalT>
__global__ void __launch_bounds__(kMaxWarps * 32) segment_sum_kernel(
    Form form, long long nd, int n_ords, long long units_per_cta,
    int* __restrict__ count, TotalT* __restrict__ total,
    int* __restrict__ part_cnt, float* __restrict__ part_tot) {
  extern __shared__ int4 smem4[];
  let_dependents_launch();
  const bool counts = count != nullptr;
  const bool sums = total != nullptr;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n4 = (n_ords + 3) & ~3;
  int* s_cnt = reinterpret_cast<int*>(smem4);
  float* s_hist =
      reinterpret_cast<float*>(s_cnt + (kShared && counts ? n4 : 0));
  int* q_key = reinterpret_cast<int*>(s_hist + (kShared && sums ? warps * n4
                                                                : 0)) +
               warp * kQueue;
  float* q_val = reinterpret_cast<float*>(q_key) + warps * kQueue;
  float* my_hist = s_hist + warp * n4;
  int* cnt_dst = kShared ? s_cnt : count;

  const long long n_units = (nd + 3) >> 2;
  const long long u_begin = static_cast<long long>(blockIdx.x) * units_per_cta;
  const long long u_end =
      u_begin + units_per_cta < n_units ? u_begin + units_per_cta : n_units;
  const long long step = static_cast<long long>(warps) * 32 * kUnroll;
  // a step's 16-byte loads; the next step's go out before this step's
  // rounds, and the first step's before the histograms are zeroed
  typename Form::Raw raw[kUnroll];
  auto load_step = [&](long long base) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long u =
          base + static_cast<long long>(warp * kUnroll + k) * 32 + lane;
      form.load(raw[k], u, u < u_end ? nd : 0, sums);
    }
  };
  if (u_begin < u_end) load_step(u_begin);
  if constexpr (kShared) {
    const int zero4 = ((counts ? n4 : 0) + (sums ? warps * n4 : 0)) >> 2;
    for (int i = threadIdx.x; i < zero4; i += blockDim.x)
      smem4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
  } else {
    // the outputs are zeroed by the kernel before this one
    wait_for_prerequisite();
  }

  // One round: the 32 queued entries from ``at`` (the first ``n`` of them
  // valid). Lanes with the same ordinal form a group; its lowest lane sums
  // the group's values in lane order and adds once. The __syncwarp
  // orders the last round's read-modify-write of my_hist before this
  // round's: another lane may lead the same ordinal's group now.
  auto round = [&](int at, int n) {
    __syncwarp();
    const int o = lane < n ? q_key[at + lane] : -1;
    const unsigned peers = __match_any_sync(kFullMask, o);
    if (o < 0 || lane != __ffs(peers) - 1) return;
    if (counts) atomicAdd(cnt_dst + o, __popc(peers));
    if (sums) {
      float s = 0.0f;
      for (unsigned m = peers; m; m &= m - 1)
        s = __fadd_rn(s, q_val[at + __ffs(m) - 1]);
      if constexpr (kShared)
        my_hist[o] = __fadd_rn(my_hist[o], s);
      else
        atomicAdd(total + o, static_cast<TotalT>(s));
    }
  };

  const unsigned below = (1u << lane) - 1;
  int queued = 0;  // the warp's queue length, the same in every lane
  for (long long base = u_begin; base < u_end; base += step) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) form.fetch(raw[k], sums);
    // queue the valid entries in a fixed order: unit, doc, lane
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      int key[4];
      float val[4];
      form.resolve(raw[k], n_ords, key, val);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned valid = __ballot_sync(kFullMask, key[e] >= 0);
        if (key[e] >= 0) {
          const int at = queued + __popc(valid & below);
          q_key[at] = key[e];
          if (sums) q_val[at] = val[e];
        }
        queued += __popc(valid);
      }
    }
    if (base + step < u_end) load_step(base + step);
    __syncwarp();
    int at = 0;
    for (; at + 32 <= queued; at += 32) round(at, 32);
    // move what is left, fewer than 32, to the front of the queue
    const int left = queued - at;
    if (at > 0 && left > 0) {
      const int k = lane < left ? q_key[at + lane] : 0;
      const float v = lane < left && sums ? q_val[at + lane] : 0.0f;
      __syncwarp();
      if (lane < left) {
        q_key[lane] = k;
        if (sums) q_val[lane] = v;
      }
    }
    __syncwarp();
    queued = left;
  }
  if (queued > 0) round(0, queued);

  if constexpr (kShared) {
    __syncthreads();
    if (gridDim.x == 1) {
      for (int o = threadIdx.x; o < n_ords; o += blockDim.x) {
        if (counts) count[o] = s_cnt[o];
        if (sums) {
          float t = 0.0f;
          for (int w = 0; w < warps; ++w)
            t = __fadd_rn(t, s_hist[w * n4 + o]);
          total[o] = static_cast<TotalT>(t);
        }
      }
    } else {
      // this CTA's partial row: n4 wide, four ordinals a thread
      const long long row = static_cast<long long>(blockIdx.x) * (n4 >> 2);
      const float4* hist4 = reinterpret_cast<const float4*>(s_hist);
      for (int o4 = threadIdx.x; o4 < (n4 >> 2); o4 += blockDim.x) {
        if (counts)
          reinterpret_cast<int4*>(part_cnt)[row + o4] = smem4[o4];
        if (sums) {
          float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int w = 0; w < warps; ++w)
            t = add4(t, hist4[w * (n4 >> 2) + o4]);
          reinterpret_cast<float4*>(part_tot)[row + o4] = t;
        }
      }
    }
  }
}

// Adds n_parts partial histograms [n_parts, n_ords padded to 4] into the
// outputs, in a fixed order: warp s of a block folds its slice of the
// parts in order, then warp 0 adds the slices in order; a lane takes one
// ordinal, so a block's loads are 32 slices of whole 128-byte rows. With
// n_parts == 0 it writes zeros (the global path's first pass).
template <typename TotalT>
__global__ void __launch_bounds__(kCombineSlices * 32)
    segment_sum_combine_kernel(const int* __restrict__ part_cnt,
                               const float* __restrict__ part_tot,
                               int n_parts, int n_ords,
                               int* __restrict__ count,
                               TotalT* __restrict__ total) {
  let_dependents_launch();
  if (n_parts == 0) {
    const int stride = gridDim.x * blockDim.x;
    for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < n_ords;
         o += stride) {
      if (count) count[o] = 0;
      if (total) total[o] = static_cast<TotalT>(0);
    }
    return;
  }
  __shared__ int s_cnt[kCombineSlices][kCombineOrds];
  __shared__ float s_tot[kCombineSlices][kCombineOrds];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int row = (n_ords + 3) & ~3;
  const int o = blockIdx.x * kCombineOrds + lane;
  const int per = (n_parts + kCombineSlices - 1) / kCombineSlices;
  const int b0 = slice * per < n_parts ? slice * per : n_parts;
  const int b1 = b0 + per < n_parts ? b0 + per : n_parts;
  int c = 0;
  float t = 0.0f;
  wait_for_prerequisite();  // the partials are the main pass's
  if (o < n_ords) {
#pragma unroll 8
    for (int b = b0; b < b1; ++b) {
      const long long i = static_cast<long long>(b) * row + o;
      if (count) c += __ldcg(part_cnt + i);
      if (total) t = __fadd_rn(t, __ldcg(part_tot + i));
    }
  }
  s_cnt[slice][lane] = c;
  s_tot[slice][lane] = t;
  __syncthreads();
  if (slice == 0 && o < n_ords) {
    int cc = 0;
    float tt = 0.0f;
    for (int s = 0; s < kCombineSlices; ++s) {
      cc += s_cnt[s][lane];
      tt = __fadd_rn(tt, s_tot[s][lane]);
    }
    if (count) count[o] = cc;
    if (total) total[o] = static_cast<TotalT>(tt);
  }
}

// A launch that may begin before the kernel ahead of it in the stream ends
// (programmatic stream serialization); the kernel waits for it itself.
template <typename Kernel, typename... Args>
cudaError_t launch_dependent(Kernel kernel, int blocks, int threads,
                             size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Checks a plan, then launches the main pass of ``form``.
template <typename TotalT, class Form>
int launch_main(const Form& form, long long nd, int n_ords, int path,
                int grid, int threads, int smem, long long units_per_cta,
                void* count, void* total, void* part_cnt, void* part_tot,
                void* stream) {
  const bool counts = count != nullptr;
  const bool sums = total != nullptr;
  if (n_ords <= 0 || nd < 0 || !(counts || sums))
    return static_cast<int>(cudaErrorInvalidValue);
  // a plan this kernel cannot run as asked is refused
  const long long n_units = (nd + 3) / 4;
  if ((path != kPathShared && path != kPathGlobal) || threads < 32 ||
      threads > kMaxWarps * 32 || threads % 32 != 0 || grid < 1 ||
      units_per_cta < 1 ||
      static_cast<long long>(grid) * units_per_cta < n_units ||
      static_cast<size_t>(smem) !=
          plan_smem(n_ords, threads / 32, counts, sums, path))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (path == kPathShared && grid > 1 &&
      ((counts && part_cnt == nullptr) || (sums && part_tot == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<int*>(count);
  auto* t = static_cast<TotalT*>(total);
  auto* pc = static_cast<int*>(part_cnt);
  auto* pt = static_cast<float*>(part_tot);
  cudaError_t err;
  if (path == kPathShared) {
    auto kernel = segment_sum_kernel<Form, true, TotalT>;
    err = estpu::allow_max_dynamic_smem(kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, smem, s>>>(form, nd, n_ords, units_per_cta, c, t,
                                       pc, pt);
  } else {
    // launched behind the combine kernel's zero pass
    auto kernel = segment_sum_kernel<Form, false, TotalT>;
    err = estpu::allow_max_dynamic_smem(kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_dependent(kernel, grid, threads, smem, s, form, nd, n_ords,
                           units_per_cta, c, t, pc, pt);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f32-mask form's main pass. count (int32) and total (f32) may each be
// null; part_cnt / part_tot are the [grid, n_ords padded to 4] scratch of
// the shared path when grid > 1, on 16-byte boundaries. On the global path the outputs must be zeroed first
// (estpu_segment_sum_combine with n_parts 0). Returns the launch's
// cudaError_t; a plan it cannot launch gives cudaErrorInvalidConfiguration.
extern "C" int estpu_segment_sum(const void* ords, const void* mask,
                                 const void* values, void* count, void* total,
                                 void* part_cnt, void* part_tot, long long nd,
                                 int n_ords, int path, int grid, int threads,
                                 int smem, long long units_per_cta,
                                 void* stream) {
  const MaskForm form{static_cast<const int*>(ords),
                      static_cast<const float*>(mask),
                      static_cast<const float*>(values)};
  return launch_main<float>(form, nd, n_ords, path, grid, threads, smem,
                            units_per_cta, count, total, part_cnt, part_tot,
                            stream);
}

// The gather form's main pass: as above, with total (if not null) f64.
extern "C" int estpu_segment_sum_gathered(
    const void* doc_index, const void* ords, const void* match,
    const void* values_by_doc, void* count, void* total, void* part_cnt,
    void* part_tot, long long nd, long long nd1, int n_ords, int path,
    int grid, int threads, int smem, long long units_per_cta, void* stream) {
  const GatherForm form{static_cast<const int*>(doc_index),
                        static_cast<const int*>(ords),
                        static_cast<const unsigned char*>(match),
                        static_cast<const double*>(values_by_doc), nd1};
  return launch_main<double>(form, nd, n_ords, path, grid, threads, smem,
                             units_per_cta, count, total, part_cnt, part_tot,
                             stream);
}

// The combine pass: the outputs from n_parts partial histograms ([n_parts,
// n_ords padded to 4]), or zeros when n_parts is 0. ``blocks`` must be
// ceil(n_ords / 32) when n_parts > 0.
extern "C" int estpu_segment_sum_combine(const void* part_cnt,
                                         const void* part_tot, void* count,
                                         void* total, int total_f64,
                                         int n_parts, int n_ords, int blocks,
                                         void* stream) {
  if (n_ords <= 0 || n_parts < 0 || (count == nullptr && total == nullptr) ||
      (n_parts > 0 && ((count && part_cnt == nullptr) ||
                       (total && part_tot == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks < 1 ||
      (n_parts > 0 && blocks != (n_ords + kCombineOrds - 1) / kCombineOrds))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto s = static_cast<cudaStream_t>(stream);
  const int* pc = static_cast<const int*>(part_cnt);
  const float* pt = static_cast<const float*>(part_tot);
  int* c = static_cast<int*>(count);
  // the fold runs behind the main pass; the zero pass is a call's first
  // kernel
  cudaError_t err = cudaSuccess;
  if (total_f64) {
    auto* t = static_cast<double*>(total);
    if (n_parts > 0)
      err = launch_dependent(segment_sum_combine_kernel<double>, blocks,
                             kCombineSlices * 32, 0, s, pc, pt, n_parts,
                             n_ords, c, t);
    else
      segment_sum_combine_kernel<double><<<blocks, kCombineSlices * 32, 0,
                                           s>>>(pc, pt, n_parts, n_ords, c,
                                                t);
  } else {
    auto* t = static_cast<float*>(total);
    if (n_parts > 0)
      err = launch_dependent(segment_sum_combine_kernel<float>, blocks,
                             kCombineSlices * 32, 0, s, pc, pt, n_parts,
                             n_ords, c, t);
    else
      segment_sum_combine_kernel<float><<<blocks, kCombineSlices * 32, 0,
                                          s>>>(pc, pt, n_parts, n_ords, c,
                                               t);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
