// Segment sum: per-bucket counts and value sums for bucketed aggregations.
//
// Replaces: elasticsearch_tpu/ops/pallas_aggs.py, segment_aggregate /
// _make_segsum_kernel. It computes, for every ordinal o < n_ords,
//   count[o] = sum_d [mask[d] > 0] [ord[d] == o]
//   total[o] = sum_d [mask[d] > 0] [ord[d] == o] sanitize(value[d])
// where sanitize maps NaN to 0 and clips to +-bf16-max, exactly as the
// JAX wrapper does before its kernel.
//
// What bounds it on an H100: bytes, nd * 12 read (ord i32, mask f32,
// value f32) and a few kilobytes of buckets written.
//
// What the design does about it: a grid-stride loop streams the docs
// coalesced; each block keeps partial counts (int32, exact past 2^24) and
// sums in shared memory and adds them into device memory once at the end,
// so device-memory atomics scale with blocks x buckets, not with docs.
// When the buckets do not fit in shared memory the same loop adds straight
// into device memory. The f32 sums go through atomics, so their order —
// and their last bits — change from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemLimit = 48 * 1024;
constexpr float kBf16Max = 3.3895313892515355e38f;

__device__ __forceinline__ float sanitize(float v) {
  if (isnan(v)) return 0.0f;
  return fminf(fmaxf(v, -kBf16Max), kBf16Max);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const int* __restrict__ ords, const float* __restrict__ mask,
    const float* __restrict__ values, int* __restrict__ count,
    float* __restrict__ total, long long nd, int n_ords) {
  extern __shared__ unsigned char smem_raw[];
  int* s_cnt = reinterpret_cast<int*>(smem_raw);
  float* s_tot = reinterpret_cast<float*>(s_cnt + (count ? n_ords : 0));
  int* cnt_dst = count;
  float* tot_dst = total;
  if (kShared) {
    for (int i = threadIdx.x; i < n_ords; i += blockDim.x) {
      if (count) s_cnt[i] = 0;
      if (total) s_tot[i] = 0.0f;
    }
    __syncthreads();
    cnt_dst = s_cnt;
    tot_dst = s_tot;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long d = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       d < nd; d += stride) {
    const int o = __ldg(ords + d);
    if (__ldg(mask + d) > 0.0f && o >= 0 && o < n_ords) {
      if (count) atomicAdd(cnt_dst + o, 1);
      if (total) atomicAdd(tot_dst + o, sanitize(__ldg(values + d)));
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_ords; i += blockDim.x) {
      if (count && s_cnt[i]) atomicAdd(count + i, s_cnt[i]);
      if (total && s_tot[i] != 0.0f) atomicAdd(total + i, s_tot[i]);
    }
  }
}

}  // namespace

// count (int32) and total (f32) must be zeroed by the caller; either may be
// null. Returns the launch's cudaError_t.
extern "C" int estpu_segment_sum(const void* ords, const void* mask,
                                 const void* values, void* count, void* total,
                                 long long nd, int n_ords, void* stream) {
  if (nd <= 0 || n_ords <= 0) return 0;
  int device = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (nd + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 8LL * n_sm ? want : 8LL * n_sm);
  const size_t smem = static_cast<size_t>(n_ords) *
                      ((count ? sizeof(int) : 0) + (total ? sizeof(float) : 0));
  auto s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(ords);
  const float* m = static_cast<const float*>(mask);
  const float* v = static_cast<const float*>(values);
  if (smem <= kSmemLimit) {
    segment_sum_kernel<true><<<grid, kThreads, smem, s>>>(
        o, m, v, static_cast<int*>(count), static_cast<float*>(total), nd,
        n_ords);
  } else {
    segment_sum_kernel<false><<<grid, kThreads, 0, s>>>(
        o, m, v, static_cast<int*>(count), static_cast<float*>(total), nd,
        n_ords);
  }
  return static_cast<int>(cudaGetLastError());
}
