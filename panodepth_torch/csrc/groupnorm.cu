// Fused GroupNorm inference for Hopper (sm_90a).
//
// Replaces the TPU kernel panodepth/kernels/groupnorm.py::group_norm
// (_group_norm_impl at groupnorm.py:128, pallas_call at :140, body _kernel
// at :63).  It computes flax's GroupNorm (panodepth/models/norm.py, flax
// _compute_stats / _normalize) over an NCHW activation, where each
// (image, group) is one contiguous span of cg * HW elements:
//
//   mean = f32(sum(x) / n),  mean2 = f32(sum(x * x) / n)   (n = cg*HW; the
//          sums and the divisions in f64, each rounded once to f32)
//   var  = max(mean2 - mean * mean, 0)
//   y    = (x - mean) * (rsqrt(var + eps) * scale[c]) + bias[c]
//   y    = relu ? max(y, 0) : y,  then one cast to the output type
//
// The input is bf16 (a conv's output) or f32; the output f32 or bf16.
// The sums are f64: each x and x * x is exact there, and for bf16 input so
// is every partial sum (8-bit mantissas, squares of 16 bits, far from f64's
// 53), so any order of summation gives the same statistics, and they are
// the correctly rounded ones.  That matters because E[x²] - E[x]² cancels:
// a group whose mean dwarfs its spread (a smooth image channel, as at the
// GN perspective net's stem, where (E[x²] + E[x]²) / var reaches ~120)
// multiplies an f32 sum's rounding by that ratio, and two f32 sums in two
// orders then disagreed by 22 f32 ulps of the output.  Every f32 operation
// is written with a round-to-nearest intrinsic (and the library is built
// with -fmad=false), so nothing is contracted into an FMA, and the plain
// PyTorch version (the same f64 sums) gives the same bits but for rsqrtf.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes.  FastPanoNet at a
// 256x512 input runs 29 norms over 12,828,672 elements per image; reading
// bf16 once and writing f32 once is 77 MB, 0.023 ms.  Most calls move
// 0.1-3 MB, so in practice a launch's start-up and tail bound each call.
//
// The design: one launch per call, the input read once.  The TPU kernel
// held an image in VMEM; here each (image, group) span is split over a
// thread-block cluster of K blocks (K up to 16, set per call by
// kernels/groupnorm.py::plan_for so that one image's G*K blocks reach the
// 132 SMs where the span allows it, the same K at any batch so that an
// image's sum order does not depend on it; a span under 6144 elements
// stays one block, since a cluster's barriers cost more than the split
// saves).  Each block
//   1. loads its slice of the span with 16-byte vector loads, keeps it in
//      shared memory and sums it to one f64 (s1, s2) pair (a fixed
//      per-thread order and a fixed reduction tree);
//   2. publishes the pair in its shared memory; after a cluster barrier,
//      reads the K pairs through distributed shared memory (one lane per
//      rank, all in flight together) and sums them in rank order, so every
//      block of the cluster finalises the same mean and 1/std, whatever
//      the scheduling;
//   3. normalises its slice from shared memory channel by channel (the
//      channel's scale and bias are read once per channel, no per-element
//      division; short channels a warp each), with 16-byte vector stores.
// A head and a tail that are not 8-aligned (HW % 8 != 0) take scalar
// accesses inside the same kernel.  A slice too large for shared memory
// even at K = 16 is read twice instead (unstaged); no zoo net's shape is.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;  // elements per vector access: 16 bytes of bf16
constexpr int kMaxCluster = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 8 elements at p (16-byte aligned for bf16, 32 for f32) as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v,
                                      uint4* raw) {
  raw[0] = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(raw);
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void load8(const float* p, float* v, uint4* raw) {
  raw[0] = reinterpret_cast<const uint4*>(p)[0];
  raw[1] = reinterpret_cast<const uint4*>(p)[1];
  const float* e = reinterpret_cast<const float*>(raw);
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = e[j];
}
__device__ __forceinline__ void keep8(__nv_bfloat16* p, const uint4* raw) {
  *reinterpret_cast<uint4*>(p) = raw[0];
}
__device__ __forceinline__ void keep8(float* p, const uint4* raw) {
  reinterpret_cast<uint4*>(p)[0] = raw[0];
  reinterpret_cast<uint4*>(p)[1] = raw[1];
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec; ++j) e[j] = __float2bfloat16_rn(v[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Sums a and b over the block in a fixed tree; the totals are valid in
// thread 0.
__device__ __forceinline__ void block_sum(double& a, double& b) {
  __shared__ double sa[kWarps], sb[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    a = __dadd_rn(a, __shfl_down_sync(0xffffffffu, a, off));
    b = __dadd_rn(b, __shfl_down_sync(0xffffffffu, b, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = sa[0];
    b = sb[0];
    for (int i = 1; i < kWarps; ++i) {
      a = __dadd_rn(a, sa[i]);
      b = __dadd_rn(b, sb[i]);
    }
  }
}

__device__ __forceinline__ float norm1(float v, float mean, float mul,
                                       float add, int relu) {
  v = __fadd_rn(__fmul_rn(__fsub_rn(v, mean), mul), add);
  return relu ? fmaxf(v, 0.0f) : v;
}

// One cluster of K blocks per (image, group) span of `span` elements;
// block rank k owns the slice [k*slice, (k+1)*slice) of it (clipped).
// `staged`: the slice is kept in dynamic shared memory between the two
// phases (else read again); `vec`: x and y are 16-byte aligned, so 8-aligned
// runs take vector accesses.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
gn_cluster(const Tin* __restrict__ x, Tout* __restrict__ y,
           const float* __restrict__ scale, const float* __restrict__ bias,
           int span, int hw, int channels, int slice, int staged, int vec,
           float eps, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tin* keep = reinterpret_cast<Tin*>(smem_raw);
  __shared__ double2 s_pair;
  __shared__ float s_mean, s_inv;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int start = (blockIdx.x / k) * span;
  const int lo = rank * slice < span ? rank * slice : span;
  const int hi = (rank + 1) * slice < span ? (rank + 1) * slice : span;
  const int s0 = start + lo, s1 = start + hi;
  const int base = s0 & ~(kVec - 1);  // keep[0] holds x[base]
  // [s0, head) scalar, [head, vend) in vectors, [vend, s1) scalar
  int head = s1, vend = s1;
  if (vec) {
    head = (s0 + kVec - 1) & ~(kVec - 1);
    head = head < s1 ? head : s1;
    vend = s1 & ~(kVec - 1);
    vend = vend > head ? vend : head;
  }

  // phase 3 splits the slice by channel: a long channel to the whole block,
  // a short one (fewer vectors than half the block) to one warp, the
  // block's warps on as many channels at once.  The first channel's scale
  // and bias are read now, off the path that waits for the statistics.
  const int team = hw / kVec >= kThreads / 2 ? kThreads : 32;
  const int me = tid % team;
  const int c0 = s0 / hw + tid / team;
  float sc = 0.0f, bi = 0.0f;
  if (static_cast<long long>(c0) * hw < s1) {
    sc = scale[c0 % channels];
    bi = bias[c0 % channels];
  }

  // 1. load (and keep) the slice, f64 sums
  double a1 = 0.0, a2 = 0.0;
  for (int i = s0 + tid; i < head; i += kThreads) {
    const Tin raw = x[i];
    if (staged) keep[i - base] = raw;
    const double v = to_f32(raw);
    a1 = __dadd_rn(a1, v);
    a2 = __dadd_rn(a2, __dmul_rn(v, v));
  }
#pragma unroll 4
  for (int i = head + tid * kVec; i < vend; i += kThreads * kVec) {
    float v[kVec];
    uint4 raw[sizeof(Tin) * kVec / 16];
    load8(x + i, v, raw);
    if (staged) keep8(keep + (i - base), raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const double d = v[j];
      a1 = __dadd_rn(a1, d);
      a2 = __dadd_rn(a2, __dmul_rn(d, d));
    }
  }
  for (int i = vend + tid; i < s1; i += kThreads) {
    const Tin raw = x[i];
    if (staged) keep[i - base] = raw;
    const double v = to_f32(raw);
    a1 = __dadd_rn(a1, v);
    a2 = __dadd_rn(a2, __dmul_rn(v, v));
  }
  block_sum(a1, a2);
  if (tid == 0) s_pair = make_double2(a1, a2);

  // 2. the cluster's pairs in rank order: every block the same statistics.
  // Lane r of warp 0 reads rank r's pair (the K remote reads in flight
  // together), and lane 0 sums them in rank order through shuffles.  A
  // lone block (K = 1, launched without a cluster) needs no cluster
  // barrier.
  const bool multi = k > 1;
  if (multi)
    cluster.sync();
  else
    __syncthreads();
  if (tid < 32) {
    double2 p = make_double2(0.0, 0.0);
    if (tid < k) p = multi ? *cluster.map_shared_rank(&s_pair, tid) : s_pair;
    double t1 = 0.0, t2 = 0.0;
    for (int r = 0; r < k; ++r) {
      t1 = __dadd_rn(t1, __shfl_sync(0xffffffffu, p.x, r));
      t2 = __dadd_rn(t2, __shfl_sync(0xffffffffu, p.y, r));
    }
    if (tid == 0) {
      const double n = span;
      const float mean = __double2float_rn(__ddiv_rn(t1, n));
      const float mean2 = __double2float_rn(__ddiv_rn(t2, n));
      const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.0f);
      s_mean = mean;
      s_inv = rsqrtf(__fadd_rn(var, eps));
    }
  }
  __syncthreads();
  // this block reads no other block's shared memory from here on; a block
  // must not exit before the others have read its pair
  if (multi)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  const float mean = s_mean, inv = s_inv;

  // 3. normalise channel by channel; x[i] of the slice is src[i - off]
  const Tin* src = staged ? keep : x;
  const int off = staged ? base : 0;
  for (int c = c0; static_cast<long long>(c) * hw < s1;
       c += kThreads / team) {
    const int a = c * hw > s0 ? c * hw : s0;
    const int b = static_cast<long long>(c + 1) * hw < s1 ? (c + 1) * hw : s1;
    if (c != c0) {
      sc = scale[c % channels];
      bi = bias[c % channels];
    }
    const float mul = __fmul_rn(inv, sc);
    const float add = bi;
    int ha = b, hb = b;
    if (vec) {
      ha = (a + kVec - 1) & ~(kVec - 1);
      ha = ha < b ? ha : b;
      hb = b & ~(kVec - 1);
      hb = hb > ha ? hb : ha;
    }
    for (int i = a + me; i < ha; i += team)
      put(y + i, norm1(to_f32(src[i - off]), mean, mul, add, relu));
#pragma unroll 4
    for (int i = ha + me * kVec; i < hb; i += team * kVec) {
      float v[kVec];
      uint4 raw[sizeof(Tin) * kVec / 16];
      load8(src + (i - off), v, raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = norm1(v[j], mean, mul, add, relu);
      store8(y + i, v);
    }
    for (int i = hb + me; i < b; i += team)
      put(y + i, norm1(to_f32(src[i - off]), mean, mul, add, relu));
  }
  if (multi)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename Tin, typename Tout>
int launch(const void* x, void* y, const float* scale, const float* bias,
           int n, int c, int hw, int groups, float eps, int relu,
           int cluster, int slice, int staged, int smem, int opt_in,
           cudaStream_t stream) {
  auto kernel = gn_cluster<Tin, Tout>;
  const int span = c / groups * hw;
  // the plan's byte count must hold a staged slice (8-aligned start: one
  // vector of slack); the card itself refuses what it cannot grant
  if (cluster < 1 || cluster > kMaxCluster || slice < 1 || smem < 0 ||
      static_cast<long long>(slice) * cluster < span ||
      (staged && static_cast<size_t>(smem) < sizeof(Tin) * (slice + kVec)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (opt_in) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n) * groups * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a lone block needs no cluster
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const Tin*>(x),
                           static_cast<Tout*>(y), scale, bias, span, hw, c,
                           slice, staged, vec, eps, relu);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int panodepth_group_norm_launches_per_call() { return 1; }

// GroupNorm of the contiguous NCHW (hw = H*W) tensor `x` into `y` on
// `stream`, in one launch of n * groups clusters of `cluster` blocks; block
// k of a cluster owns elements [k*slice, (k+1)*slice) of its span, kept in
// shared memory if `staged`.  `smem` is the dynamic shared memory per block
// (kernels/groupnorm.py, GroupNormPlan.smem_bytes), granted first with
// `opt_in` above the default 48 KB.  `x_bf16` / `y_bf16` pick bf16 (1) or
// f32 (0); `scale` and `bias` are f32 (c,).  `eps` comes in as a double
// and is rounded to float, as flax rounds it.  Returns the first CUDA
// error (0 on success; cudaErrorInvalidValue for a plan that does not
// cover the span or whose `smem` does not hold a staged slice).
extern "C" int panodepth_group_norm(const void* x, int x_bf16, void* y,
                                    int y_bf16, const float* scale,
                                    const float* bias, int n, int c, int hw,
                                    int groups, double eps, int relu,
                                    int cluster, int slice, int staged,
                                    int smem, int opt_in, void* stream) {
  const float e = static_cast<float>(eps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && y_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        x, y, scale, bias, n, c, hw, groups, e, relu, cluster, slice, staged,
        smem, opt_in, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, y, scale, bias, n, c, hw, groups,
                                        e, relu, cluster, slice, staged, smem,
                                        opt_in, s);
  if (y_bf16)
    return launch<float, __nv_bfloat16>(x, y, scale, bias, n, c, hw, groups,
                                        e, relu, cluster, slice, staged, smem,
                                        opt_in, s);
  return launch<float, float>(x, y, scale, bias, n, c, hw, groups, e, relu,
                              cluster, slice, staged, smem, opt_in, s);
}

extern "C" const char* panodepth_group_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
