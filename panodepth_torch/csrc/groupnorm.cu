// Fused GroupNorm inference for Hopper (sm_90a).
//
// Replaces the TPU kernel panodepth/kernels/groupnorm.py::group_norm
// (_group_norm_impl at groupnorm.py:128, pallas_call at :140, body _kernel
// at :63).  It computes flax's GroupNorm (panodepth/models/norm.py, flax
// _compute_stats / _normalize) over an NCHW activation, where each
// (image, group) is one contiguous span of cg * HW elements:
//
//   mean = sum(x) / n,  mean2 = sum(x * x) / n          (f32 sums, n = cg*HW)
//   var  = max(mean2 - mean * mean, 0)
//   y    = (x - mean) * (rsqrt(var + eps) * scale[c]) + bias[c]
//   y    = relu ? max(y, 0) : y,  then one cast to the output type
//
// The input is bf16 (a conv's output) or f32; the output f32 or bf16.
// Every operation is written with a round-to-nearest intrinsic (and the
// library is built with -fmad=false), so nothing is contracted into an FMA
// and the only differences from the plain PyTorch version are the order of
// the f32 sums and rsqrtf, which is not correctly rounded.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes.  FastPanoNet at a
// 256x512 input runs 29 norms over 12,828,672 elements per image; reading
// bf16 once and writing f32 once is 77 MB, 0.023 ms.  The TPU kernel kept
// each image's activation in VMEM for one read; a Hopper block has 227 KB
// of shared memory, far less than one group's span at the largest shapes
// (98,304 elements), and a sum across blocks needs a second pass anyway.
// So this first form takes two launches per call and reads the input
// twice (bound 0.031 ms): gn_stats splits every span into chunks of
// kChunk elements, one block each, grid (N*G*chunks), so even 32 groups
// keep more than 132 blocks busy at the large shapes, and writes one f32
// (sum, sum of squares) pair per chunk; gn_normalize runs on the same grid,
// finalises its group's statistics from the pairs in chunk order (so the
// result does not depend on scheduling) and normalises its chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // elements per block: 16 per thread

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Sums a and b over the block; the totals are valid in thread 0.
__device__ __forceinline__ void block_sum(float& a, float& b) {
  __shared__ float sa[kThreads / 32], sb[kThreads / 32];
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    a = __fadd_rn(a, __shfl_down_sync(full, a, off));
    b = __fadd_rn(b, __shfl_down_sync(full, b, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sa[lane] : 0.0f;
    b = lane < kThreads / 32 ? sb[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      a = __fadd_rn(a, __shfl_down_sync(full, a, off));
      b = __fadd_rn(b, __shfl_down_sync(full, b, off));
    }
  }
}

// One block per (group span, chunk): the chunk's f32 sum and sum of squares.
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
gn_stats(const Tin* __restrict__ x, float2* __restrict__ partials,
         long long span, int chunks) {
  const long long group = blockIdx.x / chunks;
  const long long start = static_cast<long long>(blockIdx.x % chunks) * kChunk;
  const long long end = start + kChunk < span ? start + kChunk : span;
  const Tin* xs = x + group * span;
  float s1 = 0.0f, s2 = 0.0f;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float v = load(xs, i);
    s1 = __fadd_rn(s1, v);
    s2 = __fadd_rn(s2, __fmul_rn(v, v));
  }
  block_sum(s1, s2);
  if (threadIdx.x == 0) partials[blockIdx.x] = make_float2(s1, s2);
}

// Same grid: the group's statistics from its chunks' pairs, then the chunk
// normalised, with the optional ReLU and one cast.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
gn_normalize(const Tin* __restrict__ x, Tout* __restrict__ y,
             const float2* __restrict__ partials,
             const float* __restrict__ scale, const float* __restrict__ bias,
             long long span, int chunks, int hw, int cg, int groups,
             float count, float eps, int relu) {
  __shared__ float s_mean, s_inv;
  const long long group = blockIdx.x / chunks;
  if (threadIdx.x == 0) {
    float s1 = 0.0f, s2 = 0.0f;
    const float2* p = partials + group * chunks;
    for (int k = 0; k < chunks; ++k) {
      s1 = __fadd_rn(s1, p[k].x);
      s2 = __fadd_rn(s2, p[k].y);
    }
    const float mean = __fdiv_rn(s1, count);
    const float mean2 = __fdiv_rn(s2, count);
    const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.0f);
    s_mean = mean;
    s_inv = rsqrtf(__fadd_rn(var, eps));
  }
  __syncthreads();
  const float mean = s_mean, inv = s_inv;
  const int c0 = static_cast<int>(group % groups) * cg;
  const long long start = static_cast<long long>(blockIdx.x % chunks) * kChunk;
  const long long end = start + kChunk < span ? start + kChunk : span;
  const long long base = group * span;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const int c = c0 + static_cast<int>(i / hw);
    const float mul = __fmul_rn(inv, scale[c]);
    float v = __fadd_rn(__fmul_rn(__fsub_rn(load(x, base + i), mean), mul),
                        bias[c]);
    if (relu) v = fmaxf(v, 0.0f);
    store(y, base + i, v);
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, void* y, float2* partials, const float* scale,
           const float* bias, int n, int c, int hw, int groups, float eps,
           int relu, cudaStream_t stream) {
  const int cg = c / groups;
  const long long span = static_cast<long long>(cg) * hw;
  const int chunks = static_cast<int>((span + kChunk - 1) / kChunk);
  const unsigned blocks = static_cast<unsigned>(n) * groups * chunks;
  gn_stats<Tin><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), partials, span, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_normalize<Tin, Tout><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(y), partials, scale,
      bias, span, chunks, hw, cg, groups, static_cast<float>(span), eps,
      relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int panodepth_group_norm_chunk() { return kChunk; }

extern "C" int panodepth_group_norm_launches_per_call() { return 2; }

// GroupNorm of the contiguous NCHW (hw = H*W) tensor `x` into `y` on
// `stream`, in two launches.  `x_bf16` / `y_bf16` pick bf16 (1) or f32 (0);
// `partials` is scratch for n * groups * ceil(c / groups * hw / kChunk)
// float2 pairs; `scale` and `bias` are f32 (c,).  `eps` comes in as a double
// and is rounded to float, as flax rounds it.  Returns the first CUDA error
// (0 on success).
extern "C" int panodepth_group_norm(const void* x, int x_bf16, void* y,
                                    int y_bf16, void* partials,
                                    const float* scale, const float* bias,
                                    int n, int c, int hw, int groups,
                                    double eps, int relu, void* stream) {
  float2* p = static_cast<float2*>(partials);
  const float e = static_cast<float>(eps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && y_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, y, p, scale, bias, n, c,
                                                hw, groups, e, relu, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, y, p, scale, bias, n, c, hw,
                                        groups, e, relu, s);
  if (y_bf16)
    return launch<float, __nv_bfloat16>(x, y, p, scale, bias, n, c, hw,
                                        groups, e, relu, s);
  return launch<float, float>(x, y, p, scale, bias, n, c, hw, groups, e,
                              relu, s);
}

extern "C" const char* panodepth_group_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
