// The int8 graph's activation quantization for Hopper (sm_90a): per-image
// absmax scale and round-half-even int8 codes, written NHWC with the
// channels zero-padded to a multiple of 16 (the input csrc/qconv.cu reads).
//
// Not the port of a TPU kernel.  The JAX package leaves this to XLA, which
// fuses it ahead of each int8 conv (panodepth/models/perspective.py::QConv,
// :62-67):
//
//   sx    = max(amax |x| over (C, H, W), 1e-8) / 127            per image
//   codes = clip(round_half_even(x / sx), -127, 127) as int8
//
// Both divisions are true round-to-nearest divisions (__fdiv_rn) and the
// round is rintf, so that a code on a rounding tie lands where the plain
// PyTorch twin (kernels/qconv.py::quantize_nhwc_plain) and JAX, op by op,
// put it: a code that crosses a tie moves a whole step.
//
// Two launches on the caller's stream: quantize_amax reads the NCHW
// activation once (16-byte loads) and writes each block's max |x| as the
// float's bits into a scratch word (nonnegative floats order as their
// bits; a NaN's absolute value orders above +inf, so a NaN propagates as
// in torch.amax); quantize_codes takes the max of its image's words,
// reads the activation once more, a 64-pixel x 64-channel tile a block
// (4 pixels of a channel a load, the images' last channels first: what the
// first pass read last is still in L2), through a shared-memory tile so that
// both the NCHW reads (along pixels) and the NHWC writes (16 bytes of
// channels a thread) are coalesced, and writes sx.  One launch would need
// every block of an image to finish its absmax before any writes a code,
// a grid-wide barrier that a graph of plain launches does not give
// safely; the scratch words need no memset.
//
// What bounds it on an H100 SXM: bytes.  It must read each input element
// once and write one byte a padded channel: at 3.35 TB/s a 15-view forward
// of the GN perspective net (0.28 G elements, mostly f32) is bound near
// 0.4 ms; the second read (the absmax pass) is what it moves beyond that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TP = 64;           // pixels a codes block
constexpr int TC = 64;           // channels a codes block
constexpr int TSTRIDE = TC + 4;  // shared row (a pixel) in bytes
constexpr int MAX_PARTS = 64;    // absmax blocks (scratch words) an image

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// |v| as float bits (ordered as the floats)
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// the largest |x| of 16 bytes of elements, as float bits
template <typename T>
__device__ __forceinline__ unsigned vec_max(const uint4& u) {
  const T* e = reinterpret_cast<const T*>(&u);
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < static_cast<int>(16 / sizeof(T)); ++i)
    m = max(m, abs_bits(to_f32(e[i])));
  return m;
}

__device__ __forceinline__ unsigned block_max(unsigned m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ unsigned warp_max[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) m = max(m, warp_max[w]);
  return m;
}

// grid (parts, N): block b of image n writes max |x| over its share of the
// image into parts[n * MAX_PARTS + b] (bits)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    quantize_amax(const T* __restrict__ x, unsigned* __restrict__ parts,
                  long long per_image, int vec) {
  const T* xi = x + static_cast<long long>(blockIdx.y) * per_image;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS +
                          threadIdx.x;
  unsigned m = 0;
  if (vec) {  // the image is 16-byte aligned and a whole number of vectors
    constexpr int PER = 16 / sizeof(T);
    const uint4* xv = reinterpret_cast<const uint4*>(xi);
    const long long nv = per_image / PER;
    long long i = first;
    for (; i + 3 * stride < nv; i += 4 * stride) {  // 4 loads in flight
      const uint4 a = __ldg(xv + i), b = __ldg(xv + i + stride),
                  c = __ldg(xv + i + 2 * stride),
                  d = __ldg(xv + i + 3 * stride);
      m = max(max(m, max(vec_max<T>(a), vec_max<T>(b))),
              max(vec_max<T>(c), vec_max<T>(d)));
    }
    for (; i < nv; i += stride) m = max(m, vec_max<T>(__ldg(xv + i)));
  } else {
    for (long long i = first; i < per_image; i += stride)
      m = max(m, abs_bits(to_f32(xi[i])));
  }
  m = block_max(m);
  if (threadIdx.x == 0) parts[blockIdx.y * MAX_PARTS + blockIdx.x] = m;
}

// 4 consecutive pixels of one channel as floats (a vector load where
// `vec4`: the pixel count a multiple of 4 and the input 16-byte aligned)
__device__ __forceinline__ void load4(const float* src, bool vec4, int left,
                                      float (&v)[4]) {
  if (vec4) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < left ? src[e] : 0.f;
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* src, bool vec4,
                                      int left, float (&v)[4]) {
  if (vec4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __bfloat162float(e[k]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < left ? __bfloat162float(src[e]) : 0.f;
  }
}

// grid (pixel tiles, N, channel tiles of the padded count): the codes of a
// 64 x 64 tile, NCHW in, NHWC out; the last channel tiles first (the tail
// of each image, which the absmax pass read last, is still in L2), and the
// block of an image's first tiles writes sx[n]
template <typename T>
__global__ void __launch_bounds__(THREADS)
    quantize_codes(const T* __restrict__ x, const unsigned* __restrict__ parts,
                   int n_parts, float* __restrict__ sx,
                   int8_t* __restrict__ q, int c_in, int pixels, int cinp,
                   int vec4) {
  __shared__ __align__(16) int8_t tile[TP * TSTRIDE];
  const int n = blockIdx.y, p0 = blockIdx.x * TP;
  const int c0 = (gridDim.z - 1 - blockIdx.z) * TC;
  unsigned bits = threadIdx.x < n_parts ? parts[n * MAX_PARTS + threadIdx.x]
                                        : 0u;
  const float a = __uint_as_float(block_max(bits));
  // max(a, 1e-8) / 127 as PyTorch's clamp_min and true division give it
  // (a NaN stays NaN)
  const float s = __fdiv_rn(a != a ? a : fmaxf(a, 1e-8f), 127.0f);
  if (blockIdx.x == 0 && c0 == 0 && threadIdx.x == 0) sx[n] = s;
  // 4 pixels of a channel a thread and step: pixel group t % 16, channel
  // t / 16 + 16 j
  const int pg = threadIdx.x & 15, cl0 = threadIdx.x >> 4;
  const int p = p0 + 4 * pg;
#pragma unroll
  for (int j = 0; j < TC / 16; ++j) {
    const int cl = cl0 + 16 * j, c = c0 + cl;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (c < c_in && p < pixels)
      load4(x + (static_cast<long long>(n) * c_in + c) * pixels + p,
            vec4 != 0, pixels - p, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int code = 0;
      if (c < c_in && p + e < pixels) {
        const float r = rintf(__fdiv_rn(v[e], s));
        code = static_cast<int>(fminf(fmaxf(r, -127.f), 127.f));
      }
      tile[(4 * pg + e) * TSTRIDE + cl] = static_cast<int8_t>(code);
    }
  }
  __syncthreads();
  // 16 channels of one pixel a thread
  const int wp = threadIdx.x >> 2, piece = threadIdx.x & 3;
  const int pw = p0 + wp, cw = c0 + piece * 16;
  if (pw < pixels && cw < cinp) {
    const unsigned* src =
        reinterpret_cast<const unsigned*>(tile + wp * TSTRIDE + piece * 16);
    *reinterpret_cast<uint4*>(
        q + (static_cast<long long>(n) * pixels + pw) * cinp + cw) =
        make_uint4(src[0], src[1], src[2], src[3]);
  }
}

template <typename T>
int launch(const T* x, unsigned* parts, float* sx, int8_t* q, int n, int c,
           int pixels, int cinp, cudaStream_t s) {
  const long long per_image = static_cast<long long>(c) * pixels;
  constexpr int PER = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec = per_image % PER == 0 && aligned;
  const long long items = vec ? per_image / PER : per_image;
  // about 8 items a thread, at most MAX_PARTS blocks an image and ~8 an SM
  long long bx = (items + THREADS * 8 - 1) / (THREADS * 8);
  long long cap = (132 * 8 + n - 1) / n;
  cap = cap < MAX_PARTS ? cap : MAX_PARTS;
  bx = bx < 1 ? 1 : (bx > cap ? cap : bx);
  quantize_amax<T><<<dim3(static_cast<unsigned>(bx), n), THREADS, 0, s>>>(
      x, parts, per_image, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((pixels + TP - 1) / TP, n, (cinp + TC - 1) / TC);
  const int vec4 = pixels % 4 == 0 && aligned;
  quantize_codes<T><<<grid, THREADS, 0, s>>>(
      x, parts, static_cast<int>(bx), sx, q, c, pixels, cinp, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Two launches: the codes of `x` (NCHW, n x c x pixels, bf16 if `x_bf16`
// else f32) into `q` (int8 NHWC, n x pixels x cinp, cinp >= c a multiple of
// 16, the padding zero) and the scales into `sx` (f32, n); `parts` (n x 64
// words) is scratch.  Returns the first CUDA error (0 on success;
// cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int panodepth_quantize_nhwc(const void* x, int x_bf16,
                                       unsigned* parts, float* sx, void* q,
                                       int n, int c, int pixels, int cinp,
                                       void* stream) {
  if (n <= 0 || n > 65535 || c <= 0 || pixels <= 0 || cinp < c ||
      cinp % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
      (cinp + TC - 1) / TC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* qi = static_cast<int8_t*>(q);
  return x_bf16 ? launch(static_cast<const __nv_bfloat16*>(x), parts, sx, qi,
                         n, c, pixels, cinp, s)
                : launch(static_cast<const float*>(x), parts, sx, qi, n, c,
                         pixels, cinp, s);
}

// The scratch words a call takes an image.
extern "C" int panodepth_quantize_parts() { return MAX_PARTS; }

extern "C" const char* panodepth_quantize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
