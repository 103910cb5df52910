// int8 convolution with exact int32 sums for Hopper (sm_90a): an implicit
// GEMM on the int8 tensor cores with the int8 graph's scaling epilogue.
//
// Not the port of a TPU kernel.  The JAX package's int8 perspective graph
// (panodepth/models/perspective.py::QConv, :56-77) leaves this conv to XLA:
//
//   y = lax.conv_general_dilated(xq, wq, strides, "SAME", NHWC/HWIO,
//                                preferred_element_type=int32)    (:68-71)
//   y = (f32(y) * (sx * scale)).astype(dtype) + bias.astype(dtype) (:72-76)
//
// with xq the per-image int8 codes of the activation (scale sx[n]) and wq
// the per-output-channel int8 codes of the weights (scale[c]).  PyTorch has
// no conv that computes it on the card (F.conv2d takes no int8), so the
// port computes both lines here (kernels/qconv.py; its plain twin is
// F.conv2d in float64 on the same integers, exact far below 2^53):
//
//   acc[n, c, p] = sum over (r, s, ci) of xq[n, ih, iw, ci] * wq[c, r, s, ci]
//                  (zero where lax's SAME pad falls; |acc| <= 9*512*127^2
//                   ~ 7.4e7 < 2^31 at the GN perspective net's widths, so
//                   int32 is exact and the order of the sum does not matter)
//   out[n, c, p] = dtype(f32(acc) * (sx[n] * scale[c]))       (rn, no FMA)
//   out[n, c, p] = dtype(f32(out) + f32(dtype(bias[c])))      (with a bias)
//
// written NCHW, the layout the next GroupNorm kernel reads.  Every f32
// step is a round-to-nearest intrinsic and the library is built with
// -fmad=false, so the output is bit-equal to the twin's PyTorch epilogue.
//
// The GEMM: M = N*Ho*Wo output pixels, N = Cout, K = kh*kw*Cinp, with the
// input int8 NHWC and its channels padded to Cinp (a multiple of 16: the
// stem's 3 become 16), so that each 16-byte piece of a row of A is one
// tap's channels, and the weights (Cout, Kp) int8, K ordered (r, s, ci) and
// zero-padded to Kp (a multiple of BK); both made by kernels/qconv.py.  A
// block computes a 128 x 64 tile of the output in 4 warps (64 x 32 each:
// 4 x 4 mma.sync.m16n8k32 tiles, 64 int32 accumulators a thread).  A and B
// go through shared memory in 64-deep K tiles, 3 in flight with cp.async;
// A is gathered from the input as it is copied (an implicit im2col: a
// 16-byte piece outside the image or beyond K is zero-filled, nothing is
// written to device memory but the output).  Rows of the shared tiles are
// 80 bytes apart, so the 32-bit fragment loads of a warp hit 32 banks.
//
// What bounds it on an H100 SXM: operations and bytes alike, at the sizes
// the net runs.  The GN perspective net's 39 int8 convs take 14.8 G
// multiply-adds a 256x256 view; at the int8 dense peak of 1,979 TOP/s one
// 15-view forward is bound at 0.22 ms, and its codes in (0.28 GB) and
// bf16 outputs (0.46 GB) at 3.35 TB/s at 0.22 ms too.
// mma.sync reaches a fraction of that peak (wgmma, fed by TMA, reaches the
// rest); the stem's 3 of 16 channels and the 32- and 64-wide layers'
// half-empty 64-wide tiles waste part of it.  This is the simple, exact
// first kernel: wgmma, TMA and fusing the activation's quantization pass
// (an absmax reduce and a rounding pass in PyTorch, ahead of each conv) are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels a block
constexpr int BN = 64;       // output channels a block
constexpr int BK = 64;       // K bytes a stage
constexpr int STAGES = 3;    // K tiles in flight
constexpr int THREADS = 128; // 4 warps: 2 along M x 2 along N
constexpr int LDS = BK + 16; // shared row stride in bytes (conflict-free)

struct Conv {
  int n, h, w, cinp;     // input NHWC, channels padded to a multiple of 16
  int cout, kw, kp;      // weights (cout, kp); kernel width
  int sh, sw, pt, pl;    // strides, and the pads before each axis
  int ho, wo;            // output size
  int ktaps;             // kh * kw * cinp: the real part of K
  int m;                 // n * ho * wo
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 zero-fills without reading
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(float* y, float v, const float* bias,
                                          int c) {
  *y = bias ? __fadd_rn(v, bias[c]) : v;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* y, float v,
                                          const float* bias, int c) {
  __nv_bfloat16 q = __float2bfloat16_rn(v);
  if (bias)
    q = __float2bfloat16_rn(__fadd_rn(
        __bfloat162float(q), __bfloat162float(__float2bfloat16_rn(bias[c]))));
  *y = q;
}

template <typename Tout>
__global__ void __launch_bounds__(THREADS)
    qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ sx, const float* __restrict__ scale,
                 const float* __restrict__ bias, Tout* __restrict__ y,
                 int* __restrict__ acc_out, const Conv p) {
  __shared__ __align__(16) int8_t As[STAGES][BM][LDS];
  __shared__ __align__(16) int8_t Bs[STAGES][BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;      // mma fragment coordinates
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int bm = blockIdx.x * BM, bn = blockIdx.y * BN;

  // the copies: a thread moves 16-byte piece `piece` of rows
  // tid/4 + 32*i, four rows of A and two of B a K tile
  const int piece = tid & 3, row0 = tid >> 2;
  long long a_base[4];
  int a_ih[4], a_iw[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = bm + row0 + 32 * i;
    a_ok[i] = m < p.m;
    const int mm = a_ok[i] ? m : 0;
    const int img = mm / (p.ho * p.wo), pix = mm - img * (p.ho * p.wo);
    const int oh = pix / p.wo, ow = pix - oh * p.wo;
    a_base[i] = static_cast<long long>(img) * p.h * p.w * p.cinp;
    a_ih[i] = oh * p.sh - p.pt;
    a_iw[i] = ow * p.sw - p.pl;
  }

  auto load_tile = [&](int stage, int ktile) {
    const int kg = ktile * BK + piece * 16;
    const bool k_ok = kg < p.ktaps;
    const int tap = kg / p.cinp, ci = kg - tap * p.cinp;
    const int r = tap / p.kw, s = tap - r * p.kw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = a_ih[i] + r, iw = a_iw[i] + s;
      const bool ok = k_ok && a_ok[i] && ih >= 0 && ih < p.h && iw >= 0 &&
                      iw < p.w;
      const int8_t* src =
          ok ? x + a_base[i] + (static_cast<long long>(ih) * p.w + iw) * p.cinp +
                   ci
             : x;
      cp_async16(smem_addr(&As[stage][row0 + 32 * i][piece * 16]), src,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = bn + row0 + 32 * i;
      const bool ok = c < p.cout;
      const int8_t* src =
          ok ? wq + static_cast<long long>(c) * p.kp + ktile * BK + piece * 16
             : wq;
      cp_async16(smem_addr(&Bs[stage][row0 + 32 * i][piece * 16]), src,
                 ok ? 16 : 0);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = p.kp / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();              // ... every thread's; stage kt-1 is free
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_tile(next % STAGES, next);
    cp_async_commit();
    const int st = kt % STAGES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* q = &As[st][wm + i * 16 + g][ks + 4 * t];
        a[i][0] = *reinterpret_cast<const unsigned*>(q);
        a[i][1] = *reinterpret_cast<const unsigned*>(q + 8 * LDS);
        a[i][2] = *reinterpret_cast<const unsigned*>(q + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(q + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* q = &Bs[st][wn + j * 8 + g][ks + 4 * t];
        b[j][0] = *reinterpret_cast<const unsigned*>(q);
        b[j][1] = *reinterpret_cast<const unsigned*>(q + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // the epilogue: accumulator e of tile (i, j) is row g + 8*(e/2), column
  // 2t + e%2 of that tile
  const int hw = p.ho * p.wo;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = bm + wm + i * 16 + g + 8 * half;
      if (m >= p.m) continue;
      const int img = m / hw, pix = m - img * hw;
      const float s_img = sx[img];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = bn + wn + j * 8 + 2 * t + e;
          if (c >= p.cout) continue;
          const int v = acc[i][j][2 * half + e];
          const long long o =
              (static_cast<long long>(img) * p.cout + c) * hw + pix;
          if (acc_out) acc_out[o] = v;
          if (y)
            store_out(y + o,
                      __fmul_rn(__int2float_rn(v), __fmul_rn(s_img, scale[c])),
                      bias, c);
        }
      }
    }
  }
}

}  // namespace

// One launch: the int8 conv of `x` (int8 NHWC, n x h x w x cinp) with `w`
// (int8, cout x kp, K ordered (r, s, ci)), stride (sh, sw), pads before
// (pt, pl), output ho x wo, into `y` (NCHW, bf16 if `y_bf16` else f32,
// scaled by sx[n] * scale[c], plus bias[c] unless `bias` is null) and/or
// `acc` (NCHW int32 sums); either output may be null.  Returns the first
// CUDA error (0 on success; cudaErrorInvalidValue for a shape the kernel
// does not take).
extern "C" int panodepth_qconv(const void* x, const void* w, const float* sx,
                               const float* scale, const float* bias, void* y,
                               int y_bf16, int* acc, int n, int h, int wd,
                               int cinp, int cout, int kh, int kw, int kp,
                               int sh, int sw, int pt, int pl, int ho, int wo,
                               void* stream) {
  const long long m = static_cast<long long>(n) * ho * wo;
  if (cinp % 16 || kp % BK || kp < kh * kw * cinp || m <= 0 ||
      m >= (1LL << 31) || cout <= 0 || (!y && !acc))
    return static_cast<int>(cudaErrorInvalidValue);
  Conv p{n, h, wd, cinp, cout, kw, kp, sh, sw, pt, pl, ho, wo, kh * kw * cinp,
         static_cast<int>(m)};
  dim3 grid(static_cast<unsigned>((m + BM - 1) / BM), (cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  if (y_bf16)
    qconv_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        xi, wi, sx, scale, bias, static_cast<__nv_bfloat16*>(y), acc, p);
  else
    qconv_kernel<float><<<grid, THREADS, 0, s>>>(
        xi, wi, sx, scale, bias, static_cast<float*>(y), acc, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* panodepth_qconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
