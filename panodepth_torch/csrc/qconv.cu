// int8 convolution with exact int32 sums for Hopper (sm_90a): an implicit
// GEMM on the int8 tensor cores through wgmma, with the int8 graph's scaling
// epilogue.
//
// Not the port of a TPU kernel.  The JAX package's int8 perspective graph
// (panodepth/models/perspective.py::QConv, :56-77) leaves this conv to XLA:
//
//   y = lax.conv_general_dilated(xq, wq, strides, "SAME", NHWC/HWIO,
//                                preferred_element_type=int32)    (:68-71)
//   y = (f32(y) * (sx * scale)).astype(dtype) + bias.astype(dtype) (:72-76)
//
// with xq the per-image int8 codes of the activation (scale sx[n]; made by
// csrc/quantize.cu) and wq the per-output-channel int8 codes of the weights
// (scale[c]).  PyTorch has no conv that computes it on the card (F.conv2d
// takes no int8), so the port computes both lines here (kernels/qconv.py;
// its plain twin is F.conv2d in float64 on the same integers, exact far
// below 2^53):
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
// zero-padded to Kp (a multiple of 64); both K-major, as 8-bit wgmma wants.
// A block of 256 threads (two warpgroups) computes a 128 x BN tile of the
// output (BN = 32, 64 or 128: the plan's, kernels/qconv.py::qconv_plan),
// each warpgroup 64 rows with wgmma.m64nBNk32 and its sums in registers.  K
// goes through shared memory in 128-byte tiles, `stages` of them in a ring,
// each stored with the 128-byte swizzle that the wgmma descriptors read:
//
//   B, the weights: one TMA load a tile (a 2-D tensor map over (Cout, Kp),
//     128-byte swizzle, zero fill past Cout and Kp), issued by one thread
//     and awaited on the stage's mbarrier;
//   A, the implicit im2col: every thread gathers four 16-byte pieces a tile
//     with cp.async (L1-allocating: the 3x3 taps reread the same input)
//     into the swizzled layout, zero-filled where lax's pad falls or past K,
//     its tap and channel advanced a tile without a division; a thread
//     waits for its own group, fences it for the async proxy, and the
//     block's barrier publishes the tile.  (A by TMA in im2col mode, a
//     load a tap, was exact too, but only where Cinp >= 64 (the stem and
//     the 32-wide layers kept the gather), and it was slower: the 39 convs
//     of a forward took 1.50-1.52 ms against the gather's 1.40; PERF.md.)
//
// Loads run stages - 2 tiles ahead of the tile in the tensor cores, and one
// wgmma group stays in flight while the next is issued.  The ring is sized
// for two blocks an SM (at most 128 registers a thread), so that one
// block's epilogue overlaps the other's main loop.  Where the tiles number
// fewer than the SMs (the 16x16 and 8x8 layers), the plan splits K: each
// split writes its int32 partial sums to a workspace and the last block of
// a tile to arrive (a counter per tile, zeroed by a memset in the same
// stream) adds the others' and runs the epilogue; int32 sums commute, so
// the result is the same bits whatever the order.  The epilogue stages the
// sums through shared memory, channel-major, so that each thread stores 16
// bytes of consecutive pixels of one channel of the NCHW output.
//
// What bounds it on an H100 SXM: the work is bound by operations and bytes
// alike.  The GN perspective net's 39 int8 convs take 14.8 G multiply-adds
// a 256x256 view; at the int8 dense peak of 1,979 TOP/s one 15-view forward
// is bound at 0.22 ms, and its codes in (0.28 GB) and bf16 outputs (0.46
// GB) at 3.35 TB/s at 0.22 ms too.  What holds this kernel at ~6x that is
// latency, not the tensor cores: with its parts switched off one at a time
// (scripts/qconv_probe.py) the wgmma's and B's TMA loads cost least, while
// the block's per-tile waits and barriers with no data at all cost most,
// then the output stores and the gather of A.  The next step is a producer
// warp whose copies arrive on the ring's mbarriers (no block barrier a K
// tile) and a persistent block whose epilogue overlaps the next tile's
// loads.  (A persistent, warp-specialized form, a form that reads each
// input byte once from a shared-memory window of the tile's rows, and
// 64-byte K tiles with deeper rings were all exact and slower at these
// shapes; PERF.md has their numbers.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"  // mbarriers, TMA loads, cuTensorMapEncodeTiled

namespace {

constexpr int BM = 128;       // output pixels a block
constexpr int BK = 128;       // K bytes a stage (one 128-byte swizzle row)
constexpr int THREADS = 256;  // two warpgroups, 64 rows of the tile each
constexpr int MAX_STAGES = 8;
constexpr int STG = BM + 4;   // staging row (a channel), in int32

struct Conv {
  int n, h, w, cinp;     // input NHWC, channels padded to a multiple of 16
  int cout, kw;          // output channels; kernel width
  int sh, sw, pt, pl;    // strides, and the pads before each axis
  int ho, wo;            // output size
  int ktaps;             // kh * kw * cinp: the real part of K
  int m;                 // n * ho * wo
  int ktiles;            // ceil(ktaps / BK)
  int stages, splits;    // the plan's ring depth and split of K
};

// 16 bytes global -> shared through L1; `bytes` 0 zero-fills without reading
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most `n` of this thread's groups are pending (n < 6)
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    default: cp_async_wait<5>(); break;
  }
}

// this thread's shared-memory writes, made visible to the async proxy
// (wgmma reads its operands through it)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the wgmma descriptor of a K-major tile with 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (the tile 1024-byte aligned; a step
// of 32 bytes along K moves the start address)
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // LBO (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // SBO
         (static_cast<uint64_t>(1) << 62);             // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of the sums across wgmma's
template <int R>
__device__ __forceinline__ void fence_sums(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= a * b for a 64 x 64 tile, K = 32 (both operands K-major in shared
// memory, read through their descriptors); 32 int32 sums a thread
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (+)= a * b for a 64 x 128 tile, K = 32 (both operands K-major in shared
// memory, read through their descriptors); 64 int32 sums a thread
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (+)= a * b for a 64 x 32 tile, K = 32 (both operands K-major in shared
// memory, read through their descriptors); 16 int32 sums a thread
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t a,
                                           uint64_t b) {
  if constexpr (BN == 32)
    wgmma_n32(d, a, b);
  else if constexpr (BN == 64)
    wgmma_n64(d, a, b);
  else
    wgmma_n128(d, a, b);
}

__device__ __forceinline__ void store8(float* y, const float (&v)[8]) {
  reinterpret_cast<float4*>(y)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(y)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* y, const float (&v)[8]) {
  uint4 u;
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * e]));
    const unsigned hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * e + 1]));
    w[e] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(y) = u;
}

__device__ __forceinline__ void store1(float* y, float v) { *y = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}

// the scaled output before its final rounding: f32(acc) * mul, plus the
// bias; for bf16 the product is rounded to bf16 first and the bias, itself
// rounded to bf16, added in f32 (the caller rounds the sum to bf16)
template <typename Tout>
__device__ __forceinline__ float scaled(int v, float mul, const float* bias,
                                        float b) {
  const float s = __fmul_rn(__int2float_rn(v), mul);
  if constexpr (sizeof(Tout) == 4) {
    return bias ? __fadd_rn(s, b) : s;
  } else {
    return bias ? __fadd_rn(__bfloat162float(__float2bfloat16_rn(s)), b) : s;
  }
}

// The epilogue of a 128 x BN tile: the sums -> shared memory `stg`,
// channel-major (sum i of thread t is row 64*wg + 16*warp + lane/4 +
// 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2 of the tile), then 8
// pixels of one channel a step, stored 16 bytes at a time along the NCHW
// output's pixels.  A thread's 8 pixels are the same in every channel it
// stores (THREADS is a multiple of BM / 8), so its image and offset are
// found once.  The caller has synchronised the block after the last read
// of the memory behind `stg`.
template <int BN, typename Tout>
__device__ __forceinline__ void store_tile(
    const int (&acc)[BN / 2], int* stg, const Conv& p, int bm, int bn,
    const float* __restrict__ sx, const float* __restrict__ scale,
    const float* __restrict__ bias, Tout* __restrict__ y,
    int* __restrict__ acc_out, int tid) {
  const int lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int row = 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    stg[col * STG + row + 8 * ((i >> 1) & 1)] = acc[i];
  }
  __syncthreads();
  const int hw = p.ho * p.wo;
  const int m0 = bm + (tid % (BM / 8)) * 8;
  if (m0 >= p.m) return;
  // 8 pixels of one image, 16-byte aligned in the output
  const bool whole = hw % 8 == 0 && m0 + 8 <= p.m;
  const int img = m0 / hw, pix = m0 - img * hw;
  const float s_img = sx[img];
  for (int cl = tid / (BM / 8); cl < BN; cl += THREADS / (BM / 8)) {
    const int c = bn + cl;
    if (c >= p.cout) break;
    const int4* src =
        reinterpret_cast<const int4*>(stg + cl * STG + (m0 - bm));
    const int4 u0 = src[0], u1 = src[1];
    const int v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    const float sc = scale[c];
    // the bias as it is added: f32, or rounded to bf16 first for bf16
    const float bb = !bias ? 0.f
                     : sizeof(Tout) == 4
                         ? bias[c]
                         : __bfloat162float(__float2bfloat16_rn(bias[c]));
    if (whole) {
      const float mul = __fmul_rn(s_img, sc);
      const long long o =
          (static_cast<long long>(img) * p.cout + c) * hw + pix;
      if (y) {
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = scaled<Tout>(v[e], mul, bias, bb);
        store8(y + o, f);
      }
      if (acc_out) {
        reinterpret_cast<int4*>(acc_out + o)[0] = u0;
        reinterpret_cast<int4*>(acc_out + o)[1] = u1;
      }
    } else {
      for (int e = 0; e < 8 && m0 + e < p.m; ++e) {
        const int m = m0 + e, im = m / hw, px = m - im * hw;
        const long long o =
            (static_cast<long long>(im) * p.cout + c) * hw + px;
        if (y)
          store1(y + o, scaled<Tout>(v[e], __fmul_rn(sx[im], sc), bias, bb));
        if (acc_out) acc_out[o] = v[e];
      }
    }
  }
}

template <int BN, typename Tout>
__global__ void __launch_bounds__(THREADS, 2)
    qconv_kernel(const __grid_constant__ CUtensorMap wmap,
                 const int8_t* __restrict__ x, const float* __restrict__ sx,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, Tout* __restrict__ y,
                 int* __restrict__ acc_out, int* __restrict__ ws,
                 const Conv p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES];
  __shared__ int s_last;

  // the ring, 1024-byte aligned (the swizzle's period): A stages, B stages
  const unsigned raw = smem_addr(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const unsigned a_ring = base;
  const unsigned b_ring = base + p.stages * BM * BK;
  const unsigned bar0 = smem_addr(&full_bar[0]);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int bm = blockIdx.x * BM, bn = blockIdx.y * BN;
  const int per = (p.ktiles + p.splits - 1) / p.splits;
  const int k0 = blockIdx.z * per;
  const int nk = max(0, min(p.ktiles, k0 + per) - k0);
  const int S = p.stages, D = p.stages - 2;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the gather of A: this thread moves 16-byte piece `piece` of rows
  // row0 + 32*i, i < 4; all four rows share one swizzle phase.  Each row's
  // offset in x at tap (0, 0) is kept, and the tap (r, s) and channel ci
  // of this thread's piece advance by BK bytes a tile without a division
  // (x has fewer than 2^31 bytes: int offsets)
  const int piece = tid & 7, row0 = tid >> 3;
  const unsigned a_off = row0 * BK + ((piece ^ (row0 & 7)) << 4);
  int a_row[4], a_ih[4], a_iw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = bm + row0 + 32 * i;
    const int mm = m < p.m ? m : 0;
    const int img = mm / (p.ho * p.wo), pix = mm - img * (p.ho * p.wo);
    const int oh = pix / p.wo, ow = pix - oh * p.wo;
    // a row past M reads nothing: its ih fails every bounds test
    a_ih[i] = m < p.m ? oh * p.sh - p.pt : -(1 << 29);
    a_iw[i] = ow * p.sw - p.pl;
    a_row[i] = m < p.m ? ((img * p.h + a_ih[i]) * p.w + a_iw[i]) * p.cinp
                       : 0;
  }
  int kg = k0 * BK + piece * 16;  // this piece's K byte, tap (r, s), ci
  int r = kg / p.cinp / p.kw, s = kg / p.cinp - r * p.kw;
  int ci = kg - (kg / p.cinp) * p.cinp;

  auto load_tile = [&](int t) {  // local K tile t into stage t % S (in order)
    const int stage = t % S, kt = k0 + t;
    if (tid == 0) {
      mbar_expect_tx(bar0 + 8 * stage, BN * BK);
      tma_load_2d(b_ring + stage * BN * BK, &wmap, bar0 + 8 * stage, kt * BK,
                  bn);
    }
    const bool k_ok = kg < p.ktaps;
    const int off = (r * p.w + s) * p.cinp + ci;
    const unsigned dst = a_ring + stage * BM * BK + a_off;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = k_ok &&
                      static_cast<unsigned>(a_ih[i] + r) <
                          static_cast<unsigned>(p.h) &&
                      static_cast<unsigned>(a_iw[i] + s) <
                          static_cast<unsigned>(p.w);
      cp_async16(dst + i * 32 * BK, ok ? x + a_row[i] + off : x,
                 ok ? 16 : 0);
    }
    kg += BK;
    for (ci += BK; ci >= p.cinp; ci -= p.cinp)
      if (++s == p.kw) s = 0, ++r;
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  for (int t = 0; t < D; ++t) {
    if (t < nk) load_tile(t);
    cp_async_commit();
  }
  fence_sums(acc);
  for (int t = 0; t < nk; ++t) {
    // (the sums are not touched between wgmma's: ptxas would wait for the
    // group in flight there)
    cp_async_wait_dyn(D - 1);  // this thread's pieces of tile t landed
    fence_proxy_async();
    wgmma_wait<1>();           // this warpgroup's wgmma of tile t-2 done
    __syncthreads();           // ... every thread's: tile t is whole and
                               // stage (t-2) % S is free
    if (t + D < nk) load_tile(t + D);
    cp_async_commit();
    const int st = t % S;
    mbar_wait(bar0 + 8 * st, (t / S) & 1);  // B of tile t landed
    __syncwarp();
    const unsigned a_st = a_ring + st * BM * BK + wg * 64 * BK;
    const unsigned b_st = b_ring + st * BN * BK;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 32; ++k)
      wgmma_tile<BN>(acc, sw128_desc(a_st + 32 * k),
                     sw128_desc(b_st + 32 * k));
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_sums(acc);
  cp_async_wait<0>();

  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (p.splits > 1) {
    // split K: write this split's sums, count the tile's arrivals; the last
    // block adds the others' (coalesced: sum i of thread t at i*256 + t)
    const int tiles = gridDim.x * gridDim.y;
    int* parts = ws + ((tiles + 3) & ~3);
    int* mine = parts + (static_cast<long long>(tile) * p.splits +
                         blockIdx.z) * (BM * BN);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) mine[i * THREADS + tid] = acc[i];
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&ws[tile], 1) == p.splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int z = 0; z < p.splits; ++z) {
      if (z == static_cast<int>(blockIdx.z)) continue;
      const int* other =
          parts + (static_cast<long long>(tile) * p.splits + z) * (BM * BN);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += __ldcg(other + i * THREADS + tid);
    }
  }

  __syncthreads();  // every warpgroup's wgmma has read the ring
  store_tile<BN>(acc, reinterpret_cast<int*>(smem), p, bm, bn, sx, scale,
                 bias, y, acc_out, tid);
}

template <int BN, typename Tout>
int launch(const CUtensorMap& map, const int8_t* x, const float* sx,
           const float* scale, const float* bias, Tout* y, int* acc, int* ws,
           const Conv& p, size_t smem, cudaStream_t s) {
  auto kernel = qconv_kernel<BN, Tout>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.m + BM - 1) / BM),
                  (p.cout + BN - 1) / BN, p.splits);
  kernel<<<grid, THREADS, smem, s>>>(map, x, sx, scale, bias, y, acc, ws, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tout>
int launch_bn(int bn, const CUtensorMap& map, const int8_t* x,
              const float* sx, const float* scale, const float* bias,
              Tout* y, int* acc, int* ws, const Conv& p, size_t smem,
              cudaStream_t s) {
  if (bn == 32)
    return launch<32>(map, x, sx, scale, bias, y, acc, ws, p, smem, s);
  if (bn == 64)
    return launch<64>(map, x, sx, scale, bias, y, acc, ws, p, smem, s);
  return launch<128>(map, x, sx, scale, bias, y, acc, ws, p, smem, s);
}

}  // namespace

// One launch of the plan (bn, stages, splits, smem): the int8 conv of `x`
// (int8 NHWC, n x h x w x cinp) with `w` (int8, cout x kp, K ordered
// (r, s, ci)), stride (sh, sw), pads before (pt, pl), output ho x wo, into
// `y` (NCHW, bf16 if `y_bf16` else f32, scaled by sx[n] * scale[c], plus
// bias[c] unless `bias` is null) and/or `acc` (NCHW int32 sums); either
// output may be null.  With splits > 1, `ws` is the workspace (int32: a
// counter per tile rounded up to 4, then splits x 128 x bn sums per tile),
// whose counters this call zeroes.  `smem` is the plan's dynamic shared
// memory (kernels/qconv.py::smem_bytes: 1024 bytes of alignment, then the
// ring of A and B tiles or the epilogue's staging, whichever is larger);
// the runtime refuses more than the card gives a block.  Returns the first
// CUDA error (0 on success; cudaErrorInvalidValue for arguments the kernel
// does not take).
extern "C" int panodepth_qconv(const void* x, const void* w, const float* sx,
                               const float* scale, const float* bias, void* y,
                               int y_bf16, int* acc, void* ws, int n, int h,
                               int wd, int cinp, int cout, int kh, int kw,
                               int kp, int sh, int sw, int pt, int pl, int ho,
                               int wo, int bn, int stages, int splits,
                               int smem, void* stream) {
  const long long m = static_cast<long long>(n) * ho * wo;
  const long long ktaps = static_cast<long long>(kh) * kw * cinp;
  if (cinp % 16 || kp % 16 || kp < ktaps || m <= 0 || m >= (1LL << 31) ||
      static_cast<long long>(n) * h * wd * cinp >= (1LL << 31) ||
      cout <= 0 || (!y && !acc) || (bn != 32 && bn != 64 && bn != 128) ||
      stages < 3 || stages > MAX_STAGES || splits < 1 || smem <= 0 ||
      (splits > 1 && !ws) || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ktiles = static_cast<int>((ktaps + BK - 1) / BK);
  if (splits > ktiles) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorInitializationError);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(bn)};
  const cuuint32_t estrides[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w),
             dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  Conv p{n, h, wd, cinp, cout, kw, sh, sw, pt, pl, ho, wo,
         static_cast<int>(ktaps), static_cast<int>(m), ktiles, stages,
         splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* wsi = static_cast<int*>(ws);
  if (splits > 1) {
    const long long tiles = ((m + BM - 1) / BM) * ((cout + bn - 1) / bn);
    cudaError_t err = cudaMemsetAsync(wsi, 0, tiles * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int8_t* xi = static_cast<const int8_t*>(x);
  if (y_bf16)
    return launch_bn(bn, map, xi, sx, scale, bias,
                     static_cast<__nv_bfloat16*>(y), acc, wsi, p,
                     static_cast<size_t>(smem), s);
  return launch_bn(bn, map, xi, sx, scale, bias, static_cast<float*>(y), acc,
                   wsi, p, static_cast<size_t>(smem), s);
}

extern "C" const char* panodepth_qconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
