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
// put it: a code that crosses a tie moves a whole step.  The absmax is the
// max of |x|'s float bits (nonnegative floats order as their bits; a NaN's
// absolute value orders above +inf, so a NaN propagates as in torch.amax),
// and a NaN scale gives the code -127 (fmaxf(NaN, -127)).
//
// What bounds it on an H100 SXM: bytes.  It must read each input element
// once and write one byte a padded channel; the GN perspective net's 39
// inputs of a 15-view forward (1.19 GB, mostly f32) are bound near
// 0.36 ms at 3.35 TB/s.  The sums are small (a max, a product and a few
// adds an element), but they sit on the path between an image's loads and
// its codes, which is what holds the kernel (PERF.md; scripts/
// quantize_probe.py switches its parts off one at a time).
//
// One launch a call, each input byte read once from device memory.  The
// codes of an image need the absmax of the whole image, so an image's
// slice stays in shared memory from its absmax to its codes:
//
// - The plan (kernels/qconv.py::quantize_plan, plain Python the CPU tests
//   check) cuts each image into tiles of `tc` channels (all of them, or a
//   multiple of 32) by `nb` boxes of `bw` pixels, and gives each block of
//   a persistent grid one slice of `k` tiles of one image a wave, `ipw`
//   images a wave; `spi` blocks an image, the grid ipw * spi.
// - Three shared-memory stages.  Warp 0 starts an item's TMA loads (3-D
//   boxes over the (N, C, H*W) view: a box never reaches into another
//   image, and what lies past C or H*W arrives as zeros) two items ahead.
// - A block takes the absmax of item j + 1 from shared memory and
//   publishes it (one atomicMax on its image's word, a release-ordered
//   arrival on the image's counter) before it waits, with acquire loads,
//   for all `spi` blocks of item j's image: the wait hides under item
//   j - 1's codes and item j + 1's absmax.
// - The codes (round to nearest even of x / sx, clamped): a product by
//   rn(1 / sx) rounded with full-rate adds, exact wherever it is not
//   within 2^-15 of a half-integer; the few codes that are (exact ties, a
//   NaN scale) are redone by the true division.  They go
//   through a padded codes' tile in shared memory, so that both the
//   tile's reads (neighbouring threads on neighbouring pixels) and the
//   NHWC stores (neighbouring threads on neighbouring 16-byte pieces) are
//   without bank conflicts and coalesced.
// - An image larger than the grid's stages (k > 1, e.g. a 512-view's 33.5
//   MB bf16 activation) takes the same loop twice over its slice within
//   the wave: its tiles stream through the stages for the absmax, then
//   again, mostly from L2, for the codes.
// - A row of H*W elements whose bytes are not a multiple of 16, or an input
//   not 16-byte aligned, is refused by TMA: those calls load each tile with
//   plain loads of all threads into the same layout (nb = 1).
//
// What could go wrong, and what is done about it:
// - Co-residency: a wait ends only if every block of the image runs.  The
//   launch is cooperative (cudaLaunchAttributeCooperative, which a CUDA
//   graph captures), so the runtime refuses a grid that cannot be
//   resident at once; the plan sizes the grid to the blocks an SM its
//   shared memory leaves.  A block publishes item j + 1 before it waits
//   on item j, and every item's publication precedes its block's later
//   waits, so no block waits on a block that waits on it.  A wait that
//   never ends (a fault) traps after ~2^34 cycles instead of hanging the
//   card.
// - The words under graph replay: the kernel leaves them zero.  Each block
//   departs (an atomicAdd) after it has read its image's words, and the
//   image's last block to depart zeroes them; the wrapper zeroes the
//   buffer once, outside any capture, and keeps one buffer a device, so
//   calls of one device must not run at once (kernels/qconv.py
//   _image_words orders eager calls on different streams).
// - A wave with fewer than ipw images leaves the rest of the grid idle
//   for it; a block with no slice in a wave skips it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"  // mbarriers, TMA loads, cuTensorMapEncodeTiled

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;    // shared-memory stages a block
constexpr int WORDS = 4;     // an image's words: amax bits, arrivals,
                             // departures, padding
constexpr int ALIGN = 128;   // a stage's and a box's alignment in shared memory
constexpr int MAX_BOX = 256;  // TMA's largest box side

struct Plan {
  int n, c, cinp;   // images, channels, channels padded to 16
  int pixels;       // H * W
  int tc;           // channels a tile (a box's rows): c, or a multiple
                    // of 16 below c
  int tcp;          // tc padded to 16: the channels a tile's codes cover
  int bw, nb;       // a box's width in pixels, the boxes a tile
  int box_bytes;    // a box's bytes in shared memory (ALIGN-padded)
  int stage;        // bytes a stage: nb * box_bytes
  int code_stride;  // bytes a pixel in the codes' tile (padded: no bank
                    // conflicts for 16-byte stores of neighbouring pixels)
  int code_px;      // pixels a round of the codes' tile holds
  int tiles_p;      // tiles along the pixels
  int tiles;        // tiles an image
  int k;            // tiles a slice (k > 1: the L2 path)
  int spi;          // slices (blocks) an image
  int ipw;          // images a wave
  int waves;
};

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// the running max of |x|'s bits over 16 bytes of elements: f32 one word
// an element; bf16 two 16-bit maxima in a word (vmaxu2), widened to float
// bits by max_bits
__device__ __forceinline__ unsigned vec_max(unsigned m, const uint4& u,
                                            float) {
  m = max(max(m, u.x & 0x7FFFFFFFu), u.y & 0x7FFFFFFFu);
  return max(max(m, u.z & 0x7FFFFFFFu), u.w & 0x7FFFFFFFu);
}
__device__ __forceinline__ unsigned vec_max(unsigned m, const uint4& u,
                                            __nv_bfloat16) {
  m = __vmaxu2(__vmaxu2(m, u.x & 0x7FFF7FFFu), u.y & 0x7FFF7FFFu);
  return __vmaxu2(__vmaxu2(m, u.z & 0x7FFF7FFFu), u.w & 0x7FFF7FFFu);
}
__device__ __forceinline__ unsigned max_bits(unsigned m, float) { return m; }
__device__ __forceinline__ unsigned max_bits(unsigned m, __nv_bfloat16) {
  return max(m & 0xFFFFu, m >> 16) << 16;
}

__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// A block's walk over its items: (wave, pass, tile of its slice).  A slice
// of one tile is one item (absmax, wait, codes); a slice of more tiles is
// two passes over them (absmax, then codes).
struct Cursor {
  int wave, pass, tile, ntile, img;
  bool valid;
};

__device__ __forceinline__ void start_wave(Cursor& cur, const Plan& p, int li,
                                           int slice, int wave) {
  cur.wave = wave;
  cur.img = wave * p.ipw + li;
  cur.valid = wave < p.waves && cur.img < p.n;
  cur.pass = cur.tile = 0;
  cur.ntile = min(p.k, p.tiles - slice * p.k);
}

__device__ __forceinline__ void next_item(Cursor& cur, const Plan& p, int li,
                                          int slice) {
  if (++cur.tile < cur.ntile) return;
  cur.tile = 0;
  if (cur.pass == 0 && cur.ntile > 1) {
    cur.pass = 1;
    return;
  }
  start_wave(cur, p, li, slice, cur.wave + 1);
}

// the first channel and pixel of tile `tile` of slice `slice`
__device__ __forceinline__ void origin(const Plan& p, int slice, int tile,
                                       int& c0, int& p0) {
  const int t = slice * p.k + tile;
  const int tc_i = t / p.tiles_p;
  c0 = tc_i * p.tc;
  p0 = (t - tc_i * p.tiles_p) * p.nb * p.bw;
}

// warp 0: the TMA loads of one tile into the stage at `dst`
template <typename T>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          unsigned dst, unsigned bar,
                                          const Plan& p, int slice,
                                          const Cursor& cur, int lane) {
  int c0, p0;
  origin(p, slice, cur.tile, c0, p0);
  if (lane == 0) mbar_expect_tx(bar, p.nb * p.tc * p.bw * sizeof(T));
  __syncwarp();
  for (int b = lane; b < p.nb; b += 32)
    tma_load_3d(dst + b * p.box_bytes, map, bar, p0 + b * p.bw, c0, cur.img);
}

// all threads: one tile by plain loads (nb == 1), zeros past C and H*W
template <typename T>
__device__ __forceinline__ void load_plain(T* tile, const T* __restrict__ x,
                                           const Plan& p, int img, int c0,
                                           int p0) {
  const int total = p.tc * p.bw;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int r = i / p.bw, col = i - r * p.bw;
    const int ch = c0 + r, px = p0 + col;
    tile[i] = ch < p.c && px < p.pixels
                  ? x[(static_cast<long long>(img) * p.c + ch) * p.pixels + px]
                  : zero_of<T>();
  }
}

// this thread's share of max |x| over a tile's channels of this image
template <typename T>
__device__ __forceinline__ unsigned tile_absmax(const uint8_t* stage,
                                                const Plan& p, int c0) {
  constexpr int PER = 16 / sizeof(T);
  const int box_vecs = min(p.tc, p.c - c0) * (p.bw / PER);
  const int stride = p.box_bytes / 16;
  const uint4* s = reinterpret_cast<const uint4*>(stage);
  unsigned m = 0;
  for (int v = threadIdx.x; v < p.nb * box_vecs; v += THREADS) {
    const int b = v / box_vecs;
    m = vec_max(m, s[b * stride + (v - b * box_vecs)], T());
  }
  return max_bits(m, T());
}

// The code of x: rintf(__fdiv_rn(x, s)) clamped to [-127, 127].
__device__ __forceinline__ int exact_code(float x, float s) {
  return static_cast<int>(
      fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f));
}

// The same code by a product: with |x / s| <= 127 (1 + 2^-23), f = x *
// rn(1 / s) lies within 1.5 * 2^-23 * |x / s| < 2.3e-5 of rn(x / s), so
// where f is farther than 2^-15 from every half-integer both round to the
// same integer, which needs no clamp.  f + 1.5 * 2^23 rounds f to an
// integer in the low bits (full-rate adds, no conversion): the low byte
// of its bits is the code (1.5 * 2^23's low byte is 0).  `near` is set
// where f is nearer a half-integer (a tie among them), a NaN or an
// infinity, for exact_code to decide.
__device__ __forceinline__ int fast_code(float x, float rcp, bool& near) {
  constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23
  const float f = __fmul_rn(x, rcp);
  const float y = __fadd_rn(f, MAGIC);
  near = !(fabsf(__fsub_rn(f, __fsub_rn(y, MAGIC))) < 0.5f - 0x1p-15f);
  return __float_as_int(y);
}

// the low bytes of four codes as one word
__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// two neighbouring pixels of one channel as floats
__device__ __forceinline__ void load_pair(const float* v, float& a,
                                          float& b) {
  const float2 u = *reinterpret_cast<const float2*>(v);
  a = u.x, b = u.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* v, float& a,
                                          float& b) {
  const unsigned u = *reinterpret_cast<const unsigned*>(v);
  a = __uint_as_float(u << 16), b = __uint_as_float(u & 0xFFFF0000u);
}

// The codes of 16 channels (rows r0.., those from vr on the padding: 0) of
// two neighbouring pixels at `src` by fast_code, packed four to a word;
// returns the mask of those near a tie: bit 2 r + e for row r0 + r, pixel
// e.
template <typename T>
__device__ __forceinline__ unsigned codes16(const T* src, int bw, int r0,
                                            int vr, float rcp,
                                            unsigned (&lo)[4],
                                            unsigned (&hi)[4]) {
  unsigned mask = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    int a[4], c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 4 * w + e;
      float x0 = 0.f, x1 = 0.f;
      if (r < vr) load_pair(src + r * bw, x0, x1);
      bool n0, n1;
      a[e] = fast_code(x0, rcp, n0);
      c[e] = fast_code(x1, rcp, n1);
      if (n0) mask |= 1u << (8 * w + 2 * e);
      if (n1) mask |= 2u << (8 * w + 2 * e);
    }
    lo[w] = pack4(a[0], a[1], a[2], a[3]);
    hi[w] = pack4(c[0], c[1], c[2], c[3]);
  }
  return mask;
}

// The codes of a tile, in rounds of code_px pixels.  First into the codes'
// tile in shared memory: a thread and step take 16 channels of two
// neighbouring pixels (neighbouring threads neighbouring pixel pairs, so
// the reads of the tile have no bank conflicts), by fast_code, and store
// them as two 16-byte pieces of padded pixel rows; the thread then redoes
// the few codes near a tie by exact_code, one byte each (most threads
// have none, so a warp waits on few divisions).  Then out, neighbouring
// threads on neighbouring 16-byte pieces of the NHWC output, so the
// stores are coalesced.
template <typename T>
__device__ __forceinline__ void tile_codes(const uint8_t* stage,
                                           uint8_t* cbuf, const Plan& p,
                                           int img, int c0, int p0, float s,
                                           int8_t* __restrict__ q) {
  const float rcp = __frcp_rn(s);
  const T* t = reinterpret_cast<const T*>(stage);
  const int width = p.nb * p.bw;
  const int vr = min(p.tc, p.c - c0);
  const int groups = (min(c0 + p.tcp, p.cinp) - c0) / 16;
  const int box_elems = p.box_bytes / static_cast<int>(sizeof(T));
  int8_t* out = q + (static_cast<long long>(img) * p.pixels + p0) * p.cinp +
                c0;
  for (int r0 = 0; r0 < width; r0 += p.code_px) {
    const int cw = min(p.code_px, width - r0), half = cw / 2;
    // item i: channels 16 g.. of pixels r0 + pc, r0 + pc + 1
    for (int i = threadIdx.x; i < groups * half; i += THREADS) {
      const int g = i / half, pc = 2 * (i - g * half), px = r0 + pc;
      const int b = px / p.bw;
      const T* src = t + b * box_elems + (px - b * p.bw);
      unsigned lo[4], hi[4];
      unsigned mask = codes16(src, p.bw, 16 * g, vr, rcp, lo, hi);
      uint8_t* dst = cbuf + pc * p.code_stride + 16 * g;
      *reinterpret_cast<uint4*>(dst) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(dst + p.code_stride) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      while (mask) {
        const int k = __ffs(mask) - 1, r = k >> 1, e = k & 1;
        mask &= mask - 1;
        int code = 0;  // the padding channels stay 0, whatever sx is
        if (16 * g + r < vr) {
          float x0, x1;
          load_pair(src + (16 * g + r) * p.bw, x0, x1);
          code = exact_code(e ? x1 : x0, s);
        }
        dst[e * p.code_stride + r] = static_cast<uint8_t>(code);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < groups * cw; i += THREADS) {
      const int pc = i / groups, g = i - pc * groups;
      if (p0 + r0 + pc < p.pixels)
        *reinterpret_cast<uint4*>(
            out + static_cast<long long>(r0 + pc) * p.cinp + 16 * g) =
            *reinterpret_cast<const uint4*>(cbuf + pc * p.code_stride +
                                            16 * g);
    }
    if (r0 + cw < width) __syncthreads();  // the codes' tile is free
  }
}

// The block's max of `m`, published on its image's words: one atomicMax
// and a release-ordered arrival.
__device__ __forceinline__ void publish(unsigned m, unsigned* words, int img,
                                        unsigned* warp_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = max(m, warp_max[w]);
    atomicMax(words + WORDS * img, m);
    red_release_add(words + WORDS * img + 1, 1u);  // after the atomicMax
  }
}

// Once every block of image `img` has published, its scale (written to
// sx[img] by the image's first slice).  Every thread gets the scale.  The
// block then departs; the image's last block to depart zeroes its words
// for the next call.
__device__ __forceinline__ float image_scale(unsigned* words,
                                             float* __restrict__ sx, int img,
                                             int slice, int spi,
                                             float* scale) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    unsigned* w = words + WORDS * img;
    while (ld_acquire(w + 1) < static_cast<unsigned>(spi))
      if (clock64() - t0 > (1LL << 34)) __trap();
    const float a = __uint_as_float(ld_acquire(w));
    if (atomicAdd(w + 2, 1u) == static_cast<unsigned>(spi) - 1)
      w[0] = w[1] = w[2] = 0;  // every block of the image has read them
    // max(a, 1e-8) / 127 as PyTorch's clamp_min and true division give it
    // (a NaN stays NaN)
    const float s = __fdiv_rn(a != a ? a : fmaxf(a, 1e-8f), 127.0f);
    *scale = s;
    if (slice == 0) sx[img] = s;
  }
  __syncthreads();
  return *scale;
}

// The absmax of item `j` (a tile of a slice's first pass) into the
// block's running max `m`, published with the slice's last tile (then 0).
template <typename T, bool TMA>
__device__ __forceinline__ unsigned absmax_item(
    uint8_t* smem, unsigned bar0, int j, const T* __restrict__ x,
    unsigned* words, const Plan& p, int slice, const Cursor& cur, unsigned m,
    unsigned* warp_max) {
  if (cur.pass != 0) return m;
  const int st = j % STAGES;
  int c0, p0;
  origin(p, slice, cur.tile, c0, p0);
  if (TMA) {
    mbar_wait(bar0 + 8 * st, (j / STAGES) & 1);
  } else {
    load_plain<T>(reinterpret_cast<T*>(smem + st * p.stage), x, p, cur.img,
                  c0, p0);
    __syncthreads();
  }
  m = max(m, tile_absmax<T>(smem + st * p.stage, p, c0));
  if (cur.tile < cur.ntile - 1) return m;
  publish(m, words, cur.img, warp_max);
  return 0;
}

// grid ipw * spi, 1, 2 or 4 blocks an SM (the plan's): block b takes slice
// b % spi of image wave * ipw + b / spi in each wave.  Item j + 1's absmax
// is published before item j's wait, so that the wait hides under item
// j - 1's codes and item j + 1's absmax; three stages: item j's codes,
// item j + 1's absmax, item j + 2's loads.
template <typename T, bool TMA>
__global__ void __launch_bounds__(THREADS, 4)
    quantize_kernel(const __grid_constant__ CUtensorMap map,
                    const T* __restrict__ x, unsigned* words,
                    float* __restrict__ sx, int8_t* __restrict__ q,
                    const Plan p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[STAGES];
  __shared__ unsigned warp_max[WARPS];
  __shared__ float scale;

  const unsigned raw = smem_addr(smem_raw);
  const unsigned base = (raw + ALIGN - 1) & ~(ALIGN - 1u);
  uint8_t* smem = smem_raw + (base - raw);
  const unsigned bar0 = smem_addr(&bars[0]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = blockIdx.x / p.spi, slice = blockIdx.x - li * p.spi;

  if (TMA && threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the loads (warp 0), the absmax and the codes walk the same items:
  // item j in stage j % STAGES, its load's phase (j / STAGES) & 1
  Cursor prod, amax, codes;
  start_wave(codes, p, li, slice, 0);
  prod = amax = codes;
  if (TMA && warp == 0) {
    for (int st = 0; st < STAGES && prod.valid; ++st) {
      load_tile<T>(&map, base + st * p.stage, bar0 + 8 * st, p, slice,
                   prod, lane);
      next_item(prod, p, li, slice);
    }
  }

  unsigned m = 0;
  float s = 0.f;
  m = absmax_item<T, TMA>(smem, bar0, 0, x, words, p, slice, amax, m,
                          warp_max);
  next_item(amax, p, li, slice);
  for (int j = 0; codes.valid; ++j) {
    if (amax.valid) {
      m = absmax_item<T, TMA>(smem, bar0, j + 1, x, words, p, slice, amax, m,
                              warp_max);
      next_item(amax, p, li, slice);
    }
    if (codes.ntile == 1 || codes.pass == 1) {
      const int st = j % STAGES;
      int c0, p0;
      origin(p, slice, codes.tile, c0, p0);
      if (TMA) {
        mbar_wait(bar0 + 8 * st, (j / STAGES) & 1);
      } else if (codes.pass == 1) {
        load_plain<T>(reinterpret_cast<T*>(smem + st * p.stage), x, p,
                      codes.img, c0, p0);
      }
      if (codes.tile == 0)  // the image's first codes: its scale
        s = image_scale(words, sx, codes.img, slice, p.spi, &scale);
      else if (!TMA)
        __syncthreads();
      tile_codes<T>(smem + st * p.stage, smem + STAGES * p.stage, p,
                    codes.img, c0, p0, s, q);
    }
    __syncthreads();  // the stage is free
    if (TMA && warp == 0 && prod.valid) {
      const int st = j % STAGES;
      load_tile<T>(&map, base + st * p.stage, bar0 + 8 * st, p, slice,
                   prod, lane);
      next_item(prod, p, li, slice);
    }
    next_item(codes, p, li, slice);
  }
}

template <typename T, bool TMA>
int launch(const CUtensorMap& map, const T* x, unsigned* words, float* sx,
           int8_t* q, const Plan& p, int smem, cudaStream_t s) {
  auto kernel = quantize_kernel<T, TMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.ipw * p.spi));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, map, x, words, sx, q, p));
}

template <typename T>
int launch_t(const T* x, int tma, unsigned* words, float* sx, int8_t* q,
             const Plan& p, int smem, cudaStream_t s) {
  CUtensorMap map = {};
  if (!tma) return launch<T, false>(map, x, words, sx, q, p, smem, s);
  EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorInitializationError);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.pixels),
                              static_cast<cuuint64_t>(p.c),
                              static_cast<cuuint64_t>(p.n)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(p.pixels) * sizeof(T),
      static_cast<cuuint64_t>(p.pixels) * p.c * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(p.bw),
                             static_cast<cuuint32_t>(p.tc), 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (encode(&map, type, 3, const_cast<T*>(x), dims, strides, box, estrides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<T, true>(map, x, words, sx, q, p, smem, s);
}

}  // namespace

// One launch of the plan (tma, tc, bw, nb, k, ipw, code_px;
// kernels/qconv.py::quantize_plan): the codes of `x` (NCHW, n x c x
// pixels, bf16 if `x_bf16` else f32) into `q` (int8 NHWC, n x pixels x
// cinp, cinp = c padded to 16, the padding zero) and the scales into `sx`
// (f32, n).  `words` (n x 4 words: each image's amax bits, arrivals and
// departures, and one of padding) must be zero when the call starts and
// is left zero when it ends.  `smem` is the plan's dynamic shared memory
// (the stages, the codes' tile and the alignment).  Returns the first CUDA
// error (0 on success; cudaErrorInvalidValue for a plan or arguments the
// kernel does not take, cudaErrorCooperativeLaunchTooLarge for a grid
// that cannot be resident).
extern "C" int panodepth_quantize_nhwc(const void* x, int x_bf16,
                                       unsigned* words, float* sx, void* q,
                                       int n, int c, int pixels, int tma,
                                       int tc, int bw, int nb, int k, int ipw,
                                       int code_px, int smem, void* stream) {
  const int esize = x_bf16 ? 2 : 4, per = 16 / esize;
  if (n <= 0 || c <= 0 || pixels <= 0 || tc <= 0 || bw <= 0 || nb <= 0 ||
      k <= 0 || ipw <= 0 || ipw > n || bw % per || code_px <= 0 ||
      code_px % 2 || code_px > static_cast<long long>(nb) * bw ||
      (tc < c && tc % 16) || tc > c || (tma && (bw > MAX_BOX ||
      tc > MAX_BOX || reinterpret_cast<uintptr_t>(x) % 16 ||
      (static_cast<long long>(pixels) * esize) % 16)) || (!tma && nb != 1) ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  p.n = n, p.c = c, p.cinp = (c + 15) / 16 * 16, p.pixels = pixels;
  p.tc = tc, p.tcp = (tc + 15) / 16 * 16, p.bw = bw, p.nb = nb;
  p.box_bytes = (tc * bw * esize + ALIGN - 1) / ALIGN * ALIGN;
  const long long stage = static_cast<long long>(nb) * p.box_bytes;
  const long long width = static_cast<long long>(nb) * bw;
  // an odd number of 16-byte pieces a pixel row: no bank conflicts
  p.code_stride = p.tcp / 16 % 2 ? p.tcp : p.tcp + 16;
  p.code_px = code_px;
  const long long code_bytes =
      (static_cast<long long>(code_px) * p.code_stride + ALIGN - 1) / ALIGN *
      ALIGN;
  p.tiles_p = static_cast<int>((pixels + width - 1) / width);
  const long long tiles =
      static_cast<long long>((c + tc - 1) / tc) * p.tiles_p;
  if (stage > (1 << 20) || STAGES * stage + code_bytes + ALIGN > smem ||
      tiles >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  p.stage = static_cast<int>(stage), p.tiles = static_cast<int>(tiles);
  p.k = k, p.spi = (p.tiles + k - 1) / k, p.ipw = ipw;
  p.waves = (n + ipw - 1) / ipw;
  if (static_cast<long long>(ipw) * p.spi > 65535 * 1024LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* qi = static_cast<int8_t*>(q);
  return x_bf16 ? launch_t(static_cast<const __nv_bfloat16*>(x), tma, words,
                           sx, qi, p, smem, s)
                : launch_t(static_cast<const float*>(x), tma, words, sx, qi,
                           p, smem, s);
}

extern "C" const char* panodepth_quantize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
