// Damped Jacobi relaxation toward a target Laplacian, for Hopper (sm_90a),
// over a batch of panoramas that share one coverage mask.
//
// Replaces the TPU kernel panodepth/kernels/jacobi.py::pallas_jacobi
// (_pallas_jacobi_impl: the single-block branch at jacobi.py:98 and the
// banded branch at jacobi.py:145-155; the step is _step, jacobi.py:44-50).
// It computes the plain panodepth_torch.fusion.jacobi, not the Pallas band
// layout: each iteration is
//
//   lap = c - 0.25 * (((l + r) + u) + d)
//   upd = B + (t - lap) * step
//   upd = upd * (1 - reg) + B * reg
//   B'  = cov ? clamp(upd, 0, 1) : B
//
// with the four taps at flat indices (i-1), (i+1), (i-W), (i+W) modulo
// N = H*W of each panorama: the reference's flat-index seam wrap into the
// adjacent row (PARITY.md quirk #19) and the vertical roll.  Because the taps wrap like
// the plain version's, no edge precondition is needed (the Pallas kernel's
// zero y-halo needed one, jacobi.py:127-138); every covered pixel, in row 0,
// row H-1, column 0 or column W-1 too, matches the plain version.
//
// Every operation is written with the round-to-nearest intrinsics (and the
// library is built with -fmad=false), so nvcc contracts nothing into an FMA
// and the result is bit-equal to the plain PyTorch version, which rounds
// after each elementwise operation.
//
// What bounds it on an H100 SXM (67 TFLOP/s f32 outside the tensor cores,
// 3.35 TB/s): one 2048-wide panorama is 200/100/50 iterations over
// 512x256, 1024x512 and 2048x1024, 183.5 M pixel-iterations at 14 f32
// operations per covered pixel, ~1.8 GFLOP or ~27 us; the least bytes are
// each level's arrays once, ~36 MB or ~11 us.  So it is bound by
// operations.  Since no FMA may be contracted, a cell-iteration takes ~15
// issue slots (11 f32 adds and multiplies, the clamp folded into the last
// add as a saturation, the coverage test and select, the edge exchange),
// ~90 us a panorama at the card's f32 issue rate even with no halo.
//
// The design (temporal blocking in registers): a block relaxes a window of
// 32*C columns by W*R rows, `halo` iterations per launch, and writes the
// window's interior (the window less `halo` cells on every side).  Each
// warp owns a strip of R consecutive window rows across all 32*C columns;
// lane l holds the micro-tile of columns l*C .. l*C+C-1 of those rows, with
// B, the target and the coverage bits in registers.  So the vertical taps
// inside a micro-tile and the horizontal taps inside a lane are register
// reads; the left and right taps at a lane's edge come from its neighbours
// by warp shuffle (2 per row), and the rows above and below a warp's strip
// through a small double-buffered shared-memory edge buffer (2*C stores and
// 2*C loads per thread), with one barrier per iteration.  Cells of the
// window's outer ring take garbage taps (a shuffle past lane 31, a warp's
// own edge at the top and bottom); the garbage moves in one cell per
// iteration and never reaches the interior in `halo` iterations, and a
// strip that no later iteration needs skips its arithmetic.  The window is
// gathered by flat index modulo N, so a window neighbour one column or one
// row away is exactly the flat tap i +- 1 or i +- W, the seam wrap
// included, and the tiled result equals the plain one bit for bit.  The
// launch plan (C, R, W and `halo`, so the window and the grid) is chosen
// per level by kernels/jacobi.py::plan_for: 128x128 windows 16 iterations
// deep where the level is large (the halo recomputed ~1.8x the interior),
// more and smaller blocks where it is small and the card would idle.
//
// A batch (the counterpart of jax.vmap over pallas_jacobi in the batched
// merge and the e2e fuse stage) is the grid's z axis: block z relaxes
// panorama z, whose buffer and target start z*H*W floats in, and reads the
// one coverage mask of the level.  The window walk and its modulo-N wrap
// stay per panorama, so each panorama's result is the bits it gets alone,
// and one launch sequence serves the whole batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// up to 1024 threads a block: the 2x4 and 4x4 micro-tiles keep a thread
// within 64 registers, so a whole block fits an SM's register file
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float relax(float c, float l, float r, float u,
                                       float d, float t, float step,
                                       float one_minus_reg, float reg) {
  const float taps = __fadd_rn(__fadd_rn(__fadd_rn(l, r), u), d);
  const float lap = __fsub_rn(c, __fmul_rn(0.25f, taps));
  float upd = __fadd_rn(c, __fmul_rn(__fsub_rn(t, lap), step));
  upd = __fadd_rn(__fmul_rn(upd, one_minus_reg), __fmul_rn(c, reg));
  return fminf(fmaxf(upd, 0.0f), 1.0f);
}

// bit ? a : b as one predicated select: left to itself nvcc turns the
// coverage test into a divergent branch around relax() per cell (5 more
// issue slots a cell, and the lanes of a warp split on mixed coverage)
__device__ __forceinline__ float pick(unsigned bit, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %1, 0;\n\t"
      "selp.f32 %0, %2, %3, p;\n\t}"
      : "=f"(r)
      : "r"(bit), "f"(a), "f"(b));
  return r;
}

// `steps` (1..halo) iterations of one (32*C) x (warps*R) window of
// panorama blockIdx.z; writes its interior.  Dynamic shared memory: the
// edge buffer, 2 buffers x (top, bottom) x warps x C x 32 floats.  Needs
// (h + warps*R + 1) * w < 2^31 (checked by the caller); the panorama's
// offset is 64-bit.
template <int C, int R>
__global__ void __launch_bounds__(kMaxWarps * 32)
jacobi_tile(const float* __restrict__ src, float* __restrict__ dst,
            const float* __restrict__ tgt, const uint8_t* __restrict__ cov,
            int h, int w, int halo, int steps, float step,
            float one_minus_reg, float reg) {
  extern __shared__ float edge[];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int win_w = 32 * C, win_h = warps * R;
  const int n = h * w;
  const size_t pano = static_cast<size_t>(blockIdx.z) * n;
  src += pano;
  dst += pano;
  tgt += pano;
  const int y0 = blockIdx.y * (win_h - 2 * halo) - halo;
  const int x0 = blockIdx.x * (win_w - 2 * halo) - halo;
  const int lx0 = lane * C, ly0 = g * R;

  float b[R][C], t[R][C];
  unsigned m = 0;  // coverage bit r*C + k
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int f = ((y0 + ly0 + r) * w + x0 + lx0) % n;
    if (f < 0) f += n;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      int fk = f + k;
      while (fk >= n) fk -= n;
      b[r][k] = src[fk];
      t[r][k] = tgt[fk];
      m |= static_cast<unsigned>(cov[fk] != 0) << (r * C + k);
    }
  }

  const int plane = warps * C * 32;  // floats per buffer and side
  const int gu = g > 0 ? g - 1 : g;
  const int gd = g < warps - 1 ? g + 1 : g;
  for (int s = 0; s < steps; ++s) {
    float* top = edge + (s & 1) * 2 * plane;
    float* bot = top + plane;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      top[(g * C + k) * 32 + lane] = b[0][k];
      bot[(g * C + k) * 32 + lane] = b[R - 1][k];
    }
    __syncthreads();
    float prev[C], dn[C];
    // after iteration s + 1 only rows [s + 1, win_h - s - 1) are still
    // needed; a strip wholly outside them skips its arithmetic (it goes on
    // publishing its edges, which its live neighbours do not read)
    if (ly0 + R <= s + 1 || ly0 >= win_h - s - 1) continue;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      prev[k] = bot[(gu * C + k) * 32 + lane];
      dn[k] = top[(gd * C + k) * 32 + lane];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float lin = __shfl_up_sync(kFull, b[r][C - 1], 1);
      const float rin = __shfl_down_sync(kFull, b[r][0], 1);
      float nb[C];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const float l = k > 0 ? b[r][k - 1] : lin;
        const float rr = k < C - 1 ? b[r][k + 1] : rin;
        const float d = r < R - 1 ? b[r + 1][k] : dn[k];
        nb[k] = pick(m & (1u << (r * C + k)),
                     relax(b[r][k], l, rr, prev[k], d, t[r][k], step,
                           one_minus_reg, reg),
                     b[r][k]);
      }
#pragma unroll
      for (int k = 0; k < C; ++k) {
        prev[k] = b[r][k];
        b[r][k] = nb[k];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ly = ly0 + r, gy = y0 + ly;
    if (ly < halo || ly >= win_h - halo || gy >= h) continue;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int lx = lx0 + k, gx = x0 + lx;
      if (lx >= halo && lx < win_w - halo && gx < w) dst[gy * w + gx] = b[r][k];
    }
  }
}

template <int C, int R>
int run(const float* buf, float* out, float* scratch, const float* target,
        const uint8_t* covered, int batch, int h, int w, int iterations,
        float step, float omr, float reg, int warps, int halo, int smem,
        int opt_in, cudaStream_t s) {
  const int win_w = 32 * C, win_h = warps * R;
  const dim3 grid((w + win_w - 2 * halo - 1) / (win_w - 2 * halo),
                  (h + win_h - 2 * halo - 1) / (win_h - 2 * halo), batch);
  // the plan's byte count must hold the edge buffer
  if (smem < 0 ||
      static_cast<size_t>(smem) < sizeof(float) * 4 * warps * C * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (opt_in) {  // above the default 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi_tile<C, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int launches = (iterations + halo - 1) / halo;
  const float* src = buf;
  int done = 0;
  for (int j = 0; j < launches; ++j) {
    const int steps = iterations - done < halo ? iterations - done : halo;
    float* dst = ((launches - 1 - j) % 2 == 0) ? out : scratch;
    jacobi_tile<C, R><<<grid, warps * 32, smem, s>>>(
        src, dst, target, covered, h, w, halo, steps, step, omr, reg);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
    done += steps;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs `iterations` iterations of each of `batch` panoramas (buf, out,
// scratch and target hold batch x h x w floats; covered one h x w mask) on
// `stream` with the launch plan (cols C, rows R, warps W, halo): ceil(iterations / halo) launches of the
// (32*C) x (W*R) window, `halo` iterations each and the rest in the last,
// each with `smem` bytes of dynamic shared memory (kernels/jacobi.py,
// JacobiPlan.smem_bytes), granted first with `opt_in` above 48 KB.
// Launch j reads the previous result (`buf` for j = 0) and writes `out` or
// `scratch`, alternating so that the last one writes `out`; `scratch` is
// unused for a single launch.  `step` and `reg` come in as doubles and are
// rounded to float here, as PyTorch rounds a Python scalar, with 1 - reg
// formed in double first.  Returns the first CUDA error (0 on success;
// cudaErrorInvalidValue for a plan this library has no kernel for, or
// whose `smem` does not hold the edge buffer, or a batch outside
// 1..65535, the grid's z limit).
extern "C" int panodepth_jacobi(const float* buf, float* out, float* scratch,
                                const float* target, const uint8_t* covered,
                                int batch, int h, int w, int iterations,
                                double step,
                                double reg, int cols, int rows, int warps,
                                int halo, int smem, int opt_in,
                                void* stream) {
  const float f_step = static_cast<float>(step);
  const float f_omr = static_cast<float>(1.0 - reg);
  const float f_reg = static_cast<float>(reg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535 || warps < 1 || warps > kMaxWarps ||
      halo < 1 || iterations < 1 ||
      32 * cols <= 2 * halo || warps * rows <= 2 * halo)
    return static_cast<int>(cudaErrorInvalidValue);
#define PANODEPTH_JACOBI_PLAN(C, R)                                          \
  if (cols == C && rows == R)                                                \
    return run<C, R>(buf, out, scratch, target, covered, batch, h, w,        \
                     iterations, f_step, f_omr, f_reg, warps, halo, smem,    \
                     opt_in, s);
  PANODEPTH_JACOBI_PLAN(2, 4)
  PANODEPTH_JACOBI_PLAN(4, 4)
#undef PANODEPTH_JACOBI_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* panodepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
