// Damped Jacobi relaxation toward a target Laplacian, for Hopper (sm_90a).
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
// N = H*W: the reference's flat-index seam wrap into the adjacent row
// (PARITY.md quirk #19) and the vertical roll.  Because the taps wrap like
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
// operations per covered pixel, ~1.8 GFLOP or ~27 us for the production
// coverage; the least bytes are each level's arrays once, ~36 MB or ~11 us.
// So the function is bound by operations.  A first form with one launch
// per iteration (350 per panorama) was held by the launch rate, not by
// either bound.  This form does kSteps iterations per launch (temporal
// blocking): a block loads a kWinH x kWinW window (the kTileH x kTileW
// interior plus a kSteps-deep halo) into shared memory, relaxes it kSteps
// times while the valid region shrinks by one ring per iteration, and
// writes the interior.  The window is gathered by flat index modulo N, so
// a window neighbour one column or one row away is exactly the flat tap
// i +- 1 or i +- W, the seam wrap included, and the tiled result equals
// the plain one bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A block relaxes a kWinH x kWinW window and writes its kTileH x kTileW
// interior.  Threads form a kWinW x kRowsPerPass grid: thread (tx, ty) owns
// window column tx and rows ty, ty + kRowsPerPass, ..., so a warp reads 32
// consecutive floats of one row (no bank conflicts, no index division).
constexpr int kSteps = 8;                    // iterations per launch = halo
constexpr int kWinW = 64;
constexpr int kWinH = 56;
constexpr int kTileW = kWinW - 2 * kSteps;   // 48
constexpr int kTileH = kWinH - 2 * kSteps;   // 40
constexpr int kRowsPerPass = 4;
constexpr int kThreads = kWinW * kRowsPerPass;

__device__ __forceinline__ float relax(float c, float l, float r, float u,
                                       float d, float t, float step,
                                       float one_minus_reg, float reg) {
  const float taps = __fadd_rn(__fadd_rn(__fadd_rn(l, r), u), d);
  const float lap = __fsub_rn(c, __fmul_rn(0.25f, taps));
  float upd = __fadd_rn(c, __fmul_rn(__fsub_rn(t, lap), step));
  upd = __fadd_rn(__fmul_rn(upd, one_minus_reg), __fmul_rn(c, reg));
  return fminf(fmaxf(upd, 0.0f), 1.0f);
}

// `steps` (1..kSteps) iterations of one window; writes its interior.
// Needs (h + 64) * w < 2^31 (checked by the caller).
__global__ void __launch_bounds__(kThreads)
jacobi_window(const float* __restrict__ src, float* __restrict__ dst,
              const float* __restrict__ tgt, const uint8_t* __restrict__ cov,
              int h, int w, int steps, float step, float one_minus_reg,
              float reg) {
  __shared__ float win[2][kWinH][kWinW];
  __shared__ float t[kWinH][kWinW];
  __shared__ uint8_t c[kWinH][kWinW];
  __shared__ int row_base[kWinH];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int n = h * w;
  const int y0 = blockIdx.y * kTileH - kSteps;
  const int x0 = blockIdx.x * kTileW - kSteps;
  // flat index of each window row's first element, modulo n
  const int tid = ty * kWinW + tx;
  if (tid < kWinH) {
    int f = ((y0 + tid) * w + x0) % n;
    row_base[tid] = f < 0 ? f + n : f;
  }
  __syncthreads();
  for (int ly = ty; ly < kWinH; ly += kRowsPerPass) {
    int f = row_base[ly] + tx;
    while (f >= n) f -= n;
    win[0][ly][tx] = src[f];
    t[ly][tx] = tgt[f];
    c[ly][tx] = cov[f];
  }
  __syncthreads();
  int cur = 0;
  for (int s = 1; s <= steps; ++s) {
    // after s-1 iterations the window is valid on [s-1, kWin - s + 1);
    // iteration s updates [s, kWin - s), whose taps all lie inside that
    const float(*a)[kWinW] = win[cur];
    float(*b)[kWinW] = win[cur ^ 1];
    if (tx >= s && tx < kWinW - s) {
      for (int ly = ty; ly < kWinH - s; ly += kRowsPerPass) {
        if (ly < s) continue;
        const float ci = a[ly][tx];
        b[ly][tx] = c[ly][tx]
                        ? relax(ci, a[ly][tx - 1], a[ly][tx + 1],
                                a[ly - 1][tx], a[ly + 1][tx], t[ly][tx], step,
                                one_minus_reg, reg)
                        : ci;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  const int gx = x0 + tx;
  if (tx >= kSteps && tx < kSteps + kTileW && gx < w) {
    for (int ly = kSteps + ty; ly < kSteps + kTileH; ly += kRowsPerPass) {
      const int gy = y0 + ly;
      if (gy < h) dst[gy * w + gx] = win[cur][ly][tx];
    }
  }
}

}  // namespace

extern "C" int panodepth_jacobi_steps_per_launch() { return kSteps; }

// Runs `iterations` iterations on `stream` in ceil(iterations / kSteps)
// launches.  Launch j reads the previous result (`buf` for j = 0) and writes
// `out` or `scratch`, alternating so that the last one writes `out`;
// `scratch` is unused for a single launch.  `step` and `reg` come in as
// doubles and are rounded to float here, as PyTorch rounds a Python scalar,
// with 1 - reg formed in double first.  Returns the first CUDA error (0 on
// success).
extern "C" int panodepth_jacobi(const float* buf, float* out, float* scratch,
                                const float* target, const uint8_t* covered,
                                int h, int w, int iterations, double step,
                                double reg, void* stream) {
  const float f_step = static_cast<float>(step);
  const float f_omr = static_cast<float>(1.0 - reg);
  const float f_reg = static_cast<float>(reg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  const dim3 block(kWinW, kRowsPerPass);
  const int launches = (iterations + kSteps - 1) / kSteps;
  const float* src = buf;
  int done = 0;
  for (int j = 0; j < launches; ++j) {
    const int steps =
        iterations - done < kSteps ? iterations - done : kSteps;
    float* dst = ((launches - 1 - j) % 2 == 0) ? out : scratch;
    jacobi_window<<<grid, block, 0, s>>>(src, dst, target, covered, h, w,
                                         steps, f_step, f_omr, f_reg);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
    done += steps;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* panodepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
