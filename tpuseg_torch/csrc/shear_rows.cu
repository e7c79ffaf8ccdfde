// Row shear with a bilinear blend (kernel K1), for Hopper.
//
// Replaces both TPU forms of one function in tpuseg/ops/warp.py:
// _shear_kernel (Pallas, per-row async DMAs, via _shear_rows_pallas) and
// _roll_shear_kernel (Pallas, per-row dynamic lane rolls, via
// _shear_rows_roll_pallas). Same contract as
// tpuseg_torch/ops/warp.py::_shear_rows_plain: for every row (n, h) of the
// mirror-padded img[N, H, Wp],
//   s = clamp(shift[n, h], 0, Wp - W - 1),  f = frac[n, h],
//   out[n, h, c] = img[n, h, s + c] * (1 - f) + img[n, h, s + c + 1] * f
// for c in [0, W). The clamp keeps both taps inside the row; the callers
// clip the shifts to that range already.
//
// Bound: memory. Each row reads W + 1 floats and its shift and frac, and
// writes W floats: at the training shape (N = 16 = batch 8 x (1 image + 1
// mask channel), H = W = 512, Wp = 880) that is
// 8192 * (513 + 512) * 4 + 8192 * 8 B = 33.65 MB, ~10.0 us at 3.35 TB/s,
// against 3 flops per output.
//
// Design (simple first): a block of kRowsPerBlock x kThreadsX threads owns
// kRowsPerBlock rows of one image; threads walk along W. Each row's shift
// and frac are read once per warp (one address, a broadcast). The two taps
// are coalesced loads of neighbouring addresses: consecutive threads read
// consecutive floats, and the +1 tap is the same cache lines again, served
// from L1. No TPU constraint carries over: no H % 8 rule, no 128-lane
// padding. The blend uses the _rn intrinsics so nvcc cannot contract it into
// an FMA: it rounds exactly where PyTorch's eager x0 * (1 - f) + x1 * f
// rounds, which makes the kernel bit-equal to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 128;    // threads along W
constexpr int kRowsPerBlock = 4;  // rows of one image per block

__global__ void __launch_bounds__(kThreadsX * kRowsPerBlock)
shear_rows_kernel(const float* __restrict__ img, const int* __restrict__ shift,
                  const float* __restrict__ frac, float* __restrict__ out, int h,
                  int wp, int w, int row_blocks) {
  const int n = blockIdx.x / row_blocks;
  const int r = (blockIdx.x % row_blocks) * kRowsPerBlock + threadIdx.y;
  if (r >= h) return;
  const long long row = (long long)n * h + r;
  const int s = min(max(__ldg(shift + row), 0), wp - w - 1);
  const float f = __ldg(frac + row);
  const float g = __fsub_rn(1.f, f);
  const float* __restrict__ src = img + row * wp + s;
  float* __restrict__ dst = out + row * w;
  for (int c = threadIdx.x; c < w; c += kThreadsX) {
    const float x0 = __ldg(src + c);
    const float x1 = __ldg(src + c + 1);
    dst[c] = __fadd_rn(__fmul_rn(x0, g), __fmul_rn(x1, f));
  }
}

}  // namespace

extern "C" {

// img: f32 [n, h, wp]; shift: i32 [n, h]; frac: f32 [n, h]; out: f32 [n, h, w];
// all contiguous, on one device, with 1 <= w <= wp - 1. Launches on `stream`
// and returns the cudaError_t of the launch (0 on success).
int tpuseg_shear_rows(const float* img, const int* shift, const float* frac, float* out,
                      int n, int h, int wp, int w, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || wp < w + 1) return (int)cudaErrorInvalidValue;
  const int row_blocks = (h + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = (long long)n * row_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 block(kThreadsX, kRowsPerBlock);
  shear_rows_kernel<<<(unsigned)blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, shift, frac, out, h, wp, w, row_blocks);
  return (int)cudaGetLastError();
}

const char* tpuseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
