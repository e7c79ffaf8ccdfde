// The fp input conv of the quantized serving walk, for Hopper: K5 of the port.
// A SAME 3x3 conv of the network input with the block's ReLU, folded BN and
// requantize fused, int8 codes out.
//
// Replaces the fp branch of `conv_block` in tpuseg/infer/quant.py:544-560
// (`_conv_fp` with bf16 operands and f32 sums, then `jnp.maximum(y + b, 0) *
// s + t`) and `emit` (:526), which XLA fuses into one conv fusion on the TPU
// (blocked at :665-674). It is XLA-fused code, not a Pallas kernel. Same
// contract as tpuseg_torch/infer/input_conv.py::_input_conv_plain: for output
// pixel (b, y, x) of x[B, H, W, C] (NHWC f32) and output channel f < F,
//   acc = 0; for ky, kx in 0..2, for c < C (in that order):
//     acc = acc + r(x[b, y + ky - 1, x + kx - 1, c]) * r(w[ky, kx, c, f])
//   (zero outside the image), r rounding to the compute dtype and back;
//   v = max(acc + b[f], 0) * s[f] + t[f]; q = clamp(rint(v / so), -127, 127).
// The output is int8 [B, H, W, F], or with `blocked` the phase-major
// [B, H/2, W/2, 4F] whose channel (py * 2 + px) * F + f holds pixel
// (2i + py, 2j + px) (quant.py's `_s2d` order). Every float operation is the
// plain version's, in its order: PyTorch runs the product and the sum as two
// kernels, so nothing there is contracted into an FMA, and the _rn
// intrinsics keep nvcc from contracting here. With bf16 operands (the served
// dtype) a product has at most 16 significant bits and is exact in f32, so
// __fmaf_rn rounds exactly as the separate product and sum do (unless a
// product falls below 2^-134, into f32's subnormals, far under any z-scored
// input times a folded weight) and takes one instruction for two. `so` is a
// true division by a scalar read from device memory (the plain version
// divides by a 0-dim device tensor, not by a reciprocal), and rint is
// round-half-even, torch.round's rule. So the kernel is bit-equal to the
// plain version. The operands are rounded as they are staged (the weights
// once per block): no launch of its own and no cached copy.
//
// Bound: bytes, nearly tied with operations. At the serving shape (batch 8 of
// 1024^2 tiles, C 1, F 64) it reads 33.5 MB of f32 input and writes 537 MB of
// int8 codes: 0.170 ms at 3.35 TB/s; its 4.83e9 multiply-adds take 0.144 ms at
// the f32 CUDA-core peak (67 TFLOP/s). The eager path it replaces wrote the
// f32 conv output (2.15 GB) and ran eight passes over it.
//
// Design: a block of 256 threads takes an 8 x 32 tile of output pixels of one
// image and a chunk of `fc` output channels (all of F unless the weights would
// not fit in shared memory; the wrapper picks fc). It stages the tile's input
// rows and its 1-pixel halo, rounded, with zeros outside the image (tiles come
// from infer/tiled.py already padded by the receptive-field radius, so these
// zeros fall only at a tile's edge, where cuDNN's SAME padding fell), the
// rounded weights of its chunk (zero past F) and b, s, t in shared memory.
// Each thread then computes items of 16 consecutive channels of four output
// pixels of one row, 8 columns apart: 64 accumulators in registers, and per
// tap and input channel four shared loads of x and four float4 loads of
// weights (broadcast across the threads of one channel group), each weight
// load feeding the four pixels. The first design, one pixel an item, spent
// four float4 loads (and three scalar loads of b, s, t per channel) on 16
// multiply-adds and took 1.8 ms a call at the serving shape, ten times its
// bound: the shared-memory pipe, by its instruction counts. The epilogue
// runs in registers, b, s and t loaded once for the four pixels, and each
// pixel's 16 codes are stored as one 16-byte store where F % 16 == 0 (scalar
// byte stores otherwise: F = 4 at the tests' base 4). Items are numbered so
// that neighbouring threads store neighbouring 16-byte chunks: channel group
// fastest, then the pixel along the row, or, in the blocked layout, the phase
// and then the blocked pixel, whose 4F codes are contiguous. Byte offsets are
// 64-bit; pixel indices 32-bit (the wrapper raises past 2^31 pixels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8;         // output rows per tile (even: blocked pixels stay whole)
constexpr int kTW = 32;        // output columns per tile (even)
constexpr int kThreads = 256;  // threads per block
constexpr int kGroup = 16;     // output channels per item
constexpr int kPix = 4;        // output pixels per item, kPixStride columns apart
constexpr int kPixStride = kTW / kPix;
constexpr int kHalo = (kTH + 2) * (kTW + 2);  // staged input pixels per tile
constexpr int kMaxSmem = 232448;              // a block's shared memory on Hopper

enum DtypeCode { kF32 = 0, kBf16 = 1 };

struct Params {
  const float* x;  // [n, h, w, c]
  const float* w;  // [3, 3, c, f]
  const float* b;  // [f]
  const float* s;  // [f]
  const float* t;  // [f]
  const float* so;  // scalar
  int8_t* out;      // [n, h, w, f] or [n, h/2, w/2, 4f]
  int h, w_, c, f;
  int fc;  // output channels per chunk, a multiple of kGroup
  int tiles_x, tiles_y;
};

template <bool BF16>
__device__ __forceinline__ float round_operand(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// acc + x * w as the plain version rounds it (see the header for the FMA).
template <bool BF16>
__device__ __forceinline__ float mac(float x, float w, float acc) {
  return BF16 ? __fmaf_rn(x, w, acc) : __fadd_rn(acc, __fmul_rn(x, w));
}

__device__ __forceinline__ uint32_t requant(float v, float so) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, so)), -127.0f), 127.0f);
  return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(q)));
}

template <bool BF16, bool BLOCKED, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) input_conv_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int c = p.c;
  const int fc = p.fc;
  float* xs = smem;                  // [kTH + 2][kTW + 2][c]
  float* ws = xs + kHalo * c;        // [9][c][fc]; kHalo * 4 bytes is a multiple of 16
  float* bst = ws + 9 * c * fc;      // b, s, t of the chunk: [3][fc]

  int tile = blockIdx.x;
  const int tx = tile % p.tiles_x;
  tile /= p.tiles_x;
  const int ty = tile % p.tiles_y;
  const int img = tile / p.tiles_y;
  const int y0 = ty * kTH, x0 = tx * kTW;
  const int f0 = blockIdx.y * fc;
  const int fvalid = min(fc, p.f - f0);

  for (int i = threadIdx.x; i < kHalo * c; i += kThreads) {
    const int pix = i / c;
    const int yy = y0 - 1 + pix / (kTW + 2);
    const int xx = x0 - 1 + pix % (kTW + 2);
    float v = 0.0f;
    if (yy >= 0 && yy < p.h && xx >= 0 && xx < p.w_)
      v = round_operand<BF16>(
          __ldg(p.x + (((long long)img * p.h + yy) * p.w_ + xx) * c + i % c));
    xs[i] = v;
  }
  for (int i = threadIdx.x; i < 9 * c * fc; i += kThreads) {
    const int fj = i % fc;
    ws[i] = fj < fvalid ? round_operand<BF16>(__ldg(p.w + (long long)(i / fc) * p.f + f0 + fj))
                        : 0.0f;
  }
  for (int i = threadIdx.x; i < fc; i += kThreads) {
    const bool in = i < fvalid;
    bst[i] = in ? __ldg(p.b + f0 + i) : 0.0f;
    bst[fc + i] = in ? __ldg(p.s + f0 + i) : 0.0f;
    bst[2 * fc + i] = in ? __ldg(p.t + f0 + i) : 0.0f;
  }
  const float so = __ldg(p.so);
  __syncthreads();

  // An item: channel group g of the kPix pixels (ly, lxb + kPixStride * k).
  // Dense: lxb runs over the first kPixStride columns; blocked: over the
  // phase and the first kPixStride / 2 blocked columns of a blocked row.
  const int groups = (fvalid + kGroup - 1) / kGroup;
  for (int it = threadIdx.x; it < kTH * kPixStride * groups; it += kThreads) {
    const int g = it % groups;
    const int q = it / groups;
    int ly, lxb;
    if (BLOCKED) {  // phase fastest, then the blocked column, then the blocked row
      const int r = q >> 2;
      ly = 2 * (r / (kPixStride / 2)) + ((q >> 1) & 1);
      lxb = 2 * (r % (kPixStride / 2)) + (q & 1);
    } else {
      ly = q / kPixStride;
      lxb = q % kPixStride;
    }
    const int y = y0 + ly;
    if (y >= p.h) continue;

    float acc[kPix][kGroup];
#pragma unroll
    for (int k = 0; k < kPix; ++k)
#pragma unroll
      for (int j = 0; j < kGroup; ++j) acc[k][j] = 0.0f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* xp = xs + ((ly + ky) * (kTW + 2) + lxb + kx) * c;
        const float* wp = ws + (ky * 3 + kx) * c * fc + g * kGroup;
        for (int ci = 0; ci < c; ++ci) {
          float xv[kPix];
#pragma unroll
          for (int k = 0; k < kPix; ++k) xv[k] = xp[k * kPixStride * c + ci];
          const float4* w4 = reinterpret_cast<const float4*>(wp + ci * fc);
#pragma unroll
          for (int j = 0; j < kGroup / 4; ++j) {
            const float4 wv = w4[j];  // one load for kPix pixels
#pragma unroll
            for (int k = 0; k < kPix; ++k) {
              acc[k][4 * j] = mac<BF16>(xv[k], wv.x, acc[k][4 * j]);
              acc[k][4 * j + 1] = mac<BF16>(xv[k], wv.y, acc[k][4 * j + 1]);
              acc[k][4 * j + 2] = mac<BF16>(xv[k], wv.z, acc[k][4 * j + 2]);
              acc[k][4 * j + 3] = mac<BF16>(xv[k], wv.w, acc[k][4 * j + 3]);
            }
          }
        }
      }
    }

    uint32_t packed[kPix][kGroup / 4] = {};
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int fl = g * kGroup + j;
      const float bj = bst[fl], sj = bst[fc + fl], tj = bst[2 * fc + fl];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        float v = fmaxf(__fadd_rn(acc[k][j], bj), 0.0f);
        v = __fadd_rn(__fmul_rn(v, sj), tj);
        packed[k][j / 4] |= requant(v, so) << (8 * (j % 4));
      }
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int x = x0 + lxb + k * kPixStride;
      if (x >= p.w_) continue;
      long long off;
      if (BLOCKED) {
        const int h2 = p.h >> 1, w2 = p.w_ >> 1;
        off = (((long long)img * h2 + (y >> 1)) * w2 + (x >> 1)) * 4 * p.f +
              ((y & 1) * 2 + (x & 1)) * p.f;
      } else {
        off = (((long long)img * p.h + y) * p.w_ + x) * p.f;
      }
      off += f0 + g * kGroup;
      if (VEC) {  // F % 16 == 0: every group is whole and 16-byte aligned
        *reinterpret_cast<uint4*>(p.out + off) =
            make_uint4(packed[k][0], packed[k][1], packed[k][2], packed[k][3]);
      } else {
        const int n = min(kGroup, fvalid - g * kGroup);
        for (int j = 0; j < n; ++j)
          p.out[off + j] = static_cast<int8_t>((packed[k][j / 4] >> (8 * (j % 4))) & 0xff);
      }
    }
  }
}

template <bool BF16, bool BLOCKED, bool VEC>
cudaError_t launch(const Params& p, dim3 grid, int smem, cudaStream_t stream) {
  auto kernel = input_conv_kernel<BF16, BLOCKED, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch(const Params& p, bool blocked, dim3 grid, int smem, cudaStream_t st) {
  const bool vec = p.f % kGroup == 0;
  if (blocked)
    return vec ? launch<BF16, true, true>(p, grid, smem, st)
               : launch<BF16, true, false>(p, grid, smem, st);
  return vec ? launch<BF16, false, true>(p, grid, smem, st)
             : launch<BF16, false, false>(p, grid, smem, st);
}

// Shared memory of a block taking C input channels and chunks of fc output
// channels, in bytes (input_conv.py::smem_bytes).
long long smem_bytes(int c, int fc) {
  return 4LL * ((long long)kHalo * c + 9LL * c * fc + 3LL * fc);
}

}  // namespace

extern "C" {

// x: f32 [n, h, w, c]; w: f32 [3, 3, c, f] (HWIO); b, s, t: f32 [f]; so: f32
// scalar on the device; out: int8 [n, h, w, f], or with `blocked` (h and w
// even) [n, h/2, w/2, 4f], 16-byte aligned; all contiguous on one device. fc:
// output channels per chunk, a multiple of 16, with the block's shared memory
// (smem_bytes) within Hopper's 227 KB. dtype: 0 (float32
// operands) or 1 (bfloat16). Launches on `stream` and returns 0 or the
// cudaError_t of the launch; the caller checked devices, dtypes and shapes.
int tpuseg_input_conv(const float* x, const float* w, const float* b, const float* s,
                      const float* t, const float* so, void* out, int n, int h, int w_,
                      int c, int f, int fc, int dtype, int blocked, void* stream) {
  if (n <= 0 || h <= 0 || w_ <= 0 || c <= 0 || f <= 0 || fc <= 0 || fc % kGroup)
    return (int)cudaErrorInvalidValue;
  if ((dtype != kF32 && dtype != kBf16) || (blocked && (h % 2 || w_ % 2)))
    return (int)cudaErrorInvalidValue;
  if ((long long)n * h * w_ >= (1LL << 31) || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes(c, fc) > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(c, fc);
  Params p;
  p.x = x;
  p.w = w;
  p.b = b;
  p.s = s;
  p.t = t;
  p.so = so;
  p.out = static_cast<int8_t*>(out);
  p.h = h;
  p.w_ = w_;
  p.c = c;
  p.f = f;
  p.fc = fc;
  p.tiles_x = (w_ + kTW - 1) / kTW;
  p.tiles_y = (h + kTH - 1) / kTH;
  const long long blocks = (long long)n * p.tiles_y * p.tiles_x;
  const long long chunks = (f + fc - 1) / fc;
  if (blocks >= (1LL << 31) || chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == kBf16 ? dispatch<true>(p, blocked != 0, grid, smem, st)
                              : dispatch<false>(p, blocked != 0, grid, smem, st));
}

const char* tpuseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
