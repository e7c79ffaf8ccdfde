// SAME int8 convolution (stride 1, 1x1 or 3x3) with int32 accumulation and
// the quantized block's epilogue fused, for Hopper: K3 of the port.
//
// Replaces tpuseg/infer/quant.py:173 `_conv_s8` (XLA's conv_general_dilated
// with preferred_element_type=int32) together with the epilogue that XLA fuses
// behind it inside `_quantized_raw_fn` (the conv block's ReLU + folded BN and
// `emit`'s requantize; the deconv's affine + requantize). It is XLA-fused code
// on the TPU, not a Pallas kernel. Same contract as
// tpuseg_torch/infer/int8_conv.py::_int8_conv_plain: for output pixel m of
// x[B, H, W, Cin] (NHWC int8) and output channel n < Cout,
//   acc = sum over taps (ky, kx) and c < Cin of x[m + (ky - kh/2, kx - kw/2)][c]
//         * w[n][tap][c]                            (int32, zero outside the image)
// then one of three epilogues, each in the plain version's order of float
// operations (PyTorch runs each as its own kernel, so nothing there is fused
// into an FMA; the _rn intrinsics keep nvcc from contracting here):
//   mode 0 (conv block):   y = max(f(acc) * ws + b, 0) * s + t,
//                          q = clamp(rint(y / so), -127, 127)        -> int8
//   mode 1 (last block):   y as in mode 0, no requantize             -> f32
//   mode 2 (deconv as a 1x1 conv to phase-major 4*cout):
//                          y = (f(acc) * ws) * s + t, q as in mode 0 -> int8
// `so` is a true division by a scalar read from device memory (the plain
// version divides by a 0-dim device tensor, not by a reciprocal), and rint is
// round-half-even, torch.round's rule. The result is bit-equal to the plain
// version: the int32 sums are exact (K <= 9 * 1024 = 9216 and 9216 * 127^2 <
// 2^31), the float operations are the same IEEE operations in the same order.
//
// Bound: int8 tensor-core operations. On the serving path's blocks (batch 8 of
// 1024^2 tiles at base 64) K = 9 * Cin is 576..9216 and N = Cout 128..2048, so
// the arithmetic intensity 2*M*K*N / (M*Cin + N*K + M*Cout) is hundreds of
// operations a byte, above the H100's 1,979 TOP/s / 3.35 TB/s = 591: e.g.
// enc1b (x 8x512x512x256, 3x3, Cout 256) needs 2.47 TOP, 1.25 ms at the int8
// peak, against 0.32 ms for its bytes.
//
// Design (simple and right first; wgmma, TMA and a persistent grid are later
// work): an implicit GEMM with M = B*H*W output pixels, N = Cout and
// K = kh*kw*Cin, with no im2col in device memory. A block computes a 128 x 128
// output tile with 8 warps (2 along M x 4 along N, 64 x 32 each) from K-steps
// of 64 bytes. For Cin % 16 == 0 a K-step is one tap (ky, kx) times 64
// channels of Cin, so each row of the A tile is a contiguous run of one input
// pixel's channels: 4 16-byte cp.async per row, with src-size 0 (zero fill)
// where the tap falls outside the image (SAME padding), past Cin (the weight
// layout pads each tap's Cin to 64 with zeros), or past M. Rows of the B tile
// are the weights of one output channel, laid out [Cout][K] (K-major, the
// `col` operand) once per device by the wrapper; rows past Cout zero-fill.
// Three stages of (A, B) tiles, 16 KB each, keep two K-steps in flight while
// one is multiplied. Shared tiles have 64-byte rows whose 16-byte chunks are
// XOR-swizzled with (row / 2) % 4, so the 8 row addresses of every ldmatrix
// phase hit 8 distinct 4-bank groups. Fragments come through ldmatrix.x4 and
// feed mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, two per K-step.
// For Cin % 16 != 0 (the input layer, Cin 1 or 4, when it is quantized) the
// taps are packed instead, K = kh*kw*Cin padded once to 64, and the A tile is
// gathered byte by byte with plain loads: slow, and off the served path.
// The epilogue runs on the accumulator fragments in registers and stores int8
// (mode 0, 2) or f32 (mode 1) straight into the NHWC output. Byte offsets are
// 64-bit (the tensors reach 2^30 bytes); pixel and channel indices are 32-bit,
// and the wrapper raises where B*H*W or the tile count would not fit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output pixels per block
constexpr int kBN = 128;      // output channels per block
constexpr int kBK = 64;       // K bytes per step
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kTileBytes = kBM * kBK;  // an A or a B tile (kBM == kBN)
constexpr int kSmemBytes = kStages * 2 * kTileBytes;
static_assert(kBM == kBN, "A and B tiles share one size");

enum Mode { kReluRequant = 0, kReluF32 = 1, kAffineRequant = 2 };

struct Params {
  const int8_t* x;   // [B, H, W, Cin]
  const int8_t* w;   // [Cout, kp]
  const float* ws;   // [Cout]
  const float* b;    // [Cout], modes 0 and 1
  const float* s;    // [Cout]
  const float* t;    // [Cout]
  const float* so;   // scalar, modes 0 and 2
  void* out;         // [B, H, W, Cout], int8 (modes 0, 2) or f32 (mode 1)
  int h, w_, cin, cout, kh, kw, kp;
  int m;             // B * H * W
  int n_tiles;       // ceil(Cout / kBN)
  int steps_per_tap; // aligned layout: ceil(Cin / kBK)
  int kvalid;        // packed layout: kh * kw * Cin
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` (0..3) of tile row `row`
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * kBK + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int size = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MODE>
__device__ __forceinline__ float affine(int acc, float ws, float b, float s, float t) {
  float y = __fmul_rn(__int2float_rn(acc), ws);
  if (MODE != kAffineRequant) y = fmaxf(__fadd_rn(y, b), 0.0f);
  return __fadd_rn(__fmul_rn(y, s), t);
}

__device__ __forceinline__ int requant(float y, float so) {
  const float q = rintf(__fdiv_rn(y, so));
  return __float2int_rn(fminf(fmaxf(q, -127.0f), 127.0f));
}

template <int MODE, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 2) int8_conv_kernel(const Params p) {
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 0..1: rows warp_m*64 ..
  const int warp_n = warp & 3;   // 0..3: columns warp_n*32 ..
  const int nt = (int)(blockIdx.x % (unsigned)p.n_tiles);
  const int m0 = (int)(blockIdx.x / (unsigned)p.n_tiles) * kBM;
  const int n0 = nt * kBN;
  const uint32_t base = smem_addr(smem);
  const int hw = p.h * p.w_;
  const int ksteps = p.kp / kBK;

  // Loader state. Aligned: thread tid copies chunk tid % 4 of tile rows
  // tid / 4 and tid / 4 + 64 of A and of B. Packed: thread tid gathers
  // bytes 32 * (tid % 2) .. + 31 of A row tid / 2 (B as aligned).
  // A pixel past M gets y far outside the image, so every tap zero-fills.
  constexpr int kRows = ALIGNED ? 2 : 1;
  int ay[kRows], ax[kRows];
  long long aoff[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ALIGNED ? (tid >> 2) + 64 * i : (tid >> 1);
    const int m = m0 + r;
    const int mm = m < p.m ? m : 0;
    const int rem = mm % hw;
    ay[i] = m < p.m ? rem / p.w_ : -(1 << 29);
    ax[i] = rem % p.w_;
    aoff[i] = (long long)mm * p.cin;
  }
  const int lchunk = tid & 3;
  const int8_t* brow[2];
  bool bok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + (tid >> 2) + 64 * i;
    bok[i] = n < p.cout;
    brow[i] = p.w + (long long)(bok[i] ? n : 0) * p.kp + lchunk * 16;
  }

  auto load_stage = [&](int step, int slot) {
    const uint32_t a_s = base + slot * 2 * kTileBytes;
    const uint32_t b_s = a_s + kTileBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp_async16(b_s + swz((tid >> 2) + 64 * i, lchunk), brow[i] + (long long)step * kBK,
                 bok[i]);
    if constexpr (ALIGNED) {
      const int tap = step / p.steps_per_tap;
      const int c0 = (step - tap * p.steps_per_tap) * kBK + lchunk * 16;
      const int ky = tap / p.kw;
      const int dy = ky - p.kh / 2;
      const int dx = tap - ky * p.kw - p.kw / 2;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int iy = ay[i] + dy, ix = ax[i] + dx;
        const bool ok = (unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w_ &&
                        c0 < p.cin;
        const int8_t* src =
            ok ? p.x + aoff[i] + ((long long)dy * p.w_ + dx) * p.cin + c0 : p.x;
        cp_async16(a_s + swz((tid >> 2) + 64 * i, lchunk), src, ok);
      }
    } else {
      const int r = tid >> 1;
      const int k0 = step * kBK + (tid & 1) * 32;
      uint32_t words[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) words[j] = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int k = k0 + j;
        const int tap = k / p.cin;
        const int c = k - tap * p.cin;
        const int ky = tap / p.kw;
        const int dy = ky - p.kh / 2;
        const int dx = tap - ky * p.kw - p.kw / 2;
        const int iy = ay[0] + dy, ix = ax[0] + dx;
        if (k < p.kvalid && (unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w_) {
          const uint32_t v =
              (uint8_t)p.x[aoff[0] + ((long long)dy * p.w_ + dx) * p.cin + c];
          words[j >> 2] |= v << (8 * (j & 3));
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t dst = a_s + swz(r, (tid & 1) * 2 + q);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                     "r"(words[4 * q]), "r"(words[4 * q + 1]), "r"(words[4 * q + 2]),
                     "r"(words[4 * q + 3]));
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ksteps) load_stage(st, st);
    cp_async_commit();
  }
  for (int step = 0; step < ksteps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step's tile is in; every warp is done with the slot refilled next
    const int next = step + kStages - 1;
    if (next < ksteps) load_stage(next, next % kStages);
    cp_async_commit();
    const uint32_t a_s = base + (step % kStages) * 2 * kTileBytes;
    const uint32_t b_s = a_s + kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t bf[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        const int n = warp_n * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(r, b_s + swz(n, kk * 2 + ((lane >> 3) & 1)));
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t af[4];
        const int row = warp_m * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(af, a_s + swz(row, kk * 2 + (lane >> 4)));
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af, bf[ni]);
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue on the C fragments: lane (g = lane / 4, q = lane % 4) holds
  // columns 2q, 2q + 1 of rows g and g + 8 of each 16 x 8 tile.
  const float so = MODE == kReluF32 ? 1.0f : __ldg(p.so);
  const bool even = (p.cout & 1) == 0;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + warp_n * 32 + ni * 8 + (lane & 3) * 2;
    if (n >= p.cout) continue;
    const bool two = n + 1 < p.cout;
    const int n1 = two ? n + 1 : n;
    const float ws0 = __ldg(p.ws + n), ws1 = __ldg(p.ws + n1);
    const float s0 = __ldg(p.s + n), s1 = __ldg(p.s + n1);
    const float t0 = __ldg(p.t + n), t1 = __ldg(p.t + n1);
    const float b0 = MODE == kAffineRequant ? 0.0f : __ldg(p.b + n);
    const float b1 = MODE == kAffineRequant ? 0.0f : __ldg(p.b + n1);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + warp_m * 64 + mi * 16 + (lane >> 2) + half * 8;
        if (m >= p.m) continue;
        const float y0 = affine<MODE>(acc[mi][ni][2 * half], ws0, b0, s0, t0);
        const float y1 = affine<MODE>(acc[mi][ni][2 * half + 1], ws1, b1, s1, t1);
        const long long off = (long long)m * p.cout + n;
        if (MODE == kReluF32) {
          float* o = static_cast<float*>(p.out) + off;
          if (two && even) {
            *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
          } else {
            o[0] = y0;
            if (two) o[1] = y1;
          }
        } else {
          const int q0 = requant(y0, so), q1 = requant(y1, so);
          int8_t* o = static_cast<int8_t*>(p.out) + off;
          if (two && even) {
            *reinterpret_cast<uint16_t*>(o) =
                (uint16_t)((uint8_t)(int8_t)q0 | ((uint16_t)(uint8_t)(int8_t)q1 << 8));
          } else {
            o[0] = (int8_t)q0;
            if (two) o[1] = (int8_t)q1;
          }
        }
      }
    }
  }
}

template <int MODE, bool ALIGNED>
cudaError_t launch(const Params& p, unsigned blocks, cudaStream_t stream) {
  auto kernel = int8_conv_kernel<MODE, ALIGNED>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool ALIGNED>
cudaError_t dispatch(const Params& p, int mode, unsigned blocks, cudaStream_t stream) {
  switch (mode) {
    case kReluRequant:
      return launch<kReluRequant, ALIGNED>(p, blocks, stream);
    case kReluF32:
      return launch<kReluF32, ALIGNED>(p, blocks, stream);
    case kAffineRequant:
      return launch<kAffineRequant, ALIGNED>(p, blocks, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: int8 [b, h, w, cin], 16-byte aligned; wm: int8 [cout, kp], laid out by
// tpuseg_torch/infer/int8_conv.py::_kernel_layout (cin % 16 == 0: each tap's
// cin padded to 64, kp = kh*kw*ceil(cin/64)*64; otherwise the taps packed,
// kp = ceil(kh*kw*cin/64)*64); ws, b, s, t: f32 [cout] (b unused, may be
// null, in mode 2); so: f32 scalar on the device (unused in mode 1); out:
// [b, h, w, cout], int8 for modes 0 and 2, f32 for mode 1. Launches on
// `stream` and returns the cudaError_t of the launch (0 on success); the
// caller checked devices, dtypes and contiguity.
int tpuseg_int8_conv(const void* x, const void* wm, const float* ws, const float* b,
                     const float* s, const float* t, const float* so, void* out, int n_img,
                     int h, int w, int cin, int cout, int kh, int kw, int kp, int mode,
                     void* stream) {
  if (n_img <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  if ((kh != 1 && kh != 3) || (kw != 1 && kw != 3)) return (int)cudaErrorInvalidValue;
  if (mode < 0 || mode > 2 || (mode != kAffineRequant && b == nullptr) ||
      (mode != kReluF32 && so == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool aligned = cin % 16 == 0;
  const long long taps = (long long)kh * kw;
  const long long want_kp = aligned ? taps * ((cin + kBK - 1) / kBK) * kBK
                                    : (taps * cin + kBK - 1) / kBK * kBK;
  if (kp != want_kp || (aligned && (reinterpret_cast<uintptr_t>(x) & 15)) ||
      (reinterpret_cast<uintptr_t>(wm) & 15))
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)n_img * h * w;
  const long long n_tiles = (cout + kBN - 1) / kBN;
  const long long blocks = (m + kBM - 1) / kBM * n_tiles;
  if (m >= (1LL << 31) || blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(wm);
  p.ws = ws;
  p.b = b;
  p.s = s;
  p.t = t;
  p.so = so;
  p.out = out;
  p.h = h;
  p.w_ = w;
  p.cin = cin;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.kp = kp;
  p.m = (int)m;
  p.n_tiles = (int)n_tiles;
  p.steps_per_tap = (cin + kBK - 1) / kBK;
  p.kvalid = (int)(taps * cin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return aligned ? (int)dispatch<true>(p, mode, (unsigned)blocks, st)
                 : (int)dispatch<false>(p, mode, (unsigned)blocks, st);
}

const char* tpuseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
