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
// operations a byte, above the H100's 1,979 TOP/s / 3.35 TB/s = 591. The
// operations counted are those the weights need: the blocked edge convs
// (enc1b, dec1a, dec1b of the int8_blocked walk) have exactly 3/4 structural
// zeros, so enc1b (x 8x512x512x256, 3x3, Cout 256) needs 0.62 TOP, 0.31 ms at
// the int8 peak, not the 2.47 TOP its dense shape would.
//
// Both routes: an implicit GEMM with M = output pixels, N = Cout and K =
// kh*kw*Cin, no im2col in device memory, in K-steps of 64 bytes. The weights
// are laid out [Cout][K] (K-major) once per device by the wrapper; for
// Cin % 16 == 0 a K-step is one tap (ky, kx) times 64 channels of Cin (each
// tap's Cin padded to 64 with zeros). Each N tile runs only the K-steps of its
// skip list: those whose codes are not all zero within the tile
// (int8_conv.py::_skip_lists), so the blocked convs' zero taps are neither
// loaded nor multiplied; a tile whose list is empty stores the epilogue of
// zero sums. The epilogue runs on the accumulators in registers and stores
// int8 (mode 0, 2) or f32 (mode 1) straight into the NHWC output. Byte offsets
// are 64-bit (the tensors reach 2^30 bytes); pixel and channel indices are
// 32-bit, and the wrapper raises where they would not fit.
//
// Route "wgmma" (Cin % 16 == 0: every block of the served walk). A block of
// 288 threads computes a 128-pixel x BN tile (BN 64, 128 or 256, chosen by the
// wrapper), the 128 pixels a bh x bw patch of one image (bw 16..128, bh =
// 128 / bw). Warp 8 is the producer: one thread walks the skip list and, for
// each K-step, waits for a free stage of a ring of 4-6 in shared memory, arms
// its mbarrier with the stage's bytes and issues two TMA loads: A, the box
// {64 channels, bw, bh, 1} of a 4-D tensor map over x {Cin, W, H, B} at the
// signed coordinates (c0, x0 + dx, y0 + dy, b), and B, the box {64, BN} of a
// 2-D map over the weights {kp, Cout}. TMA fills every coordinate outside the
// tensor with zeros, so SAME padding, the Cin tail and rows past Cout cost no
// code. Both maps use the 64-byte swizzle, 16-byte chunk c of 64-byte row r at
// r*64 + ((c ^ ((r >> 1) & 3)) << 4). Warps 0-7 are two consumer warpgroups
// of 64 pixels each: per K-step, two wgmma.m64nBNk32.s32.s8.s8 read A and B
// straight from the stage (descriptors with the 64B swizzle, 512 bytes between
// 8-row groups, +32 bytes for the second k32); each group stays in flight
// while the next is issued, and a stage goes back to the producer (one arrival
// per warpgroup on its `empty` barrier) once wgmma.wait_group says it has been
// read. The epilogue writes each warpgroup's int8 codes into a shared output
// tile and stores it as 16-byte row segments (the f32 mode stores from the
// registers); the patch's rows past H or W are masked there.
//
// The store forms (route "wgmma", int8 modes; they replace the walk's edge
// passes that XLA fused into the jitted predict on the TPU:
// tpuseg/infer/quant.py `_maxpool` :157, `phase_max` :651, the skip concats
// :590-594 and :688, `_d2s` :212). Each is a change of where the shared tile's
// 16-byte segments go, and all take Cout, the row stride and the phase width
// in multiples of 16, so a segment stays one run of one pixel's channels:
//   - a row stride `ostride` >= Cout: `out` points at a channel offset of a
//     wider NHWC buffer [B, H, W, ostride] (the walk's concat buffer, whose
//     other channels another launch fills);
//   - depth-to-space (`d2s_c` = C = Cout / 4): channel n = (py*2 + px)*C + c
//     of pixel (y, x) goes to pixel (2y + py, 2x + px), channel c, of a
//     [B, 2H, 2W, ostride] output;
//   - a second, pooled output from the same tile: "spatial", the 2x2/2 max of
//     each window (even H and W, patches of even height, bw <= 64; a window of
//     a 64-wide patch straddles the two warpgroups' rows, so both wait on one
//     barrier first), into [B, H/2, W/2, Cout]; "phase", the max over the four
//     phase groups n = phase*F + c of each pixel's channels, into [B, H, W,
//     F]: from the shared tile where one N tile holds Cout = 4F, or, where
//     each of the 4 N tiles is one phase (F = BN = 64: the blocked enc1b,
//     whose tiles then skip 3/4 of their K-steps, as the 256-wide tile
//     cannot), one block computes the 4 tiles in turn on one TMA ring and
//     keeps a running max of its codes in registers. Max over int8 codes is
//     exact and the phases share one scale, so both equal the max taken
//     after the store.
//   The pooled bytes are a quarter of the full-resolution ones; the separate
//   passes read the full-resolution codes back and wrote them again.
//
// Route "mma" (any Cin; the packed-tap layout of a quantized input layer, and
// the yardstick the new route is timed against): a block of 256 threads
// computes a 128 x 128 tile with 8 warps (2 along M x 4 along N, 64 x 32 each)
// from three cp.async stages of 16 KB; a row of A is a contiguous run of one
// input pixel's channels, 4 16-byte cp.async per row, with src-size 0 (zero
// fill) where the tap leaves the image, past Cin or past M. Shared tiles use
// the same swizzle, read through ldmatrix.x4 into
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, two per K-step. For
// Cin % 16 != 0 the taps are packed, K = kh*kw*Cin padded once to 64, and the
// A tile is gathered byte by byte with plain loads: slow, and off the served
// path. A persistent grid (tried: no faster, the per-tile epilogue is not
// overlapped with the next tile's products) and TMA stores are later work.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output pixels per tile (both routes)
constexpr int kBK = 64;   // K bytes per step (both routes)

enum Mode { kReluRequant = 0, kReluF32 = 1, kAffineRequant = 2 };
enum Route { kRouteMma = 0, kRouteWgmma = 1 };

// Errors of the tensor-map encoder, returned beside cudaError_t codes.
constexpr int kErrNoEncoder = -1;      // the driver has no cuTensorMapEncodeTiled
constexpr int kErrEncodeBase = -1000;  // -1000 - the CUresult of a refused encode

// ---- shared by both routes -------------------------------------------------

// The epilogue's operands (see the header).
struct Epi {
  const float* ws;  // [Cout]
  const float* b;   // [Cout], modes 0 and 1
  const float* s;   // [Cout]
  const float* t;   // [Cout]
  const float* so;  // scalar, modes 0 and 2
  void* out;        // [B, H, W, Cout], int8 (modes 0, 2) or f32 (mode 1)
  int cout;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The epilogue's per-channel vectors of output channels n and n1 (n1 == n
// where n is the last channel).
struct ChanPair {
  float ws0, ws1, b0, b1, s0, s1, t0, t1;
};

template <int MODE>
__device__ __forceinline__ ChanPair chan_pair(const Epi& e, int n, int n1) {
  ChanPair c;
  c.ws0 = __ldg(e.ws + n);
  c.ws1 = __ldg(e.ws + n1);
  c.s0 = __ldg(e.s + n);
  c.s1 = __ldg(e.s + n1);
  c.t0 = __ldg(e.t + n);
  c.t1 = __ldg(e.t + n1);
  c.b0 = MODE == kAffineRequant ? 0.0f : __ldg(e.b + n);
  c.b1 = MODE == kAffineRequant ? 0.0f : __ldg(e.b + n1);
  return c;
}

// Epilogue of the sums a0, a1 of channels n, n + 1 of one output pixel,
// stored at element `off` = pixel * Cout + n (`two`: n + 1 < Cout; with an
// even Cout the pair is one aligned store).
template <int MODE>
__device__ __forceinline__ void store_pair(const Epi& e, const ChanPair& c, long long off,
                                           bool two, int a0, int a1, float so) {
  const float y0 = affine<MODE>(a0, c.ws0, c.b0, c.s0, c.t0);
  const float y1 = affine<MODE>(a1, c.ws1, c.b1, c.s1, c.t1);
  const bool pair = two && (e.cout & 1) == 0;
  if (MODE == kReluF32) {
    float* o = static_cast<float*>(e.out) + off;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
    } else {
      o[0] = y0;
      if (two) o[1] = y1;
    }
  } else {
    const int q0 = requant(y0, so), q1 = requant(y1, so);
    int8_t* o = static_cast<int8_t*>(e.out) + off;
    if (pair) {
      *reinterpret_cast<uint16_t*>(o) =
          (uint16_t)((uint8_t)(int8_t)q0 | ((uint16_t)(uint8_t)(int8_t)q1 << 8));
    } else {
      o[0] = (int8_t)q0;
      if (two) o[1] = (int8_t)q1;
    }
  }
}

// ---- route "mma": cp.async + ldmatrix + mma.sync ---------------------------

constexpr int kMmaBN = 128;  // output channels per block
constexpr int kMmaStages = 3;
constexpr int kMmaThreads = 256;
constexpr int kMmaTileBytes = kBM * kBK;  // an A or a B tile (kBM == kMmaBN)
constexpr int kMmaSmemBytes = kMmaStages * 2 * kMmaTileBytes;
static_assert(kBM == kMmaBN, "A and B tiles share one size");

struct Params {
  const int8_t* x;   // [B, H, W, Cin]
  const int8_t* w;   // [Cout, kp]
  const int* steps;  // [n_tiles, list_stride]: each N tile's skip list
  const int* counts; // [n_tiles]
  Epi e;
  int h, w_, cin, cout, kh, kw, kp;
  int list_stride;   // kp / kBK
  int m;             // B * H * W
  int n_tiles;       // ceil(Cout / kMmaBN)
  int steps_per_tap; // aligned layout: ceil(Cin / kBK)
  int kvalid;        // packed layout: kh * kw * Cin
};

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

template <int MODE, bool ALIGNED>
__global__ void __launch_bounds__(kMmaThreads, 2) int8_conv_kernel(const Params p) {
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 0..1: rows warp_m*64 ..
  const int warp_n = warp & 3;   // 0..3: columns warp_n*32 ..
  const int nt = (int)(blockIdx.x % (unsigned)p.n_tiles);
  const int m0 = (int)(blockIdx.x / (unsigned)p.n_tiles) * kBM;
  const int n0 = nt * kMmaBN;
  const uint32_t base = smem_addr(smem);
  const int hw = p.h * p.w_;
  const int* list = p.steps + (long long)nt * p.list_stride;
  const int count = __ldg(p.counts + nt);

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

  // K-step `step` (a listed one) into stage `slot`
  auto load_stage = [&](int step, int slot) {
    const uint32_t a_s = base + slot * 2 * kMmaTileBytes;
    const uint32_t b_s = a_s + kMmaTileBytes;
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
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < count) load_stage(__ldg(list + st), st);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // step i's tile is in; every warp is done with the slot refilled next
    const int next = i + kMmaStages - 1;
    if (next < count) load_stage(__ldg(list + next), next % kMmaStages);
    cp_async_commit();
    const uint32_t a_s = base + (i % kMmaStages) * 2 * kMmaTileBytes;
    const uint32_t b_s = a_s + kMmaTileBytes;
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
  const float so = MODE == kReluF32 ? 1.0f : __ldg(p.e.so);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + warp_n * 32 + ni * 8 + (lane & 3) * 2;
    if (n >= p.cout) continue;
    const bool two = n + 1 < p.cout;
    const ChanPair c = chan_pair<MODE>(p.e, n, two ? n + 1 : n);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + warp_m * 64 + mi * 16 + (lane >> 2) + half * 8;
        if (m >= p.m) continue;
        store_pair<MODE>(p.e, c, (long long)m * p.cout + n, two, acc[mi][ni][2 * half],
                         acc[mi][ni][2 * half + 1], so);
      }
    }
  }
}

// ---- route "wgmma": TMA ring + warp-specialised wgmma ----------------------

constexpr int kWgThreads = 288;  // two consumer warpgroups, then the producer warp

template <int BN>
struct WgCfg {
  static constexpr int kStages = BN == 256 ? 6 : 4;
  static constexpr int kABytes = kBM * kBK;  // 8 KB: 128 pixels x 64 bytes
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kStageBytes = kABytes + kBBytes;  // a multiple of 1024
  // the int8 output tile, rows padded by 16 bytes against bank conflicts
  static constexpr int kOutStride = BN + 16;
  static constexpr int kOutBytes = kBM * kOutStride;
  // the stages, the output tile, the full and empty barriers, and slack to
  // align to 1024
  static constexpr int kSmemBytes = kStages * kStageBytes + kOutBytes + 16 * kStages + 1024;
  static constexpr int kMinBlocks = BN == 256 ? 1 : 2;
};

enum Pool { kPoolNone = 0, kPoolSpatial = 1, kPoolPhase = 2 };

struct WParams {
  const int* steps;   // [n_tiles, list_stride]: each N tile's skip list
  const int* counts;  // [n_tiles]
  Epi e;
  int8_t* pooled;     // the pooled output (pool != kPoolNone)
  int ostride;        // elements between pixels of e.out (Cout, or a buffer's width)
  int d2s_c;          // depth-to-space's phase width C, 0 for none
  int pool;           // a Pool
  int h, w_, kh, kw;
  int list_stride;    // kp / kBK
  int steps_per_tap;  // ceil(Cin / kBK)
  int bw_log2;        // patch width bw = 1 << bw_log2, height kBM >> bw_log2
  int tiles_x, tiles_y, n_tiles;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 64-byte rows in the 64-byte swizzle:
// start address >> 4 (bits 0-13), leading byte offset unused for swizzled
// K-major tiles (1), 512 bytes between 8-row groups (bits 32-45, in 16-byte
// units), layout type 2 = 64B swizzle (bits 62-63). The tile's 512-byte
// swizzle atoms are aligned, so the base offset is 0; +32 bytes on `addr`
// selects the second k32 of a 64-byte K-step.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
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

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma (their values change behind its back until the wait).
template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x N] += A[64 x 32] * B[N x 32]^T, s8 x s8 -> s32, both from shared
// memory; thread t of the warpgroup holds, for each 8-column group j,
// d[4j], d[4j + 1] at row 16 * (t / 32) + (t % 32) / 4, columns 8j + 2 * (t % 4)
// + {0, 1}, and d[4j + 2], d[4j + 3] 8 rows below.
__device__ __forceinline__ void wgmma_m64n64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k32(int* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_m64n64(d, da, db);
  } else if constexpr (BN == 128) {
    wgmma_m64n128(d, da, db);
  } else {
    wgmma_m64n256(d, da, db);
  }
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// the bytewise max of 16 int8 codes
__device__ __forceinline__ uint4 vmax16(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y), __vmaxs4(a.z, b.z),
                    __vmaxs4(a.w, b.w));
}

// LOOPED: the block computes every N tile of its patch in turn (a phase max
// whose 4 phases are one N tile each); its own instances, so the others keep
// their registers, held to 72 a thread so that 3 blocks share an SM as the
// 64-wide instances do
template <int MODE, int BN, bool LOOPED>
__global__ void __launch_bounds__(kWgThreads, LOOPED ? 3 : WgCfg<BN>::kMinBlocks)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap, const WParams p) {
  using Cfg = WgCfg<BN>;
  extern __shared__ uint8_t wsmem[];
  const uint32_t base = (smem_addr(wsmem) + 1023u) & ~1023u;
  const uint32_t out_tile = base + Cfg::kStages * Cfg::kStageBytes;
  const uint32_t full0 = out_tile + Cfg::kOutBytes;  // full[s] at full0 + 8s
  const uint32_t empty0 = full0 + 8 * Cfg::kStages;
  const int tid = threadIdx.x;
  // A block computes kTiles consecutive N tiles of one patch (the looped
  // phase max: its 4 phases; a constant, so that the other instances are
  // the straight-line kernel)
  constexpr int kTiles = LOOPED ? 4 : 1;
  const int groups = p.n_tiles / kTiles;
  const int nt0 = (int)(blockIdx.x % (unsigned)groups) * kTiles;
  int mt = (int)(blockIdx.x / (unsigned)groups);
  const int tx = mt % p.tiles_x;
  mt /= p.tiles_x;
  const int ty = mt % p.tiles_y;
  const int img = mt / p.tiles_y;
  const int x0 = tx << p.bw_log2;
  const int y0 = ty * (kBM >> p.bw_log2);

  if (tid == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's arrival + the stage's bytes
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp: one thread issues every load
    if (tid == 256) {
      int g = 0;  // K-steps issued by this block, over its N tiles
      for (int k = 0; k < kTiles; ++k) {
        const int nt = nt0 + k;
        const int* list = p.steps + (long long)nt * p.list_stride;
        const int count = __ldg(p.counts + nt);
        for (int i = 0; i < count; ++i, ++g) {
          const int slot = g % Cfg::kStages;
          // a fresh barrier's phase "before 0" counts as complete: the first
          // round finds every stage free
          mbar_wait(empty0 + 8 * slot, ((g / Cfg::kStages) & 1) ^ 1);
          const int step = __ldg(list + i);
          const int tap = step / p.steps_per_tap;
          const int c0 = (step - tap * p.steps_per_tap) * kBK;
          const int ky = tap / p.kw;
          const int dy = ky - p.kh / 2;
          const int dx = tap - ky * p.kw - p.kw / 2;
          const uint32_t a = base + slot * Cfg::kStageBytes;
          const uint32_t bar = full0 + 8 * slot;
          mbar_expect_tx(bar, Cfg::kStageBytes);  // zero-filled bytes count too
          tma_load_4d(a, &xmap, bar, c0, x0 + dx, y0 + dy, img);
          tma_load_2d(a + Cfg::kABytes, &wmap, bar, step * kBK, nt * BN);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: patch rows 64 * wg .. 64 * wg + 63 (the
  // epilogue's indices are computed after the products, whose sums hold the
  // registers)
  const int wg = tid >> 7;
  // the looped phase max: each thread's running max of its codes over the
  // block's N tiles (one phase each), four codes a word: columns 2q, 2q + 1
  // of rows g and g + 8 of each 8-column group
  uint32_t pmax[LOOPED ? BN / 8 : 1];
#pragma unroll
  for (int j = 0; j < (LOOPED ? BN / 8 : 1); ++j) pmax[j] = 0x80808080u;
  int g0 = 0;  // K-steps this block consumed for its earlier N tiles
  // the block's k-th N tile: products, epilogue and stores
  auto tile = [&](const int k) {
    const int nt = nt0 + k;
    const int n0 = nt * BN;
    const int count = __ldg(p.counts + nt);
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int i = 0; i < count; ++i) {
      const int g = g0 + i;
      const int slot = g % Cfg::kStages;
      mbar_wait(full0 + 8 * slot, (g / Cfg::kStages) & 1);
      const uint32_t a = base + slot * Cfg::kStageBytes + wg * (64 * kBK);
      const uint32_t b = base + slot * Cfg::kStageBytes + Cfg::kABytes;
      wgmma_fence();
      wgmma_k32<BN>(acc, smem_desc(a), smem_desc(b));
      wgmma_k32<BN>(acc, smem_desc(a + 32), smem_desc(b + 32));
      wgmma_commit();
      wgmma_wait<1>();  // step g - 1's products are done: its stage has been read
      if (i > 0 && (tid & 127) == 0) mbar_arrive(empty0 + 8 * ((g - 1) % Cfg::kStages));
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc);
    g0 += count;
    if constexpr (LOOPED) {  // the tile's last stage goes back: the next N tile reuses the ring
      if (count > 0 && (tid & 127) == 0) mbar_arrive(empty0 + 8 * ((g0 - 1) % Cfg::kStages));
    }
    const int t = tid & 127;
    const int lane = t & 31;
    const uint32_t rows = out_tile + wg * 64 * Cfg::kOutStride;

    if constexpr (MODE == kReluF32) {
      // the f32 head (off the served path): straight from the registers
      long long off[2];
      bool ok[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wg * 64 + (t >> 5) * 16 + (lane >> 2) + 8 * i;  // row of the patch
        const int y = y0 + (r >> p.bw_log2);
        const int x = x0 + (r & ((1 << p.bw_log2) - 1));
        ok[i] = y < p.h && x < p.w_;
        off[i] = (((long long)img * p.h + y) * p.w_ + x) * p.e.cout;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + j * 8 + (lane & 3) * 2;
        if (n >= p.e.cout) continue;
        const bool two = n + 1 < p.e.cout;
        const ChanPair c = chan_pair<MODE>(p.e, n, two ? n + 1 : n);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (ok[i])
            store_pair<MODE>(p.e, c, off[i] + n, two, acc[4 * j + 2 * i],
                             acc[4 * j + 2 * i + 1], 1.0f);
      }
    } else {
      // int8 codes: into the warpgroup's 64 rows of the shared output tile,
      // then out as 16-byte row segments, consecutive threads on consecutive
      // bytes of a pixel's channels
      if (k > 0) {  // the warpgroup has stored the previous tile's rows
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
      const float so = __ldg(p.e.so);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        const int n = n0 + col;
        if (n >= p.e.cout) continue;
        const bool two = n + 1 < p.e.cout;
        const ChanPair c = chan_pair<MODE>(p.e, n, two ? n + 1 : n);
        uint32_t both = 0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q0 = requant(affine<MODE>(acc[4 * j + 2 * i], c.ws0, c.b0, c.s0, c.t0), so);
          const int q1 =
              requant(affine<MODE>(acc[4 * j + 2 * i + 1], c.ws1, c.b1, c.s1, c.t1), so);
          const int rr = (t >> 5) * 16 + (lane >> 2) + 8 * i;
          const uint16_t v =
              (uint16_t)((uint8_t)(int8_t)q0 | ((uint16_t)(uint8_t)(int8_t)q1 << 8));
          both |= (uint32_t)v << (16 * i);
          asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(rows + rr * Cfg::kOutStride + col),
                       "h"(v)
                       : "memory");
        }
        if constexpr (LOOPED) pmax[j] = __vmaxs4(pmax[j], both);
      }
      if (p.pool == kPoolNone || LOOPED) {
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
      } else {
        asm volatile("bar.sync 3, 256;\n" ::: "memory");  // the pooled reads cross warpgroups
      }
      constexpr int kChunks = BN / 16;
      const bool vec = (p.e.cout & 15) == 0 && (p.ostride & 15) == 0;
      int8_t* out = static_cast<int8_t*>(p.e.out);
      for (int c = t; c < 64 * kChunks; c += 128) {
        const int rr = c / kChunks;
        const int col = (c - rr * kChunks) * 16;
        const int r = wg * 64 + rr;
        const int y = y0 + (r >> p.bw_log2);
        const int x = x0 + (r & ((1 << p.bw_log2) - 1));
        const int n = n0 + col;
        if (y >= p.h || x >= p.w_ || n >= p.e.cout) continue;
        const uint4 v = ld_shared16(rows + rr * Cfg::kOutStride + col);
        long long off;
        if (p.d2s_c) {  // channel n = (py * 2 + px) * C + c -> pixel (2y + py, 2x + px), channel c
          const int ph = n / p.d2s_c;
          off = (((long long)img * 2 * p.h + 2 * y + (ph >> 1)) * (2 * p.w_) + 2 * x +
                 (ph & 1)) * p.ostride + (n - ph * p.d2s_c);
        } else {
          off = (((long long)img * p.h + y) * p.w_ + x) * p.ostride + n;
        }
        int8_t* o = out + off;
        if (vec && n + 16 <= p.e.cout) {
          *reinterpret_cast<uint4*>(o) = v;
        } else {
          const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
          for (int k = 0; k < 16 && n + k < p.e.cout; ++k)
            o[k] = (int8_t)(wv[k >> 2] >> (8 * (k & 3)));
        }
      }
      if (p.pool == kPoolSpatial) {
        // the bh/2 x bw/2 windows of the patch (its origin and H, W even), all
        // 256 consumer threads over the whole tile
        const int pw_log2 = p.bw_log2 - 1;
        const int hp = p.h >> 1, wp = p.w_ >> 1;
        const uint32_t below = (uint32_t)(Cfg::kOutStride << p.bw_log2);  // one patch row down
        for (int c = tid; c < (kBM / 4) * kChunks; c += 256) {
          const int q = c / kChunks;
          const int col = (c - q * kChunks) * 16;
          const int pr = q >> pw_log2, pc = q & ((1 << pw_log2) - 1);
          const int yy = (y0 >> 1) + pr, xx = (x0 >> 1) + pc;
          const int n = n0 + col;
          if (yy >= hp || xx >= wp || n >= p.e.cout) continue;
          const uint32_t s0 =
              out_tile + ((2 * pr << p.bw_log2) + 2 * pc) * Cfg::kOutStride + col;
          const uint4 m = vmax16(vmax16(ld_shared16(s0), ld_shared16(s0 + Cfg::kOutStride)),
                                 vmax16(ld_shared16(s0 + below),
                                        ld_shared16(s0 + below + Cfg::kOutStride)));
          *reinterpret_cast<uint4*>(p.pooled + (((long long)img * hp + yy) * wp + xx) *
                                                   p.e.cout + n) = m;
        }
      } else if (p.pool == kPoolPhase && !LOOPED) {
        // channel n = phase * F + c of each pixel of the patch (n0 = 0, Cout = 4F)
        const int f = p.e.cout >> 2;
        const int fchunks = f >> 4;
        for (int c = tid; c < kBM * fchunks; c += 256) {
          const int r = c / fchunks;
          const int col = (c - r * fchunks) * 16;
          const int y = y0 + (r >> p.bw_log2);
          const int x = x0 + (r & ((1 << p.bw_log2) - 1));
          if (y >= p.h || x >= p.w_) continue;
          const uint32_t s0 = out_tile + r * Cfg::kOutStride + col;
          const uint4 m = vmax16(vmax16(ld_shared16(s0), ld_shared16(s0 + f)),
                                 vmax16(ld_shared16(s0 + 2 * f), ld_shared16(s0 + 3 * f)));
          *reinterpret_cast<uint4*>(p.pooled + (((long long)img * p.h + y) * p.w_ + x) * f +
                                    col) = m;
        }
      }
    }
  };
  if constexpr (LOOPED) {  // one copy of the tile's code, not four
#pragma unroll 1
    for (int k = 0; k < kTiles; ++k) tile(k);
  } else {
    tile(0);
  }
  if constexpr (MODE != kReluF32 && LOOPED) {
    const int t = tid & 127;
    const int lane = t & 31;
    const uint32_t rows = out_tile + wg * 64 * Cfg::kOutStride;
    {
      // the phase max of the block's 4 N tiles (F = BN): the running max into
      // the warpgroup's rows of the shared tile, then out as 16-byte segments
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the last tile is stored
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rr = (t >> 5) * 16 + (lane >> 2) + 8 * i;
          asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(rows + rr * Cfg::kOutStride + col),
                       "h"((uint16_t)(pmax[j] >> (16 * i)))
                       : "memory");
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      constexpr int kChunks = BN / 16;
      for (int c = t; c < 64 * kChunks; c += 128) {
        const int rr = c / kChunks;
        const int col = (c - rr * kChunks) * 16;
        const int r = wg * 64 + rr;
        const int y = y0 + (r >> p.bw_log2);
        const int x = x0 + (r & ((1 << p.bw_log2) - 1));
        if (y >= p.h || x >= p.w_) continue;
        *reinterpret_cast<uint4*>(p.pooled + (((long long)img * p.h + y) * p.w_ + x) * BN +
                                  col) = ld_shared16(rows + rr * Cfg::kOutStride + col);
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------

template <int MODE, bool ALIGNED>
cudaError_t launch_mma(const Params& p, unsigned blocks, cudaStream_t stream) {
  auto kernel = int8_conv_kernel<MODE, ALIGNED>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemBytes);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kMmaThreads, kMmaSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool ALIGNED>
cudaError_t dispatch_mma(const Params& p, int mode, unsigned blocks, cudaStream_t stream) {
  switch (mode) {
    case kReluRequant:
      return launch_mma<kReluRequant, ALIGNED>(p, blocks, stream);
    case kReluF32:
      return launch_mma<kReluF32, ALIGNED>(p, blocks, stream);
    case kAffineRequant:
      return launch_mma<kAffineRequant, ALIGNED>(p, blocks, stream);
  }
  return cudaErrorInvalidValue;
}

template <int MODE, int BN, bool LOOPED = false>
cudaError_t launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap, const WParams& p,
                         unsigned blocks, cudaStream_t stream) {
  auto kernel = int8_conv_wgmma_kernel<MODE, BN, LOOPED>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WgCfg<BN>::kSmemBytes);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kWgThreads, WgCfg<BN>::kSmemBytes, stream>>>(xmap, wmap, p);
  return cudaGetLastError();
}

template <int BN>
cudaError_t dispatch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap, const WParams& p,
                           int mode, bool looped, unsigned blocks, cudaStream_t stream) {
  if constexpr (BN == 64) {
    if (looped) {  // the phase max of 4 N tiles, a phase each (an int8 mode)
      if (mode == kReluRequant)
        return launch_wgmma<kReluRequant, 64, true>(xmap, wmap, p, blocks, stream);
      if (mode == kAffineRequant)
        return launch_wgmma<kAffineRequant, 64, true>(xmap, wmap, p, blocks, stream);
      return cudaErrorInvalidValue;
    }
  }
  switch (mode) {
    case kReluRequant:
      return launch_wgmma<kReluRequant, BN>(xmap, wmap, p, blocks, stream);
    case kReluF32:
      return launch_wgmma<kReluF32, BN>(xmap, wmap, p, blocks, stream);
    case kAffineRequant:
      return launch_wgmma<kAffineRequant, BN>(xmap, wmap, p, blocks, stream);
  }
  return cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled is a driver function: it is taken from the runtime's
// entry-point query, so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess && f != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// A tiled uint8 tensor map with the 64-byte swizzle; out-of-range
// coordinates read as zero. Returns 0 or one of the kErr* codes.
int encode_map(CUtensorMap* map, const void* ptr, cuuint32_t rank, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), dims, strides, box,
         elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase - (int)r;
}

}  // namespace

extern "C" {

// x: int8 [n_img, h, w, cin], 16-byte aligned; wm: int8 [cout, kp], laid out
// by tpuseg_torch/infer/int8_conv.py::_kernel_layout (cin % 16 == 0: each
// tap's cin padded to 64, kp = kh*kw*ceil(cin/64)*64; otherwise the taps
// packed, kp = ceil(kh*kw*cin/64)*64); ws, b, s, t: f32 [cout] (b unused, may
// be null, in mode 2); so: f32 scalar on the device (unused in mode 1); out:
// [n_img, h, w, out_stride] (channels 0..cout-1 written), int8 for modes 0
// and 2, f32 for mode 1; with d2s, [n_img, 2h, 2w, out_stride] and channel n
// = (py*2 + px) * cout/4 + c written to pixel (2y + py, 2x + px), channel c
// (channels 0..cout/4-1 written);
// pooled (pool 1, "spatial"): int8 [n_img, h/2, w/2, cout], the 2x2/2 max;
// (pool 2, "phase"): int8 [n_img, h, w, cout/4], the max over the 4 phase
// groups of channels (cout <= bn, or cout == 4 * bn with bn 64: one block
// computes the 4 N tiles); steps, counts: int32 [ceil(cout/bn), list_stride] and
// [ceil(cout/bn)], each N tile's skip list (int8_conv.py::_skip_lists),
// list_stride = kp / 64. route 0 ("mma") takes bn 128 and no store form
// (out_stride == cout, no d2s, pool 0); route 1 ("wgmma") takes cin % 16 ==
// 0, bn 64, 128 or 256 and the patch width bw 16, 32, 64 or 128, and the
// store forms in modes 0 and 2 where cout and out_stride are multiples of 16,
// out and pooled 16-byte aligned, d2s's cout/4 a multiple of 16 (no pool),
// "spatial" with h, w even and bw <= 64, "phase" with cout/4 a multiple of 16
// and cout <= bn or cout == 4 * bn == 256. Launches on `stream` and returns 0, the cudaError_t of the
// launch, or a negative code of the tensor-map encoder
// (tpuseg_cuda_error_string names each); the caller checked devices, dtypes
// and contiguity.
int tpuseg_int8_conv(const void* x, const void* wm, const float* ws, const float* b,
                     const float* s, const float* t, const float* so, void* out, int out_stride,
                     int d2s, void* pooled, int pool, const int* steps, const int* counts,
                     int list_stride, int n_img, int h, int w, int cin, int cout, int kh, int kw,
                     int kp, int mode, int route, int bn, int bw, void* stream) {
  if (n_img <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  if ((kh != 1 && kh != 3) || (kw != 1 && kw != 3)) return (int)cudaErrorInvalidValue;
  if (mode < 0 || mode > 2 || (mode != kAffineRequant && b == nullptr) ||
      (mode != kReluF32 && so == nullptr) || steps == nullptr || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool forms = out_stride != cout || d2s != 0 || pool != kPoolNone;
  if (forms) {
    const bool aligned16 = (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                           (reinterpret_cast<uintptr_t>(pooled) & 15) == 0;
    if (route != kRouteWgmma || mode == kReluF32 || out_stride < (d2s ? cout / 4 : cout) ||
        out_stride % 16 ||
        cout % 16 || !aligned16 || pool < kPoolNone || pool > kPoolPhase ||
        (pool != kPoolNone) != (pooled != nullptr) || (d2s && (cout % 64 || pool)) ||
        (pool == kPoolSpatial && (h % 2 || w % 2 || bw > 64)) ||
        (pool == kPoolPhase && (cout % 64 || (cout > bn && (cout != 4 * bn || bn != 64)))))
      return (int)cudaErrorInvalidValue;
  }
  const bool aligned = cin % 16 == 0;
  const long long taps = (long long)kh * kw;
  const long long want_kp = aligned ? taps * ((cin + kBK - 1) / kBK) * kBK
                                    : (taps * cin + kBK - 1) / kBK * kBK;
  if (kp != want_kp || list_stride != kp / kBK ||
      (aligned && (reinterpret_cast<uintptr_t>(x) & 15)) ||
      (reinterpret_cast<uintptr_t>(wm) & 15))
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)n_img * h * w;
  if (m >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const Epi e = {ws, b, s, t, so, out, cout};
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (route == kRouteMma) {
    if (bn != kMmaBN) return (int)cudaErrorInvalidValue;
    const long long n_tiles = (cout + kMmaBN - 1) / kMmaBN;
    const long long blocks = (m + kBM - 1) / kBM * n_tiles;
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    Params p;
    p.x = static_cast<const int8_t*>(x);
    p.w = static_cast<const int8_t*>(wm);
    p.steps = steps;
    p.counts = counts;
    p.e = e;
    p.h = h;
    p.w_ = w;
    p.cin = cin;
    p.cout = cout;
    p.kh = kh;
    p.kw = kw;
    p.kp = kp;
    p.list_stride = list_stride;
    p.m = (int)m;
    p.n_tiles = (int)n_tiles;
    p.steps_per_tap = (cin + kBK - 1) / kBK;
    p.kvalid = (int)(taps * cin);
    return aligned ? (int)dispatch_mma<true>(p, mode, (unsigned)blocks, st)
                   : (int)dispatch_mma<false>(p, mode, (unsigned)blocks, st);
  }

  if (route != kRouteWgmma || !aligned || (bn != 64 && bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  int bw_log2 = -1;
  for (int l = 4; l <= 7; ++l)
    if (bw == (1 << l)) bw_log2 = l;
  if (bw_log2 < 0) return (int)cudaErrorInvalidValue;
  const int bh = kBM / bw;
  WParams p;
  p.steps = steps;
  p.counts = counts;
  p.e = e;
  p.h = h;
  p.w_ = w;
  p.kh = kh;
  p.kw = kw;
  p.list_stride = list_stride;
  p.steps_per_tap = (cin + kBK - 1) / kBK;
  p.bw_log2 = bw_log2;
  p.tiles_x = (w + bw - 1) / bw;
  p.tiles_y = (h + bh - 1) / bh;
  p.n_tiles = (cout + bn - 1) / bn;
  p.pooled = static_cast<int8_t*>(pooled);
  p.ostride = out_stride;
  p.d2s_c = d2s ? cout / 4 : 0;
  p.pool = pool;
  const bool looped = pool == kPoolPhase && cout > bn;  // 4 N tiles of 64, a phase each
  const long long blocks = (long long)n_img * p.tiles_y * p.tiles_x * (looped ? 1 : p.n_tiles);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;

  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h,
                               (cuuint64_t)n_img};
  const cuuint64_t xstrides[3] = {(cuuint64_t)cin, (cuuint64_t)w * cin,
                                  (cuuint64_t)h * w * cin};
  const cuuint32_t xbox[4] = {(cuuint32_t)kBK, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  int err = encode_map(&xmap, x, 4, xdims, xstrides, xbox);
  if (err != 0) return err;
  const cuuint64_t wdims[2] = {(cuuint64_t)kp, (cuuint64_t)cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)kp};
  const cuuint32_t wbox[2] = {(cuuint32_t)kBK, (cuuint32_t)bn};
  err = encode_map(&wmap, wm, 2, wdims, wstrides, wbox);
  if (err != 0) return err;
  switch (bn) {
    case 64:
      return (int)dispatch_wgmma<64>(xmap, wmap, p, mode, looped, (unsigned)blocks, st);
    case 128:
      return (int)dispatch_wgmma<128>(xmap, wmap, p, mode, false, (unsigned)blocks, st);
    default:
      return (int)dispatch_wgmma<256>(xmap, wmap, p, mode, false, (unsigned)blocks, st);
  }
}

// Dynamic shared memory of a block of `route` at N-tile width `bn`, in
// bytes (0 for a width the route does not take).
int tpuseg_int8_conv_smem_bytes(int route, int bn) {
  if (route == kRouteMma) return bn == kMmaBN ? kMmaSmemBytes : 0;
  switch (bn) {
    case 64:
      return WgCfg<64>::kSmemBytes;
    case 128:
      return WgCfg<128>::kSmemBytes;
    case 256:
      return WgCfg<256>::kSmemBytes;
  }
  return 0;
}

const char* tpuseg_cuda_error_string(int err) {
  if (err == kErrNoEncoder) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err <= kErrEncodeBase)
    return "cuTensorMapEncodeTiled refused the tensor map (the code is -1000 - its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
