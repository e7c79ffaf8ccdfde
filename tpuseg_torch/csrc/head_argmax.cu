// The int8 serving walks' 1x1 head + first-max argmax, for Hopper: K2, the
// blocked walk's (with its per-phase argmax and depth-to-space), and K6, the
// dense walk's. One source, one set of routes: the layout is a template
// parameter.
//
// K2 replaces the TPU kernel tpuseg/infer/head_kernel.py::_head_kernel
// (Pallas, called through _head_pallas). Same contract as
// tpuseg_torch/infer/head_kernel.py::_blocked_head_argmax_plain: per blocked
// pixel (b, i, j) of the phase-major dec1b edge x[B, h, w, C4],
//   fp head:   xf[k] = round_to_wt_type(float(x[k]) * sv[k]),
//              y[o]  = sum_k xf[k] * wt[o, k]                     (f32)
//   int8 head: y[o]  = float(sum_k x[k] * wt[o, k] in int32) * epi[3][o]
//   then       y[o]  = max(y[o] + epi[0][o], 0) * epi[1][o] + epi[2][o],
// a first-max argmax over the classes of each phase p = dy*2 + dx (rows
// p*ncls .. p*ncls+ncls-1), and the label is written straight to
// out[b, 2i+dy, 2j+dx]: the logits never exist in device memory.
//
// K6 replaces what XLA fused on the TPU at the end of the dense int8 walk:
// conv_block's head (tpuseg/infer/quant.py:544-560: dequant or the int8 conv
// times wscale, + b, ReLU, * s + t, f32 logits) and predict's argmax
// (:785-786). Same contract as _dense_head_argmax_plain: per pixel n of the
// dense dec1b edge x[B, H, W, C] (int8), with wt[ncls, C] and epi[4, ncls],
// the same y[o] as above over its C channels, a first-max argmax over its
// ncls classes, and the int32 label written to out[n] of out[B, H, W].
//
// Bound: memory, for both. At K2's serving shape (B=8, h=w=512, C4=256 int8,
// ncls=2) the kernel must read 8*512*512*256 B = 537 MB and write
// 8*1024*1024*4 B = 34 MB: 170 us at 3.35 TB/s, against 8.6 GFLOP of
// multiply-adds (9 us on the bf16 tensor cores). K6's serving shape
// (B=8, H=W=1024, C=64) moves the same bytes and needs a quarter of the
// multiply-adds. Every input byte is read once, as a stream: nothing is
// reused but the head's few KB of constants.
//
// Layouts (template parameter DENSE). Both routes see x as rows of four
// sub-pixels, each with its own class rows o = p*ncls + c:
//  - blocked (K2): a row is one blocked pixel of C4 = 4C channels, its
//    sub-pixels the four phases; the weight is [4*ncls, C4];
//  - dense (K6): a row is four consecutive pixels 4n .. 4n+3 of the dense
//    edge, C4 = 4C bytes apart from the next row. The kernel stages the
//    [ncls, C] weight as the block-diagonal [4*ncls, 4C] one (sub-pixel p's
//    classes see only its own C channels), sv tiled 4 times and epi's rows
//    tiled 4 times, so the mma route's loads, fragments and epilogue are
//    K2's, at the same 16 rows x 256 bytes a warp tile at C = 64. A warp
//    tile of 16 single 64-byte pixels would stream a quarter of that per
//    load and leave the HBM pipe short of requests; the block-diagonal
//    zeros cost 4x tensor-core work, which the memory bound hides: K2's
//    8.6 GFLOP, 9 us of bf16 mma against 170 us of bytes. The last row may hold 1-3 pixels:
//    the pieces of missing pixels load zeros and their labels are not
//    written. The general route keeps one thread per dense pixel.
//
// Two routes, chosen by the caller (the Python wrapper) from dtypes alone and
// passed in as `route`:
//
// * mma (head_mma_kernel, dense_head_mma_kernel): x int8 with a bf16 weight
//   (fp head, the served default) or an int8 weight (int8 head), any ncls
//   1..8, C4 % 16 == 0 (C % 16 == 0 dense).
// * general (head_fp_kernel, dense_head_fp_kernel): the fp head's other
//   inputs, i.e. an f32 weight (the f32 walk) or, blocked only, an fp edge
//   into the head (x bf16 or f32, sv all ones). Tensor cores cannot form
//   f32 x f32 products exactly, and those inputs are off the serving path.
//   (The int8 head takes only int8 x and wt: always mma.)
//
// What held the first design (the general route, one thread per blocked pixel)
// at 35-38% of the bound, measured on an H100 at 0.49 ms (fp head) and 0.44 ms
// (int8 head) against 0.170 ms:
//  1. uncoalesced rows: each thread streams its own 256-byte pixel row in
//     16-byte pieces, so one warp load touches 32 rows 256 B apart and uses
//     half of each 32-byte sector; the other half must survive in an L1 shared
//     by 2048 rows in flight, and the int8 head (cheap __dp4a arithmetic) runs
//     no faster than that access pattern allows;
//  2. the fp head converts every int8 value on the conversion unit (16 a clock
//     per SM) and then does 2*NMAX FMAs and shared weight loads per value on
//     the CUDA cores.
//
// The mma route. A warp owns 16 consecutive blocked pixels (a tile) at a time,
// in a grid-stride loop, and loads the next tile before it multiplies this one.
// A dot product does not care about the order of k, so the loads are chosen to
// be coalesced and to be mma fragments as they arrive: lane (g = lane/4,
// t = lane%4) loads the 16 bytes at channel 64q + 16t of pixel rows g and g+8,
// for q = 0 .. C4/64 - 1 (in chunks of 4 q, 256 channels). One load instruction
// thus reads 8 rows x 64 contiguous bytes and uses every sector it fetches.
// Those 16 bytes (words w0..w3) become the lane's A-fragment slots:
//  - int8 head, mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, two k-steps
//    s = 0, 1 per q: slots 4t..4t+3 <- w[2s], slots 4t+16..4t+19 <- w[2s+1]
//    (row g's words in a0/a2, row g+8's in a1/a3). The s32 sum is exact.
//  - fp head, mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, four
//    k-steps j = 0..3 per q: slots 2t, 2t+1 <- channels 4j, 4j+1 of the 16 and
//    slots 2t+8, 2t+9 <- 4j+2, 4j+3, each dequantised as bf16(float(x) * sv):
//    the byte, XOR 0x80, goes into the mantissa of 2^23 (PRMT), 2^23 + 128 is
//    subtracted (exact), then __fmul_rn by sv and __floats2bfloat162_rn on the
//    pair: the plain version's rounding, with no int-to-float conversion.
// The B fragments (the weights, output o = 8*nt + g in column g of n-tile nt)
// hold the same permutation: lane (g, t) holds row o's 16 channels at
// 64q + 16t. They are staged once per block in shared memory in fragment
// order (one conflict-free 16-byte read per lane), and at ncls <= 2 with
// C4 <= 256 copied into registers (16 of them for int8, 32 for bf16). sv is
// staged as [q][j][t][4] so a lane's float4 read is conflict-free. A ragged
// k-range (C4 = 16, 32, 48, ...) loads zeros and carries zero weights.
// Epilogue: the m16n8 C fragment gives lane (g, t) outputs 2t, 2t+1 of pixels
// g and g+8. At ncls = 2 those are phase t's two classes, so the first-max
// argmax is lane-local and the lane writes labels (2i+dy, 2j+dx), t = 2dy+dx.
// Other ncls stage the warp's 16 x 8*NT results in a per-warp shared scratch
// and finish as the general route does. The epilogue rounds in the _rn
// intrinsics exactly as `argmax_classes` does, so the int8 head stays bit-equal to the
// plain version; the fp head sums the same exact bf16 products in another
// order (the tensor cores' f32 accumulation).
//
// The general route (the first design's fp head): one thread per blocked pixel
// in a grid-stride loop over a grid sized to the SMs, so each block stages the
// head's constants (sv and wt as f32, and epi) in shared memory once and reuses
// them for many pixels. Each thread streams its pixel's C4 values with 16-byte
// vector loads; all threads of a warp read the same 16-byte weight group at a
// time, a shared-memory broadcast. Neighbouring threads own neighbouring
// pixels, so the label writes (an 8-byte pair per output row) coalesce. The
// epilogue uses the _rn intrinsics so nvcc cannot contract it into FMAs: it
// rounds where the PyTorch plain version rounds. Each phase's class rows are
// padded to NMAX (2, 4 or 8, a template argument) so the accumulators stay in
// registers. Dense (K6), a thread owns one pixel and writes one label.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DType { kInt8 = 0, kBF16 = 1, kF32 = 2 };
enum Route { kRouteGeneral = 0, kRouteMma = 1 };
constexpr int kThreads = 256;

// 16 bytes of activations as float lanes
template <typename T> struct Vec16;
template <> struct Vec16<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void load(const int8_t* p, float* out) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      out[i] = __int2float_rn((int)(int8_t)((words[i / 4] >> (8 * (i % 4))) & 0xff));
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(b[i]);
  }
};
template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

// the folded ReLU+BN epilogue, rounded as the plain version rounds
__device__ __forceinline__ float epilogue(float y, float bias, float scale, float shift) {
  return __fadd_rn(__fmul_rn(fmaxf(__fadd_rn(y, bias), 0.f), scale), shift);
}

// the epilogue and a first-max argmax over the classes of each of PH
// sub-pixels: y holds PH groups of NMAX outputs, s_epi is [4][PH*ncls]
template <int NMAX, int PH>
__device__ __forceinline__ void argmax_classes(const float (&y)[PH * NMAX], const float* s_epi,
                                               int ncls, int (&lbl)[PH]) {
  const int nout = PH * ncls;
#pragma unroll
  for (int p = 0; p < PH; ++p) {
    int best_c = 0;
    float best = 0.f;
#pragma unroll
    for (int c = 0; c < NMAX; ++c) {
      if (c < ncls) {
        const int o = p * ncls + c;
        const float v = epilogue(y[p * NMAX + c], s_epi[o], s_epi[nout + o], s_epi[2 * nout + o]);
        if (c == 0 || v > best) {  // first max wins ties, as argmax does
          best = v;
          best_c = c;
        }
      }
    }
    lbl[p] = best_c;
  }
}

// The general route. PH = 4 (K2): a thread per blocked pixel of the
// phase-major [B, h, w, c4] edge, its four labels to out[b, 2i+dy, 2j+dx].
// PH = 1 (K6): a thread per pixel of the dense [npix, c4] edge, its label
// to out[n].
template <typename TX, int NMAX, int PH>
__device__ __forceinline__ void head_fp_body(const TX* __restrict__ x,
                                             const float* __restrict__ sv,
                                             const void* __restrict__ wt, int wt_dtype,
                                             const float* __restrict__ epi,
                                             int* __restrict__ out, long long npix, int h,
                                             int w, int c4, int ncls) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_w = smem;                   // [PH*NMAX][c4], sub-pixel rows padded to NMAX
  float* s_sv = s_w + PH * NMAX * c4;  // [c4]
  float* s_epi = s_sv + c4;            // [4][PH*ncls]
  const bool round_bf16 = wt_dtype == kBF16;
  for (int t = threadIdx.x; t < PH * NMAX * c4; t += blockDim.x) {
    const int r = t / c4, k = t % c4, p = r / NMAX, c = r % NMAX;
    float v = 0.f;
    if (c < ncls) {
      const long long src = (long long)(p * ncls + c) * c4 + k;
      v = round_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(wt)[src])
                     : static_cast<const float*>(wt)[src];
    }
    s_w[t] = v;
  }
  for (int t = threadIdx.x; t < c4; t += blockDim.x) s_sv[t] = sv[t];
  for (int t = threadIdx.x; t < 4 * PH * ncls; t += blockDim.x) s_epi[t] = epi[t];
  __syncthreads();

  constexpr int V = Vec16<TX>::N;
  const long long hw = (long long)h * w;
  for (long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x; n < npix;
       n += (long long)gridDim.x * blockDim.x) {
    const TX* px = x + n * c4;
    float y[PH * NMAX];
#pragma unroll
    for (int o = 0; o < PH * NMAX; ++o) y[o] = 0.f;
    for (int k0 = 0; k0 < c4; k0 += V) {
      float xf[V];
      Vec16<TX>::load(px + k0, xf);
#pragma unroll
      for (int u = 0; u < V; u += 4) {
        const float4 s = *reinterpret_cast<const float4*>(s_sv + k0 + u);
        float v[4] = {__fmul_rn(xf[u], s.x), __fmul_rn(xf[u + 1], s.y),
                      __fmul_rn(xf[u + 2], s.z), __fmul_rn(xf[u + 3], s.w)};
        if (round_bf16) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
        }
#pragma unroll
        for (int o = 0; o < PH * NMAX; ++o) {
          const float4 wv = *reinterpret_cast<const float4*>(s_w + o * c4 + k0 + u);
          y[o] = fmaf(v[0], wv.x, y[o]);
          y[o] = fmaf(v[1], wv.y, y[o]);
          y[o] = fmaf(v[2], wv.z, y[o]);
          y[o] = fmaf(v[3], wv.w, y[o]);
        }
      }
    }
    int lbl[PH];
    argmax_classes<NMAX, PH>(y, s_epi, ncls, lbl);
    if constexpr (PH == 1) {
      out[n] = lbl[0];
    } else {
      // out is [B, 2h, 2w]; pixel (i, j) owns (2i+dy, 2j+dx)
      const long long b = n / hw;
      const int rem = (int)(n - b * hw), i = rem / w, j = rem % w;
      const long long w2 = 2LL * w;
      const long long top = (b * 2LL * h + 2LL * i) * w2 + 2LL * j;
      *reinterpret_cast<int2*>(out + top) = make_int2(lbl[0], lbl[1]);
      *reinterpret_cast<int2*>(out + top + w2) = make_int2(lbl[2], lbl[3]);
    }
  }
}

template <typename TX, int NMAX>
__global__ void __launch_bounds__(kThreads)
head_fp_kernel(const TX* __restrict__ x, const float* __restrict__ sv,
               const void* __restrict__ wt, int wt_dtype,
               const float* __restrict__ epi, int* __restrict__ out,
               long long npix, int h, int w, int c4, int ncls) {
  head_fp_body<TX, NMAX, 4>(x, sv, wt, wt_dtype, epi, out, npix, h, w, c4, ncls);
}

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
dense_head_fp_kernel(const int8_t* __restrict__ x, const float* __restrict__ sv,
                     const void* __restrict__ wt, int wt_dtype,
                     const float* __restrict__ epi, int* __restrict__ out, long long npix,
                     int c, int ncls) {
  head_fp_body<int8_t, NMAX, 1>(x, sv, wt, wt_dtype, epi, out, npix, 1, 1, c, ncls);
}

// ---- the mma route -----------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kKQ = 4;  // 64-channel groups per chunk held in registers

__device__ __forceinline__ uint32_t word(const int4& v, int i) {
  return (uint32_t)(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}

// x + 128 in byte e of `biased` -> float(x), exactly, without a conversion
__device__ __forceinline__ float s8_to_f32(uint32_t biased, int e) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + e)),
                   8388736.0f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// an output's pre-epilogue value: the fp head's f32 sum as it is; the int8
// head's exact int32 sum times the output's weight scale
__device__ __forceinline__ float head_y(float acc, float) { return acc; }
__device__ __forceinline__ float head_y(int acc, float wscale) {
  return __fmul_rn(__int2float_rn(acc), wscale);
}

// 16 B of the lane's two rows (g, g+8) at channels 64q + 16t, q in one chunk.
// A row past the last loads zeros; so do (DENSE) the channels of the last
// row's missing pixels when npix is not a multiple of 4.
template <bool DENSE>
__device__ __forceinline__ void load_chunk(int4 (&buf)[2][kKQ], const int8_t* __restrict__ x,
                                           int tile, int chunk, int nrow, int npix, int c4,
                                           int c, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = tile * 16 + g + 8 * r;
    int lim = n < nrow ? c4 : 0;  // channels of the row that exist
    if (DENSE && n < nrow && npix - 4 * n < 4) lim = (npix - 4 * n) * c;
    const int8_t* row = x + (long long)n * c4;
#pragma unroll
    for (int q = 0; q < kKQ; ++q) {
      const int k = (chunk * kKQ + q) * 64 + 16 * t;
      buf[r][q] = k < lim ? __ldcs(reinterpret_cast<const int4*>(row + k))
                          : make_int4(0, 0, 0, 0);
    }
  }
}

// DENSE: the layout (see the head of this file): rows of four dense pixels
// (K6) or blocked pixels of four phases (K2); nrow rows of c4 channels, npix
// pixels (dense; blocked, npix = nrow), c = c4 / 4 channels a dense pixel.
// FP: int8 x with a bf16 weight; else int8 x int8. NT: n-tiles of 8 outputs
// (ceil(4*ncls/8)). BREG: the weights' fragments live in registers (one n-tile,
// C4 <= 256); otherwise each is read from shared memory where it is used.
template <bool DENSE, bool FP, int NT, bool BREG>
__device__ __forceinline__ void head_mma_body(const int8_t* __restrict__ x,
                                              const float* __restrict__ sv,
                                              const void* __restrict__ wt,
                                              const float* __restrict__ epi,
                                              int* __restrict__ out, int nrow, int npix, int h,
                                              int w, int c4, int c, int ncls) {
  using Acc = typename std::conditional<FP, float, int>::type;
  constexpr int N8 = 8 * NT;
  constexpr int BW = FP ? 2 : 1;  // 16-byte pieces of a lane's B data per (q, n-tile)
  constexpr int SST = N8 + 1;     // scratch row stride, in floats
  const int nq = (c4 + 63) / 64;
  const int nchunks = (nq + kKQ - 1) / kKQ;
  const int nqpad = nchunks * kKQ;
  const int nout = 4 * ncls;
  const int ecols = DENSE ? ncls : nout;  // columns of epi

  extern __shared__ int4 smem_mma[];
  int4* s_b = smem_mma;  // [nqpad][NT][BW][32 lanes] weight fragments
  float* s_sv = reinterpret_cast<float*>(s_b + nqpad * NT * BW * 32);  // [nqpad][4][4][4]
  float* s_epi = s_sv + (FP ? nqpad * 64 : 0);  // [4][N8], zero past nout
  float* s_scr = s_epi + 4 * N8;                // [warps][16][SST]

  const int8_t* wt8 = static_cast<const int8_t*>(wt);
  for (int i = threadIdx.x; i < nqpad * NT * BW * 32; i += blockDim.x) {
    const int ln = i % 32, half = (i / 32) % BW, nt = (i / (32 * BW)) % NT;
    const int q = i / (32 * BW * NT);
    const int o = nt * 8 + ln / 4;
    const int k = 64 * q + 16 * (ln % 4) + 8 * half;  // first channel of the piece
    // dense: output o = p*ncls + cls sees only sub-pixel p's channels, as
    // row cls of the [ncls, C] weight (block-diagonal)
    long long src = -1;
    if (o < nout && k < c4) {
      if (!DENSE)
        src = (long long)o * c4 + k;
      else if (k / c == o / ncls)
        src = (long long)(o % ncls) * c + k % c;
    }
    s_b[i] = src >= 0 ? *reinterpret_cast<const int4*>(wt8 + src * BW) : make_int4(0, 0, 0, 0);
  }
  if (FP) {
    for (int i = threadIdx.x; i < nqpad * 64; i += blockDim.x) {
      const int k = 64 * (i >> 6) + 16 * ((i >> 2) & 3) + 4 * ((i >> 4) & 3) + (i & 3);
      s_sv[i] = k < c4 ? sv[DENSE ? k % c : k] : 0.f;
    }
  }
  for (int i = threadIdx.x; i < 4 * N8; i += blockDim.x)
    s_epi[i] = i % N8 < nout ? epi[(i / N8) * ecols + (i % N8) % ecols] : 0.f;
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int ntiles = (nrow + 15) / 16;
  const int tstride = gridDim.x * kMmaWarps;
  int tile = blockIdx.x * kMmaWarps + warp;
  if (tile >= ntiles) return;

  int4 breg[BREG ? kKQ * BW : 1];
  if (BREG) {
#pragma unroll
    for (int i = 0; i < kKQ * BW; ++i) breg[BREG ? i : 0] = s_b[i * 32 + lane];
  }
  // ncls = 2: lane (g, t) finishes sub-pixel t, outputs 2t and 2t+1
  const float eb0 = s_epi[2 * t], eb1 = s_epi[2 * t + 1];
  const float es0 = s_epi[N8 + 2 * t], es1 = s_epi[N8 + 2 * t + 1];
  const float eh0 = s_epi[2 * N8 + 2 * t], eh1 = s_epi[2 * N8 + 2 * t + 1];
  const float ew0 = s_epi[3 * N8 + 2 * t], ew1 = s_epi[3 * N8 + 2 * t + 1];
  const int hw = h * w;
  const long long w2 = 2LL * w;

  Acc acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0;

  int4 cur[2][kKQ], nxt[2][kKQ];
  int chunk = 0;
  load_chunk<DENSE>(cur, x, tile, 0, nrow, npix, c4, c, g, t);
  while (true) {
    int ntile = tile, nchunk = chunk + 1;
    if (nchunk == nchunks) {
      nchunk = 0;
      ntile += tstride;
    }
    const bool more = ntile < ntiles;
    if (more) load_chunk<DENSE>(nxt, x, ntile, nchunk, nrow, npix, c4, c, g, t);

#pragma unroll
    for (int q = 0; q < kKQ; ++q) {
      const int qg = chunk * kKQ + q;
      if (qg >= nq) break;
      int4 bf[NT][BW];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < BW; ++hf)
          bf[nt][hf] = BREG ? breg[BREG ? q * BW + hf : 0]
                            : s_b[((qg * NT + nt) * BW + hf) * 32 + lane];
      if constexpr (FP) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 s = *reinterpret_cast<const float4*>(s_sv + (qg * 4 + j) * 16 + 4 * t);
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t v = word(cur[r][q], j) ^ 0x80808080u;
            a[r] = pack_bf16(__fmul_rn(s8_to_f32(v, 0), s.x), __fmul_rn(s8_to_f32(v, 1), s.y));
            a[r + 2] = pack_bf16(__fmul_rn(s8_to_f32(v, 2), s.z),
                                 __fmul_rn(s8_to_f32(v, 3), s.w));
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[nt], a[0], a[1], a[2], a[3], word(bf[nt][j / 2], 2 * (j % 2)),
                     word(bf[nt][j / 2], 2 * (j % 2) + 1));
        }
      } else {
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_s8(acc[nt], word(cur[0][q], 2 * s), word(cur[1][q], 2 * s),
                   word(cur[0][q], 2 * s + 1), word(cur[1][q], 2 * s + 1),
                   word(bf[nt][0], 2 * s), word(bf[nt][0], 2 * s + 1));
      }
    }

    if (nchunk == 0) {  // the tile's last chunk: epilogue, argmax, labels
      if (NT == 1 && ncls == 2) {
        const int dy = t / 2, dx = t % 2;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = tile * 16 + g + 8 * r;
          const float v0 = epilogue(head_y(acc[0][2 * r], ew0), eb0, es0, eh0);
          const float v1 = epilogue(head_y(acc[0][2 * r + 1], ew1), eb1, es1, eh1);
          if (DENSE) {  // pixel 4n + t; lanes t = 0..3 of 8 rows: 128 B in a row
            if (n < nrow && 4 * n + t < npix) out[4 * n + t] = v1 > v0 ? 1 : 0;
          } else if (n < nrow) {
            const int b = n / hw, rem = n - b * hw, i = rem / w, j = rem - i * w;
            out[((long long)b * 2 * h + 2 * i + dy) * w2 + 2 * j + dx] = v1 > v0 ? 1 : 0;
          }
        }
      } else {
        float* scr = s_scr + warp * 16 * SST;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int o = nt * 8 + 2 * t + i % 2;
            scr[(g + 8 * (i / 2)) * SST + o] = head_y(acc[nt][i], s_epi[3 * N8 + o]);
          }
        }
        __syncwarp();
        const int pix = lane / 2, dy = lane % 2;
        const int n = tile * 16 + pix;
        if (n < nrow) {
          int lbl[2];
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const int p = 2 * dy + dx;
            int best_c = 0;
            float best = 0.f;
            for (int c = 0; c < ncls; ++c) {
              const int o = p * ncls + c;
              const float v = epilogue(scr[pix * SST + o], s_epi[o], s_epi[N8 + o],
                                       s_epi[2 * N8 + o]);
              if (c == 0 || v > best) {  // first max wins ties, as argmax does
                best = v;
                best_c = c;
              }
            }
            lbl[dx] = best_c;
          }
          if (DENSE) {  // sub-pixels 2dy, 2dy+1: pixels 4n + 2dy and the next
            const int p0 = 4 * n + 2 * dy;
            if (p0 + 1 < npix)
              *reinterpret_cast<int2*>(out + p0) = make_int2(lbl[0], lbl[1]);
            else if (p0 < npix)
              out[p0] = lbl[0];
          } else {
            const int b = n / hw, rem = n - b * hw, i = rem / w, j = rem - i * w;
            *reinterpret_cast<int2*>(out + ((long long)b * 2 * h + 2 * i + dy) * w2 + 2 * j) =
                make_int2(lbl[0], lbl[1]);
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
    }
    if (!more) break;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < kKQ; ++q) cur[r][q] = nxt[r][q];
    tile = ntile;
    chunk = nchunk;
  }
}

// K2: npix blocked pixels of c4 channels
template <bool FP, int NT, bool BREG>
__global__ void __launch_bounds__(kMmaThreads, 3)
head_mma_kernel(const int8_t* __restrict__ x, const float* __restrict__ sv,
                const void* __restrict__ wt, const float* __restrict__ epi,
                int* __restrict__ out, int npix, int h, int w, int c4, int ncls) {
  head_mma_body<false, FP, NT, BREG>(x, sv, wt, epi, out, npix, npix, h, w, c4, c4 / 4, ncls);
}

// K6: npix dense pixels of c channels, as rows of four
template <bool FP, int NT, bool BREG>
__global__ void __launch_bounds__(kMmaThreads, 3)
dense_head_mma_kernel(const int8_t* __restrict__ x, const float* __restrict__ sv,
                      const void* __restrict__ wt, const float* __restrict__ epi,
                      int* __restrict__ out, int npix, int c, int ncls) {
  head_mma_body<true, FP, NT, BREG>(x, sv, wt, epi, out, (npix + 3) / 4, npix, 1, 1, 4 * c, c,
                                    ncls);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms > 0 ? sms : 132;
}

int grid_for(long long npix) {
  const long long need = (npix + kThreads - 1) / kThreads;
  const long long cap = 8LL * sm_count();
  return (int)(need < cap ? need : cap);
}

template <typename... KArgs, typename... Args>
cudaError_t run(void (*kernel)(KArgs...), size_t smem, long long npix,
                cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid_for(npix), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int NMAX>
cudaError_t dispatch(const void* x, int x_dtype, const float* sv, const void* wt,
                     int wt_dtype, const float* epi, int* out, long long npix, int h,
                     int w, int c4, int ncls, cudaStream_t stream) {
  const size_t smem = (4 * NMAX * c4 + c4 + 16 * ncls) * sizeof(float);
  switch (x_dtype) {
    case kInt8:
      return run(head_fp_kernel<int8_t, NMAX>, smem, npix, stream,
                 static_cast<const int8_t*>(x), sv, wt, wt_dtype, epi, out, npix, h, w,
                 c4, ncls);
    case kBF16:
      return run(head_fp_kernel<__nv_bfloat16, NMAX>, smem, npix, stream,
                 static_cast<const __nv_bfloat16*>(x), sv, wt, wt_dtype, epi, out, npix,
                 h, w, c4, ncls);
    case kF32:
      return run(head_fp_kernel<float, NMAX>, smem, npix, stream,
                 static_cast<const float*>(x), sv, wt, wt_dtype, epi, out, npix, h, w,
                 c4, ncls);
  }
  return cudaErrorInvalidValue;
}

template <int NMAX>
cudaError_t dispatch_dense(const void* x, const float* sv, const void* wt, int wt_dtype,
                           const float* epi, int* out, long long npix, int c, int ncls,
                           cudaStream_t stream) {
  const size_t smem = (NMAX * c + c + 4 * ncls) * sizeof(float);
  return run(dense_head_fp_kernel<NMAX>, smem, npix, stream, static_cast<const int8_t*>(x),
             sv, wt, wt_dtype, epi, out, npix, c, ncls);
}

// shared memory of a head_mma body with NT n-tiles over rows of c4 channels
size_t mma_smem(bool fp, int nt, int c4) {
  const int nqpad = ((c4 + 63) / 64 + kKQ - 1) / kKQ * kKQ;
  return (size_t)nqpad * nt * (fp ? 2 : 1) * 32 * 16 + (fp ? nqpad * 64 * sizeof(float) : 0) +
         4 * 8 * nt * sizeof(float) + kMmaWarps * 16 * (8 * nt + 1) * sizeof(float);
}

// a grid of as many blocks as fit on the card at once, or fewer for few rows
template <typename... KArgs, typename... Args>
cudaError_t run_mma(void (*kernel)(KArgs...), size_t smem, int nrow, cudaStream_t stream,
                    Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long need = ((nrow + 15) / 16 + kMmaWarps - 1) / kMmaWarps;
  const long long cap = (long long)per_sm * sm_count();
  kernel<<<(int)(need < cap ? need : cap), kMmaThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// c4: the row width, 4C for the dense layout (npix dense pixels) and the
// blocked edge's channels otherwise (npix blocked pixels)
template <bool DENSE, bool FP, int NT, bool BREG>
cudaError_t run_mma_layout(const int8_t* x, const float* sv, const void* wt, const float* epi,
                           int* out, int npix, int h, int w, int c4, int ncls,
                           cudaStream_t stream) {
  const size_t smem = mma_smem(FP, NT, c4);
  if constexpr (DENSE)
    return run_mma(dense_head_mma_kernel<FP, NT, BREG>, smem, (npix + 3) / 4, stream, x, sv,
                   wt, epi, out, npix, c4 / 4, ncls);
  else
    return run_mma(head_mma_kernel<FP, NT, BREG>, smem, npix, stream, x, sv, wt, epi, out,
                   npix, h, w, c4, ncls);
}

template <bool DENSE, bool FP>
cudaError_t dispatch_mma(const void* x, const float* sv, const void* wt, const float* epi,
                         int* out, int npix, int h, int w, int c4, int ncls,
                         cudaStream_t stream) {
  const int8_t* x8 = static_cast<const int8_t*>(x);
  switch ((ncls + 1) / 2) {  // n-tiles of 8 outputs
    case 1:
      if (c4 <= 64 * kKQ)
        return run_mma_layout<DENSE, FP, 1, true>(x8, sv, wt, epi, out, npix, h, w, c4, ncls,
                                                  stream);
      return run_mma_layout<DENSE, FP, 1, false>(x8, sv, wt, epi, out, npix, h, w, c4, ncls,
                                                 stream);
    case 2:
      return run_mma_layout<DENSE, FP, 2, false>(x8, sv, wt, epi, out, npix, h, w, c4, ncls,
                                                 stream);
    case 3:
      return run_mma_layout<DENSE, FP, 3, false>(x8, sv, wt, epi, out, npix, h, w, c4, ncls,
                                                 stream);
    case 4:
      return run_mma_layout<DENSE, FP, 4, false>(x8, sv, wt, epi, out, npix, h, w, c4, ncls,
                                                 stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K2. x: [b, h, w, c4] of x_dtype; sv: f32 [c4] (fp head only); wt: [4*ncls, c4]
// (bf16 or f32 for the fp head, int8 otherwise); epi: f32 [4, 4*ncls];
// out: int32 [b, 2h, 2w]; route: 1 for the mma route (x int8, wt bf16 for the
// fp head or int8 for the int8 head), 0 for the general route (fp head only:
// any x, wt bf16 or f32). Launches on `stream` and returns the cudaError_t of the
// launch (0 on success); the caller checked devices and contiguity.
int tpuseg_head_argmax(const void* x, int x_dtype, const float* sv, const void* wt,
                       int wt_dtype, const float* epi, int* out, int b, int h, int w,
                       int c4, int ncls, int fp, int route, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || ncls < 1 || ncls > 8 || c4 % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (!fp && (x_dtype != kInt8 || wt_dtype != kInt8)) return (int)cudaErrorInvalidValue;
  if (fp && wt_dtype != kBF16 && wt_dtype != kF32) return (int)cudaErrorInvalidValue;
  const long long npix = (long long)b * h * w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteMma) {
    if (x_dtype != kInt8 || (fp && wt_dtype != kBF16) || npix >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    return fp ? (int)dispatch_mma<false, true>(x, sv, wt, epi, out, (int)npix, h, w, c4, ncls, s)
              : (int)dispatch_mma<false, false>(x, sv, wt, epi, out, (int)npix, h, w, c4, ncls,
                                                s);
  }
  if (route != kRouteGeneral || !fp) return (int)cudaErrorInvalidValue;
  if (ncls <= 2)
    return (int)dispatch<2>(x, x_dtype, sv, wt, wt_dtype, epi, out, npix, h, w, c4, ncls, s);
  if (ncls <= 4)
    return (int)dispatch<4>(x, x_dtype, sv, wt, wt_dtype, epi, out, npix, h, w, c4, ncls, s);
  return (int)dispatch<8>(x, x_dtype, sv, wt, wt_dtype, epi, out, npix, h, w, c4, ncls, s);
}

// K6. x: int8 [npix, c] (the dense [B, H, W, C] edge); sv: f32 [c] (fp head
// only); wt: [ncls, c] (bf16 or f32 for the fp head, int8 otherwise); epi: f32
// [4, ncls]; out: int32 [npix]; route: 1 for the mma route (wt bf16 for the fp
// head or int8 for the int8 head), 0 for the general route (fp head, wt bf16
// or f32). Launches on `stream` and returns the cudaError_t of the launch.
int tpuseg_dense_head_argmax(const void* x, const float* sv, const void* wt, int wt_dtype,
                             const float* epi, int* out, long long npix, int c, int ncls,
                             int fp, int route, void* stream) {
  if (npix <= 0 || npix >= (1LL << 31) || c <= 0 || c > (1 << 20) || c % 16 != 0 ||
      ncls < 1 || ncls > 8)
    return (int)cudaErrorInvalidValue;
  if (!fp && wt_dtype != kInt8) return (int)cudaErrorInvalidValue;
  if (fp && wt_dtype != kBF16 && wt_dtype != kF32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteMma) {
    if (fp && wt_dtype != kBF16) return (int)cudaErrorInvalidValue;
    return fp ? (int)dispatch_mma<true, true>(x, sv, wt, epi, out, (int)npix, 1, 1, 4 * c, ncls, s)
              : (int)dispatch_mma<true, false>(x, sv, wt, epi, out, (int)npix, 1, 1, 4 * c,
                                               ncls, s);
  }
  if (route != kRouteGeneral || !fp) return (int)cudaErrorInvalidValue;
  if (ncls <= 2) return (int)dispatch_dense<2>(x, sv, wt, wt_dtype, epi, out, npix, c, ncls, s);
  if (ncls <= 4) return (int)dispatch_dense<4>(x, sv, wt, wt_dtype, epi, out, npix, c, ncls, s);
  return (int)dispatch_dense<8>(x, sv, wt, wt_dtype, epi, out, npix, c, ncls, s);
}

const char* tpuseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
