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
// divides by a 0-dim device tensor, not by a reciprocal). The requantize
// clamps before it rounds (the same codes: +-127 are integers) and rounds by
// adding 1.5 * 2^23, whose sum's low byte is then rint(q) in two's complement
// (f32 addition rounds half to even, torch.round's rule), so it needs no
// conversion instruction. Where 2^-64 <= so <= 2^64 (every scale the
// calibration gives: so >= 1e-12 / 127) it divides by one reciprocal and one
// correction with the clamp moved before them (requant_rcp), which gives the
// true division's codes: chip_smoke.py checks that on all 2^32 f32 values;
// other scales take __fdiv_rn. So the kernel is bit-equal to the plain
// version.
//
// Bound: bytes, nearly tied with operations. At the serving shape (batch 8 of
// 1024^2 tiles, C 1, F 64) it reads 33.5 MB of f32 input and writes 537 MB of
// int8 codes: 0.170 ms at 3.35 TB/s; its 4.83e9 multiply-adds take 0.144 ms at
// the f32 CUDA-core peak (67 TFLOP/s). What sets its pace on the card is
// instruction issue: each output takes 9 FMAs and an epilogue of about as many
// instructions again (the affine, the division, the clamp, the rounding, the
// packing), so the issue floor (chip_smoke.py counts it in the SASS) lies
// well above the bound. The design keeps everything else off the issue slots
// and out of the way of the arithmetic.
//
// Design: a persistent grid. The launch plan (`plan` below, the one place it
// is made) gives each block one chunk of `fc` output channels (all of F
// unless the weights would not fit in shared memory) and launches min(tiles x
// chunks, SMs x resident blocks) blocks (the SM count and the occupancy are
// queried once per device and kernel and cached here). Each block stages its
// chunk's rounded weights and b, s, t in shared memory once, then walks a
// contiguous run of output tiles in row-major order (tx fastest), so its
// successive tiles lie in one image row band. A tile is 4 x 128 pixels at C
// == 1 (of the shapes timed, the fastest in both layouts) and 8 x 32 at other
// C, whose smaller halo lets C reach 119. The input tile with its 1-pixel
// halo comes in by 4-byte cp.async, src-size 0 outside the image (so SAME
// padding is the zero fill), into one of two halo buffers: while tile k computes, tile k + 1's
// halo arrives (where the two buffers do not fit, at C >= 71, the block
// loads each halo after the previous tile's compute into one buffer). After
// the wait each thread rounds the elements it copied to the operand dtype, in
// place; a barrier publishes them. Tiles come from infer/tiled.py already
// padded by the receptive-field radius, so the zeros fall only at a tile's
// edge, where cuDNN's SAME padding fell.
//
// An item of a thread is 4 consecutive output channels of 2 x 4 pixels
// (two rows, four columns): 32 accumulators; per tap (ky, kx) one 16-byte
// load of its 4 weights feeds 32 multiply-adds, and each of the item's 4
// halo rows is loaded once, 6 values in 3 loads (the C == 1 template aligns
// the halo rows so that the 4 inner values are one 16-byte load; general C
// loads 8 scalars per tap and channel). In both layouts the item's 8 staged
// words then lie 8 strides of F apart from one base: two rows of 4 pixels
// (dense), or 2 blocked pixels of 4 phases each (blocked). A thread keeps its
// channel group g = tid % (fc / 4) for the whole kernel; its items step by
// 256 / (fc / 4), so nothing divides by a runtime value inside a loop. At F =
// 64, the two half-warps take the same columns of neighbouring row pairs,
// which with the staged rows' padding (32 bytes a dense row, 64 a blocked
// one) puts their code stores in different banks in both layouts.
//
// The epilogue packs each pixel's 4 codes into one word (__byte_perm) and,
// where the codes of a tile row are contiguous in the output (F % 16 == 0 and
// one chunk: every served call), stages them in one of two code buffers in
// shared memory, laid out as the output (dense rows of tile-width x F bytes,
// or blocked rows of tile-width / 2 x 4F), then fences the async proxy and, after a
// barrier, one thread per row writes it out by cp.async.bulk (shared to
// global, one bulk group per thread). The store of tile k overlaps tile k +
// 1's compute; a thread waits for its group of tile k - 1 to have been read
// (wait_group.read 1) before the buffer is written again. Otherwise (a tail
// F % 16 != 0, or chunks) each thread stores its words straight to device
// memory: one 4-byte store per pixel where F % 4 == 0, byte stores otherwise.
// Byte offsets are 64-bit; pixel indices 32-bit (the wrapper raises past 2^31
// pixels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kItemW = 4;               // an item: 2 rows x 4 columns of pixels
constexpr int kItem = 2 * kItemW;
constexpr int kNG = 4;                  // output channels of an item
constexpr int kGroup = 16;              // a chunk is a multiple of this many channels
constexpr int kMaxFc = kNG * kThreads;  // every thread keeps one channel group
constexpr int kStagePad = 32;           // bytes after a staged dense row (blocked: 64)
constexpr int kMaxSmem = 232448;        // a block's shared memory on Hopper
// The blocks an SM the served variants' registers are capped for (bf16,
// C == 1, staged codes: 3 measured fastest and does not spill); the others
// keep 2.
constexpr int kServedMinBlocks = 3;

// Output rows and columns of a tile. C == 1 takes a wide one; other C keep
// 8 x 32, whose halo lets C reach 119 (with one halo buffer and 16 channels).
template <bool C1>
struct Tile {
  static constexpr int h = C1 ? 4 : 8;
  static constexpr int w = C1 ? 128 : 32;
  static constexpr int pitch = w + 8;  // floats per halo row at C == 1
};

enum DtypeCode { kF32 = 0, kBf16 = 1 };

struct Params {
  const float* x;   // [n, h, w, c]
  const float* w;   // [3, 3, c, f]
  const float* b;   // [f]
  const float* s;   // [f]
  const float* t;   // [f]
  const float* so;  // scalar
  int8_t* out;      // [n, h, w, f] or [n, h/2, w/2, 4f]
  int h, w_, c, f;
  int fc;           // output channels per chunk, a multiple of kGroup
  int chunks;       // ceil(f / fc)
  int stages;       // halo buffers: 2 (prefetch) or 1
  int tiles_x, tiles_y;
  long long tiles;  // n * tiles_y * tiles_x
  int halo_floats;  // one halo buffer, a multiple of 4 floats
  int halo_pitch;   // floats per halo row
  int stage_pitch;  // bytes per staged row of codes
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

// The block's ReLU and folded BN on one sum.
__device__ __forceinline__ float affine(float acc, float b, float s, float t) {
  const float v = fmaxf(__fadd_rn(acc, b), 0.0f);
  return __fadd_rn(__fmul_rn(v, s), t);
}

// The requantize of one value v: a word whose low byte is the int8 code. The
// true division, clamped to +-127, rounded half to even by the add.
__device__ __forceinline__ uint32_t requant_div(float v, float so) {
  const float q = fminf(fmaxf(__fdiv_rn(v, so), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(q, 12582912.0f));  // 1.5 * 2^23 + rint(q)
}

// The same word without the division's subroutine (10 instructions, one
// MUFU.RCP and a branch around a slow path), for 2^-64 <= so <= 2^64. v is
// clamped to +-m first, m = RN(127 so), whose quotient lies within 127 (1 +-
// 2^-24) of the code 127: the same codes as clamping the quotient (a NaN v
// becomes -m, code -127, as the true division's NaN does; with a negative so
// it would be +127, so negative scales take requant_div). Then the
// quotient from r = RN(1 / so) with one correction, q' = q + (v - q so) r
// (Markstein: the correctly rounded quotient where nothing under- or
// overflows). chip_smoke.py holds it against requant_div on every f32 v for
// the main path's scales and on random v for 256 random scales
// (tpuseg_input_conv_check_requant).
__device__ __forceinline__ uint32_t requant_rcp(float v, float so, float r, float m) {
  v = fminf(fmaxf(v, -m), m);
  const float q = __fmul_rn(v, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-q, so, v), r, q);
  return __float_as_uint(__fadd_rn(q1, 12582912.0f));
}

// A block's output scale with its reciprocal and clamp, computed once.
struct Scale {
  float so, r, m;
  bool fast;  // requant_rcp's range
};

__device__ __forceinline__ Scale make_scale(float so) {
  return {so, __frcp_rn(so), __fmul_rn(127.0f, so), so >= 0x1p-64f && so <= 0x1p64f};
}

template <bool RCP>
__device__ __forceinline__ uint32_t requant(float v, const Scale& sc) {
  return RCP ? requant_rcp(v, sc.so, sc.r, sc.m) : requant_div(v, sc.so);
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(s), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Each pixel's 4 codes of an item, packed into a word.
template <bool RCP>
__device__ __forceinline__ void epilogue(const float (&acc)[kItem][kNG], float4 b, float4 s,
                                         float4 t, const Scale& sc, uint32_t (&words)[kItem]) {
#pragma unroll
  for (int i = 0; i < kItem; ++i)
    words[i] = pack4(requant<RCP>(affine(acc[i][0], b.x, s.x, t.x), sc),
                     requant<RCP>(affine(acc[i][1], b.y, s.y, t.y), sc),
                     requant<RCP>(affine(acc[i][2], b.z, s.z, t.z), sc),
                     requant<RCP>(affine(acc[i][3], b.w, s.w, t.w), sc));
}

// Issue (ROUND false) the cp.async copies of the halo of the tile at (img,
// y0, x0) into `buf`, or (ROUND true, after they landed) round the elements
// this thread copied. Warp w takes halo rows w, w + 8, ...; a halo row is
// (kTW + 2) * C floats, contiguous in x, and an element lies outside the image
// exactly where its flat offset in the image row does.
template <bool C1, bool ROUND, bool BF16>
__device__ __forceinline__ void halo_pass(const Params& p, float* buf, int img, int y0,
                                          int x0) {
  constexpr int kTH = Tile<C1>::h, kTW = Tile<C1>::w;
  const int lane = threadIdx.x & 31;
  const int c = C1 ? 1 : p.c;
  const int rowlen = (kTW + 2) * c;
  const int rowend = p.w_ * c;
  const int e0 = (x0 - 1) * c;
  for (int r = threadIdx.x >> 5; r < kTH + 2; r += kWarps) {
    float* dst = buf + r * p.halo_pitch + (C1 ? 3 : 0);  // C1: column -1 at index 3
    if (ROUND) {
      for (int k = lane; k < rowlen; k += 32) dst[k] = round_operand<BF16>(dst[k]);
    } else {
      const int yy = y0 - 1 + r;
      const bool rowok = yy >= 0 && yy < p.h;
      const long long base = ((long long)img * p.h + yy) * rowend;
      for (int k = lane; k < rowlen; k += 32) {
        const int e = e0 + k;
        const bool ok = rowok && e >= 0 && e < rowend;
        cp_async4(dst + k, ok ? p.x + base + e : p.x, ok);
      }
    }
  }
}

template <bool BF16, bool BLOCKED, bool C1, bool STAGED>
__global__ void __launch_bounds__(kThreads, BF16 && C1 && STAGED ? kServedMinBlocks : 2)
    input_conv_kernel(Params p) {
  constexpr int kTH = Tile<C1>::h, kTW = Tile<C1>::w;
  constexpr int kItemCols = kTW / kItemW;
  constexpr int kItems = kTH / 2 * kItemCols;
  extern __shared__ __align__(16) float smem[];
  const int c = C1 ? 1 : p.c;
  const int fc = p.fc;
  const bool two = p.stages == 2;
  float* halo0 = smem;
  float* halo1 = smem + (two ? p.halo_floats : 0);
  float* ws = smem + p.stages * p.halo_floats;  // [9][c][fc]
  float* bst = ws + 9 * c * fc;                  // b, s, t of the chunk: [3][fc]
  uint8_t* stage0 = reinterpret_cast<uint8_t*>(bst + 3 * fc);
  constexpr int kStageRows = BLOCKED ? kTH / 2 : kTH;
  uint8_t* stage1 = stage0 + kStageRows * p.stage_pitch;

  // This block's chunk and its contiguous run [t, end) of the tiles.
  const int chunk = blockIdx.x % p.chunks;
  const int slots = gridDim.x / p.chunks;
  const int slot = blockIdx.x / p.chunks;
  long long t = slot * p.tiles / slots;
  const long long end = (slot + 1) * p.tiles / slots;
  if (t >= end) return;
  const int f0 = chunk * fc;
  const int fvalid = min(fc, p.f - f0);

  int tx = (int)(t % p.tiles_x);
  int ty = (int)((t / p.tiles_x) % p.tiles_y);
  int img = (int)(t / p.tiles_x / p.tiles_y);
  halo_pass<C1, false, BF16>(p, halo0, img, ty * kTH, tx * kTW);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < 9 * c; r += kWarps)
    for (int j = lane; j < fc; j += 32)
      ws[r * fc + j] =
          j < fvalid ? round_operand<BF16>(__ldg(p.w + (long long)r * p.f + f0 + j)) : 0.0f;
  for (int j = threadIdx.x; j < fc; j += kThreads) {
    const bool in = j < fvalid;
    bst[j] = in ? __ldg(p.b + f0 + j) : 0.0f;
    bst[fc + j] = in ? __ldg(p.s + f0 + j) : 0.0f;
    bst[2 * fc + j] = in ? __ldg(p.t + f0 + j) : 0.0f;
  }
  const Scale sc = make_scale(__ldg(p.so));

  // This thread's channel group and first item; its items step by rstep.
  const int groups = fc / kNG;
  const int rstep = kThreads / groups;
  const int g = threadIdx.x % groups;
  int r0 = threadIdx.x / groups;
  if (r0 >= rstep || kNG * g >= fvalid) r0 = kItems;  // no items

  for (int k = 0; t < end; ++t, ++k) {
    int ntx = tx + 1, nty = ty, nimg = img;
    if (ntx == p.tiles_x) {
      ntx = 0;
      if (++nty == p.tiles_y) {
        nty = 0;
        ++nimg;
      }
    }
    const bool more = t + 1 < end;
    float* cur = (k & 1) ? halo1 : halo0;
    if (two) {
      if (more) halo_pass<C1, false, BF16>(p, (k & 1) ? halo0 : halo1, nimg, nty * kTH,
                                           ntx * kTW);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (BF16) halo_pass<C1, true, BF16>(p, cur, img, ty * kTH, tx * kTW);
    if (STAGED && threadIdx.x < kStageRows) bulk_wait_read<1>();
    __syncthreads();

    const int y0 = ty * kTH, x0 = tx * kTW;
    uint8_t* stage = (k & 1) ? stage1 : stage0;
    for (int r = r0; r < kItems; r += rstep) {
      // rows ly0, ly0 + 1 from 4 (2k + h): the two half-warps of F = 64 take
      // the same columns of neighbouring row pairs
      const int q = r >> 1;
      const int ly0 = 2 * (2 * (q / kItemCols) + (r & 1));
      const int lx0 = kItemW * (q % kItemCols);

      // acc[dy * kItemW + dx][j]: pixel (ly0 + dy, lx0 + dx), channel 4g + j
      float acc[kItem][kNG];
#pragma unroll
      for (int i = 0; i < kItem; ++i)
#pragma unroll
        for (int j = 0; j < kNG; ++j) acc[i][j] = 0.0f;
      const float* hb = cur + ly0 * p.halo_pitch;  // halo row ly0: image row y0 + ly0 - 1
      if (C1) {
        // the kItemW + 2 inputs of halo rows ky and ky + 1 from column lx0 - 1
        // (index lx0 + 3): a scalar, a 16-byte load and a scalar each
        float xa[kItemW + 2], xb[kItemW + 2];
        auto load_row = [&](float (&xv)[kItemW + 2], const float* row) {
          const float* xr = row + lx0 + 3;
          const float4 v4 = *reinterpret_cast<const float4*>(xr + 1);
          xv[0] = xr[0];
          xv[1] = v4.x;
          xv[2] = v4.y;
          xv[3] = v4.z;
          xv[4] = v4.w;
          xv[5] = xr[5];
        };
        load_row(xa, hb);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          load_row(xb, hb + (ky + 1) * p.halo_pitch);
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float4 wv = *reinterpret_cast<const float4*>(ws + (ky * 3 + kx) * fc + kNG * g);
#pragma unroll
            for (int dx = 0; dx < kItemW; ++dx) {
              float* a0 = acc[dx];
              float* a1 = acc[kItemW + dx];
              a0[0] = mac<BF16>(xa[dx + kx], wv.x, a0[0]);
              a0[1] = mac<BF16>(xa[dx + kx], wv.y, a0[1]);
              a0[2] = mac<BF16>(xa[dx + kx], wv.z, a0[2]);
              a0[3] = mac<BF16>(xa[dx + kx], wv.w, a0[3]);
              a1[0] = mac<BF16>(xb[dx + kx], wv.x, a1[0]);
              a1[1] = mac<BF16>(xb[dx + kx], wv.y, a1[1]);
              a1[2] = mac<BF16>(xb[dx + kx], wv.z, a1[2]);
              a1[3] = mac<BF16>(xb[dx + kx], wv.w, a1[3]);
            }
          }
#pragma unroll
          for (int i = 0; i < kItemW + 2; ++i) xa[i] = xb[i];
        }
      } else {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float* xp = hb + ky * p.halo_pitch + (lx0 + kx) * c;  // column lx0 + kx - 1
            const float* wp = ws + (ky * 3 + kx) * c * fc + kNG * g;
            for (int ci = 0; ci < c; ++ci) {
              const float4 wv = *reinterpret_cast<const float4*>(wp + ci * fc);
#pragma unroll
              for (int i = 0; i < kItem; ++i) {
                const float xv = xp[(i / kItemW) * p.halo_pitch + (i % kItemW) * c + ci];
                acc[i][0] = mac<BF16>(xv, wv.x, acc[i][0]);
                acc[i][1] = mac<BF16>(xv, wv.y, acc[i][1]);
                acc[i][2] = mac<BF16>(xv, wv.z, acc[i][2]);
                acc[i][3] = mac<BF16>(xv, wv.w, acc[i][3]);
              }
            }
          }
        }
      }

      const float4 bv = *reinterpret_cast<const float4*>(bst + kNG * g);
      const float4 sv = *reinterpret_cast<const float4*>(bst + fc + kNG * g);
      const float4 tv = *reinterpret_cast<const float4*>(bst + 2 * fc + kNG * g);
      uint32_t words[kItem];
      if (sc.fast)
        epilogue<true>(acc, bv, sv, tv, sc, words);
      else
        epilogue<false>(acc, bv, sv, tv, sc, words);
      // Staged, the item's 8 words are 8 strides of fc apart from one base:
      // dense, two rows of 4 pixels; blocked, 2 blocked pixels x 4 phases.
      const int base = BLOCKED ? (ly0 >> 1) * p.stage_pitch + (lx0 >> 1) * 4 * fc
                               : ly0 * p.stage_pitch + lx0 * fc;
#pragma unroll
      for (int i = 0; i < kItem; ++i) {
        const int dy = i / kItemW, dx = i % kItemW;
        const uint32_t word = words[i];
        if (STAGED) {  // fc == f: the tile's codes laid out as the output's rows
          const int off = BLOCKED ? base + (4 * (dx >> 1) + 2 * dy + (dx & 1)) * fc
                                  : base + dy * p.stage_pitch + dx * fc;
          *reinterpret_cast<uint32_t*>(stage + off + kNG * g) = word;
        } else {
          const int y = y0 + ly0 + dy, x = x0 + lx0 + dx;
          if (y >= p.h || x >= p.w_) continue;
          long long off;
          if (BLOCKED) {
            off = (((long long)img * (p.h >> 1) + (y >> 1)) * (p.w_ >> 1) + (x >> 1)) * 4 * p.f +
                  ((y & 1) * 2 + (x & 1)) * p.f;
          } else {
            off = (((long long)img * p.h + y) * p.w_ + x) * p.f;
          }
          off += f0 + kNG * g;
          if ((p.f & 3) == 0) {  // whole, aligned words
            *reinterpret_cast<uint32_t*>(p.out + off) = word;
          } else {
            const int n = min(kNG, fvalid - kNG * g);
            for (int j = 0; j < n; ++j) p.out[off + j] = static_cast<int8_t>(word >> (8 * j));
          }
        }
      }
    }

    if (STAGED) fence_async_shared();
    __syncthreads();
    if (STAGED && threadIdx.x < kStageRows) {
      const int i = threadIdx.x;
      const int wv = min(kTW, p.w_ - x0);
      if (BLOCKED) {
        const int yb = (y0 >> 1) + i;
        if (yb < (p.h >> 1))
          bulk_store(p.out + (((long long)img * (p.h >> 1) + yb) * (p.w_ >> 1) + (x0 >> 1)) *
                                 4 * p.f,
                     stage + i * p.stage_pitch, (uint32_t)((wv >> 1) * 4 * p.f));
      } else {
        const int yy = y0 + i;
        if (yy < p.h)
          bulk_store(p.out + (((long long)img * p.h + yy) * p.w_ + x0) * p.f,
                     stage + i * p.stage_pitch, (uint32_t)(wv * p.f));
      }
      bulk_commit();
    }
    if (!two && more) {
      halo_pass<C1, false, BF16>(p, halo0, nimg, nty * kTH, ntx * kTW);
      cp_async_commit();
    }
    tx = ntx;
    ty = nty;
    img = nimg;
  }
  if (STAGED && threadIdx.x < kStageRows) bulk_wait_all();
}

// Holds requant_rcp against requant_div for each scale so_list[blockIdx.y]
// and adds to out[kWords] the values v whose words differ, to out[kQuotients]
// those whose corrected quotient differs from __fdiv_rn's on the clamped v,
// and to out[kNormal] those of the latter outside underflow: |v| >= 2^-100
// (so the residual v - q so, a multiple of 2^-48 |v| at least, is exact in
// f32) and a normal true quotient, where the correction is correctly
// rounded (Markstein). Below that, for 2^-64 <= so, the true quotient and
// the corrected one are under 2^-34, both code 0. It keeps in
// out[kLargestQ] and out[kLargestV] the bits of the largest |__fdiv_rn
// quotient| and |v| among the differing ones, and the bits of the first
// kExamples differing words' (so, v) in out[kFirst + 2j], out[kFirst + 2j +
// 1]. v runs over every f32 bit pattern (exhaustive) or `count` draws of a
// hash of (seed, i): half random bit patterns, half within 8 ulps of (k +
// 1/2) so, the ties of the rounding, for k in -128..128.
enum CheckSlot { kWords = 0, kQuotients, kNormal, kLargestQ, kLargestV, kFirst };
constexpr int kExamples = 8;

__global__ void requant_check_kernel(const float* so_list, long long count, int exhaustive,
                                     unsigned long long seed, unsigned long long* out) {
  const Scale sc = make_scale(so_list[blockIdx.y]);
  unsigned long long quotients = 0, normal = 0, largest_q = 0, largest_v = 0;
  const long long n = exhaustive ? (1LL << 32) : count;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v;
    if (exhaustive) {
      v = __uint_as_float((uint32_t)i);
    } else {
      unsigned long long z = seed + (unsigned long long)i * 0x9E3779B97F4A7C15ULL +
                             blockIdx.y * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      z ^= z >> 31;
      if (z & 1) {
        v = __uint_as_float((uint32_t)(z >> 32));
      } else {
        const float k = (float)((int)((z >> 8) % 257) - 128) + 0.5f;
        const int d = (int)((z >> 24) % 17) - 8;
        v = __uint_as_float(__float_as_uint(__fmul_rn(k, sc.so)) + d);
      }
    }
    if (requant_rcp(v, sc.so, sc.r, sc.m) != requant_div(v, sc.so)) {
      const unsigned long long j = atomicAdd(out + kWords, 1ULL);
      if (j < kExamples) {
        out[kFirst + 2 * j] = __float_as_uint(sc.so);
        out[kFirst + 2 * j + 1] = __float_as_uint(v);
      }
    }
    const float vc = fminf(fmaxf(v, -sc.m), sc.m);
    const float q = __fmul_rn(vc, sc.r);
    const float q1 = __fmaf_rn(__fmaf_rn(-q, sc.so, vc), sc.r, q);
    const float want = __fdiv_rn(vc, sc.so);
    if (__float_as_uint(q1) != __float_as_uint(want)) {
      ++quotients;
      normal += fabsf(vc) >= 0x1p-100f && fabsf(want) >= 0x1p-126f;
      largest_q = max(largest_q, (unsigned long long)__float_as_uint(fabsf(want)));
      largest_v = max(largest_v, (unsigned long long)__float_as_uint(fabsf(vc)));
    }
  }
  if (quotients) {
    atomicAdd(out + kQuotients, quotients);
    atomicAdd(out + kNormal, normal);
    atomicMax(out + kLargestQ, largest_q);
    atomicMax(out + kLargestV, largest_v);
  }
}

using Kernel = void (*)(Params);

// The kernel for dtype code, layout, C == 1 and staged codes.
Kernel pick(int dtype, bool blocked, bool c1, bool staged) {
  static const Kernel table[16] = {
      input_conv_kernel<false, false, false, false>, input_conv_kernel<false, false, false, true>,
      input_conv_kernel<false, false, true, false>,  input_conv_kernel<false, false, true, true>,
      input_conv_kernel<false, true, false, false>,  input_conv_kernel<false, true, false, true>,
      input_conv_kernel<false, true, true, false>,   input_conv_kernel<false, true, true, true>,
      input_conv_kernel<true, false, false, false>,  input_conv_kernel<true, false, false, true>,
      input_conv_kernel<true, false, true, false>,   input_conv_kernel<true, false, true, true>,
      input_conv_kernel<true, true, false, false>,   input_conv_kernel<true, true, false, true>,
      input_conv_kernel<true, true, true, false>,    input_conv_kernel<true, true, true, true>};
  return table[(dtype == kBf16) * 8 + blocked * 4 + c1 * 2 + staged];
}

// SMs of the current device and resident blocks of `kernel` at `smem` bytes,
// each queried once per device (and kernel and size) and kept.
cudaError_t occupancy(Kernel kernel, int smem, int* sms, int* resident) {
  struct Entry {
    int dev;
    Kernel kernel;
    int smem, blocks;
  };
  static std::mutex mu;
  static int sm_counts[64];
  static Entry cache[64];
  static int cached = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  const bool keep = dev >= 0 && dev < 64;
  int n = keep ? sm_counts[dev] : 0;
  if (n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (keep) sm_counts[dev] = n;
  }
  *sms = n;
  for (int i = 0; i < cached; ++i)
    if (cache[i].dev == dev && cache[i].kernel == kernel && cache[i].smem == smem) {
      *resident = cache[i].blocks;
      return cudaSuccess;
    }
  // Every launch of this kernel on this device may then take up to kMaxSmem.
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  if (keep && cached < 64) cache[cached++] = {dev, kernel, smem, blocks};
  *resident = blocks;
  return cudaSuccess;
}

int tile_h(int c) { return c == 1 ? Tile<true>::h : Tile<false>::h; }
int tile_w(int c) { return c == 1 ? Tile<true>::w : Tile<false>::w; }

// One buffer of halo, in floats: the tile and its 1-pixel ring, rows tile
// width + 8 apart at C == 1 (column -1 at index 3, so the inner values of an
// item are 16-byte aligned), else (tile width + 2) * c apart, rounded up to 4.
int halo_floats(int c) {
  return c == 1 ? (Tile<true>::h + 2) * Tile<true>::pitch
                : ((Tile<false>::h + 2) * (Tile<false>::w + 2) * c + 3) / 4 * 4;
}

// Shared memory of a block, in bytes: `stages` halo buffers, the chunk's
// weights and b, s, t, and with `staged` two buffers of a tile's codes.
long long smem_bytes(int c, int fc, int stages, bool staged) {
  const long long codes =
      staged ? 2LL * tile_h(c) * ((long long)tile_w(c) * fc + kStagePad) : 0;
  return 4LL * ((long long)stages * halo_floats(c) + 9LL * c * fc + 3LL * fc) + codes;
}

// The chunk of output channels a block takes (fc), its halo buffers and
// whether its codes leave by bulk copy: all of f staged with two halo
// buffers where f % 16 == 0 and that fits (a tile row's codes are then
// contiguous in the output); otherwise the widest multiple of 16 up to
// kMaxFc that fits with two halo buffers, else with one (C >= 71). False
// where not even 16 channels fit (C >= 120).
bool choose(int c, int f, int* fc, int* stages, bool* staged) {
  if (f % kGroup == 0 && f <= kMaxFc && smem_bytes(c, f, 2, true) <= kMaxSmem) {
    *fc = f;
    *stages = 2;
    *staged = true;
    return true;
  }
  *staged = false;
  for (*stages = 2; *stages >= 1; --*stages) {
    *fc = f > kMaxFc ? kMaxFc : (f + kGroup - 1) / kGroup * kGroup;
    while (*fc > kGroup && smem_bytes(c, *fc, *stages, false) > kMaxSmem) *fc -= kGroup;
    if (smem_bytes(c, *fc, *stages, false) <= kMaxSmem) return true;
  }
  return false;
}

struct Launch {
  Params p;
  Kernel kernel;
  bool staged;
  int smem, grid, resident, sms;
};

cudaError_t plan(int n, int h, int w_, int c, int f, int dtype, int blocked, Launch* l) {
  if (n <= 0 || h <= 0 || w_ <= 0 || c <= 0 || f <= 0) return cudaErrorInvalidValue;
  if ((dtype != kF32 && dtype != kBf16) || (blocked && (h % 2 || w_ % 2)))
    return cudaErrorInvalidValue;
  if ((long long)n * h * w_ >= (1LL << 31) || (long long)w_ * c >= (1LL << 31))
    return cudaErrorInvalidValue;
  Params& p = l->p;
  if (!choose(c, f, &p.fc, &p.stages, &l->staged)) return cudaErrorInvalidValue;
  p.h = h;
  p.w_ = w_;
  p.c = c;
  p.f = f;
  p.chunks = (f + p.fc - 1) / p.fc;
  p.tiles_x = (w_ + tile_w(c) - 1) / tile_w(c);
  p.tiles_y = (h + tile_h(c) - 1) / tile_h(c);
  p.tiles = (long long)n * p.tiles_y * p.tiles_x;
  p.halo_floats = halo_floats(c);
  p.halo_pitch = c == 1 ? Tile<true>::pitch : (Tile<false>::w + 2) * c;
  p.stage_pitch = (blocked ? 2 : 1) * (tile_w(c) * f + kStagePad);
  l->kernel = pick(dtype, blocked != 0, c == 1, l->staged);
  l->smem = (int)smem_bytes(c, p.fc, p.stages, l->staged);
  const cudaError_t e = occupancy(l->kernel, l->smem, &l->sms, &l->resident);
  if (e != cudaSuccess) return e;
  long long slots = (long long)l->sms * l->resident / p.chunks;
  if (slots < 1) slots = 1;
  if (slots > p.tiles) slots = p.tiles;
  if (slots * p.chunks >= (1LL << 31)) return cudaErrorInvalidValue;
  l->grid = (int)(slots * p.chunks);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x: f32 [n, h, w, c]; w: f32 [3, 3, c, f] (HWIO); b, s, t: f32 [f]; so: f32
// scalar on the device; out: int8 [n, h, w, f], or with `blocked` (h and w
// even) [n, h/2, w/2, 4f], 16-byte aligned; all contiguous on one device.
// dtype: 0 (float32 operands) or 1 (bfloat16). Plans the launch (`plan`) and
// makes it on `stream`; returns 0 or the cudaError_t of the plan or the launch
// (cudaErrorInvalidValue where the shapes are refused, or where c >= 120
// leaves no room in shared memory); the caller checked devices and dtypes.
int tpuseg_input_conv(const float* x, const float* w, const float* b, const float* s,
                      const float* t, const float* so, void* out, int n, int h, int w_,
                      int c, int f, int dtype, int blocked, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) & 15) return (int)cudaErrorInvalidValue;
  Launch l;
  cudaError_t e = plan(n, h, w_, c, f, dtype, blocked, &l);
  if (e != cudaSuccess) return (int)e;
  l.p.x = x;
  l.p.w = w;
  l.p.b = b;
  l.p.s = s;
  l.p.t = t;
  l.p.so = so;
  l.p.out = static_cast<int8_t*>(out);
  l.kernel<<<l.grid, kThreads, l.smem, static_cast<cudaStream_t>(stream)>>>(l.p);
  return (int)cudaGetLastError();
}

// The launch tpuseg_input_conv would make on the current device, without
// making it: out[0] blocks, out[1] resident blocks per SM, out[2] SMs,
// out[3] tiles (clipped to 2^31 - 1), out[4] shared memory bytes per block,
// out[5] and out[6] the tile's rows and columns, out[7] the output channels
// of a chunk, out[8] halo buffers, out[9] 1 where the codes leave by bulk
// copy. Returns 0 or a cudaError_t.
int tpuseg_input_conv_plan(int n, int h, int w_, int c, int f, int dtype, int blocked,
                           int* out) {
  Launch l;
  const cudaError_t e = plan(n, h, w_, c, f, dtype, blocked, &l);
  if (e != cudaSuccess) return (int)e;
  out[0] = l.grid;
  out[1] = l.resident;
  out[2] = l.sms;
  out[3] = (int)(l.p.tiles < (1LL << 31) ? l.p.tiles : (1LL << 31) - 1);
  out[4] = l.smem;
  out[5] = tile_h(c);
  out[6] = tile_w(c);
  out[7] = l.p.fc;
  out[8] = l.p.stages;
  out[9] = l.staged;
  return 0;
}

// requant_check_kernel over `nso` scales on the device (so_list), every f32 v
// if `exhaustive`, else `count` hashed draws each; adds its counts to out[0]
// (words), out[1] (quotients) and out[2] (quotients outside underflow),
// keeps the bits of the largest differing |quotient| and |v| in out[3] and
// out[4] and the first 8 differing words' (so, v) bits in out[5..20], all
// zeroed by the caller. Returns 0 or a cudaError_t of the launch.
int tpuseg_input_conv_check_requant(const float* so_list, int nso, long long count,
                                    int exhaustive, unsigned long long seed,
                                    unsigned long long* out, void* stream) {
  if (nso <= 0 || nso > 65535 || (!exhaustive && count <= 0)) return (int)cudaErrorInvalidValue;
  const dim3 grid(1024, nso);
  requant_check_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      so_list, count, exhaustive, seed, out);
  return (int)cudaGetLastError();
}

const char* tpuseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
