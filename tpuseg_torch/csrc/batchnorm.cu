// Bias + ReLU + BatchNorm (kernel K4), for Hopper: four kernels.
//
// Replaces what XLA fuses on the TPU around every conv of
// tpuseg/models/unet.py: ConvBlock (:94-102, the conv's `+ bias`, nn.relu,
// nn.BatchNorm) and DeconvBlock (:163-170, nn.BatchNorm), in train mode
// (batch statistics, forward and backward) and eval mode (running
// statistics). Same contract as tpuseg_torch/ops/batchnorm.py's plain
// versions. The input x is the conv's output in the model's dtype (bf16 or
// f32), m = N*H*W rows of c channels with a row stride ld (channels-last:
// ld == c; a channel slice of a concat's gradient: ld > c). Per element, in
// f32 with each operation rounded on its own (the _rn intrinsics, so nvcc
// cannot contract them into FMAs that PyTorch's separate eager kernels do
// not form):
//   a    = relu(r(x + r(bias)))            (r: round to the dtype; bias and relu optional)
//   (a)  stats:            out = [sum a, sum a^2, n]                      per channel
//   (b)  apply:            y   = r(((a - mean) * mul) + beta)
//   (c)  backward reduce:  out = [sum g, sum g*ah (, sum relu'*g, sum relu', sum relu'*ah)]
//                          with ah = (a - mean) * rstd; the last three with a bias
//   (d)  backward apply:   dx  = relu' ? r(((g - k1) - ah * k2) * mul) : 0
// (b) and (d) are bit-equal to the plain versions given the same vectors;
// (a) and (c) sum in another order.
//
// The order after (relu 2, TransUNet's conv -> BatchNorm -> ReLU; no bias):
// a = x, and the ReLU comes after the normalization, a compile-time form
// (POST) of (b), (c) and (d), so that the forms above compile as they did:
//   (a)  stats of x, as without a ReLU
//   (b)  y   = relu(r(((a - mean) * mul) + beta))
//   (c)  and (d) take g' = (o <= 0) ? 0 : g in g's place, with o = r(((a -
//        mean) * mul) + beta) recomputed from x (autograd's relu' of y:
//        threshold_backward, where NaN passes), mul and beta given.
//
// (b) has two store forms, which take the bf16/f32 eval walk's concats and
// max pools off the card's other queues: y goes to rows of any stride ldy
// >= c (a channel slice of the decoder's concat buffer [n, 2c, h, w],
// channels-last), and with a pooled output (h and w even) the same pass
// also writes the 2x2/2 max of y, [n, h/2, w/2, c] contiguous. Its threads
// walk pooled pixels: each loads its channels of the window's four rows
// (both horizontal neighbours back to back, so a warp's loads still cover
// whole 128-byte lines), stores the four rows of y and their max. The max
// runs over the rounded y in F.max_pool2d's window order and rule (take v
// where v > max or v is NaN, from -inf), so it equals F.max_pool2d(y) bit
// for bit, NaN included. Train mode takes both forms too (the U-Net's
// levels 1-3), and then (c) and (d) have a pooled form of their own: given
// gp, the gradient of the pooled output (rows of stride ldgp), their
// threads walk the same windows of x and g, recompute the four y from x,
// mean, mul and beta (bit-equal to what (b) wrote), pick the window's
// argmax tap by (b)'s rule (the first maximum, the last NaN: max_pool2d's
// index), and take r(g + (tap is the argmax ? gp : 0)) in g's place, as
// autograd adds the concat's and the pool's gradients (so -0 + 0 is +0).
// No index is stored, no pool backward runs, no gradient is added apart.
//
// The per-channel vectors come from the sums inside the kernels, with no
// launch between them: (b) in train mode derives, in its prologue, from
// (a)'s sums (or their all-reduce across a process group) exactly what the
// plain finalize() does, op for op: mean = s0 / n, raw = s1 / n - mean^2,
// var = raw < 0 ? 0 : raw, rstd = rsqrtf(var + eps) (what torch.rsqrt is
// on the card), mul = rstd * gamma; in eval mode rstd and mul from the
// running variance. Every block derives its tile's vectors from the same
// sums by the same f32 operations, so all get the same bits; the blocks of
// column 0 also write them out ([mean, var, rstd, mul, unclipped]) and
// update the running statistics in place (momentum * running + (1 -
// momentum) * batch, each product and the sum rounded, as the eager update
// did). (d) in train mode derives k1 = sum g / n and k2 = unclipped ? sum
// g*ah / n : 0 from (c)'s sums (or their all-reduce) in its prologue, and its
// column-0 blocks write the bias gradient mul * ((s2 - k1 * s3) - k2 * s4).
//
// Bound: memory. Per element (a) reads x, (b) reads x and writes y, (c)
// reads x and g, (d) reads x and g and writes dx: 1, 2, 2 and 3 times the
// activation's bytes, against a dozen flops; the pooled forms add a
// quarter (y/4 written, gp read) and, in (c) and (d), the recomputed y and
// argmax, some thirty flops an element. A train step at 512^2, batch 8,
// base 64 sums N*H*W*C over its 23 BatchNorm layers to 1.28e9 elements,
// 2.56 GB in bf16: 8 x 2.56 GB at 3.35 TB/s, ~6.1 ms a step.
//
// Design (simple first). Every kernel maps a block of 256 threads onto a
// tile of up to 64 channels (grid.y walks the tiles) and as many rows as
// its threads cover at once: each thread owns 16 bytes of one row (8 bf16
// or 4 f32 channels, one 16-byte load) where c, ld and the pointers allow.
// Where a row is narrower than 16 bytes and divides them (bf16 c = 1, 2,
// 4; f32 c = 1, 2; the head's c = 2) and the rows are contiguous, a thread
// loads 16 bytes that span PACK = 16 / (c * esize) whole rows (the packed
// narrow path): slot j of a load is channel j % c, the last load of the
// tensor is masked element by element. Otherwise (a concat's channel slice
// of a narrow layer, c = 3 ...) each thread loads one element (the narrow
// path). Threads keep their channels' vectors in registers. Rows advance
// in batches of kUnroll loads, loads first, to keep bytes in flight; (b)
// issues its first batch before it derives its vectors. The
// reductions are deterministic without float atomics: each block sums a
// fixed chunk of rows (each thread its rows in order, a packed thread then
// its slots of a channel in slot order, then the block's row lanes through
// shared memory) into its partials, and the last block of a channel tile
// to finish, found with an integer counter (left at zero for the next
// launch), adds the partials. Both sums over a column (the row lanes, the
// blocks) take L lanes a column, as many as 256 threads give the columns
// (a power of two: 1 at enc1's 64 channels and 5 sums, 64 at the head's 2
// channels and 2 sums), lane l the values l, l + L, ... in order with 8
// loads in flight, then a pairwise tree over the lanes, all in a fixed
// order. The block count of a reduction depends on m and c alone, not on
// the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 64;               // channels of a tile (grid.y)
constexpr int kUnroll = 4;               // rows a thread loads before it computes
constexpr int kPoolUnroll = 2;           // (b)'s pooled form's windows (4 rows each) likewise
constexpr int kPoolBackwardUnroll = 1;   // (c)'s and (d)'s pooled forms' (9 loads a window)
constexpr int kReduceBlocks = 264;       // blocks of a reduction, over all tiles
constexpr int kMinRowsPerBlock = 64;     // rows (loads) a reduction block takes at least
constexpr int kApplyBlocks = 528;        // blocks of an elementwise pass, over all tiles
constexpr int kMaxTiles = 64;            // counters the caller provides
// Blocks an SM holds of the pooled (c) and (d), so at most 128 registers a
// thread: at ~190 an SM held one block of 8 warps, too few to hide the
// loads' latency behind their arithmetic (with one window a thread: at
// enc1b's train shape (c) 0.69 -> 0.53 ms and (d) 0.70 -> 0.63 ms, a few
// bytes spilled, on an H100)
constexpr int kPoolBackwardBlocks = 2;

// Loads (windows, in the pooled forms) a thread issues before it computes.
template <bool BWD, bool POOL>
__host__ __device__ constexpr int unroll_of() {
  return POOL ? (BWD ? kPoolBackwardUnroll : kPoolUnroll) : kUnroll;
}

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// VEC elements as they are loaded: one 16-byte vector (kept packed until
// each element is used, so a bf16 vector takes 4 registers), or one element
// on the narrow path.
template <typename T, int VEC>
struct Raw {
  static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes");
  using type = uint4;
};

template <typename T>
struct Raw<T, 1> {
  using type = T;
};

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename Raw<T, VEC>::type*>(p);
}

// The packed path's last load of the tensor: its first `valid` elements,
// one by one (the rest zero, and masked where they are used).
template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_part(const T* p, int valid) {
  typename Raw<T, VEC>::type raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) e[j] = j < valid ? p[j] : T(0.f);
  return raw;
}

template <typename T, int VEC>
__device__ __forceinline__ float element(const typename Raw<T, VEC>::type& r, int j) {
  return Elt<T>::load(reinterpret_cast<const T*>(&r) + j);
}

// VEC values to p: one 16-byte store, or the first `valid` one by one.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC], int valid) {
  if (valid >= VEC) {
    typename Raw<T, VEC>::type raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) Elt<T>::store(e + j, v[j]);
    *reinterpret_cast<typename Raw<T, VEC>::type*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < valid) Elt<T>::store(p + j, v[j]);
  }
}

// a = relu(r(x + r(bias))): PyTorch's bf16 add rounds the f32 sum, and its
// relu keeps x unless x < 0 (NaN and -0 pass, as clamp_min passes them).
template <typename T>
__device__ __forceinline__ float activation(float x, float b, bool has_bias, bool relu) {
  const float a = has_bias ? Elt<T>::round(__fadd_rn(x, b)) : x;
  return (relu && a < 0.f) ? 0.f : a;
}

// The order after's normalized o = r(((a - mean) * mul) + beta), (b)'s y
// before its ReLU.
template <typename T>
__device__ __forceinline__ float normalized(float a, float mean, float mul, float beta) {
  return Elt<T>::round(__fadd_rn(__fmul_rn(__fsub_rn(a, mean), mul), beta));
}

// The order after's g': g where relu(o) > 0, else 0 (threshold_backward's
// rule on y = relu(o): zero where y <= 0, so NaN passes).
template <typename T>
__device__ __forceinline__ float after_gradient(float a, float mean, float mul, float beta,
                                                float g) {
  return normalized<T>(a, mean, mul, beta) <= 0.f ? 0.f : g;
}

// The tap (0-3, F.max_pool2d's order) of a window's max of y = o(a), by
// the pooled form's rule: take v where v > max or v is NaN, from -inf.
template <typename T>
__device__ __forceinline__ int window_argmax(const float (&a)[4], float mean, float mul,
                                             float beta) {
  float mx = -__int_as_float(0x7f800000);
  int arg = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float v = normalized<T>(a[q], mean, mul, beta);
    if (v > mx || isnan(v)) {
      mx = v;
      arg = q;
    }
  }
  return arg;
}

// Tap q's gradient in a pooled backward: r(g + (q is the argmax ? gp : 0)),
// autograd's add of the concat's and the pool's gradients.
template <typename T>
__device__ __forceinline__ float pooled_gradient(float g, float gp, int q, int arg) {
  return Elt<T>::round(__fadd_rn(g, q == arg ? gp : 0.f));
}

// (c)'s terms of one element into a thread's sums.
template <int NS, int VEC>
__device__ __forceinline__ void add_terms(float (&acc)[NS][VEC], int j, float a, float ah,
                                          float gg, int relu) {
  acc[0][j] = __fadd_rn(acc[0][j], gg);
  acc[1][j] = __fmaf_rn(gg, ah, acc[1][j]);
  if constexpr (NS == 5) {
    if (!relu || a > 0.f) {  // relu' (1 without a ReLU)
      acc[2][j] = __fadd_rn(acc[2][j], gg);
      acc[3][j] = __fadd_rn(acc[3][j], 1.f);
      acc[4][j] = __fadd_rn(acc[4][j], ah);
    }
  }
}

// (d)'s dx of one element: relu' ? r(((g - k1) - ah * k2) * mul) : 0.
__device__ __forceinline__ float input_gradient(float a, float gg, float mean, float rstd,
                                                float k1, float k2, float mul, int relu) {
  const float ah = __fmul_rn(__fsub_rn(a, mean), rstd);
  const float dd = __fmul_rn(__fsub_rn(__fsub_rn(gg, k1), __fmul_rn(ah, k2)), mul);
  return (relu && !(a > 0.f)) ? 0.f : dd;
}

// The tile geometry of a block: threads per row, rows per iteration, this
// thread's row lane and first channel, and whether it has channels. On the
// packed path (PACK > 1) a "row" is one 16-byte load of PACK rows: one
// thread per load, its slot j channel j % (VEC / PACK).
template <int VEC, int PACK>
struct Tile {
  int tpr, rpi, lr, c0;
  bool active;
  __device__ __forceinline__ Tile(int c) {
    const int tile_c = PACK > 1 ? VEC : min(c, kTileC);
    tpr = (tile_c + VEC - 1) / VEC;
    rpi = kThreads / tpr;
    lr = threadIdx.x / tpr;
    c0 = PACK > 1 ? 0 : blockIdx.y * kTileC + (threadIdx.x % tpr) * VEC;
    active = lr < rpi && c0 < c;
  }
  // channel of slot j
  __device__ __forceinline__ int channel(int j) const {
    return PACK > 1 ? j % (VEC / PACK) : c0 + j;
  }
  // whether slot j is its channel's first in this thread (it writes the
  // channel's outputs)
  __device__ __forceinline__ bool first(int j) const { return PACK == 1 || j < VEC / PACK; }
};

// Load `r` of a pass over m rows: its address and, on the packed path, the
// valid elements of the tensor's last load.
template <int VEC, int PACK>
__device__ __forceinline__ long long row_offset(long long r, long long ld, int c0) {
  return PACK > 1 ? r * VEC : r * ld + c0;
}

template <int VEC, int PACK>
__device__ __forceinline__ int valid_of(long long r, long long m, int c) {
  if (PACK == 1) return VEC;
  const long long left = (m - r * PACK) * c;
  return left < VEC ? (int)left : VEC;
}

// U loads of a thread, rows r0, r0 + rpi, ..., those below `end`: x's,
// and g's with BWD; the packed path's last load of the tensor masked.
template <typename T, int VEC, int PACK, int U, bool BWD>
__device__ __forceinline__ void load_batch(const T* x, long long ldx, const T* g, long long ldg,
                                           long long r0, int rpi, int c0, long long end,
                                           long long m, int c,
                                           typename Raw<T, VEC>::type (&xv)[U],
                                           typename Raw<T, VEC>::type (&gv)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long r = r0 + (long long)u * rpi;
    if (r < end) {
      const int valid = valid_of<VEC, PACK>(r, m, c);
      if (valid == VEC) {
        xv[u] = load_raw<T, VEC>(x + row_offset<VEC, PACK>(r, ldx, c0));
        if constexpr (BWD) gv[u] = load_raw<T, VEC>(g + row_offset<VEC, PACK>(r, ldg, c0));
      } else {
        xv[u] = load_part<T, VEC>(x + row_offset<VEC, PACK>(r, ldx, c0), valid);
        if constexpr (BWD) gv[u] = load_part<T, VEC>(g + row_offset<VEC, PACK>(r, ldg, c0), valid);
      }
    }
  }
}

// The first row of pooled pixel p's window, for [n, h/2, w/2] pooled
// pixels over [n, h, w] rows: p = (b * h/2 + i) * w/2 + j takes rows
// (b * h + 2i) * w + 2j (returned), + 1, + w and + w + 1.
__device__ __forceinline__ long long window_row(long long p, long long w) {
  const long long half = w >> 1;
  return 2 * ((p / half) * w + p % half);
}

// U windows of a thread, pooled pixels p0, p0 + rpi, ..., those below
// `end`: the four rows of window u into xv[4u .. 4u + 3], in
// F.max_pool2d's order (top left, top right, bottom left, bottom right).
template <typename T, int VEC, int U>
__device__ __forceinline__ void load_windows(const T* x, long long ldx, long long p0, int rpi,
                                             int c0, long long end, long long w,
                                             typename Raw<T, VEC>::type (&xv)[4 * U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long p = p0 + (long long)u * rpi;
    if (p < end) {
      const T* top = x + window_row(p, w) * ldx + c0;
      xv[4 * u] = load_raw<T, VEC>(top);
      xv[4 * u + 1] = load_raw<T, VEC>(top + ldx);
      xv[4 * u + 2] = load_raw<T, VEC>(top + w * ldx);
      xv[4 * u + 3] = load_raw<T, VEC>(top + (w + 1) * ldx);
    }
  }
}

// U rows of the pooled gradient gp (one a window), pooled pixels p0, p0 +
// rpi, ..., those below `end`.
template <typename T, int VEC, int U>
__device__ __forceinline__ void load_pooled(const T* gp, long long ldgp, long long p0, int rpi,
                                            int c0, long long end,
                                            typename Raw<T, VEC>::type (&pv)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long p = p0 + (long long)u * rpi;
    if (p < end) pv[u] = load_raw<T, VEC>(gp + p * ldgp + c0);
  }
}

struct Vectors {
  const float *bias, *mean, *rstd, *mul, *beta, *k1, *k2;
};

// Where (b) and (d) take their per-channel vectors from. (b): in train
// mode the sums `stats` [3, c] = [sum a, sum a^2, n], writing `vec` [5, c]
// and updating run_mean / run_var (if given); in eval mode run_mean and
// run_var. (d): in train mode `totals` (rows sum g, sum g*ah, row stride c)
// and n = stats[2], with `unclipped` (vec's row 4) and, where dbias is
// given, the local sums `sums` [5, c] for the bias gradient; in eval mode
// the given k1 and k2.
struct Derive {
  bool train;
  const float* stats;
  const float* gamma;
  float eps;
  float* vec;
  float* run_mean;
  float* run_var;
  float momentum, one_minus_momentum;
  const float* totals;
  const float* unclipped;
  const float* sums;
  float* dbias;
};

template <int VEC>
__device__ __forceinline__ void load_params(const float* p, const int (&ch)[VEC],
                                            float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = p ? __ldg(p + ch[j]) : 0.f;
}

// log2 of the lanes column_sums gives each of `cols` columns: as many as
// the block's threads allow, a power of two.
__host__ __device__ __forceinline__ int lanes_log2(int cols) {
  int lg = 0;
  while ((2 << lg) * cols <= kThreads) ++lg;
  return lg;
}

// The sum of n values of each of `cols` columns into lanes[col << lg],
// deterministic: L = 1 << lg lanes a column, lane l adds the values l, l + L,
// l + 2L, ... in order (8 loads in flight), then a pairwise tree over the
// lanes (lane q takes lane q + h for h = 1, 2, 4, ...). base(col) is the
// column's first value, load(base, q) its value q. Returns lg; the block's
// threads are synchronised after.
template <typename Base, typename Load>
__device__ __forceinline__ int column_sums(int cols, int n, float* lanes, Base base, Load load) {
  const int lg = lanes_log2(cols);
  const int nl = 1 << lg;
  for (int i = threadIdx.x; i < (cols << lg); i += kThreads) {
    const auto b = base(i >> lg);
    float s = 0.f;
    int q = i & (nl - 1);
    for (; q + 7 * nl < n; q += 8 * nl) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = load(b, q + u * nl);
#pragma unroll
      for (int u = 0; u < 8; ++u) s = __fadd_rn(s, v[u]);
    }
    for (; q < n; q += nl) s = __fadd_rn(s, load(b, q));
    lanes[i] = s;
  }
  __syncthreads();
  for (int h = 1; h < nl; h <<= 1) {
    for (int i = threadIdx.x; i < (cols << lg); i += kThreads)
      if ((i & (2 * h - 1)) == 0) lanes[i] = __fadd_rn(lanes[i], lanes[i + h]);
    __syncthreads();
  }
  return lg;
}

// (a) with BWD false, (c) with BWD true: NS sums a channel. Block bx sums
// rows (loads on the packed path) [bx * rpb, (bx + 1) * rpb) into
// partials[bx][k][c]; the tile's last block adds them into out[k][c], and
// (a)'s also writes n = m into out[2][c]. POST: (c) of the order after.
// POOL: (c)'s pooled form, whose blocks take pooled pixels of rows `w`
// wide (each its window's four rows) and the pooled gradient gp.
template <typename T, int VEC, int PACK, int NS, bool BWD, bool POST, bool POOL>
__global__ void __launch_bounds__(kThreads, POOL ? kPoolBackwardBlocks : 1)
bn_reduce_kernel(const T* __restrict__ x, long long ldx, const T* __restrict__ g, long long ldg,
                 const T* __restrict__ gp, long long ldgp, long long w, Vectors vec, int relu,
                 long long m, int c, long long rpb, float* __restrict__ out,
                 float* __restrict__ partials, int* __restrict__ counters) {
  static_assert(!POST || (BWD && NS == 2), "the order after's reduce is (c) without a bias");
  static_assert(!POOL || (BWD && !POST && PACK == 1), "the pooled (c): one row a load");
  extern __shared__ float smem[];  // [NS][rpi][sw], then the lane buffer of column_sums
  __shared__ bool last;
  const Tile<VEC, PACK> t(c);
  const bool has_bias = vec.bias != nullptr;
  const long long rows = POOL ? m / 4 : PACK > 1 ? (m + PACK - 1) / PACK : m;
  float acc[NS][VEC];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] = 0.f;
  if (t.active) {
    int ch[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) ch[j] = t.channel(j);
    float bb[VEC], mu[VEC], rs[VEC];
    [[maybe_unused]] float ml[VEC], bt[VEC];
    load_params<VEC>(vec.bias, ch, bb);
#pragma unroll
    for (int j = 0; j < VEC; ++j) bb[j] = has_bias ? Elt<T>::round(bb[j]) : 0.f;
    if constexpr (BWD) {
      load_params<VEC>(vec.mean, ch, mu);
      load_params<VEC>(vec.rstd, ch, rs);
    }
    if constexpr (POST || POOL) {
      load_params<VEC>(vec.mul, ch, ml);
      load_params<VEC>(vec.beta, ch, bt);
    }
    const long long r_end = min(rows, (blockIdx.x + 1) * rpb);
    if constexpr (POOL) {  // pooled pixels, each its window's taps in order
      constexpr int U = kPoolBackwardUnroll;
      for (long long p0 = blockIdx.x * rpb + t.lr; p0 < r_end; p0 += (long long)U * t.rpi) {
        typename Raw<T, VEC>::type xv[4 * U], gv[4 * U], pv[U];
        load_windows<T, VEC, U>(x, ldx, p0, t.rpi, t.c0, r_end, w, xv);
        load_windows<T, VEC, U>(g, ldg, p0, t.rpi, t.c0, r_end, w, gv);
        load_pooled<T, VEC, U>(gp, ldgp, p0, t.rpi, t.c0, r_end, pv);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (p0 + (long long)u * t.rpi >= r_end) break;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float a[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              a[q] = activation<T>(element<T, VEC>(xv[4 * u + q], j), bb[j], has_bias, relu);
            const int arg = window_argmax<T>(a, mu[j], ml[j], bt[j]);
            const float gpj = element<T, VEC>(pv[u], j);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float gg = pooled_gradient<T>(element<T, VEC>(gv[4 * u + q], j), gpj, q, arg);
              add_terms<NS, VEC>(acc, j, a[q], __fmul_rn(__fsub_rn(a[q], mu[j]), rs[j]), gg,
                                 relu);
            }
          }
        }
      }
    } else {
      for (long long r0 = blockIdx.x * rpb + t.lr; r0 < r_end; r0 += (long long)kUnroll * t.rpi) {
        typename Raw<T, VEC>::type xv[kUnroll], gv[kUnroll];
        load_batch<T, VEC, PACK, kUnroll, BWD>(x, ldx, g, ldg, r0, t.rpi, t.c0, r_end, m, c, xv,
                                               gv);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long r = r0 + (long long)u * t.rpi;
          if (r >= r_end) break;
          const int valid = valid_of<VEC, PACK>(r, m, c);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            if (j >= valid) break;
            const float a = activation<T>(element<T, VEC>(xv[u], j), bb[j], has_bias, relu);
            if constexpr (!BWD) {
              acc[0][j] = __fadd_rn(acc[0][j], a);
              acc[1][j] = __fmaf_rn(a, a, acc[1][j]);
            } else {
              float gg = element<T, VEC>(gv[u], j);
              if constexpr (POST) gg = after_gradient<T>(a, mu[j], ml[j], bt[j], gg);
              add_terms<NS, VEC>(acc, j, a, __fmul_rn(__fsub_rn(a, mu[j]), rs[j]), gg, relu);
            }
          }
        }
      }
    }
    if constexpr (PACK > 1) {  // a channel's slots, in slot order, into its first
      constexpr int C = VEC / PACK;
#pragma unroll
      for (int k = 0; k < NS; ++k)
#pragma unroll
        for (int j = C; j < VEC; ++j) {
          acc[k][j % C] = __fadd_rn(acc[k][j % C], acc[k][j]);
          acc[k][j] = 0.f;
        }
    }
  }
  // the block's row lanes, through shared memory [NS][rpi][sw], summed by
  // column_sums into the lane buffer behind them
  constexpr int kSlots = PACK > 1 ? VEC / PACK : VEC;  // a thread's columns
  const int sw = PACK > 1 ? kSlots : t.tpr * VEC;
  const int lc = PACK > 1 ? 0 : (threadIdx.x % t.tpr) * VEC;
  if (t.lr < t.rpi) {
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int j = 0; j < kSlots; ++j) smem[(k * t.rpi + t.lr) * sw + lc + j] = acc[k][j];
  }
  __syncthreads();
  const int tile0 = blockIdx.y * kTileC;
  const int tw = min(c - tile0, PACK > 1 ? c : kTileC);  // channels of this tile
  const int cols = NS * tw;
  float* lanes = smem + NS * t.rpi * sw;
  const int lg = column_sums(
      cols, t.rpi, lanes, [&](int col) { return (col / tw) * t.rpi * sw + col % tw; },
      [&](long long base, int q) { return smem[base + q * sw]; });
  for (int i = threadIdx.x; i < cols; i += kThreads)
    partials[((long long)blockIdx.x * NS + i / tw) * c + tile0 + i % tw] = lanes[i << lg];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + blockIdx.y, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: the blocks' partials of each column, in block order
  const long long stride = (long long)NS * c;
  column_sums(
      cols, (int)gridDim.x, lanes,
      [&](int col) { return (long long)(col / tw) * c + tile0 + col % tw; },
      [&](long long base, int b) { return __ldcg(partials + base + b * stride); });
  for (int col = threadIdx.x; col < cols; col += kThreads) {
    out[(col / tw) * c + tile0 + col % tw] = lanes[col << lg];
    if (!BWD && col < tw) out[2 * c + tile0 + col] = (float)m;
  }
  if (threadIdx.x == 0) counters[blockIdx.y] = 0;
}

// (b) with BWD false: y = r(((a - mean) * mul) + beta); (d) with BWD true:
// dx = relu' ? r(((g - k1) - ah * k2) * mul) : 0. Blocks stride over rows;
// with POOL (one row a load) over pooled pixels of rows `w` wide: (b)'s
// pooled form writes each window's max of y to `pooled` (row stride c),
// (d)'s takes the pooled gradient gp (row stride ldgp) at each window's
// argmax. POST: (b) and (d) of the order after.
template <typename T, int VEC, int PACK, bool BWD, bool POOL, bool POST>
__global__ void __launch_bounds__(kThreads, BWD && POOL ? kPoolBackwardBlocks : 1)
bn_apply_kernel(const T* __restrict__ x, long long ldx, const T* __restrict__ g, long long ldg,
                const T* __restrict__ gp, long long ldgp, Vectors vec, Derive d, int relu,
                long long m, int c, T* __restrict__ out, long long ldo, T* __restrict__ pooled,
                long long w) {
  static_assert(!POOL || PACK == 1, "the pooled forms take one row a load");
  static_assert(!POOL || !POST, "the order after has no pooled form");
  const Tile<VEC, PACK> t(c);
  if (!t.active) return;
  const bool has_bias = vec.bias != nullptr;
  const long long rows = POOL ? m / 4 : PACK > 1 ? (m + PACK - 1) / PACK : m;
  constexpr int U = unroll_of<BWD, POOL>();
  // (b)'s first batch of loads goes out before the prologue's (in (d) it
  // measured slower)
  const long long step = (long long)gridDim.x * U * t.rpi;
  const long long first = (long long)blockIdx.x * U * t.rpi + t.lr;
  typename Raw<T, VEC>::type xv[POOL ? 4 * U : U], gv[POOL ? 4 * U : U];
  [[maybe_unused]] typename Raw<T, VEC>::type pv[U];
  if constexpr (POOL && !BWD)
    load_windows<T, VEC, U>(x, ldx, first, t.rpi, t.c0, rows, w, xv);
  else if constexpr (!BWD)
    load_batch<T, VEC, PACK, kUnroll, BWD>(x, ldx, g, ldg, first, t.rpi, t.c0, rows, m, c, xv,
                                           gv);
  // the block of column 0 writes each channel's outputs once: its row lane 0
  const bool writer = blockIdx.x == 0 && t.lr == 0;
  int ch[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) ch[j] = t.channel(j);
  float bb[VEC], mu[VEC], ml[VEC], p0[VEC], p1[VEC], p2[VEC];
  [[maybe_unused]] float bt[VEC];
  load_params<VEC>(vec.bias, ch, bb);
#pragma unroll
  for (int j = 0; j < VEC; ++j) bb[j] = has_bias ? Elt<T>::round(bb[j]) : 0.f;
  if constexpr (!BWD) {
    load_params<VEC>(vec.beta, ch, p0);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int k = ch[j];
      float mean, var, raw = 0.f;
      if (d.train) {  // finalize(): mean, the clipped fast variance
        const float n = __ldg(d.stats + 2 * c + k);
        mean = __fdiv_rn(__ldg(d.stats + k), n);
        raw = __fsub_rn(__fdiv_rn(__ldg(d.stats + c + k), n), __fmul_rn(mean, mean));
        var = raw < 0.f ? 0.f : raw;  // clamp_min: NaN passes
      } else {
        mean = __ldg(d.run_mean + k);
        var = __ldg(d.run_var + k);
      }
      const float rstd = rsqrtf(__fadd_rn(var, d.eps));
      mu[j] = mean;
      ml[j] = __fmul_rn(rstd, __ldg(d.gamma + k));
      if (d.train && writer && t.first(j)) {
        d.vec[k] = mean;
        d.vec[c + k] = var;
        d.vec[2 * c + k] = rstd;
        d.vec[3 * c + k] = ml[j];
        d.vec[4 * c + k] = raw >= 0.f ? 1.f : 0.f;
        if (d.run_mean) {
          d.run_mean[k] = __fadd_rn(__fmul_rn(d.momentum, d.run_mean[k]),
                                    __fmul_rn(d.one_minus_momentum, mean));
          d.run_var[k] = __fadd_rn(__fmul_rn(d.momentum, d.run_var[k]),
                                   __fmul_rn(d.one_minus_momentum, var));
        }
      }
    }
  } else {
    load_params<VEC>(vec.mean, ch, mu);
    load_params<VEC>(vec.mul, ch, ml);
    load_params<VEC>(vec.rstd, ch, p0);
    if constexpr (POST || POOL) load_params<VEC>(vec.beta, ch, bt);
    if (!d.train) {
      load_params<VEC>(vec.k1, ch, p1);
      load_params<VEC>(vec.k2, ch, p2);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int k = ch[j];
        const float n = __ldg(d.stats + 2 * c + k);
        p1[j] = __fdiv_rn(__ldg(d.totals + k), n);
        p2[j] = __ldg(d.unclipped + k) != 0.f ? __fdiv_rn(__ldg(d.totals + c + k), n) : 0.f;
        if (d.dbias && writer && t.first(j)) {
          const float s2 = __ldg(d.sums + 2 * c + k), s3 = __ldg(d.sums + 3 * c + k),
                      s4 = __ldg(d.sums + 4 * c + k);
          d.dbias[k] = __fmul_rn(ml[j], __fsub_rn(__fsub_rn(s2, __fmul_rn(p1[j], s3)),
                                                  __fmul_rn(p2[j], s4)));
        }
      }
    }
  }
  for (long long r0 = first; r0 < rows; r0 += step) {
    if constexpr (POOL && BWD) {
      load_windows<T, VEC, U>(x, ldx, r0, t.rpi, t.c0, rows, w, xv);
      load_windows<T, VEC, U>(g, ldg, r0, t.rpi, t.c0, rows, w, gv);
      load_pooled<T, VEC, U>(gp, ldgp, r0, t.rpi, t.c0, rows, pv);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long p = r0 + (long long)u * t.rpi;
        if (p >= rows) break;
        const long long top = window_row(p, w);
        int arg[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float a[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[q] = activation<T>(element<T, VEC>(xv[4 * u + q], j), bb[j], has_bias, relu);
          arg[j] = window_argmax<T>(a, mu[j], ml[j], bt[j]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float o[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float a =
                activation<T>(element<T, VEC>(xv[4 * u + q], j), bb[j], has_bias, relu);
            const float gg = pooled_gradient<T>(element<T, VEC>(gv[4 * u + q], j),
                                                element<T, VEC>(pv[u], j), q, arg[j]);
            o[j] = input_gradient(a, gg, mu[j], p0[j], p1[j], p2[j], ml[j], relu);
          }
          store_vec<T, VEC>(out + (top + (q & 1) + (q >> 1) * w) * ldo + t.c0, o, VEC);
        }
      }
    } else if constexpr (POOL) {
      if (r0 != first) load_windows<T, VEC, U>(x, ldx, r0, t.rpi, t.c0, rows, w, xv);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long p = r0 + (long long)u * t.rpi;
        if (p >= rows) break;
        const long long top = window_row(p, w);
        float mx[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) mx[j] = -__int_as_float(0x7f800000);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float o[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float a =
                activation<T>(element<T, VEC>(xv[4 * u + q], j), bb[j], has_bias, relu);
            o[j] = normalized<T>(a, mu[j], ml[j], p0[j]);
            if (o[j] > mx[j] || isnan(o[j])) mx[j] = o[j];
          }
          store_vec<T, VEC>(out + (top + (q & 1) + (q >> 1) * w) * ldo + t.c0, o, VEC);
        }
        store_vec<T, VEC>(pooled + p * c + t.c0, mx, VEC);
      }
    } else {
      if (BWD || r0 != first)
        load_batch<T, VEC, PACK, kUnroll, BWD>(x, ldx, g, ldg, r0, t.rpi, t.c0, rows, m, c, xv,
                                               gv);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + (long long)u * t.rpi;
        if (r >= rows) break;
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float a = activation<T>(element<T, VEC>(xv[u], j), bb[j], has_bias, relu);
          if constexpr (!BWD && POST) {
            const float v = normalized<T>(a, mu[j], ml[j], p0[j]);
            o[j] = v < 0.f ? 0.f : v;
          } else if constexpr (!BWD) {
            o[j] = __fadd_rn(__fmul_rn(__fsub_rn(a, mu[j]), ml[j]), p0[j]);
          } else {
            float gg = element<T, VEC>(gv[u], j);
            if constexpr (POST) gg = after_gradient<T>(a, mu[j], ml[j], bt[j], gg);
            o[j] = input_gradient(a, gg, mu[j], p0[j], p1[j], p2[j], ml[j], relu);
          }
        }
        store_vec<T, VEC>(out + row_offset<VEC, PACK>(r, ldo, t.c0), o,
                          valid_of<VEC, PACK>(r, m, c));
      }
    }
  }
}

int tiles_of(int c) { return (c + kTileC - 1) / kTileC; }

// Loads along the rows (rows, or on the packed path loads of PACK rows).
long long rows_of(long long m, int pack) { return pack > 1 ? (m + pack - 1) / pack : m; }

long long reduce_blocks(long long rows, int c) {
  const long long by_rows = (rows + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  const long long cap = kReduceBlocks / tiles_of(c) > 0 ? kReduceBlocks / tiles_of(c) : 1;
  return by_rows < cap ? (by_rows > 0 ? by_rows : 1) : cap;
}

bool aligned(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

// The path of a pass: 0 one element a thread, 1 a 16-byte vector of one
// row, PACK > 1 a 16-byte load of PACK whole contiguous rows.
int path_of(int elt, int c, const void* const* ptrs, const long long* lds, int n) {
  const int vec = 16 / elt;
  if (!aligned(ptrs, n)) return 0;
  if (c % vec == 0) {
    for (int i = 0; i < n; ++i)
      if (lds[i] % vec) return 0;
    return 1;
  }
  if (c > vec || vec % c) return 0;
  for (int i = 0; i < n; ++i)
    if (lds[i] != c) return 0;
  return vec / c;
}

bool bad_args(long long m, int c) {
  return m < 0 || c <= 0 || tiles_of(c) > kMaxTiles || m >= (1LL << 40);
}

// Threads a load row of the tile takes, and rows an iteration covers.
int rows_per_iteration(int c, int vec, int pack) {
  const int tile_c = pack > 1 ? vec : (c < kTileC ? c : kTileC);
  return kThreads / ((tile_c + vec - 1) / vec);
}

template <typename T, int VEC, int PACK, int NS, bool BWD, bool POST, bool POOL>
int launch_reduce(const void* x, long long ldx, const void* g, long long ldg, const void* gp,
                  long long ldgp, long long w, Vectors vec, int relu, long long m, int c,
                  float* out, float* partials, int* counters, cudaStream_t stream) {
  const long long rows = POOL ? m / 4 : rows_of(m, PACK);
  const long long gx = reduce_blocks(rows, c);
  const long long rpb = (rows + gx - 1) / gx;
  const int rpi = rows_per_iteration(c, VEC, PACK);
  const int sw = PACK > 1 ? VEC / PACK : (kThreads / rpi) * VEC;
  // the row lanes' values, then the lane buffer (cols << lg <= max(cols, 256))
  const int lane_floats = NS * kTileC > kThreads ? NS * kTileC : kThreads;
  const size_t smem = sizeof(float) * (NS * rpi * sw + lane_floats);
  const dim3 grid((unsigned)gx, (unsigned)tiles_of(c));
  bn_reduce_kernel<T, VEC, PACK, NS, BWD, POST, POOL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(g), ldg, static_cast<const T*>(gp),
      ldgp, w, vec, relu, m, c, rpb, out, partials, counters);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int PACK, bool BWD, bool POOL, bool POST>
int launch_apply(const void* x, long long ldx, const void* g, long long ldg, const void* gp,
                 long long ldgp, Vectors vec, const Derive& d, int relu, long long m, int c,
                 void* out, long long ldo, void* pooled, long long w, cudaStream_t stream) {
  const long long per_block =
      (long long)rows_per_iteration(c, VEC, PACK) * unroll_of<BWD, POOL>();
  long long gx = ((POOL ? m / 4 : rows_of(m, PACK)) + per_block - 1) / per_block;
  const long long cap = kApplyBlocks / tiles_of(c) > 0 ? kApplyBlocks / tiles_of(c) : 1;
  gx = gx < cap ? gx : cap;
  gx = gx > 0 ? gx : 1;  // m == 0 still derives and writes the vectors
  const dim3 grid((unsigned)gx, (unsigned)tiles_of(c));
  bn_apply_kernel<T, VEC, PACK, BWD, POOL, POST><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(g), ldg, static_cast<const T*>(gp),
      ldgp, vec, d, relu, m, c, static_cast<T*>(out), ldo, static_cast<T*>(pooled), w);
  return (int)cudaGetLastError();
}

// The pooled forms ((b) with `pooled`, (c) and (d) with `gp`) take one row a
// load: a 16-byte vector of it (path 1), or one element.
template <int NS, bool BWD, bool POST = false>
int reduce_dispatch(int dtype, int path, const void* x, long long ldx, const void* g,
                    long long ldg, const void* gp, long long ldgp, long long w, Vectors vec,
                    int relu, long long m, int c, float* out, float* partials, int* counters,
                    cudaStream_t stream) {
#define TPUSEG_BN_REDUCE(T, V, P, POOL)                                                      \
  return launch_reduce<T, V, P, NS, BWD, POST, POOL>(x, ldx, g, ldg, gp, ldgp, w, vec, relu, m, \
                                                     c, out, partials, counters, stream)
  if constexpr (BWD && !POST && NS == 5) {
    if (gp) {
      if (dtype == 1) {
        if (path == 1) TPUSEG_BN_REDUCE(__nv_bfloat16, 8, 1, true);
        TPUSEG_BN_REDUCE(__nv_bfloat16, 1, 1, true);
      }
      if (path == 1) TPUSEG_BN_REDUCE(float, 4, 1, true);
      TPUSEG_BN_REDUCE(float, 1, 1, true);
    }
  }
  if (dtype == 1) {
    switch (path) {
      case 1: TPUSEG_BN_REDUCE(__nv_bfloat16, 8, 1, false);
      case 2: TPUSEG_BN_REDUCE(__nv_bfloat16, 8, 2, false);
      case 4: TPUSEG_BN_REDUCE(__nv_bfloat16, 8, 4, false);
      case 8: TPUSEG_BN_REDUCE(__nv_bfloat16, 8, 8, false);
      default: TPUSEG_BN_REDUCE(__nv_bfloat16, 1, 1, false);
    }
  }
  switch (path) {
    case 1: TPUSEG_BN_REDUCE(float, 4, 1, false);
    case 2: TPUSEG_BN_REDUCE(float, 4, 2, false);
    case 4: TPUSEG_BN_REDUCE(float, 4, 4, false);
    default: TPUSEG_BN_REDUCE(float, 1, 1, false);
  }
#undef TPUSEG_BN_REDUCE
}

template <bool BWD, bool POST = false>
int apply_dispatch(int dtype, int path, const void* x, long long ldx, const void* g,
                   long long ldg, const void* gp, long long ldgp, Vectors vec, const Derive& d,
                   int relu, long long m, int c, void* out, long long ldo, void* pooled,
                   long long w, cudaStream_t stream) {
#define TPUSEG_BN_APPLY(T, V, P, POOL)                                                        \
  return launch_apply<T, V, P, BWD, POOL, POST>(x, ldx, g, ldg, gp, ldgp, vec, d, relu, m, c,  \
                                                out, ldo, pooled, w, stream)
  if constexpr (!POST) {
    if (BWD ? gp != nullptr : pooled != nullptr) {
      if (dtype == 1) {
        if (path == 1) TPUSEG_BN_APPLY(__nv_bfloat16, 8, 1, true);
        TPUSEG_BN_APPLY(__nv_bfloat16, 1, 1, true);
      }
      if (path == 1) TPUSEG_BN_APPLY(float, 4, 1, true);
      TPUSEG_BN_APPLY(float, 1, 1, true);
    }
  }
  if (dtype == 1) {
    switch (path) {
      case 1: TPUSEG_BN_APPLY(__nv_bfloat16, 8, 1, false);
      case 2: TPUSEG_BN_APPLY(__nv_bfloat16, 8, 2, false);
      case 4: TPUSEG_BN_APPLY(__nv_bfloat16, 8, 4, false);
      case 8: TPUSEG_BN_APPLY(__nv_bfloat16, 8, 8, false);
      default: TPUSEG_BN_APPLY(__nv_bfloat16, 1, 1, false);
    }
  }
  switch (path) {
    case 1: TPUSEG_BN_APPLY(float, 4, 1, false);
    case 2: TPUSEG_BN_APPLY(float, 4, 2, false);
    case 4: TPUSEG_BN_APPLY(float, 4, 4, false);
    default: TPUSEG_BN_APPLY(float, 1, 1, false);
  }
#undef TPUSEG_BN_APPLY
}

int elt_size(int dtype) { return dtype == 1 ? 2 : 4; }

bool bad_dtype(int dtype) { return dtype != 0 && dtype != 1; }

// relu: 0 none, 1 before the normalization (the kernels' `relu`), 2 after
// it (the POST forms).
bool bad_relu(int relu) { return relu < 0 || relu > 2; }

// What the pooled forms of (c) and (d) refuse: gp, the gradient of (b)'s
// pooled output, is dtype [m / 4 rows of stride ldgp >= c, c] over rows [n,
// h, w] with h and w (`width`) even; they recompute y from mul and beta;
// they are a conv block's (a bias; the order after has no pooled form).
bool bad_pooled(const void* gp, long long ldgp, long long width, long long m, int c,
                const float* bias, int relu, const float* mul, const float* beta) {
  return gp && (width <= 0 || width % 2 || m % (2 * width) || ldgp < c || !bias || relu == 2 ||
                !mul || !beta);
}

}  // namespace

extern "C" {

// The plan of a reduction, (a) with g null or (c), over [m, c] with these
// pointers and row strides (and gp, ldgp and width: the pooled (c), gp
// non-null), as the launch makes it: plan[0] the floats of scratch it needs
// (its per-block partials), plan[1] its blocks along the rows, plan[2] the
// rows a block sums, plan[3] the most f32 additions between a term and its
// sum (a thread's loads, four a window in the pooled form, a packed
// thread's slots of a channel, the block's row lanes, the last block's
// lanes over the blocks and its sum of the lanes: the depth d of the bound
// |error| <= gamma_d * sum |t|, each term being exact, a product inside an
// FMA), plan[4] the path (0 one element a thread, 1 a 16-byte vector of one
// row, PACK > 1 a load of PACK rows). Returns 0, or -1 where c needs more
// than 64 channel tiles.
int tpuseg_bn_reduce_plan(const void* x, long long ldx, const void* g, long long ldg,
                          const void* gp, long long ldgp, long long width, int dtype,
                          long long m, int c, int nsums, long long* plan) {
  if (bad_args(m, c) || bad_dtype(dtype) || (gp && width <= 0)) return -1;
  const void* ptrs[] = {x, g, gp};
  const long long lds[] = {ldx, ldg, ldgp};
  int path = path_of(elt_size(dtype), c, ptrs, lds, gp ? 3 : g ? 2 : 1);
  if (gp && path > 1) path = 0;
  const int vec = path ? 16 / elt_size(dtype) : 1;
  const int pack = path > 1 ? path : 1;
  const int per_load = gp ? 4 : 1;  // terms of a thread's load (a window's four rows)
  const long long rows = gp ? m / 4 : rows_of(m, pack);
  const long long rpi = rows_per_iteration(c, vec, pack);
  const long long gx = reduce_blocks(rows, c);
  const long long rpb = (rows + gx - 1) / gx;
  // the block's row lanes and the last block's sum over the blocks, by
  // column_sums: the deepest of the (at most two) tile widths
  long long sums = 0;
  for (int tile = 0; tile < tiles_of(c); tile += tiles_of(c) - 1) {
    const int tw = pack > 1 ? c : (c - tile * kTileC < kTileC ? c - tile * kTileC : kTileC);
    const int lg = lanes_log2(nsums * tw);
    const long long depth = (rpi + (1 << lg) - 1) / (1 << lg) + (gx + (1 << lg) - 1) / (1 << lg)
                            + 2 * lg;
    sums = depth > sums ? depth : sums;
    if (tiles_of(c) == 1) break;
  }
  plan[0] = gx * nsums * c;
  plan[1] = gx;
  plan[2] = rpb * pack * per_load;
  plan[3] = per_load * ((rpb + rpi - 1) / rpi) + (pack - 1) + sums;
  plan[4] = path;
  return 0;
}

// (a). x: dtype (0 f32, 1 bf16) [m rows of stride ldx, c]; bias: f32 [c] or
// null; relu: 0 none, 1 before the normalization, 2 after it (then no bias:
// the stats of x); out: f32 [3, c] (sum a, sum a^2, n = m); scratch:
// plan[0] floats of tpuseg_bn_reduce_plan; counters: 64 ints, zero (and
// left zero). Returns the launch's cudaError_t.
int tpuseg_bn_stats(const void* x, long long ldx, int dtype, const float* bias, int relu,
                    long long m, int c, float* out, float* scratch, int* counters, void* stream) {
  if (bad_args(m, c) || ldx < c || bad_dtype(dtype) || bad_relu(relu) || (relu == 2 && bias))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return (int)cudaMemsetAsync(out, 0, sizeof(float) * 3 * c, s);
  const void* ptrs[] = {x};
  const long long lds[] = {ldx};
  Vectors vec{bias, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return reduce_dispatch<2, false>(dtype, path_of(elt_size(dtype), c, ptrs, lds, 1), x, ldx,
                                   nullptr, 0, nullptr, 0, 0, vec, relu == 1, m, c, out, scratch,
                                   counters, s);
}

// (b). y: dtype [m rows of stride ldy, c]; gamma, beta: f32 [c]. train 1:
// stats f32 [3, c] = [sum a, sum a^2, n]; writes vec f32 [5, c] = [mean,
// var, rstd, mul, unclipped (1 or 0)] and, where run_mean and run_var (f32
// [c]) are given, sets each to momentum * it + one_minus_momentum * the
// batch's. train 0 (eval): run_mean and run_var as the statistics. pooled:
// null, or dtype [m / 4 rows of stride c, c], the 2x2/2 max of y where the
// m rows are [n, h, w] with h and w (`width`) even (not with relu 2).
int tpuseg_bn_apply(const void* x, long long ldx, int dtype, const float* bias, int relu,
                    int train, const float* stats, const float* gamma, float eps,
                    float* vec_out, float* run_mean, float* run_var, float momentum,
                    float one_minus_momentum, const float* beta, long long m, int c, void* y,
                    long long ldy, void* pooled, long long width, void* stream) {
  if (bad_args(m, c) || ldx < c || ldy < c || bad_dtype(dtype) || bad_relu(relu) || !gamma ||
      (train && (!stats || !vec_out)) || (!train && !run_mean) || (!run_mean != !run_var) ||
      (pooled && (width <= 0 || width % 2 || m % (2 * width))) ||
      (relu == 2 && (bias || pooled)))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, y, pooled};
  const long long lds[] = {ldx, ldy, c};
  Vectors vec{bias, nullptr, nullptr, nullptr, beta, nullptr, nullptr};
  Derive d{train != 0, stats, gamma, eps, vec_out, run_mean, run_var, momentum,
           one_minus_momentum, nullptr, nullptr, nullptr, nullptr};
  const int path = path_of(elt_size(dtype), c, ptrs, lds, pooled ? 3 : 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (relu == 2)
    return apply_dispatch<false, true>(dtype, path, x, ldx, nullptr, 0, nullptr, 0, vec, d, 0,
                                       m, c, y, ldy, nullptr, 0, s);
  return apply_dispatch<false>(dtype, path, x, ldx, nullptr, 0, nullptr, 0, vec, d, relu, m, c,
                               y, ldy, pooled, width, s);
}

// (c). g: dtype [m rows of stride ldg, c]; mean, rstd: f32 [c]; mul, beta:
// f32 [c] with relu 2 or gp (else unread); gp: null, or the pooled form's
// (bad_pooled); nsums 2, or 5 with a bias; out: f32 [nsums, c]; scratch,
// counters as for (a).
int tpuseg_bn_backward_reduce(const void* x, long long ldx, const void* g, long long ldg,
                              const void* gp, long long ldgp, long long width, int dtype,
                              const float* bias, int relu, const float* mean, const float* rstd,
                              const float* mul, const float* beta, long long m, int c, int nsums,
                              float* out, float* scratch, int* counters, void* stream) {
  if (bad_args(m, c) || ldx < c || ldg < c || bad_dtype(dtype) || bad_relu(relu) ||
      nsums != (bias ? 5 : 2) || (relu == 2 && (bias || !mul || !beta)) ||
      bad_pooled(gp, ldgp, width, m, c, bias, relu, mul, beta))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return (int)cudaMemsetAsync(out, 0, sizeof(float) * nsums * c, s);
  const void* ptrs[] = {x, g, gp};
  const long long lds[] = {ldx, ldg, ldgp};
  const int path = path_of(elt_size(dtype), c, ptrs, lds, gp ? 3 : 2);
  Vectors vec{bias, mean, rstd, mul, beta, nullptr, nullptr};
  if (relu == 2)
    return reduce_dispatch<2, true, true>(dtype, path, x, ldx, g, ldg, nullptr, 0, 0, vec, 0, m,
                                          c, out, scratch, counters, s);
  if (nsums == 5)
    return reduce_dispatch<5, true>(dtype, path, x, ldx, g, ldg, gp, ldgp, width, vec, relu, m,
                                    c, out, scratch, counters, s);
  return reduce_dispatch<2, true>(dtype, path, x, ldx, g, ldg, gp, ldgp, width, vec, relu, m, c,
                                  out, scratch, counters, s);
}

// (d). mean, rstd, mul: f32 [c]; beta: f32 [c] with relu 2 or gp (else
// unread); gp: null, or the pooled form's (bad_pooled); dx: dtype [m rows
// of stride lddx, c]. train 0: k1, k2 f32 [c] given. train 1: k1 and k2
// from totals (f32, rows sum g and sum g*ah of stride c), stats' n (f32 [3,
// c]) and unclipped (f32 [c], 1 or 0); where dbias (f32 [c]) is given, also
// writes the bias gradient from sums (f32 [5, c], this rank's (c)).
int tpuseg_bn_backward_apply(const void* x, long long ldx, const void* g, long long ldg,
                             const void* gp, long long ldgp, long long width, int dtype,
                             const float* bias, int relu, const float* mean, const float* rstd,
                             const float* mul, const float* beta, int train, const float* k1,
                             const float* k2, const float* stats, const float* totals,
                             const float* unclipped, const float* sums, float* dbias,
                             long long m, int c, void* dx, long long lddx, void* stream) {
  if (bad_args(m, c) || ldx < c || ldg < c || lddx < c || bad_dtype(dtype) || bad_relu(relu) ||
      (!train && (!k1 || !k2)) || (train && (!stats || !totals || !unclipped)) ||
      (dbias && (!train || !sums)) || (relu == 2 && (bias || !beta)) ||
      bad_pooled(gp, ldgp, width, m, c, bias, relu, mul, beta))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, g, dx, gp};
  const long long lds[] = {ldx, ldg, lddx, ldgp};
  Vectors vec{bias, mean, rstd, mul, beta, k1, k2};
  Derive d{train != 0, stats, nullptr, 0.f, nullptr, nullptr, nullptr, 0.f, 0.f,
           totals, unclipped, sums, dbias};
  const int path = path_of(elt_size(dtype), c, ptrs, lds, gp ? 4 : 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (relu == 2)
    return apply_dispatch<true, true>(dtype, path, x, ldx, g, ldg, nullptr, 0, vec, d, 0, m, c,
                                      dx, lddx, nullptr, 0, s);
  return apply_dispatch<true>(dtype, path, x, ldx, g, ldg, gp, ldgp, vec, d, relu, m, c, dx,
                              lddx, nullptr, width, s);
}

const char* tpuseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
