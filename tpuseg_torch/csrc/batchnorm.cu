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
//   (a)  stats:            out = [sum a, sum a^2]                         per channel
//   (b)  apply:            y   = r(((a - mean) * mul) + beta)
//   (c)  backward reduce:  out = [sum g, sum g*ah (, sum relu'*g, sum relu', sum relu'*ah)]
//                          with ah = (a - mean) * rstd; the last three with a bias
//   (d)  backward apply:   dx  = relu' ? r(((g - k1) - ah * k2) * mul) : 0
// (b) and (d) are bit-equal to the plain versions given the same vectors;
// (a) and (c) sum in another order.
//
// Bound: memory. Per element (a) reads x, (b) reads x and writes y, (c)
// reads x and g, (d) reads x and g and writes dx: 1, 2, 2 and 3 times the
// activation's bytes, against a dozen flops. A train step at 512^2, batch 8,
// base 64 sums N*H*W*C over its 23 BatchNorm layers to 1.28e9 elements,
// 2.56 GB in bf16: 8 x 2.56 GB at 3.35 TB/s, ~6.1 ms a step.
//
// Design (simple first). Every kernel maps a block of 256 threads onto a
// tile of up to 64 channels (grid.y walks the tiles) and as many rows as
// its threads cover at once: each thread owns 16 bytes of one row (8 bf16 or 4 f32 channels, one
// 16-byte load) where c, ld and the pointers allow, else one element (the
// narrow path, e.g. the head's c = 2), and keeps its channels' vectors in
// registers. Rows advance in batches of kUnroll, loads first, to keep bytes
// in flight. The reductions are deterministic without float atomics: each
// block sums a fixed chunk of rows (each thread its rows in order, then the
// block's threads in order through shared memory) into its partials, and
// the last block of a channel tile to finish, found with an integer counter
// (left at zero for the next launch), adds the partials in block order. The
// block count of a reduction depends on m and c alone, not on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 64;               // channels of a tile (grid.y)
constexpr int kUnroll = 4;               // rows a thread loads before it computes
constexpr int kReduceBlocks = 264;       // blocks of a reduction, over all tiles
constexpr int kMinRowsPerBlock = 64;     // rows a reduction block takes at least
constexpr int kApplyBlocks = 528;        // blocks of an elementwise pass, over all tiles
constexpr int kMaxTiles = 64;            // counters the caller provides

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

template <typename T, int VEC>
__device__ __forceinline__ float element(const typename Raw<T, VEC>::type& r, int j) {
  return Elt<T>::load(reinterpret_cast<const T*>(&r) + j);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  typename Raw<T, VEC>::type raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) Elt<T>::store(e + j, v[j]);
  *reinterpret_cast<typename Raw<T, VEC>::type*>(p) = raw;
}

// a = relu(r(x + r(bias))): PyTorch's bf16 add rounds the f32 sum, and its
// relu keeps x unless x < 0 (NaN and -0 pass, as clamp_min passes them).
template <typename T>
__device__ __forceinline__ float activation(float x, float b, bool has_bias, bool relu) {
  const float a = has_bias ? Elt<T>::round(__fadd_rn(x, b)) : x;
  return (relu && a < 0.f) ? 0.f : a;
}

// The tile geometry of a block: threads per row, rows per iteration, this
// thread's row lane and first channel, and whether it has channels.
template <int VEC>
struct Tile {
  int tpr, rpi, lr, c0;
  bool active;
  __device__ __forceinline__ Tile(int c) {
    const int tile_c = min(c, kTileC);
    tpr = (tile_c + VEC - 1) / VEC;
    rpi = kThreads / tpr;
    lr = threadIdx.x / tpr;
    c0 = blockIdx.y * kTileC + (threadIdx.x % tpr) * VEC;
    active = lr < rpi && c0 < c;
  }
};

struct Vectors {
  const float *bias, *mean, *rstd, *mul, *beta, *k1, *k2;
};

template <int VEC>
__device__ __forceinline__ void load_params(const float* p, int c0, float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = p ? __ldg(p + c0 + j) : 0.f;
}

// (a) with BWD false, (c) with BWD true: NS sums a channel. Block bx sums
// rows [bx * rpb, (bx + 1) * rpb) into partials[bx][k][c]; the tile's last
// block adds them in block order into out[k][c].
template <typename T, int VEC, int NS, bool BWD>
__global__ void __launch_bounds__(kThreads)
bn_reduce_kernel(const T* __restrict__ x, long long ldx, const T* __restrict__ g, long long ldg,
              Vectors vec, int relu, long long m, int c, long long rpb, float* __restrict__ out,
              float* __restrict__ partials, int* __restrict__ counters) {
  extern __shared__ float smem[];  // [NS][rpi][tpr * VEC]
  __shared__ bool last;
  const Tile<VEC> t(c);
  const bool has_bias = vec.bias != nullptr;
  float acc[NS][VEC];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] = 0.f;
  if (t.active) {
    float bb[VEC], mu[VEC], rs[VEC];
    load_params<VEC>(vec.bias, t.c0, bb);
#pragma unroll
    for (int j = 0; j < VEC; ++j) bb[j] = has_bias ? Elt<T>::round(bb[j]) : 0.f;
    if constexpr (BWD) {
      load_params<VEC>(vec.mean, t.c0, mu);
      load_params<VEC>(vec.rstd, t.c0, rs);
    }
    const long long r_end = min(m, (blockIdx.x + 1) * rpb);
    for (long long r0 = blockIdx.x * rpb + t.lr; r0 < r_end; r0 += (long long)kUnroll * t.rpi) {
      typename Raw<T, VEC>::type xv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + (long long)u * t.rpi;
        if (r < r_end) {
          xv[u] = load_raw<T, VEC>(x + r * ldx + t.c0);
          if constexpr (BWD) gv[u] = load_raw<T, VEC>(g + r * ldg + t.c0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + (long long)u * t.rpi >= r_end) break;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float a = activation<T>(element<T, VEC>(xv[u], j), bb[j], has_bias, relu);
          if constexpr (!BWD) {
            acc[0][j] = __fadd_rn(acc[0][j], a);
            acc[1][j] = __fmaf_rn(a, a, acc[1][j]);
          } else {
            const float ah = __fmul_rn(__fsub_rn(a, mu[j]), rs[j]);
            const float gg = element<T, VEC>(gv[u], j);
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
        }
      }
    }
  }
  // the block's threads in row-lane order, through shared memory
  const int width = t.tpr * VEC;
  const int lc = (threadIdx.x % t.tpr) * VEC;
  if (t.lr < t.rpi) {
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) smem[(k * t.rpi + t.lr) * width + lc + j] = acc[k][j];
  }
  __syncthreads();
  const int tile0 = blockIdx.y * kTileC;
  for (int i = threadIdx.x; i < NS * width; i += kThreads) {
    const int k = i / width, cc = i % width;
    if (tile0 + cc >= c) continue;
    float s = 0.f;
    for (int q = 0; q < t.rpi; ++q) s = __fadd_rn(s, smem[(k * t.rpi + q) * width + cc]);
    partials[((long long)blockIdx.x * NS + k) * c + tile0 + cc] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + blockIdx.y, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < NS * width; i += kThreads) {
    const int k = i / width, cc = i % width;
    if (tile0 + cc >= c) continue;
    const float* p = partials + (long long)k * c + tile0 + cc;
    const long long stride = (long long)NS * c;
    float s = 0.f;
#pragma unroll 8
    for (int b = 0; b < (int)gridDim.x; ++b) s = __fadd_rn(s, __ldcg(p + b * stride));
    out[k * c + tile0 + cc] = s;
  }
  if (threadIdx.x == 0) counters[blockIdx.y] = 0;
}

// (b) with BWD false: y = r(((a - mean) * mul) + beta); (d) with BWD true:
// dx = relu' ? r(((g - k1) - ah * k2) * mul) : 0. Blocks stride over rows.
template <typename T, int VEC, bool BWD>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, long long ldx, const T* __restrict__ g, long long ldg,
             Vectors vec, int relu, long long m, int c, T* __restrict__ out, long long ldo) {
  const Tile<VEC> t(c);
  if (!t.active) return;
  const bool has_bias = vec.bias != nullptr;
  float bb[VEC], mu[VEC], ml[VEC], p0[VEC], p1[VEC], p2[VEC];
  load_params<VEC>(vec.bias, t.c0, bb);
#pragma unroll
  for (int j = 0; j < VEC; ++j) bb[j] = has_bias ? Elt<T>::round(bb[j]) : 0.f;
  load_params<VEC>(vec.mean, t.c0, mu);
  load_params<VEC>(vec.mul, t.c0, ml);
  if constexpr (BWD) {
    load_params<VEC>(vec.rstd, t.c0, p0);
    load_params<VEC>(vec.k1, t.c0, p1);
    load_params<VEC>(vec.k2, t.c0, p2);
  } else {
    load_params<VEC>(vec.beta, t.c0, p0);
  }
  const long long step = (long long)gridDim.x * kUnroll * t.rpi;
  for (long long r0 = (long long)blockIdx.x * kUnroll * t.rpi + t.lr; r0 < m; r0 += step) {
    typename Raw<T, VEC>::type xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + (long long)u * t.rpi;
      if (r < m) {
        xv[u] = load_raw<T, VEC>(x + r * ldx + t.c0);
        if constexpr (BWD) gv[u] = load_raw<T, VEC>(g + r * ldg + t.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + (long long)u * t.rpi;
      if (r >= m) break;
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float a = activation<T>(element<T, VEC>(xv[u], j), bb[j], has_bias, relu);
        if constexpr (!BWD) {
          o[j] = __fadd_rn(__fmul_rn(__fsub_rn(a, mu[j]), ml[j]), p0[j]);
        } else {
          const float ah = __fmul_rn(__fsub_rn(a, mu[j]), p0[j]);
          const float gg = element<T, VEC>(gv[u], j);
          const float d = __fmul_rn(__fsub_rn(__fsub_rn(gg, p1[j]), __fmul_rn(ah, p2[j])), ml[j]);
          o[j] = (relu && !(a > 0.f)) ? 0.f : d;
        }
      }
      store_vec<T, VEC>(out + r * ldo + t.c0, o);
    }
  }
}

int tiles_of(int c) { return (c + kTileC - 1) / kTileC; }

long long reduce_blocks(long long m, int c) {
  const long long by_rows = (m + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  const long long cap = kReduceBlocks / tiles_of(c) > 0 ? kReduceBlocks / tiles_of(c) : 1;
  return by_rows < cap ? (by_rows > 0 ? by_rows : 1) : cap;
}

// 16-byte vectors where every pointer, row stride and c allow them.
bool vector_ok(int elt, int c, const void* const* ptrs, const long long* lds, int n) {
  const int vec = 16 / elt;
  if (c % vec) return false;
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 || lds[i] % vec) return false;
  }
  return true;
}

bool bad_args(long long m, int c) {
  return m < 0 || c <= 0 || tiles_of(c) > kMaxTiles || m >= (1LL << 40);
}

template <typename T, int VEC, int NS, bool BWD>
int launch_reduce(const void* x, long long ldx, const void* g, long long ldg, Vectors vec,
                  int relu, long long m, int c, float* out, float* partials, int* counters,
                  cudaStream_t stream) {
  const long long gx = reduce_blocks(m, c);
  const long long rpb = (m + gx - 1) / gx;
  const int tile_c = c < kTileC ? c : kTileC;
  const int tpr = (tile_c + VEC - 1) / VEC;
  const size_t smem = sizeof(float) * NS * (kThreads / tpr) * tpr * VEC;
  const dim3 grid((unsigned)gx, (unsigned)tiles_of(c));
  bn_reduce_kernel<T, VEC, NS, BWD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(g), ldg, vec, relu, m, c, rpb, out,
      partials, counters);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, bool BWD>
int launch_apply(const void* x, long long ldx, const void* g, long long ldg, Vectors vec,
                 int relu, long long m, int c, void* out, long long ldo, cudaStream_t stream) {
  const int tile_c = c < kTileC ? c : kTileC;
  const int rpi = kThreads / ((tile_c + VEC - 1) / VEC);
  const long long per_block = (long long)rpi * kUnroll;
  long long gx = (m + per_block - 1) / per_block;
  const long long cap = kApplyBlocks / tiles_of(c) > 0 ? kApplyBlocks / tiles_of(c) : 1;
  gx = gx < cap ? gx : cap;
  const dim3 grid((unsigned)gx, (unsigned)tiles_of(c));
  bn_apply_kernel<T, VEC, BWD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(g), ldg, vec, relu, m, c,
      static_cast<T*>(out), ldo);
  return (int)cudaGetLastError();
}

template <int NS, bool BWD>
int reduce_dispatch(int dtype, bool vector, const void* x, long long ldx, const void* g,
                    long long ldg, Vectors vec, int relu, long long m, int c, float* out,
                    float* partials, int* counters, cudaStream_t stream) {
  if (dtype == 1) {
    return vector ? launch_reduce<__nv_bfloat16, 8, NS, BWD>(x, ldx, g, ldg, vec, relu, m, c, out,
                                                             partials, counters, stream)
                  : launch_reduce<__nv_bfloat16, 1, NS, BWD>(x, ldx, g, ldg, vec, relu, m, c, out,
                                                             partials, counters, stream);
  }
  return vector ? launch_reduce<float, 4, NS, BWD>(x, ldx, g, ldg, vec, relu, m, c, out, partials,
                                                   counters, stream)
                : launch_reduce<float, 1, NS, BWD>(x, ldx, g, ldg, vec, relu, m, c, out, partials,
                                                   counters, stream);
}

template <bool BWD>
int apply_dispatch(int dtype, bool vector, const void* x, long long ldx, const void* g,
                   long long ldg, Vectors vec, int relu, long long m, int c, void* out,
                   long long ldo, cudaStream_t stream) {
  if (dtype == 1) {
    return vector ? launch_apply<__nv_bfloat16, 8, BWD>(x, ldx, g, ldg, vec, relu, m, c, out, ldo,
                                                        stream)
                  : launch_apply<__nv_bfloat16, 1, BWD>(x, ldx, g, ldg, vec, relu, m, c, out, ldo,
                                                        stream);
  }
  return vector ? launch_apply<float, 4, BWD>(x, ldx, g, ldg, vec, relu, m, c, out, ldo, stream)
                : launch_apply<float, 1, BWD>(x, ldx, g, ldg, vec, relu, m, c, out, ldo, stream);
}

int elt_size(int dtype) { return dtype == 1 ? 2 : 4; }

}  // namespace

extern "C" {

// The plan of a reduction, (a) with g null or (c), over [m, c] with these
// pointers and row strides: plan[0] the floats of scratch it needs (its
// per-block partials), plan[1] its blocks along the rows, plan[2] the rows a
// block sums, plan[3] the most f32 additions between a term and its sum (a
// thread's rows, then the block's row lanes, then the blocks: the depth d
// of the bound |error| <= gamma_d * sum |t|, each term being exact, a
// product inside an FMA). Returns 0, or -1 where c needs more than 64
// channel tiles.
int tpuseg_bn_reduce_plan(const void* x, long long ldx, const void* g, long long ldg, int dtype,
                          long long m, int c, int nsums, long long* plan) {
  if (bad_args(m, c)) return -1;
  const void* ptrs[] = {x, g};
  const long long lds[] = {ldx, ldg};
  const int vec = vector_ok(elt_size(dtype), c, ptrs, lds, g ? 2 : 1) ? 16 / elt_size(dtype) : 1;
  const int tile_c = c < kTileC ? c : kTileC;
  const long long rpi = kThreads / ((tile_c + vec - 1) / vec);
  const long long gx = reduce_blocks(m, c);
  const long long rpb = (m + gx - 1) / gx;
  plan[0] = gx * nsums * c;
  plan[1] = gx;
  plan[2] = rpb;
  plan[3] = (rpb + rpi - 1) / rpi + rpi + gx;
  return 0;
}

// (a). x: dtype (0 f32, 1 bf16) [m rows of stride ldx, c]; bias: f32 [c] or
// null; out: f32 [2, c]; scratch: plan[0] floats of tpuseg_bn_reduce_plan;
// counters: 64 ints, zero (and left zero). Returns the launch's cudaError_t.
int tpuseg_bn_stats(const void* x, long long ldx, int dtype, const float* bias, int relu,
                    long long m, int c, float* out, float* scratch, int* counters, void* stream) {
  if (bad_args(m, c) || ldx < c || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return (int)cudaMemsetAsync(out, 0, sizeof(float) * 2 * c, s);
  const void* ptrs[] = {x};
  const long long lds[] = {ldx};
  Vectors vec{bias, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  return reduce_dispatch<2, false>(dtype, vector_ok(elt_size(dtype), c, ptrs, lds, 1), x, ldx,
                                   nullptr, 0, vec, relu, m, c, out, scratch, counters, s);
}

// (b). mean, mul, beta: f32 [c]; y: dtype [m rows of stride ldy, c].
int tpuseg_bn_apply(const void* x, long long ldx, int dtype, const float* bias, int relu,
                    const float* mean, const float* mul, const float* beta, long long m, int c,
                    void* y, long long ldy, void* stream) {
  if (bad_args(m, c) || ldx < c || ldy < c || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const void* ptrs[] = {x, y};
  const long long lds[] = {ldx, ldy};
  Vectors vec{bias, mean, nullptr, mul, beta, nullptr, nullptr};
  return apply_dispatch<false>(dtype, vector_ok(elt_size(dtype), c, ptrs, lds, 2), x, ldx,
                               nullptr, 0, vec, relu, m, c, y, ldy,
                               static_cast<cudaStream_t>(stream));
}

// (c). g: dtype [m rows of stride ldg, c]; mean, rstd: f32 [c]; nsums 2, or
// 5 with a bias; out: f32 [nsums, c]; scratch, counters as for (a).
int tpuseg_bn_backward_reduce(const void* x, long long ldx, const void* g, long long ldg,
                              int dtype, const float* bias, int relu, const float* mean,
                              const float* rstd, long long m, int c, int nsums, float* out,
                              float* scratch, int* counters, void* stream) {
  if (bad_args(m, c) || ldx < c || ldg < c || (dtype != 0 && dtype != 1) ||
      nsums != (bias ? 5 : 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return (int)cudaMemsetAsync(out, 0, sizeof(float) * nsums * c, s);
  const void* ptrs[] = {x, g};
  const long long lds[] = {ldx, ldg};
  const bool v = vector_ok(elt_size(dtype), c, ptrs, lds, 2);
  Vectors vec{bias, mean, rstd, nullptr, nullptr, nullptr, nullptr};
  if (nsums == 5)
    return reduce_dispatch<5, true>(dtype, v, x, ldx, g, ldg, vec, relu, m, c, out, scratch,
                                    counters, s);
  return reduce_dispatch<2, true>(dtype, v, x, ldx, g, ldg, vec, relu, m, c, out, scratch,
                                  counters, s);
}

// (d). mean, rstd, mul, k1, k2: f32 [c]; dx: dtype [m rows of stride lddx, c].
int tpuseg_bn_backward_apply(const void* x, long long ldx, const void* g, long long ldg,
                             int dtype, const float* bias, int relu, const float* mean,
                             const float* rstd, const float* mul, const float* k1,
                             const float* k2, long long m, int c, void* dx, long long lddx,
                             void* stream) {
  if (bad_args(m, c) || ldx < c || ldg < c || lddx < c || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const void* ptrs[] = {x, g, dx};
  const long long lds[] = {ldx, ldg, lddx};
  Vectors vec{bias, mean, rstd, mul, nullptr, k1, k2};
  return apply_dispatch<true>(dtype, vector_ok(elt_size(dtype), c, ptrs, lds, 3), x, ldx, g, ldg,
                              vec, relu, m, c, dx, lddx, static_cast<cudaStream_t>(stream));
}

const char* tpuseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
