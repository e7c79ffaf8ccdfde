// Blocked 1x1 head + per-phase first-max argmax + depth-to-space, for Hopper.
//
// Replaces the TPU kernel tpuseg/infer/head_kernel.py::_head_kernel (Pallas,
// called through _head_pallas). Same contract as
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
// Bound: memory. At the serving shape (B=8, h=w=512, C4=256 int8, ncls=2) the
// kernel must read 8*512*512*256 B = 537 MB and write 8*1024*1024*4 B = 34 MB:
// ~170 us at 3.35 TB/s, against ~8.6 GFLOP of multiply-adds.
//
// Design (simple first): one thread per blocked pixel in a grid-stride loop
// over a grid sized to the SMs, so each block stages the head's constants
// (sv and wt as f32, or wt as packed int8, and epi) in shared memory once and
// reuses them for many pixels. Each thread streams its pixel's C4 values with
// 16-byte vector loads; all threads of a warp read the same 16-byte weight
// group at a time, a shared-memory broadcast. Neighbouring threads own
// neighbouring pixels, so the label writes (an 8-byte pair per output row)
// coalesce. The int8 head accumulates with __dp4a, exact in int32. The
// epilogue uses the _rn intrinsics so nvcc cannot contract it into FMAs: it
// rounds where the PyTorch plain version rounds, which keeps the int8 head's
// labels bit-equal to it. Each phase's class rows are padded to NMAX (2, 4 or
// 8, a template argument) so the accumulators stay in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kInt8 = 0, kBF16 = 1, kF32 = 2 };
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

// epilogue, per-phase argmax, and the depth-to-space write of pixel (b, i, j)
template <int NMAX>
__device__ __forceinline__ void finish(const float (&y)[4 * NMAX], const float* s_epi,
                                       int ncls, int* out, long long b, int i, int j,
                                       int h, int w) {
  const int nout = 4 * ncls;
  int lbl[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    int best_c = 0;
    float best = 0.f;
#pragma unroll
    for (int c = 0; c < NMAX; ++c) {
      if (c < ncls) {
        const int o = p * ncls + c;
        float v = fmaxf(__fadd_rn(y[p * NMAX + c], s_epi[o]), 0.f);
        v = __fadd_rn(__fmul_rn(v, s_epi[nout + o]), s_epi[2 * nout + o]);
        if (c == 0 || v > best) {  // first max wins ties, as argmax does
          best = v;
          best_c = c;
        }
      }
    }
    lbl[p] = best_c;
  }
  // out is [B, 2h, 2w]; pixel (i, j) owns (2i+dy, 2j+dx)
  const long long w2 = 2LL * w;
  const long long top = (b * 2LL * h + 2LL * i) * w2 + 2LL * j;
  *reinterpret_cast<int2*>(out + top) = make_int2(lbl[0], lbl[1]);
  *reinterpret_cast<int2*>(out + top + w2) = make_int2(lbl[2], lbl[3]);
}

template <typename TX, int NMAX>
__global__ void __launch_bounds__(kThreads)
head_fp_kernel(const TX* __restrict__ x, const float* __restrict__ sv,
               const void* __restrict__ wt, int wt_dtype,
               const float* __restrict__ epi, int* __restrict__ out,
               long long npix, int h, int w, int c4, int ncls) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_w = smem;                  // [4*NMAX][c4], phase rows padded to NMAX
  float* s_sv = s_w + 4 * NMAX * c4;  // [c4]
  float* s_epi = s_sv + c4;           // [4][4*ncls]
  const bool round_bf16 = wt_dtype == kBF16;
  for (int t = threadIdx.x; t < 4 * NMAX * c4; t += blockDim.x) {
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
  for (int t = threadIdx.x; t < 16 * ncls; t += blockDim.x) s_epi[t] = epi[t];
  __syncthreads();

  constexpr int V = Vec16<TX>::N;
  const long long hw = (long long)h * w;
  for (long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x; n < npix;
       n += (long long)gridDim.x * blockDim.x) {
    const TX* px = x + n * c4;
    float y[4 * NMAX];
#pragma unroll
    for (int o = 0; o < 4 * NMAX; ++o) y[o] = 0.f;
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
        for (int o = 0; o < 4 * NMAX; ++o) {
          const float4 wv = *reinterpret_cast<const float4*>(s_w + o * c4 + k0 + u);
          y[o] = fmaf(v[0], wv.x, y[o]);
          y[o] = fmaf(v[1], wv.y, y[o]);
          y[o] = fmaf(v[2], wv.z, y[o]);
          y[o] = fmaf(v[3], wv.w, y[o]);
        }
      }
    }
    const long long b = n / hw;
    const int rem = (int)(n - b * hw);
    finish<NMAX>(y, s_epi, ncls, out, b, rem / w, rem % w, h, w);
  }
}

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
head_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
               const float* __restrict__ epi, int* __restrict__ out,
               long long npix, int h, int w, int c4, int ncls) {
  extern __shared__ int4 smem_i4[];
  const int nout = 4 * ncls;
  const int c16 = c4 / 16;  // 16-byte groups per row
  int4* s_w = smem_i4;      // [4*NMAX][c4/16] packed int8, phase rows padded
  float* s_epi = reinterpret_cast<float*>(s_w + 4 * NMAX * c16);  // [4][nout]
  for (int t = threadIdx.x; t < 4 * NMAX * c16; t += blockDim.x) {
    const int r = t / c16, k = t % c16, p = r / NMAX, c = r % NMAX;
    s_w[t] = c < ncls ? reinterpret_cast<const int4*>(wt)[(p * ncls + c) * c16 + k]
                      : make_int4(0, 0, 0, 0);
  }
  for (int t = threadIdx.x; t < 4 * nout; t += blockDim.x) s_epi[t] = epi[t];
  __syncthreads();

  const long long hw = (long long)h * w;
  for (long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x; n < npix;
       n += (long long)gridDim.x * blockDim.x) {
    const int4* px = reinterpret_cast<const int4*>(x + n * c4);
    int acc[4 * NMAX];
#pragma unroll
    for (int o = 0; o < 4 * NMAX; ++o) acc[o] = 0;
    for (int q = 0; q < c16; ++q) {
      const int4 v = px[q];
#pragma unroll
      for (int o = 0; o < 4 * NMAX; ++o) {
        const int4 wv = s_w[o * c16 + q];
        acc[o] = __dp4a(v.x, wv.x, acc[o]);
        acc[o] = __dp4a(v.y, wv.y, acc[o]);
        acc[o] = __dp4a(v.z, wv.z, acc[o]);
        acc[o] = __dp4a(v.w, wv.w, acc[o]);
      }
    }
    float y[4 * NMAX];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int c = 0; c < NMAX; ++c) {
        y[p * NMAX + c] = c < ncls ? __fmul_rn(__int2float_rn(acc[p * NMAX + c]),
                                               s_epi[3 * nout + p * ncls + c])
                                   : 0.f;
      }
    }
    const long long b = n / hw;
    const int rem = (int)(n - b * hw);
    finish<NMAX>(y, s_epi, ncls, out, b, rem / w, rem % w, h, w);
  }
}

int grid_for(long long npix) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long need = (npix + kThreads - 1) / kThreads;
  const long long cap = 8LL * (sms > 0 ? sms : 132);
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
                     int w, int c4, int ncls, bool fp, cudaStream_t stream) {
  if (!fp) {
    const size_t smem = 4 * NMAX * c4 + 16 * ncls * sizeof(float);
    return run(head_s8_kernel<NMAX>, smem, npix, stream,
               static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt), epi, out,
               npix, h, w, c4, ncls);
  }
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

}  // namespace

extern "C" {

// x: [b, h, w, c4] of x_dtype; sv: f32 [c4] (fp head only); wt: [4*ncls, c4]
// (bf16 or f32 for the fp head, int8 otherwise); epi: f32 [4, 4*ncls];
// out: int32 [b, 2h, 2w]. Launches on `stream` and returns the cudaError_t
// of the launch (0 on success); the caller checked devices and contiguity.
int tpuseg_head_argmax(const void* x, int x_dtype, const float* sv, const void* wt,
                       int wt_dtype, const float* epi, int* out, int b, int h, int w,
                       int c4, int ncls, int fp, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || ncls < 1 || ncls > 8 || c4 % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (!fp && (x_dtype != kInt8 || wt_dtype != kInt8)) return (int)cudaErrorInvalidValue;
  if (fp && wt_dtype != kBF16 && wt_dtype != kF32) return (int)cudaErrorInvalidValue;
  const long long npix = (long long)b * h * w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ncls <= 2)
    return (int)dispatch<2>(x, x_dtype, sv, wt, wt_dtype, epi, out, npix, h, w, c4, ncls, fp, s);
  if (ncls <= 4)
    return (int)dispatch<4>(x, x_dtype, sv, wt, wt_dtype, epi, out, npix, h, w, c4, ncls, fp, s);
  return (int)dispatch<8>(x, x_dtype, sv, wt, wt_dtype, epi, out, npix, h, w, c4, ncls, fp, s);
}

const char* tpuseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
