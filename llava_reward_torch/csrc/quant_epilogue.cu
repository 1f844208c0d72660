// Quantizing epilogues written by hand for Hopper (sm_90a).
//
// rms_quant_kernel replaces llava_reward_tpu/ops/quant_epilogue.py:
//   _rms_quant_kernel (B4): Phi-3 RMSNorm (fp32 variance, x * 1/sqrt(var+eps),
//   bf16 rounding before and after the weight multiply for bf16 input), then
//   per-row int8 codes and the row amax.
// silu_mul_quant_kernel replaces _silu_mul_quant_kernel (B5): from the fused
//   (M, 2I) gate_up, y = g * sigmoid(g) * u in fp32 (gate in the first I
//   columns), rounded to bf16 for bf16 input, then codes and amax.
// row_quant_kernel replaces _row_quant_kernel (B6): codes and amax of x.
// ln_quant_kernel replaces _ln_quant_kernel (B9): LayerNorm in fp32 (mean,
//   centred variance, xc * 1/sqrt(var+eps) * w + b), with NO bf16 rounding of
//   the result (ln_quant quantizes the fp32 LayerNorm output), then codes and
//   amax. It feeds the CLIP tower's W8A8 qkv and fc1 projections.
//
// All four emit codes = rint(y * (127 / amax)) (round half to even) with
// amax := 1 for an all-zero row, and write amax itself as the row scale.
// The arithmetic uses the _rn intrinsics (IEEE division, sqrt, reciprocal,
// no FMA contraction) and IEEE expf, so each element is computed as the
// plain PyTorch version computes it. Only the row sums of B4 (x^2) and B9 (x,
// then xc^2) are taken in another order than the plain version's torch.sum,
// which can move a code by one at a rounding boundary.
//
// What bounds them on an H100: a few operations per element against 2 bytes
// read and 1 written (B5: 4 read, 1 written), far below the card's ~295
// operations-per-byte ridge, so they are bound by memory bytes. One block of
// 256 threads owns one row: it reads the row once from device memory with
// 16-byte loads, keeps the fp32 values in shared memory (12 KB for B4 / B6
// at H = 3072, 32 KB for B5 at I = 8192, 4 KB for B9 at CLIP's H = 1024,
// whose 87040 rows of a B=8 request make 87040 blocks), reduces in registers and shared
// memory, and writes the codes with 8-byte stores.
#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;  // threads per block; one block per row

// Load 8 consecutive values of a row (16 bytes of bf16, two 16-byte words of
// f32) as fp32.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v);

template <>
__device__ __forceinline__ void load8<bf16>(const bf16* p, float* v) {
  lrt::Vec8 w;
  w.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(w.h[e]);
}

template <>
__device__ __forceinline__ void load8<float>(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Block-wide sum / max of one value per thread; every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : __fadd_rn(v, w);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) v = MAX ? fmaxf(v, red[w]) : __fadd_rn(v, red[w]);
  return v;
}

// Codes of the n fp32 values in ys (shared memory) with row amax ``mx``.
__device__ __forceinline__ void write_codes(const float* ys, int n, float mx, int8_t* codes,
                                            float* amax_out) {
  const float amax = mx > 0.f ? mx : 1.f;
  const float q = __fdiv_rn(127.f, amax);
  for (int c = threadIdx.x; c < n / 8; c += NT) {
    union {
      uint2 u;
      int8_t b[8];
    } w;
#pragma unroll
    for (int e = 0; e < 8; ++e) w.b[e] = (int8_t)rintf(__fmul_rn(ys[c * 8 + e], q));
    *reinterpret_cast<uint2*>(codes + c * 8) = w.u;
  }
  if (threadIdx.x == 0) *amax_out = amax;
}

template <typename T>
__global__ void __launch_bounds__(NT)
    rms_quant_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     int8_t* __restrict__ codes, float* __restrict__ amax_out, int H,
                     float eps) {
  extern __shared__ float ys[];
  __shared__ float red[NT / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * H;
  float ss = 0.f;
  for (int c = threadIdx.x; c < H / 8; c += NT) {
    float v[8];
    load8<T>(xr + c * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ys[c * 8 + e] = v[e];
      ss = __fadd_rn(ss, __fmul_rn(v[e], v[e]));
    }
  }
  const float var = __fdiv_rn(block_reduce<false>(ss, red), (float)H);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  const bool is_bf16 = sizeof(T) == 2;
  float mx = 0.f;
  for (int i = threadIdx.x; i < H; i += NT) {
    float y = __fmul_rn(ys[i], inv);
    if (is_bf16) {
      y = bf16_round(__fmul_rn(w[i], bf16_round(y)));
    } else {
      y = __fmul_rn(w[i], y);
    }
    ys[i] = y;
    mx = fmaxf(mx, fabsf(y));
  }
  mx = block_reduce<true>(mx, red);
  write_codes(ys, H, mx, codes + row * H, amax_out + row);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, int8_t* __restrict__ codes,
                    float* __restrict__ amax_out, int H, float eps) {
  extern __shared__ float ys[];
  __shared__ float red[NT / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * H;
  float s = 0.f;
  for (int c = threadIdx.x; c < H / 8; c += NT) {
    float v[8];
    load8<T>(xr + c * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ys[c * 8 + e] = v[e];
      s = __fadd_rn(s, v[e]);
    }
  }
  const float mean = __fdiv_rn(block_reduce<false>(s, red), (float)H);
  float ss = 0.f;
  for (int i = threadIdx.x; i < H; i += NT) {
    const float xc = __fsub_rn(ys[i], mean);
    ys[i] = xc;
    ss = __fadd_rn(ss, __fmul_rn(xc, xc));
  }
  const float var = __fdiv_rn(block_reduce<false>(ss, red), (float)H);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  float mx = 0.f;
  for (int i = threadIdx.x; i < H; i += NT) {
    // each thread rereads the elements it centred: no barrier needed
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(ys[i], inv), w[i]), b[i]);
    ys[i] = y;
    mx = fmaxf(mx, fabsf(y));
  }
  mx = block_reduce<true>(mx, red);
  write_codes(ys, H, mx, codes + row * H, amax_out + row);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    silu_mul_quant_kernel(const T* __restrict__ gu, int8_t* __restrict__ codes,
                          float* __restrict__ amax_out, int I) {
  extern __shared__ float ys[];
  __shared__ float red[NT / 32];
  const long long row = blockIdx.x;
  const T* gr = gu + row * 2LL * I;
  const bool is_bf16 = sizeof(T) == 2;
  float mx = 0.f;
  for (int c = threadIdx.x; c < I / 8; c += NT) {
    float g[8], u[8];
    load8<T>(gr + c * 8, g);
    load8<T>(gr + I + c * 8, u);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g[e])));
      float y = __fmul_rn(__fmul_rn(g[e], sig), u[e]);
      if (is_bf16) y = bf16_round(y);
      ys[c * 8 + e] = y;
      mx = fmaxf(mx, fabsf(y));
    }
  }
  mx = block_reduce<true>(mx, red);
  write_codes(ys, I, mx, codes + row * I, amax_out + row);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    row_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
                     float* __restrict__ amax_out, int H) {
  extern __shared__ float ys[];
  __shared__ float red[NT / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * H;
  float mx = 0.f;
  for (int c = threadIdx.x; c < H / 8; c += NT) {
    float v[8];
    load8<T>(xr + c * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ys[c * 8 + e] = v[e];
      mx = fmaxf(mx, fabsf(v[e]));
    }
  }
  mx = block_reduce<true>(mx, red);
  write_codes(ys, H, mx, codes + row * H, amax_out + row);
}

// Launch one block per row with n fp32 values of dynamic shared memory.
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int M, int n, cudaStream_t st, Args... args) {
  if (M == 0) return 0;
  const size_t smem = (size_t)n * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<M, NT, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// B4: x (M, H) bf16 or f32, weight (H,) f32 -> codes (M, H) int8, amax (M,) f32.
// H a multiple of 8; rows 16-byte aligned.
extern "C" int lrt_rms_quant(const void* x, const void* w, void* codes, void* amax, int M,
                             int H, float eps, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  int8_t* cp = static_cast<int8_t*>(codes);
  float* ap = static_cast<float*>(amax);
  if (is_bf16)
    return launch_rows(rms_quant_kernel<bf16>, M, H, st, static_cast<const bf16*>(x), wp, cp,
                       ap, H, eps);
  return launch_rows(rms_quant_kernel<float>, M, H, st, static_cast<const float*>(x), wp, cp,
                     ap, H, eps);
}

// B5: gate_up (M, 2I) bf16 or f32 -> codes (M, I) int8, amax (M,) f32.
extern "C" int lrt_silu_mul_quant(const void* gate_up, void* codes, void* amax, int M, int I,
                                  int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* cp = static_cast<int8_t*>(codes);
  float* ap = static_cast<float*>(amax);
  if (is_bf16)
    return launch_rows(silu_mul_quant_kernel<bf16>, M, I, st,
                       static_cast<const bf16*>(gate_up), cp, ap, I);
  return launch_rows(silu_mul_quant_kernel<float>, M, I, st,
                     static_cast<const float*>(gate_up), cp, ap, I);
}

// B6: x (M, H) bf16 or f32 -> codes (M, H) int8, amax (M,) f32.
extern "C" int lrt_row_quant(const void* x, void* codes, void* amax, int M, int H,
                             int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* cp = static_cast<int8_t*>(codes);
  float* ap = static_cast<float*>(amax);
  if (is_bf16)
    return launch_rows(row_quant_kernel<bf16>, M, H, st, static_cast<const bf16*>(x), cp, ap,
                       H);
  return launch_rows(row_quant_kernel<float>, M, H, st, static_cast<const float*>(x), cp, ap,
                     H);
}

// B9: x (M, H) bf16 or f32, weight and bias (H,) f32 -> codes (M, H) int8,
// amax (M,) f32. H a multiple of 8; rows 16-byte aligned.
extern "C" int lrt_ln_quant(const void* x, const void* w, const void* b, void* codes,
                            void* amax, int M, int H, float eps, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  int8_t* cp = static_cast<int8_t*>(codes);
  float* ap = static_cast<float*>(amax);
  if (is_bf16)
    return launch_rows(ln_quant_kernel<bf16>, M, H, st, static_cast<const bf16*>(x), wp, bp,
                       cp, ap, H, eps);
  return launch_rows(ln_quant_kernel<float>, M, H, st, static_cast<const float*>(x), wp, bp,
                     cp, ap, H, eps);
}
