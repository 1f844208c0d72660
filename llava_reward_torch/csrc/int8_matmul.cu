// W8A8 GEMM written by hand for Hopper (sm_90a).
//
// int8_matmul_kernel replaces llava_reward_tpu/ops/int8_matmul.py:_make_kernel
//   (B7, via w8a8_matmul): C[m, n] = cast(f32(sum_k a[m, k] * w[k, n])
//   * (amax[m] / 127) * wscale[n]), a = int8 row codes (M, K), w = int8
//   weights (K, N) row-major as the param tree holds them, s32 accumulation.
//   The epilogue keeps the order of utils/quantize.py:_int8_matmul_2d and
//   int8_linear_pre, with IEEE division and no FMA contraction, so it agrees
//   with the plain PyTorch version bit for bit. The row quantization of B7's
//   dynamic form is B6's kernel (quant_epilogue.cu), launched first.
//
// What bounds it on an H100: at the decoder's shapes (M = 5120 or 20480, K x N
// = 3072 x 9216, 3072 x 3072, 3072 x 16384, 8192 x 3072) each weight byte
// feeds M multiply-adds, thousands of operations per byte, so it is bound by
// the tensor cores' int8 rate (1979 TOPS dense). This first kernel is simple:
// 128 x 128 output tiles, 64-deep K steps double-buffered in shared memory
// through cp.async, and WMMA s8 16x16x16 products (mma.sync) into s32
// accumulators, 64 x 32 per warp. Shared memory holds each 16-byte-wide
// K (for a) or N (for w) slice as its own array, so every WMMA fragment
// starts on a 256-byte boundary and w needs no transpose (ldmatrix.trans has
// no 8-bit form). wgmma wants K-major int8 w and is left for later work.
// Rows past M read zeros and are not written; K and N are multiples of 16.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int NT = 256;           // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;   // warp tile
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int A_BYTES = BM * BK;  // one stage of a: [BK/16][BM][16]
constexpr int B_BYTES = BK * BN;  // one stage of w: [BN/16][BK][16]
constexpr int STAGE = A_BYTES + B_BYTES;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n"); }

// One BM x BK tile of a and one BK x BN tile of w into a stage.
__device__ __forceinline__ void load_stage(unsigned char* st, const int8_t* a, const int8_t* w,
                                           int M, int N, int K, int m0, int n0, int k0) {
  unsigned char* sa = st;
  unsigned char* sb = st + A_BYTES;
  for (int idx = threadIdx.x; idx < BM * (BK / 16); idx += NT) {
    const int r = idx / (BK / 16), kc = idx % (BK / 16);
    const bool ok = m0 + r < M && k0 + kc * 16 < K;
    const int8_t* src = ok ? a + (long long)(m0 + r) * K + k0 + kc * 16 : a;
    cp_async16(sa + (kc * BM + r) * 16, src, ok);
  }
  for (int idx = threadIdx.x; idx < BK * (BN / 16); idx += NT) {
    const int kr = idx / (BN / 16), nc = idx % (BN / 16);
    const bool ok = k0 + kr < K && n0 + nc * 16 < N;
    const int8_t* src = ok ? w + (long long)(k0 + kr) * N + n0 + nc * 16 : w;
    cp_async16(sb + (nc * BK + kr) * 16, src, ok);
  }
}

template <typename OutT>
__device__ __forceinline__ void store8(OutT* dst, const float* v);

template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* dst, const float* v) {
  lrt::Vec8 o;
#pragma unroll
  for (int e = 0; e < 8; ++e) o.h[e] = __float2bfloat16_rn(v[e]);
  *reinterpret_cast<uint4*>(dst) = o.u;
}

template <>
__device__ __forceinline__ void store8<float>(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename OutT>
__global__ void __launch_bounds__(NT)
    int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                       const float* __restrict__ amax, const float* __restrict__ wscale,
                       OutT* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) unsigned char smem[2 * STAGE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int nk = (K + BK - 1) / BK;
  load_stage(smem, a, w, M, N, K, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage(smem + ((kt + 1) & 1) * STAGE, a, w, M, N, K, m0, n0,
                                (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait1();  // every group but the newest is in: stage kt is ready
    __syncthreads();
    const signed char* sa = reinterpret_cast<const signed char*>(smem + (kt & 1) * STAGE);
    const signed char* sb = sa + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], sa + (kk * BM + wm * WM + i * 16) * 16, 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], sb + ((wn * FN + j) * BK + kk * 16) * 16, 16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the stage is free for the load two steps on
  }

  // epilogue: each warp stages one 16 x 16 s32 fragment at a time in its own
  // 1 KB of the (now idle) pipeline memory; a lane pair owns one row
  int* scratch = reinterpret_cast<int*>(smem) + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
    const int gm = m0 + wm * WM + i * 16 + r;
    const float rs = gm < M ? __fdiv_rn(amax[gm], 127.f) : 0.f;
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gn = n0 + wn * WN + j * 16 + c0;
      if (gm < M && gn < N) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __fmul_rn(__fmul_rn((float)scratch[r * 16 + c0 + e], rs), wscale[gn + e]);
        store8<OutT>(out + (long long)gm * N + gn, v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// codes (M, K) int8, w (K, N) int8, amax (M,) f32, wscale (N,) f32 ->
// out (M, N) bf16 (out_is_bf16) or f32. K % 16 == 0, N % 16 == 0.
extern "C" int lrt_int8_matmul(const void* codes, const void* w, const void* amax,
                               const void* wscale, void* out, int M, int N, int K,
                               int out_is_bf16, void* stream) {
  if (K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int8_t* ap = static_cast<const int8_t*>(codes);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* rp = static_cast<const float*>(amax);
  const float* sp = static_cast<const float*>(wscale);
  if (out_is_bf16)
    int8_matmul_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        ap, wp, rp, sp, static_cast<__nv_bfloat16*>(out), M, N, K);
  else
    int8_matmul_kernel<float><<<grid, NT, 0, st>>>(ap, wp, rp, sp, static_cast<float*>(out),
                                                    M, N, K);
  return (int)cudaGetLastError();
}
