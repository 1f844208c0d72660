// W8A8 GEMM written by hand for Hopper (sm_90a).
//
// int8_matmul_kernel replaces llava_reward_tpu/ops/int8_matmul.py:_make_kernel
//   (B7, via w8a8_matmul): C[m, n] = cast(f32(sum_k a[m, k] * w[k, n])
//   * (amax[m] / 127) * wscale[n]), a = int8 row codes (M, K), w = int8
//   weights (K, N), s32 accumulation. The epilogue keeps the order of
//   utils/quantize.py:_int8_matmul_2d and int8_linear_pre, with IEEE division
//   and no FMA contraction, so it agrees with the plain PyTorch version bit
//   for bit. The row quantization of B7's dynamic form is B6's kernel
//   (quant_epilogue.cu), launched first.
//
// What bounds it on an H100: at the decoders' shapes (M = 20480 or 14336 at
// B=8, K x N up to 3584 x 37888) each weight byte feeds M multiply-adds,
// thousands of operations per byte, so it is bound by the tensor cores' int8
// rate (1979 TOPS dense).
//
// Design. wgmma's s8 form takes both operands K-major from shared memory and
// has no transpose, and TMA cannot transpose bytes, so w is read as its
// (N, K) row-major storage: the W8A8 leaf keeps its (in, out) shape with
// strides (1, in) (utils/quantize.py:k_major). A persistent grid of one block
// per SM walks 128 x 256 output tiles, eight N tiles wide and down M in a
// band (so that the tiles in flight share their a rows and w columns in L2).
// Warpgroup 0 is the producer: it drops to 24 registers and one thread keeps
// TMA loads of a 4-stage ring in flight (a: 128 rows x 128 bytes, w: 256 rows
// x 128 bytes, 48 KiB a stage, 128-byte swizzle: one K step of 128 int8 is
// exactly one swizzle row), running on into the next tile while the
// consumers finish this one. Warpgroups 1 and 2 (240 registers) own 64 rows
// each: four m64n256k32 products per stage into 128 s32 accumulators a
// thread, one stage's products left in flight while the next stage's barrier
// is awaited. The epilogue's row and column scales are loaded before the
// mainloop (the column scales handed on through shared memory); the scaled
// tile goes from the accumulator layout into a 32 KiB staging buffer in the
// 128-byte swizzle layout (conflict-free) and out by TMA stores, 256 bytes
// of each row at a time, which drain while the consumers run the next tile's
// mainloop. TMA reads zeros past M, N and K and clips its stores there, so M
// is any size and K and N are multiples of 16 (TMA's 16-byte row strides).
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BM = 128, BN = 256, BK = 128;  // BK bytes: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int NTHREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int GROUP_N = 8;     // N tiles in one band of the raster
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the output staging: 128 rows x 256 bytes, two 128-byte-swizzled boxes
constexpr int OUT_BOX = BM * 128;
// the ring and the staging (both on 1024-byte boundaries), the column scales
// of two tiles, the ring's full / empty barriers: 226 KiB of the 227
constexpr size_t OUT_OFF = (size_t)STAGES * STAGE_BYTES;
constexpr size_t WS_OFF = OUT_OFF + 2 * OUT_BOX;
constexpr size_t BAR_OFF = WS_OFF + 2 * BN * 4;
constexpr size_t SMEM_BYTES = BAR_OFF + 2 * STAGES * 8;

struct Args {
  CUtensorMap ta;    // codes (M, K), box 128 x 128
  CUtensorMap tb;    // w as its (N, K) storage, box 256 x 128
  CUtensorMap tout;  // out (M, N), box 128 rows x 128 bytes
  const float* amax;
  const float* wscale;
  int M, N, m_tiles, n_tiles, k_steps;
};

// tile -> (m, n): bands of GROUP_N tiles along N, walked along M
__device__ __forceinline__ void tile_mn(int tile, int m_tiles, int n_tiles, int& m, int& n) {
  const int band = tile / (GROUP_N * m_tiles), r = tile % (GROUP_N * m_tiles);
  const int n0 = band * GROUP_N;
  const int width = min(GROUP_N, n_tiles - n0);
  m = r / width;
  n = n0 + r % width;
}

template <typename OutT>
__device__ __forceinline__ void put2(unsigned char* p, float x, float y);

template <>
__device__ __forceinline__ void put2<__nv_bfloat16>(unsigned char* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = sm90::pack_bf16(x, y);
}

template <>
__device__ __forceinline__ void put2<float>(unsigned char* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

template <typename OutT>
__global__ void __launch_bounds__(NTHREADS, 1) int8_matmul_kernel(const __grid_constant__ Args a) {
  // the swizzled tiles need 1024-byte alignment, which the dynamic shared
  // memory's base has on this card; a launch where it had not would trap
  extern __shared__ __align__(1024) unsigned char smem[];
  if (sm90::smem_u32(smem) & 1023) asm volatile("trap;");
  unsigned char* s_out = smem + OUT_OFF;
  float* s_ws = reinterpret_cast<float*>(smem + WS_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int n_tiles_all = a.m_tiles * a.n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full, across tiles
    sm90::reg_dealloc<24>();
    if (t != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles_all; tile += gridDim.x) {
      int m, n;
      tile_mn(tile, a.m_tiles, a.n_tiles, m, n);
      for (int ks = 0; ks < a.k_steps; ++ks, ++it) {
        const int st = it % STAGES;
        sm90::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        unsigned char* sa = smem + st * STAGE_BYTES;
        sm90::mbar_expect_tx(&full[st], STAGE_BYTES);
        sm90::tma_load_2d(sa, &a.ta, &full[st], ks * BK, m * BM);
        sm90::tma_load_2d(sa + A_BYTES, &a.tb, &full[st], ks * BK, n * BN);
      }
    }
    return;
  }

  // ---- consumers: rows (wg - 1) * 64 .. + 64 of each tile, all 256 columns
  sm90::reg_alloc<240>();
  const int ct = threadIdx.x - 128;  // 0..255 over both consumer warpgroups
  const int lr0 = (wg - 1) * 64 + sm90::acc_row(t, 0);  // this thread's rows lr0, lr0 + 8
  constexpr int E = sizeof(OutT);
  constexpr int ROUND_COLS = 256 / E;  // columns staged at a time: 256 bytes of each row
  constexpr int GROUPS = ROUND_COLS / 8;  // 8-column accumulator groups in a round
  int it = 0;
  for (int tile = blockIdx.x, ti = 0; tile < n_tiles_all; tile += gridDim.x, ++ti) {
    int m, n;
    tile_mn(tile, a.m_tiles, a.n_tiles, m, n);
    // the epilogue's scales, loaded now so that the mainloop hides their
    // latency: this thread's two row amax and one column scale of the tile
    float am[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = m * BM + lr0 + 8 * j;
      am[j] = row < a.M ? a.amax[row] : 0.f;
    }
    const float my_ws = n * BN + ct < a.N ? a.wscale[n * BN + ct] : 0.f;
    int acc[BN / 2];
    for (int ks = 0; ks < a.k_steps; ++ks, ++it) {
      const int st = it % STAGES;
      sm90::mbar_wait(&full[st], (it / STAGES) & 1);
      const unsigned char* sa = smem + st * STAGE_BYTES + (wg - 1) * 64 * BK;
      const unsigned char* sb = smem + st * STAGE_BYTES + A_BYTES;
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        sm90::WgmmaS8<BN>::ss(acc, sm90::desc_sw128(sa + kk * 32), sm90::desc_sw128(sb + kk * 32),
                              ks > 0 || kk > 0);
      sm90::wg_commit();
      // the previous stage's products are done: release it
      sm90::wg_wait<1>();
      if (ks > 0) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    sm90::wg_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(&empty[(it - 1) % STAGES]);

    // the column scales through shared memory: a slot is rewritten two tiles
    // on, after every thread has passed the barriers of the tile between
    float* ws_tile = s_ws + (ti & 1) * BN;
    ws_tile[ct] = my_ws;
    const float rs[2] = {__fdiv_rn(am[0], 127.f), __fdiv_rn(am[1], 127.f)};
    // one flat unrolled loop over the column groups, so that every
    // accumulator index is a constant; a round is GROUPS groups
#pragma unroll
    for (int g = 0; g < BN / 8; ++g) {
      const int h = g / GROUPS;
      if (g % GROUPS == 0) {
        // the staging is free once the last round's stores have read it
        if (ct == 0) sm90::bulk_wait_read();
        sm90::bar_sync(1, 256);
      }
      const int c = sm90::acc_col(t, 4 * g);      // tile column of this thread's pair
      const int byte = (c - h * ROUND_COLS) * E;  // in the round's 256 bytes of a row
      const float2 ws = *reinterpret_cast<const float2*>(ws_tile + c);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = lr0 + 8 * j;
        const float x = __fmul_rn(__fmul_rn((float)acc[4 * g + 2 * j], rs[j]), ws.x);
        const float y = __fmul_rn(__fmul_rn((float)acc[4 * g + 2 * j + 1], rs[j]), ws.y);
        // box byte / 128; in it, row r's 16-byte chunk swizzled by r % 8
        put2<OutT>(s_out + (byte / 128) * OUT_BOX + r * 128 +
                       ((((byte % 128) / 16) ^ (r % 8)) * 16) + byte % 16,
                   x, y);
      }
      if (g % GROUPS == GROUPS - 1) {
        sm90::fence_async_smem();
        sm90::bar_sync(1, 256);
        if (ct == 0) {
          for (int b = 0; b < 2; ++b)
            sm90::tma_store_2d(&a.tout, s_out + b * OUT_BOX,
                               n * BN + h * ROUND_COLS + b * 128 / E, m * BM);
          sm90::bulk_commit();
        }
      }
    }
  }
  if (ct == 0) sm90::bulk_wait();  // the last stores are done before the block's memory goes
}

template <typename OutT>
int launch(const Args& a, int grid, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(int8_matmul_kernel<OutT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  int8_matmul_kernel<OutT><<<grid, NTHREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// codes (M, K) int8, w (K, N) int8 stored K-major, i.e. passed as the
// pointer of its (N, K) row-major storage, amax (M,) f32, wscale (N,) f32 ->
// out (M, N) bf16 (out_is_bf16) or f32. K % 16 == 0, N % 16 == 0; codes, w
// and out 16-byte aligned.
extern "C" int lrt_int8_matmul(const void* codes, const void* w, const void* amax,
                               const void* wscale, void* out, int M, int N, int K,
                               int out_is_bf16, void* stream) {
  if (K <= 0 || K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  Args a;
  const int E = out_is_bf16 ? 2 : 4;
  int e = sm90_host::sw128_map(&a.ta, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, K, BM);
  if (e == 0) e = sm90_host::sw128_map(&a.tb, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, K, BN);
  if (e == 0)
    e = sm90_host::sw128_map(&a.tout, out,
                             out_is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                             E, M, N, (long long)N * E, BM);
  if (e != 0) return e;
  a.amax = static_cast<const float*>(amax);
  a.wscale = static_cast<const float*>(wscale);
  a.M = M;
  a.N = N;
  a.m_tiles = (M + BM - 1) / BM;
  a.n_tiles = (N + BN - 1) / BN;
  a.k_steps = (K + BK - 1) / BK;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaGetLastError();
  }
  const int tiles = a.m_tiles * a.n_tiles;
  const int grid = tiles < sms ? tiles : sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_is_bf16 ? launch<__nv_bfloat16>(a, grid, st) : launch<float>(a, grid, st);
}
