// Attention forward kernels written by hand for Hopper (sm_90a).
//
// fa_direct_kernel replaces llava_reward_tpu/ops/flash_attention.py:
//   _fa_direct_kernel (B1): q/k/v read straight out of the fused (B, S, 3*H*D)
//   projection, optional rotate-half RoPE on q and k, output written as
//   (B, S, H*D). It carries the CLIP tower (16 heads x 64, non-causal,
//   valid_len key mask) and the Phi-3 decoder at B*(H/g) >= 32 (32 heads x
//   96, causal, su-RoPE, left-pad kv_start).
// fa_hm_kernel replaces llava_reward_tpu/ops/flash_attention.py:_fa_kernel
//   (B3): head-major (or any (b, h, s) strided) q/k/v, native GQA (query head
//   h reads kv head h / n_rep), causal + window + kv_start + q_len masks. The
//   key-mask and segment-id modes wait for the Qwen slice.
//
// What bounds them on an H100: causal attention at S=2560, D=96 does about
// 4*D*S*S/2 FLOPs per head on 2*S*D*3 bytes, ~100 FLOP/byte per head pair,
// far past the card's ~295 FLOP/byte ridge, so they are bound by tensor-core
// operations. The design keeps the S x S scores out of device memory (online
// softmax over 64-key tiles, fp32 state in registers), feeds the tensor cores
// through WMMA bf16 16x16x16 products with fp32 accumulation, and skips key
// tiles that the masks make empty (causal tail, left pad, q_len tail).
// wgmma, TMA and warp specialisation are left for later work.
//
// Semantics kept from the TPU kernels:
// - roped q/k are rounded to bf16 before the dot; scale is applied to the
//   fp32 dot; masked scores take the finite fill -1e30 (not -inf), so a query
//   row whose keys are all masked (a left-pad row) comes out finite, as the
//   mean of V over the keys visited, and never NaN;
// - probabilities are rounded to bf16 before P.V, accumulated in fp32.
//   The TPU normalises before that rounding, this kernel after P.V (online
//   softmax); the difference is within bf16 rounding of the probabilities.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NWARPS = 4;    // each warp owns 16 query rows
constexpr int NTHREADS = 32 * NWARPS;
constexpr int WROWS = 16;
constexpr int LDP = BK + 8;  // bf16 probability tile row stride
constexpr float MASK_FILL = -1e30f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const bf16* cos;  // (B, S, D) when RoPE is on
  const bf16* sin;
  const int* kv_start;  // (B,) first valid key per batch row
  long long q_sb, q_sh, q_ss;  // element strides: batch, head, sequence
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int S, n_rep, q_len, causal, window;  // window <= 0: no sliding window
  float scale;
};

template <int D>
struct Smem {
  static constexpr int LDS = (BK + 4) > (D + 4) ? (BK + 4) : (D + 4);  // fp32 scratch stride
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + (size_t)BQ * D * 2;
  static constexpr size_t v_off = k_off + (size_t)BK * D * 2;
  static constexpr size_t s_off = v_off + (size_t)BK * D * 2;
  static constexpr size_t p_off = s_off + (size_t)NWARPS * WROWS * LDS * 4;
  static constexpr size_t bytes = p_off + (size_t)NWARPS * WROWS * LDP * 2;
};

// 64 rows x D columns of a (row-strided) bf16 matrix into shared memory,
// zero past the last row, roped in fp32 when ROPE (cos/sin rows are D wide).
template <int D, bool ROPE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int row0, int n_rows, const bf16* cos,
                                          const bf16* sin) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH;
    const int gr = row0 + r;
    lrt::Vec8 val;
    val.u = make_uint4(0, 0, 0, 0);
    if (gr < n_rows) {
      const bf16* row = src + (long long)gr * row_stride;
      val.u = *reinterpret_cast<const uint4*>(row + c * 8);
      if (ROPE) {
        lrt::Vec8 par, cv, sv;
        par.u = *reinterpret_cast<const uint4*>(row + ((c + CH / 2) % CH) * 8);
        cv.u = *reinterpret_cast<const uint4*>(cos + (long long)gr * D + c * 8);
        sv.u = *reinterpret_cast<const uint4*>(sin + (long long)gr * D + c * 8);
        val = lrt::rope_chunk(val, par, cv, sv, c < CH / 2);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * D + c * 8) = val.u;
  }
}

template <int D, bool ROPE>
__device__ __forceinline__ void attn_block(const Args& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  typedef Smem<D> L;
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p_off);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // heaviest causal tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.n_rep;
  const int q0 = qt * BQ;
  const int kvs = a.kv_start[b];

  const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + hk * a.v_sh;
  const bf16* cb = ROPE ? a.cos + (long long)b * a.S * D : nullptr;
  const bf16* sb = ROPE ? a.sin + (long long)b * a.S * D : nullptr;

  load_tile<D, ROPE>(sQ, qb, a.q_ss, q0, a.S, cb, sb);

  // key tiles that can hold an unmasked key for some row of this block
  int k_end = a.causal ? min(q0 + BQ, a.S) : a.S;
  k_end = min(k_end, a.q_len);
  int k_begin = (kvs / BK) * BK;
  if (a.causal && a.window > 0) {
    const int lo = q0 - a.window + 1;
    if (lo > 0) k_begin = max(k_begin, (lo / BK) * BK);
  }

  // each lane pair owns one query row; lane & 1 picks its half of the columns
  const int r = lane >> 1, half = lane & 1;
  const int qrow = q0 + warp * WROWS + r;
  float m = MASK_FILL, l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float* sSw = sS + warp * WROWS * L::LDS;
  bf16* sPw = sP + warp * WROWS * LDP;

  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + warp * WROWS * D + kk * 16, D);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, ROPE>(sK, kb, a.k_ss, k0, a.S, cb, sb);
    load_tile<D, false>(sV, vb, a.v_ss, k0, a.S, nullptr, nullptr);
    __syncthreads();

    // scores: (16 x D) . (D x 64) per warp, fp32
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + n * 16 * D + kk * 16, D);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(sSw + n * 16, sf, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // masked online softmax on this lane's half row
    float sv[32];
    float tmax = MASK_FILL;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kc = half * 32 + j;
      const int kpos = k0 + kc;
      bool ok = kpos < a.q_len && kpos >= kvs;
      if (a.causal) {
        ok = ok && kpos <= qrow;
        if (a.window > 0) ok = ok && kpos > qrow - a.window;
      }
      const float s = ok ? sSw[r * L::LDS + kc] * a.scale : MASK_FILL;
      sv[j] = s;
      tmax = fmaxf(tmax, s);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(sv[j] - m_new);
      psum += p;
      sPw[r * LDP + half * 32 + j] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    // P.V: (16 x 64) . (64 x D), fp32, into the scratch the scores left
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sPw + kk * 16, LDP);
        wmma::load_matrix_sync(vf, sV + kk * 16 * D + n * 16, D);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(sSw + n * 16, of, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D / 2; ++j)
      acc[j] = acc[j] * alpha + sSw[r * L::LDS + half * (D / 2) + j];
    __syncwarp();
  }

  if (qrow < a.S) {
    // l == 0 only when no key tile was visited (a block of pure pad rows)
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* orow = a.o + b * a.o_sb + h * a.o_sh + (long long)qrow * a.o_ss + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      lrt::Vec8 w;
#pragma unroll
      for (int e = 0; e < 8; ++e) w.h[e] = __float2bfloat16(acc[c * 8 + e] * inv);
      *reinterpret_cast<uint4*>(orow + c * 8) = w.u;
    }
  }
}

template <int D, bool ROPE>
__global__ void __launch_bounds__(NTHREADS) fa_direct_kernel(Args a) {
  attn_block<D, ROPE>(a);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) fa_hm_kernel(Args a) {
  attn_block<D, false>(a);
}

template <int D>
int launch(void (*kernel)(Args), const Args& a, int B, int H, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// B1: qkv (B, S, 3*H*D) bf16 -> out (B, S, H*D) bf16. cos/sin (B, S, D) or
// both null for no RoPE. Returns cudaGetLastError() after the launch.
extern "C" int lrt_fa_direct(const void* qkv, const void* cos, const void* sin,
                             const void* kv_start, void* out, int B, int S, int H, int D,
                             int q_len, int causal, int window, float scale, void* stream) {
  Args a;
  const long long C = 3LL * H * D;
  const bf16* base = static_cast<const bf16*>(qkv);
  a.q = base;
  a.k = base + (long long)H * D;
  a.v = base + 2LL * H * D;
  a.o = static_cast<bf16*>(out);
  a.cos = static_cast<const bf16*>(cos);
  a.sin = static_cast<const bf16*>(sin);
  a.kv_start = static_cast<const int*>(kv_start);
  a.q_sb = a.k_sb = a.v_sb = (long long)S * C;
  a.q_sh = a.k_sh = a.v_sh = D;
  a.q_ss = a.k_ss = a.v_ss = C;
  a.o_sb = (long long)S * H * D;
  a.o_sh = D;
  a.o_ss = (long long)H * D;
  a.S = S;
  a.n_rep = 1;
  a.q_len = q_len;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rope = cos != nullptr;
  switch (D) {
    case 64:
      return rope ? launch<64>(fa_direct_kernel<64, true>, a, B, H, st)
                  : launch<64>(fa_direct_kernel<64, false>, a, B, H, st);
    case 96:
      return rope ? launch<96>(fa_direct_kernel<96, true>, a, B, H, st)
                  : launch<96>(fa_direct_kernel<96, false>, a, B, H, st);
    case 128:
      return rope ? launch<128>(fa_direct_kernel<128, true>, a, B, H, st)
                  : launch<128>(fa_direct_kernel<128, false>, a, B, H, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// B3: q (B, H, S, D) and k/v (B, Hk, S, D), any element strides with a unit
// last-dim stride; out written through its own strides.
extern "C" int lrt_fa_hm(const void* q, const void* k, const void* v, const void* kv_start,
                         void* out, int B, int H, int Hk, int S, int D, long long q_sb,
                         long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                         long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                         long long o_sb, long long o_sh, long long o_ss, int q_len,
                         int causal, int window, float scale, void* stream) {
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(out);
  a.cos = nullptr;
  a.sin = nullptr;
  a.kv_start = static_cast<const int*>(kv_start);
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.S = S;
  a.n_rep = H / Hk;
  a.q_len = q_len;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(fa_hm_kernel<64>, a, B, H, st);
    case 96: return launch<96>(fa_hm_kernel<96>, a, B, H, st);
    case 128: return launch<128>(fa_hm_kernel<128>, a, B, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
