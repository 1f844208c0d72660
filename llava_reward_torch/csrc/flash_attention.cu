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
//   h reads kv head h / n_rep), causal + window + kv_start + q_len masks, and
//   the two modes of an int32 (B, S) row (_fa_kernel:96-111):
//   - key mask (MODE 1): key k counts iff mask[k] != 0 (Qwen2.5-VL's vision
//     windows, any pattern of interleaved pads);
//   - segment ids (MODE 2): key k counts for query q iff seg[k] != 0 and
//     seg[k] == seg[q] (the vision tower's full-attention blocks; 0 = pad).
//     q's id is read from the same row at the query's position: the TPU's
//     second, q-block view of the row is not needed.
//   MODE 0 (no row) is its own instantiation, so the left-pad launch keeps
//   its code. Head dims 64, 96, 128 and Qwen's vision 80 (1280 / 16; a
//   multiple of the 16-wide WMMA step: the JAX package pads 80 to 128 for
//   Mosaic's lanes, which is no part of the kernel's meaning).
//
// What bounds them on an H100: causal attention at S=2560, D=96 does about
// 4*D*S*S/2 FLOPs per head on 2*S*D*3 bytes, ~100 FLOP/byte per head pair,
// far past the card's ~295 FLOP/byte ridge, so they are bound by tensor-core
// operations. Both keep the S x S scores out of device memory (online softmax
// over 64-key tiles, fp32 state in registers) and skip key tiles that the
// masks make empty (causal tail, left pad, q_len tail).
//
// B1's design (fa_direct_kernel, in the style of FlashAttention-3): 128 query
// rows per block (measured against nothing smaller: two consumer warpgroups
// share each K/V tile), three warpgroups. Warpgroup 0 is the producer: it
// drops to 64 registers (setmaxnreg) and keeps TMA loads of a 3-stage K/V ring
// in flight, straight out of the fused projection through a 4-D tensor map (8
// columns, S, column chunks, B): a ragged tile reads zeros, never the next
// batch row. With RoPE it ropes Q once (cos/sin from the tables) and each K
// tile in shared memory, with the tile's cos/sin rows brought by TMA into the
// same stage (lrt::rope_chunk, bit-equal to B2); the next tile's loads go out
// before this one is roped, and a fence.proxy.async makes the generic-proxy
// writes visible to wgmma before the tile is released. Warpgroups 1 and 2 (216
// registers each) own 64 query rows: S = Q.K^T by wgmma from shared memory
// (both K-major), issued one tile ahead so that it runs during the masked
// online softmax (registers, base 2, scale * log2(e) folded into the fp32
// dot), then O += P.V with P as the register A operand and V as the MN-major B
// operand. A warpgroup waits for every tile, also one outside its rows' key
// range, before releasing its stage, so that no release runs ahead of the
// other warpgroup's use of it. Shared memory tiles use wgmma's unswizzled
// core-matrix layout (sm90.cuh), so head_dim 96 needs no swizzle atom of its
// own. q tiles of one (b, h) are adjacent in the grid (K/V hit L2), heaviest
// causal tiles first. B3 (fa_hm_kernel) is still the WMMA kernel of the first
// slice; its rework comes next.
//
// Semantics kept from the TPU kernels:
// - roped q/k are rounded to bf16 before the dot; scale is applied to the
//   fp32 dot; masked scores take the finite fill -1e30 (not -inf), so a query
//   row whose keys are all masked (a left-pad row, or a pad patch whose
//   segment id is 0) comes out finite, as the mean of V over the keys
//   visited, and never NaN: the next window block's reference attention
//   runs over those rows, where a NaN would reach valid rows;
// - probabilities are rounded to bf16 before P.V, accumulated in fp32.
//   The TPU normalises before that rounding, these kernels after P.V (online
//   softmax); the difference is within bf16 rounding of the probabilities.
#include <mma.h>

#include "common.cuh"
#include "sm90.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// ------------------------------------------------------------------ B3 (WMMA)

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
  const int* kv_start;  // (B,) first valid key per batch row
  const int* mask;  // (B, S) key mask / segment ids (MODE 1 / 2), else null
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
  static constexpr size_t m_off = p_off + (size_t)NWARPS * WROWS * LDP * 2;
  static constexpr size_t bytes = m_off + (size_t)BK * 4;  // the tile's mask row
};

// 64 rows x D columns of a (row-strided) bf16 matrix into shared memory,
// zero past the last row.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int row0, int n_rows) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH;
    const int gr = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gr < n_rows) val = *reinterpret_cast<const uint4*>(src + (long long)gr * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * D + c * 8) = val;
  }
}

// MODE: 0 no mask row, 1 key mask, 2 segment ids (see the top of the file).
template <int D, int MODE>
__device__ __forceinline__ void attn_block(const Args& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  typedef Smem<D> L;
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p_off);
  int* sM = reinterpret_cast<int*>(smem + L::m_off);

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

  load_tile<D>(sQ, qb, a.q_ss, q0, a.S);

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
  const int* mrow = MODE != 0 ? a.mask + (long long)b * a.S : nullptr;
  // a query past S takes id 0, which no key matches: its row is never written
  const int qseg = (MODE == 2 && qrow < a.S) ? mrow[qrow] : 0;
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
    load_tile<D>(sK, kb, a.k_ss, k0, a.S);
    load_tile<D>(sV, vb, a.v_ss, k0, a.S);
    if (MODE != 0) {
      for (int i = threadIdx.x; i < BK; i += NTHREADS) sM[i] = k0 + i < a.S ? mrow[k0 + i] : 0;
    }
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
      if (MODE == 1) ok = ok && sM[kc] != 0;
      if (MODE == 2) ok = ok && sM[kc] != 0 && sM[kc] == qseg;
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

template <int D, int MODE>
__global__ void __launch_bounds__(NTHREADS) fa_hm_kernel(Args a) {
  attn_block<D, MODE>(a);
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

template <int D>
int launch_hm(const Args& a, int mode, int B, int H, cudaStream_t st) {
  switch (mode) {
    case 0: return launch<D>(fa_hm_kernel<D, 0>, a, B, H, st);
    case 1: return launch<D>(fa_hm_kernel<D, 1>, a, B, H, st);
    default: return launch<D>(fa_hm_kernel<D, 2>, a, B, H, st);
  }
}

// ------------------------------------------------------------------ B1 (wgmma + TMA)

namespace direct {

constexpr int BQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr float MASK_FILL = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  CUtensorMap tq;   // qkv as (8, S, 3*H*D/8, B), box 128 rows x D columns
  CUtensorMap tkv;  // the same, box 64 rows
  CUtensorMap tc, ts;  // RoPE: the cos / sin tables as (8, S, D/8, B), box 64 rows
  bf16* o;          // (B, S, H*D)
  const bf16* cos;  // (B, S, D) when RoPE is on
  const bf16* sin;
  const int* kv_start;
  int S, H, q_len, causal, window;  // window <= 0: no sliding window
  float scale_log2;                 // scale * log2(e): the softmax runs in base 2
};

// The K/V ring is 3 deep (4 measured no faster). With RoPE each stage also
// holds the K tile's cos/sin rows; at head_dim 128 that is 224 KiB in all.
template <int D, bool ROPE>
struct Smem {
  static constexpr int STAGES = 3;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + (size_t)BQ * D * 2;
  static constexpr size_t v_off = k_off + (size_t)STAGES * BK * D * 2;
  static constexpr size_t cs_off = v_off + (size_t)STAGES * BK * D * 2;
  static constexpr size_t bar_off = cs_off + (ROPE ? (size_t)STAGES * BK * 2 * D * 2 : 0);
  // q_full, q_ready, then per stage k_raw, k_full, v_full, empty
  static constexpr size_t bytes = bar_off + (2 + 4 * STAGES) * 8;
};

// Rotate-half RoPE in place on an R-row chunk-major tile; chunk c pairs with
// chunk c + D/16. The Q tile takes its cos/sin rows from the (B, S, D) tables
// in global memory (rows past S are skipped: they are zeros); a K tile takes
// them from its stage (`cs`: cos then sin, chunk-major like the tile, zeros
// past S).
template <int D, int R>
__device__ __forceinline__ void rope_pair(bf16* tile, int r, int c, const uint4& c1,
                                          const uint4& s1, const uint4& c2, const uint4& s2) {
  constexpr int HALF = D / 16;
  uint4* p1 = reinterpret_cast<uint4*>(tile + (c * R + r) * 8);
  uint4* p2 = reinterpret_cast<uint4*>(tile + ((c + HALF) * R + r) * 8);
  lrt::Vec8 x1, x2, vc1, vs1, vc2, vs2;
  x1.u = *p1;
  x2.u = *p2;
  vc1.u = c1;
  vs1.u = s1;
  vc2.u = c2;
  vs2.u = s2;
  *p1 = lrt::rope_chunk(x1, x2, vc1, vs1, true).u;
  *p2 = lrt::rope_chunk(x2, x1, vc2, vs2, false).u;
}

template <int D>
__device__ __forceinline__ void rope_q(bf16* tile, const bf16* cos, const bf16* sin, int row0,
                                       int S, int tid) {
  constexpr int HALF = D / 16;
  for (int idx = tid; idx < BQ * HALF; idx += 128) {
    const int r = idx % BQ, c = idx / BQ;
    const long long gr = row0 + r;
    if (gr >= S) continue;
    const uint4* cr = reinterpret_cast<const uint4*>(cos + gr * D);
    const uint4* sr = reinterpret_cast<const uint4*>(sin + gr * D);
    rope_pair<D, BQ>(tile, r, c, cr[c], sr[c], cr[c + HALF], sr[c + HALF]);
  }
}

template <int D>
__device__ __forceinline__ void rope_k(bf16* tile, const bf16* cs, int tid) {
  constexpr int HALF = D / 16;
  const uint4* cc = reinterpret_cast<const uint4*>(cs);
  const uint4* ss = cc + BK * D / 8;
  for (int idx = tid; idx < BK * HALF; idx += 128) {
    const int r = idx % BK, c = idx / BK;
    rope_pair<D, BK>(tile, r, c, cc[c * BK + r], ss[c * BK + r], cc[(c + HALF) * BK + r],
                     ss[(c + HALF) * BK + r]);
  }
}

template <int D, bool ROPE>
__global__ void __launch_bounds__(NTHREADS, 1) fa_direct_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  typedef Smem<D, ROPE> L;
  constexpr int STAGES = L::STAGES;
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* sCS = reinterpret_cast<bf16*>(smem + L::cs_off);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* q_ready = q_full + 1;
  uint64_t* k_raw = q_full + 2;
  uint64_t* k_full = k_raw + STAGES;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int kvs = a.kv_start[b];
  // the union of the two 64-row tiles' key ranges
  const int k_begin = lrt::key_tile_begin(q0, kvs, a.causal, a.window);
  const int k_end = lrt::key_tile_end(q0 + 64, a.S, a.q_len, a.causal);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_ready, 128);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&k_raw[s], 1);
      sm90::mbar_init(&k_full[s], ROPE ? 128 : 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 0) {
    // ---- producer: TMA loads (and RoPE in shared memory)
    sm90::reg_dealloc<64>();
    // tile i into its stage: K (with its cos/sin rows) and V
    auto issue = [&](int i) {
      const int st = i % STAGES, ph = (i / STAGES) & 1;
      const int k0 = k_begin + i * BK;
      sm90::mbar_wait(&empty[st], ph ^ 1);
      if (t == 0) {
        uint64_t* kb = ROPE ? &k_raw[st] : &k_full[st];
        sm90::mbar_expect_tx(kb, (ROPE ? 3 : 1) * BK * D * 2);
        sm90::tma_load_4d(sK + st * BK * D, &a.tkv, kb, 0, k0, (a.H + h) * D / 8, b);
        if (ROPE) {
          sm90::tma_load_4d(sCS + st * 2 * BK * D, &a.tc, kb, 0, k0, 0, b);
          sm90::tma_load_4d(sCS + (st * 2 + 1) * BK * D, &a.ts, kb, 0, k0, 0, b);
        }
        sm90::mbar_expect_tx(&v_full[st], BK * D * 2);
        sm90::tma_load_4d(sV + st * BK * D, &a.tkv, &v_full[st], 0, k0, (2 * a.H + h) * D / 8, b);
      }
    };
    if (t == 0) {
      sm90::mbar_expect_tx(q_full, BQ * D * 2);
      sm90::tma_load_4d(sQ, &a.tq, q_full, 0, q0, h * D / 8, b);
    }
    if (!ROPE) {
      if (t == 0)
        for (int i = 0; i < n_tiles; ++i) issue(i);
    } else {
      // the next tile's loads go out before this one is roped
      if (n_tiles > 0) issue(0);
      sm90::mbar_wait(q_full, 0);
      rope_q<D>(sQ, a.cos + (long long)b * a.S * D, a.sin + (long long)b * a.S * D, q0, a.S, t);
      sm90::fence_async_smem();
      sm90::mbar_arrive(q_ready);
      for (int i = 0; i < n_tiles; ++i) {
        if (i + 1 < n_tiles) issue(i + 1);
        const int st = i % STAGES;
        sm90::mbar_wait(&k_raw[st], (i / STAGES) & 1);
        rope_k<D>(sK + st * BK * D, sCS + st * 2 * BK * D, t);
        sm90::fence_async_smem();
        sm90::mbar_arrive(&k_full[st]);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    sm90::reg_alloc<216>();
    const int wq0 = q0 + (wg - 1) * 64;
    const int my_begin = lrt::key_tile_begin(wq0, kvs, a.causal, a.window);
    const int my_end = lrt::key_tile_end(wq0, a.S, a.q_len, a.causal);
    const bf16* sQw = sQ + (wg - 1) * 64 * 8;  // row 64 of each chunk
    // this thread's two rows of the accumulators, and their open keys [lo, hi)
    const int qrow[2] = {wq0 + sm90::acc_row(t, 0), wq0 + sm90::acc_row(t, 2)};
    int lo[2], hi[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      lo[j] = kvs;
      hi[j] = a.q_len;
      if (a.causal) {
        hi[j] = min(hi[j], qrow[j] + 1);
        if (a.window > 0) lo[j] = max(lo[j], qrow[j] - a.window + 1);
      }
    }
    float m[2] = {MASK_FILL, MASK_FILL}, l[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    sm90::mbar_wait(ROPE ? q_ready : q_full, 0);

    // This warpgroup's tiles are [i_lo, i_hi) of the block's n_tiles. A tile
    // outside them is still waited for before its stage is released, so that
    // no release runs ahead of the other warpgroup's use of the stage.
    const int i_lo = min((my_begin - k_begin) / BK, n_tiles);
    const int i_hi =
        my_end > my_begin ? max(i_lo, min(n_tiles, (my_end - k_begin + BK - 1) / BK)) : i_lo;
    auto skip = [&](int i) {
      sm90::mbar_wait(&k_full[i % STAGES], (i / STAGES) & 1);
      sm90::mbar_arrive(&empty[i % STAGES]);
    };
    // S = Q.K^T of tile i into s
    auto scores = [&](int i, float(&s)[32]) {
      const int st = i % STAGES;
      sm90::mbar_wait(&k_full[st], (i / STAGES) & 1);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<64>::template ss<0, 0>(s, sm90::desc_k<BQ>(sQw, kk),
                                           sm90::desc_k<BK>(sK + st * BK * D, kk), kk > 0);
      sm90::wg_commit();
    };
    for (int i = 0; i < i_lo; ++i) skip(i);
    float s[32], s_next[32];
    if (i_lo < i_hi) {
      scores(i_lo, s);
      sm90::wg_wait<0>();
      sm90::fence_regs(s);
    }
    for (int it = i_lo; it < i_hi; ++it) {
      const int st = it % STAGES, ph = (it / STAGES) & 1;
      const int k0 = k_begin + it * BK;
      // the next tile's scores run on the tensor cores during this softmax
      if (it + 1 < i_hi) scores(it + 1, s_next);

      // masked online softmax, base 2; a row's 64 columns live on 4 lanes
      float tmax[2] = {MASK_FILL, MASK_FILL};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = (i >> 1) & 1;
        const int kp = k0 + sm90::acc_col(t, i);
        s[i] = (kp >= lo[j] && kp < hi[j]) ? s[i] * a.scale_log2 : MASK_FILL;
        tmax[j] = fmaxf(tmax[j], s[i]);
      }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        tmax[j] = fmaxf(tmax[j], __shfl_xor_sync(0xffffffffu, tmax[j], 1));
        tmax[j] = fmaxf(tmax[j], __shfl_xor_sync(0xffffffffu, tmax[j], 2));
        const float m_new = fmaxf(m[j], tmax[j]);
        alpha[j] = exp2f(m[j] - m_new);
        m[j] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = (i >> 1) & 1;
        s[i] = exp2f(s[i] - m[j]);
        psum[j] += s[i];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        psum[j] += __shfl_xor_sync(0xffffffffu, psum[j], 1);
        psum[j] += __shfl_xor_sync(0xffffffffu, psum[j], 2);
        l[j] = l[j] * alpha[j] + psum[j];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P.V: P (bf16) from registers, V MN-major
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::acc_to_a(s, kk, pa[kk]);
      sm90::mbar_wait(&v_full[st], ph);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::Wgmma<D>::template rs<1>(o, pa[kk], sm90::desc_mn<BK>(sV + st * BK * D, kk), 1);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(s_next);
      sm90::mbar_arrive(&empty[st]);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = s_next[i];
    }
    for (int i = i_hi; i < n_tiles; ++i) skip(i);

    // l == 0 only when no key tile was visited (a tile of pure pad rows)
    const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
    const long long ld = (long long)a.H * D;
    bf16* ob = a.o + (long long)b * a.S * ld + h * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int j = (i >> 1) & 1;
      if (qrow[j] < a.S)
        *reinterpret_cast<uint32_t*>(ob + qrow[j] * ld + sm90::acc_col(t, i)) =
            sm90::pack_bf16(o[i] * inv[j], o[i + 1] * inv[j]);
    }
  }
}

template <int D, bool ROPE>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = Smem<D, ROPE>::bytes;
  cudaError_t e = cudaFuncSetAttribute(fa_direct_kernel<D, ROPE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  fa_direct_kernel<D, ROPE><<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace direct

}  // namespace

// B1: qkv (B, S, 3*H*D) bf16 -> out (B, S, H*D) bf16. cos/sin (B, S, D) or
// both null for no RoPE. Returns cudaGetLastError() after the launch.
extern "C" int lrt_fa_direct(const void* qkv, const void* cos, const void* sin,
                             const void* kv_start, void* out, int B, int S, int H, int D,
                             int q_len, int causal, int window, float scale, void* stream) {
  if (D != 64 && D != 96 && D != 128) return (int)cudaErrorInvalidValue;
  direct::Args a;
  const long long C = 3LL * H * D;
  const int outer[1] = {B};
  const long long outer_stride[1] = {(long long)S * C};
  int e = sm90_host::tile_map(&a.tq, qkv, S, C, (int)(C / 8), direct::BQ, D / 8, 1, outer,
                              outer_stride);
  if (e == 0)
    e = sm90_host::tile_map(&a.tkv, qkv, S, C, (int)(C / 8), direct::BK, D / 8, 1, outer,
                            outer_stride);
  const long long table_stride[1] = {(long long)S * D};
  if (e == 0 && cos != nullptr)
    e = sm90_host::tile_map(&a.tc, cos, S, D, D / 8, direct::BK, D / 8, 1, outer, table_stride);
  if (e == 0 && cos != nullptr)
    e = sm90_host::tile_map(&a.ts, sin, S, D, D / 8, direct::BK, D / 8, 1, outer, table_stride);
  if (e != 0) return e;
  a.o = static_cast<bf16*>(out);
  a.cos = static_cast<const bf16*>(cos);
  a.sin = static_cast<const bf16*>(sin);
  a.kv_start = static_cast<const int*>(kv_start);
  a.S = S;
  a.H = H;
  a.q_len = q_len;
  a.causal = causal;
  a.window = window;
  a.scale_log2 = scale * direct::LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rope = cos != nullptr;
  switch (D) {
    case 64: return rope ? direct::launch<64, true>(a, B, st) : direct::launch<64, false>(a, B, st);
    case 96: return rope ? direct::launch<96, true>(a, B, st) : direct::launch<96, false>(a, B, st);
    default:
      return rope ? direct::launch<128, true>(a, B, st) : direct::launch<128, false>(a, B, st);
  }
}

// B3: q (B, H, S, D) and k/v (B, Hk, S, D), any element strides with a unit
// last-dim stride; out written through its own strides. mask: a contiguous
// int32 (B, S) row read as a key mask (mask_mode 1) or segment ids (2), or
// null with mask_mode 0.
extern "C" int lrt_fa_hm(const void* q, const void* k, const void* v, const void* kv_start,
                         const void* mask, void* out, int B, int H, int Hk, int S, int D,
                         long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                         long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                         long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                         int q_len, int causal, int window, int mask_mode, float scale,
                         void* stream) {
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(out);
  a.kv_start = static_cast<const int*>(kv_start);
  a.mask = static_cast<const int*>(mask);
  if ((mask_mode != 0) != (mask != nullptr) || mask_mode < 0 || mask_mode > 2)
    return (int)cudaErrorInvalidValue;
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
    case 64: return launch_hm<64>(a, mask_mode, B, H, st);
    case 80: return launch_hm<80>(a, mask_mode, B, H, st);
    case 96: return launch_hm<96>(a, mask_mode, B, H, st);
    case 128: return launch_hm<128>(a, mask_mode, B, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
