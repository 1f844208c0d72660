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
//   its code. Head dims 64, 80 (Qwen's vision 1280 / 16: the JAX package
//   pads 80 to 128 for Mosaic's lanes, which is no part of the kernel's
//   meaning), 96 and 128.
//
// What bounds them on an H100: causal attention at S=2560, D=96 does about
// 4*D*S*S/2 FLOPs per head on 2*S*D*3 bytes, ~100 FLOP/byte per head pair,
// far past the card's ~295 FLOP/byte ridge, so they are bound by tensor-core
// operations. Both keep the S x S scores out of device memory (online softmax
// over 64-key tiles, fp32 state in registers) and skip key tiles that the
// masks make empty (causal tail, left pad, q_len tail, window).
//
// Design (in the style of FlashAttention-3), one for both: 128 query rows per
// block (two consumer warpgroups share each K/V tile), three warpgroups.
// Warpgroup 0 is the producer: it keeps TMA loads of a 3-stage K/V ring in
// flight. Warpgroups 1 and 2 own 64 query rows each and run the same code
// (consume): S = Q.K^T by wgmma from shared memory (both K-major), issued one
// tile ahead so that it runs during the masked online softmax (registers,
// base 2, scale * log2(e) folded into the fp32 dot), then O += P.V with P as
// the register A operand and V as the MN-major B operand. A warpgroup waits
// for every tile, also one outside its rows' key range, before releasing its
// stage, so that no release runs ahead of the other warpgroup's use of it.
// Shared memory tiles use wgmma's unswizzled core-matrix layout (sm90.cuh),
// so head_dim 80 and 96 need no swizzle atom of their own. q tiles of one
// (b, h) are adjacent in the grid (K/V hit L2), heaviest causal tiles first;
// the heads come next, so the n_rep query heads of one kv head follow each
// other and share its K/V tiles in L2.
// - B1's producer (64 registers; consumers 216) reads straight out of the
//   fused projection through a 4-D tensor map (8 columns, S, column chunks,
//   B): a ragged tile reads zeros, never the next batch row. With RoPE it
//   ropes Q once (cos/sin from the tables) and each K tile in shared memory,
//   with the tile's cos/sin rows brought by TMA into the same stage
//   (lrt::rope_chunk, bit-equal to B2); the next tile's loads go out before
//   this one is roped, and a fence.proxy.async makes the generic-proxy writes
//   visible to wgmma before the tile is released.
// - B3's producer is one thread (24 registers; consumers 240): q, k and v
//   each have their own 5-D tensor map (8 columns, S, D/8 chunks, heads, B)
//   over the callers' element strides, rows past S read zeros; in MODE 1 and
//   2 each K tile's 64 ints of the mask row (padded with zeros to whole
//   tiles) come by bulk copy into its stage, and a consumer reads its rows'
//   segment ids once. The output is written through its own strides.
//
// Semantics kept from the TPU kernels:
// - roped q/k are rounded to bf16 before the dot; scale is applied to the
//   fp32 dot; masked scores take the finite fill -1e30 (not -inf), so a query
//   row whose keys are all masked (a left-pad row, or a pad patch whose
//   segment id is 0) comes out finite, as the mean of V over the keys
//   visited (in MODE 1 and 2, those below S), and never NaN: the next window
//   block's reference attention runs over those rows, where a NaN would reach
//   valid rows; a row whose block visited no key is written as 0;
// - probabilities are rounded to bf16 before P.V, accumulated in fp32.
//   The TPU normalises before that rounding, these kernels after P.V (online
//   softmax); the difference is within bf16 rounding of the probabilities.
#include "common.cuh"
#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int STAGES = 3;      // K/V ring depth (4 measured no faster in B1)
constexpr float MASK_FILL = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------------ consumers

// The masks of a block's rows.
struct Rows {
  int kvs, S, q_len, causal, window;  // window <= 0: no sliding window
  float scale_log2;                   // scale * log2(e): the softmax runs in base 2
};

// The K/V ring as the consumers see it. ids: each stage's 64 ints of the mask
// row (MODE 1 / 2).
struct Ring {
  const bf16* k;
  const bf16* v;
  const int* ids;
  uint64_t* k_full;
  uint64_t* v_full;
  uint64_t* empty;
};

// Scale and mask one tile's scores (base 2), and each row's max. EDGE: the
// tile crosses a row's open range [lo, hi) (the diagonal, window and left-pad
// tiles): only those test the key positions. MODE 2 compares ids alone; a
// row whose own id is 0 is masked whole by the caller.
template <int MODE, bool EDGE>
__device__ __forceinline__ void mask_tile(float (&s)[32], float (&tmax)[2], const int* ids,
                                          int k0, int t, const int (&lo)[2], const int (&hi)[2],
                                          const int (&qseg)[2], float scale_log2) {
  tmax[0] = tmax[1] = MASK_FILL;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int j = (i >> 1) & 1;
    const int kc = sm90::acc_col(t, i);
    bool ok = true;
    if (EDGE) ok = k0 + kc >= lo[j] && k0 + kc < hi[j];
    if (MODE == 1) ok = ok && ids[kc] != 0;
    if (MODE == 2) ok = ok && ids[kc] == qseg[j];
    s[i] = ok ? s[i] * scale_log2 : MASK_FILL;
    tmax[j] = fmaxf(tmax[j], s[i]);
  }
}

// One consumer warpgroup: 64 query rows from wq0, the Q tile's rows at sQw
// (row 64 of each chunk for the second warpgroup), the block's n_tiles key
// tiles from k_begin. seg: the batch row's segment ids (MODE 2). Row q of the
// output is written at ob + q * ld.
template <int D, int MODE>
__device__ __forceinline__ void consume(const bf16* sQw, const Ring& r, const Rows& a, int t,
                                        int wq0, int k_begin, int n_tiles, const int* seg,
                                        bf16* ob, long long ld) {
  const int my_begin = lrt::key_tile_begin(wq0, a.kvs, a.causal, a.window);
  const int my_end = lrt::key_tile_end(wq0, a.S, a.q_len, a.causal);
  // this thread's two rows of the accumulators, and their open keys [lo, hi)
  const int qrow[2] = {wq0 + sm90::acc_row(t, 0), wq0 + sm90::acc_row(t, 2)};
  int lo[2], hi[2], qseg[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    lo[j] = a.kvs;
    hi[j] = a.q_len;
    if (a.causal) {
      hi[j] = min(hi[j], qrow[j] + 1);
      if (a.window > 0) lo[j] = max(lo[j], qrow[j] - a.window + 1);
    }
    // a query past S takes id 0, which no key matches
    qseg[j] = (MODE == 2 && qrow[j] < a.S) ? seg[qrow[j]] : 0;
  }
  float m[2] = {MASK_FILL, MASK_FILL}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  // This warpgroup's tiles are [i_lo, i_hi) of the block's n_tiles. A tile
  // outside them is still waited for before its stage is released, so that
  // no release runs ahead of the other warpgroup's use of the stage.
  const int i_lo = min((my_begin - k_begin) / BK, n_tiles);
  const int i_hi =
      my_end > my_begin ? max(i_lo, min(n_tiles, (my_end - k_begin + BK - 1) / BK)) : i_lo;
  auto skip = [&](int i) {
    sm90::mbar_wait(&r.k_full[i % STAGES], (i / STAGES) & 1);
    sm90::mbar_arrive(&r.empty[i % STAGES]);
  };
  // S = Q.K^T of tile i into s
  auto scores = [&](int i, float(&s)[32]) {
    const int st = i % STAGES;
    sm90::mbar_wait(&r.k_full[st], (i / STAGES) & 1);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::Wgmma<64>::template ss<0, 0>(s, sm90::desc_k<BQ>(sQw, kk),
                                         sm90::desc_k<BK>(r.k + st * BK * D, kk), kk > 0);
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
    const int* ids = r.ids + st * BK;
    float tmax[2];
    if (k0 >= max(lo[0], lo[1]) && k0 + BK <= min(hi[0], hi[1]))
      mask_tile<MODE, false>(s, tmax, ids, k0, t, lo, hi, qseg, a.scale_log2);
    else
      mask_tile<MODE, true>(s, tmax, ids, k0, t, lo, hi, qseg, a.scale_log2);
    if (MODE == 2 && (qseg[0] == 0 || qseg[1] == 0)) {
      // a query with id 0 has no key, not even another pad's
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (qseg[(i >> 1) & 1] == 0) s[i] = MASK_FILL;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (qseg[j] == 0) tmax[j] = MASK_FILL;
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
    for (int i = 0; i < 32; ++i) s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
    if (MODE != 0 && k0 + BK > a.S) {
      // mask modes: a key past S never counts, also not for a fully masked row
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + sm90::acc_col(t, i) >= a.S) s[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) psum[(i >> 1) & 1] += s[i];
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
    sm90::mbar_wait(&r.v_full[st], ph);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::Wgmma<D>::template rs<1>(o, pa[kk], sm90::desc_mn<BK>(r.v + st * BK * D, kk), 1);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(s_next);
    sm90::mbar_arrive(&r.empty[st]);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = s_next[i];
  }
  for (int i = i_hi; i < n_tiles; ++i) skip(i);

  // l == 0 only when no key tile was visited (a tile of pure pad rows)
  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int j = (i >> 1) & 1;
    if (qrow[j] < a.S)
      *reinterpret_cast<uint32_t*>(ob + qrow[j] * ld + sm90::acc_col(t, i)) =
          sm90::pack_bf16(o[i] * inv[j], o[i + 1] * inv[j]);
  }
}

// ------------------------------------------------------------------ B1

namespace direct {

struct Args {
  CUtensorMap tq;   // qkv as (8, S, 3*H*D/8, B), box 128 rows x D columns
  CUtensorMap tkv;  // the same, box 64 rows
  CUtensorMap tc, ts;  // RoPE: the cos / sin tables as (8, S, D/8, B), box 64 rows
  bf16* o;          // (B, S, H*D)
  const bf16* cos;  // (B, S, D) when RoPE is on
  const bf16* sin;
  const int* kv_start;
  int S, H, q_len, causal, window;  // window <= 0: no sliding window
  float scale_log2;
};

// With RoPE each stage also holds the K tile's cos/sin rows; at head_dim 128
// that is 224 KiB in all.
template <int D, bool ROPE>
struct Smem {
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
    const Rows rows{kvs, a.S, a.q_len, a.causal, a.window, a.scale_log2};
    const Ring ring{sK, sV, nullptr, k_full, v_full, empty};
    const long long ld = (long long)a.H * D;
    sm90::mbar_wait(ROPE ? q_ready : q_full, 0);
    consume<D, 0>(sQ + (wg - 1) * 64 * 8, ring, rows, t, q0 + (wg - 1) * 64, k_begin, n_tiles,
                  nullptr, a.o + (long long)b * a.S * ld + h * D, ld);
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

// ------------------------------------------------------------------ B3

namespace hm {

struct Args {
  CUtensorMap tq;      // q as (8, S, D/8, H, B), box 128 rows
  CUtensorMap tk, tv;  // k, v as (8, S, D/8, Hk, B), box 64 rows
  bf16* o;
  long long o_sb, o_sh, o_ss;  // element strides of the output
  const int* kv_start;
  const int* mask;  // (B, S_pad) key mask / segment ids, zero past S (MODE 1 / 2), else null
  int S, S_pad, n_rep, q_len, causal, window;
  float scale_log2;
};

template <int D>
struct Smem {
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + (size_t)BQ * D * 2;
  static constexpr size_t v_off = k_off + (size_t)STAGES * BK * D * 2;
  static constexpr size_t id_off = v_off + (size_t)STAGES * BK * D * 2;
  static constexpr size_t bar_off = id_off + (size_t)STAGES * BK * 4;
  // q_full, then per stage k_full, v_full, empty
  static constexpr size_t bytes = bar_off + (1 + 3 * STAGES) * 8;
};

template <int D, int MODE>
__global__ void __launch_bounds__(NTHREADS, 1) fa_hm_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  typedef Smem<D> L;
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  int* sId = reinterpret_cast<int*>(smem + L::id_off);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.n_rep;
  const int q0 = qt * BQ;
  const int kvs = a.kv_start[b];
  const int k_begin = lrt::key_tile_begin(q0, kvs, a.causal, a.window);
  const int k_end = lrt::key_tile_end(q0 + 64, a.S, a.q_len, a.causal);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA ring full
    sm90::reg_dealloc<24>();
    if (t != 0) return;
    sm90::mbar_expect_tx(q_full, BQ * D * 2);
    sm90::tma_load_5d(sQ, &a.tq, q_full, 0, q0, 0, h, b);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES, ph = (i / STAGES) & 1;
      const int k0 = k_begin + i * BK;
      sm90::mbar_wait(&empty[st], ph ^ 1);
      sm90::mbar_expect_tx(&k_full[st], BK * D * 2 + (MODE != 0 ? BK * 4 : 0));
      sm90::tma_load_5d(sK + st * BK * D, &a.tk, &k_full[st], 0, k0, 0, hk, b);
      if (MODE != 0)
        sm90::bulk_load(sId + st * BK, a.mask + (long long)b * a.S_pad + k0, BK * 4, &k_full[st]);
      sm90::mbar_expect_tx(&v_full[st], BK * D * 2);
      sm90::tma_load_5d(sV + st * BK * D, &a.tv, &v_full[st], 0, k0, 0, hk, b);
    }
    return;
  }

  // ---- consumers: 64 query rows each
  sm90::reg_alloc<240>();
  const Rows rows{kvs, a.S, a.q_len, a.causal, a.window, a.scale_log2};
  const Ring ring{sK, sV, sId, k_full, v_full, empty};
  const int* seg = MODE == 2 ? a.mask + (long long)b * a.S_pad : nullptr;
  sm90::mbar_wait(q_full, 0);
  consume<D, MODE>(sQ + (wg - 1) * 64 * 8, ring, rows, t, q0 + (wg - 1) * 64, k_begin, n_tiles,
                   seg, a.o + b * a.o_sb + h * a.o_sh, a.o_ss);
}

template <int D, int MODE>
int launch(const Args& a, int B, int H, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(fa_hm_kernel<D, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.S + BQ - 1) / BQ, H, B);
  fa_hm_kernel<D, MODE><<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mode(const Args& a, int mode, int B, int H, cudaStream_t st) {
  switch (mode) {
    case 0: return launch<D, 0>(a, B, H, st);
    case 1: return launch<D, 1>(a, B, H, st);
    default: return launch<D, 2>(a, B, H, st);
  }
}

}  // namespace hm

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
  int e = sm90_host::tile_map(&a.tq, qkv, S, C, (int)(C / 8), BQ, D / 8, 1, outer, outer_stride);
  if (e == 0)
    e = sm90_host::tile_map(&a.tkv, qkv, S, C, (int)(C / 8), BK, D / 8, 1, outer, outer_stride);
  const long long table_stride[1] = {(long long)S * D};
  if (e == 0 && cos != nullptr)
    e = sm90_host::tile_map(&a.tc, cos, S, D, D / 8, BK, D / 8, 1, outer, table_stride);
  if (e == 0 && cos != nullptr)
    e = sm90_host::tile_map(&a.ts, sin, S, D, D / 8, BK, D / 8, 1, outer, table_stride);
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
  a.scale_log2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rope = cos != nullptr;
  switch (D) {
    case 64: return rope ? direct::launch<64, true>(a, B, st) : direct::launch<64, false>(a, B, st);
    case 96: return rope ? direct::launch<96, true>(a, B, st) : direct::launch<96, false>(a, B, st);
    default:
      return rope ? direct::launch<128, true>(a, B, st) : direct::launch<128, false>(a, B, st);
  }
}

// B3: q (B, H, S, D) and k/v (B, Hk, S, D), any element strides that are
// multiples of 8 with a unit last-dim stride, 16-byte aligned; out written
// through its own strides. mask: a contiguous int32 (B, S_pad) row, S_pad = S
// rounded up to 64, zero past S, read as a key mask (mask_mode 1) or segment
// ids (2), or null with mask_mode 0.
extern "C" int lrt_fa_hm(const void* q, const void* k, const void* v, const void* kv_start,
                         const void* mask, void* out, int B, int H, int Hk, int S, int D,
                         long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                         long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                         long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                         int q_len, int causal, int window, int mask_mode, float scale,
                         void* stream) {
  if ((mask_mode != 0) != (mask != nullptr) || mask_mode < 0 || mask_mode > 2)
    return (int)cudaErrorInvalidValue;
  if (D != 64 && D != 80 && D != 96 && D != 128) return (int)cudaErrorInvalidValue;
  hm::Args a;
  const int q_outer[2] = {H, B}, kv_outer[2] = {Hk, B};
  const long long q_os[2] = {q_sh, q_sb}, k_os[2] = {k_sh, k_sb}, v_os[2] = {v_sh, v_sb};
  int e = sm90_host::tile_map(&a.tq, q, S, q_ss, D / 8, BQ, D / 8, 2, q_outer, q_os);
  if (e == 0) e = sm90_host::tile_map(&a.tk, k, S, k_ss, D / 8, BK, D / 8, 2, kv_outer, k_os);
  if (e == 0) e = sm90_host::tile_map(&a.tv, v, S, v_ss, D / 8, BK, D / 8, 2, kv_outer, v_os);
  if (e != 0) return e;
  a.o = static_cast<bf16*>(out);
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.o_ss = o_ss;
  a.kv_start = static_cast<const int*>(kv_start);
  a.mask = static_cast<const int*>(mask);
  a.S = S;
  a.S_pad = (S + BK - 1) / BK * BK;
  a.n_rep = H / Hk;
  a.q_len = q_len;
  a.causal = causal;
  a.window = window;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return hm::launch_mode<64>(a, mask_mode, B, H, st);
    case 80: return hm::launch_mode<80>(a, mask_mode, B, H, st);
    case 96: return hm::launch_mode<96>(a, mask_mode, B, H, st);
    default: return hm::launch_mode<128>(a, mask_mode, B, H, st);
  }
}
