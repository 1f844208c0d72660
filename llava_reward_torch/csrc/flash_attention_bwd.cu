// Attention backward written by hand for Hopper (sm_90a).
//
// Replaces llava_reward_tpu/ops/flash_attention.py:_fa_bwd_kernel (B8,
// reached through _flash_bwd from _core_bwd and _fused_core_bwd): for
// head-major q, g (B, H, S, D) and k, v (B, Hk, S, D) it recomputes the
// masked fp32 scores and the full-row softmax p, and forms
//   dp = g.V^T,  delta = rowsum(p * dp) (from fp32 p, not rowsum(dO * O)),
//   ds = p * (dp - delta) * scale,
//   dq = ds.K,  dk = sum over reps of ds^T.q,  dv = sum over reps of p^T.g,
// with ds and p rounded to bf16 before the three products, every product
// accumulated in fp32, and dq/dk/dv rounded to bf16 once. The masks are B3's:
// k < q_len, k >= kv_start (left pad), then by MODE (a template argument, as
// in fa_hm_kernel) nothing more (0), a key mask != 0 (1) or segment ids,
// seg[k] != 0 and seg[k] == seg[q] (2), read from one (B, S) int32 row, then
// causal and sliding window. head_dim is 64, 80 (five 16-wide WMMA steps, no
// padding to 128), 96 or 128.
//
// Fully masked rows. A masked score takes the finite fill -1e30, so a query
// whose keys are all masked (a left-pad query, a pad patch with segment id 0)
// gets p = exp(fill - fill) / l: uniform over the keys its tiles visit, never
// NaN. As in the TPU kernel and the plain version, such a row's ds and its
// share of dk/dv are NOT zero unless g is zero there. In the mask modes the
// keys at or past S in a ragged last tile are left out of that row's sum, so
// where every key tile is visited (non-causal, no left pad, q_len == S: the
// Qwen2.5-VL vision blocks) a pad query weighs 1/S on every key, exactly as in
// the plain version, and dk/dv agree on every valid key. Under causal or
// left-pad tile skipping a pad row is uniform over the visited keys only; its
// dq is never compared, and its g is zero on the training path.
//
// What bounds it on an H100: five products of 2*D operations per unmasked
// (query, key) pair against 7 tensors of S*D bf16 moved once; at the
// decoder's S = 2560, D = 96 that is far past the ~295 operations per byte
// ridge, so the bound is tensor-core operations. The design keeps the S x S
// tiles out of device memory and takes no atomics, so the sums are
// deterministic. It runs as two launches (one fa_bwd call):
//   pass A, per (b, h, 64-row q tile): sweep the key tiles once for the row
//     max m, the row sum l and delta (online, rescaled like the forward's
//     softmax), store m, 1/l and delta (fp32, B*H*S each); sweep again to
//     recompute p = exp(s - m) / l, ds, and accumulate dq in WMMA fragments;
//   pass B, per (b, kv head, 64-key tile): walk the q tiles of every rep
//     that reach this key tile, recompute p^T and ds^T from the stored row
//     statistics, and accumulate dk and dv in WMMA fragments.
// Both passes visit exactly the tiles the forward visits (causal tail, left
// pad, q_len tail and window skipped), so the two agree on every row,
// including fully masked ones. Products are WMMA bf16 16x16x16 with fp32
// accumulation; the element-wise passes take each row's mask as one key
// interval, __expf (p is rounded to bf16 anyway), and a column order that
// keeps a warp's 32 lanes on 32 shared-memory banks. wgmma, TMA and a fused
// single pass are left for later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int NWARPS = 4;    // each warp owns 16 rows (pass A) or 16 keys (pass B)
constexpr int NTHREADS = 32 * NWARPS;
constexpr int WROWS = 16;
constexpr int LDS = BK + 4;  // fp32 scratch row stride
constexpr int LDP = BK + 8;  // bf16 scratch row stride
constexpr float MASK_FILL = -1e30f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* row_m;      // (B, H, S) row max of the masked scores
  float* row_inv_l;  // (B, H, S) 1 / row sum of exp(s - m), 0 if no key tile visited
  float* row_delta;  // (B, H, S) rowsum(p * dp)
  const int* kv_start;
  const int* mask;  // (B, S) key mask or segment ids; null in MODE 0
  long long q_sb, q_sh, q_ss;  // element strides: batch, head, sequence
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long g_sb, g_sh, g_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int H, S, n_rep, q_len, causal, window;  // window <= 0: no sliding window
  float scale;
};

template <int D>
struct SmemA {
  static constexpr size_t q_off = 0;
  static constexpr size_t g_off = q_off + (size_t)BQ * D * 2;
  static constexpr size_t k_off = g_off + (size_t)BQ * D * 2;
  static constexpr size_t v_off = k_off + (size_t)BK * D * 2;
  static constexpr size_t s_off = v_off + (size_t)BK * D * 2;
  static constexpr size_t dp_off = s_off + (size_t)NWARPS * WROWS * LDS * 4;
  static constexpr size_t p_off = dp_off + (size_t)NWARPS * WROWS * LDS * 4;
  static constexpr size_t m_off = p_off + (size_t)NWARPS * WROWS * LDP * 2;
  static constexpr size_t bytes = m_off + (size_t)BK * 4;  // key ids of the tile
};

template <int D>
struct SmemB {
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + (size_t)BK * D * 2;
  static constexpr size_t q_off = v_off + (size_t)BK * D * 2;
  static constexpr size_t g_off = q_off + (size_t)BQ * D * 2;
  static constexpr size_t s_off = g_off + (size_t)BQ * D * 2;
  static constexpr size_t dp_off = s_off + (size_t)NWARPS * WROWS * LDS * 4;
  static constexpr size_t p_off = dp_off + (size_t)NWARPS * WROWS * LDS * 4;
  static constexpr size_t ds_off = p_off + (size_t)NWARPS * WROWS * LDP * 2;
  static constexpr size_t stat_off = ds_off + (size_t)NWARPS * WROWS * LDP * 2;
  static constexpr size_t m_off = stat_off + (size_t)3 * BQ * 4;
  static constexpr size_t bytes = m_off + (size_t)BQ * 4;  // query ids of the tile
};

// 64 rows x D columns of a row-strided bf16 matrix into shared memory (row
// stride D), zero past the last row.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long row_stride,
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

// Key tiles [k_begin, k_end) that the q tile starting at q0 visits: the
// forward's (flash_attention.cu) skip rule, shared by both passes.
__device__ __forceinline__ void key_range(const Args& a, int q0, int kvs, int* k_begin,
                                          int* k_end) {
  int e = a.causal ? min(q0 + BQ, a.S) : a.S;
  *k_end = min(e, a.q_len);
  int b = (kvs / BK) * BK;
  if (a.causal && a.window > 0) {
    const int lo = q0 - a.window + 1;
    if (lo > 0) b = max(b, (lo / BK) * BK);
  }
  *k_begin = b;
}

// The open keys of query row qpos form [lo, hi): k < q_len, k >= kv_start,
// and, causal, k <= qpos and k > qpos - window.
__device__ __forceinline__ void row_keys(const Args& a, int qpos, int kvs, int* lo, int* hi) {
  *lo = kvs;
  *hi = a.q_len;
  if (a.causal) {
    *hi = min(*hi, qpos + 1);
    if (a.window > 0) *lo = max(*lo, qpos - a.window + 1);
  }
}

// The same masks seen from key row kpos: the open queries form [lo, hi),
// empty when the key itself is masked.
__device__ __forceinline__ void key_queries(const Args& a, int kpos, int kvs, int* lo,
                                            int* hi) {
  const bool open = kpos >= kvs && kpos < a.q_len;
  *lo = a.causal ? kpos : 0;
  *hi = !open ? 0 : (a.causal && a.window > 0) ? kpos + a.window : 0x7fffffff;
}

// Whether key column kc (position kp) counts for a query with open interval
// [lo, hi) and segment id qseg; ids holds the tile's key-mask values or ids.
template <int MODE>
__device__ __forceinline__ bool key_open(int kp, int lo, int hi, const int* ids, int kc,
                                         int qseg) {
  bool ok = kp >= lo && kp < hi;
  if (MODE == 1) ok = ok && ids[kc] != 0;
  if (MODE == 2) ok = ok && ids[kc] != 0 && ids[kc] == qseg;
  return ok;
}

// 64 entries of a (S,) int32 row into shared memory, zero past the end.
__device__ __forceinline__ void load_ids(int* dst, const int* row, int i0, int S) {
  for (int i = threadIdx.x; i < 64; i += NTHREADS) dst[i] = i0 + i < S ? row[i0 + i] : 0;
}

// Column j of a lane pair's half row: the pair's two lanes take the even and
// odd columns, and row r starts at column 2r, so the 32 lanes of a warp hit
// 32 different shared-memory banks of the fp32 scratch (row stride LDS).
__device__ __forceinline__ int lane_col(int j, int r, int half) {
  return 2 * ((j + r) & 31) + half;
}

// (16 x D) . (D x 64) into an fp32 16 x LDS scratch: rows of A from a
// row-major [16][D] tile, columns of B from a row-major [64][D] tile read
// as its transpose.
template <int D>
__device__ __forceinline__ void rows_times_tile_t(float* out, const bf16* a_rows,
                                                  const bf16* b_tile) {
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
      wmma::load_matrix_sync(af, a_rows + kk * 16, D);
      wmma::load_matrix_sync(bfr, b_tile + n * 16 * D + kk * 16, D);
      wmma::mma_sync(acc, af, bfr, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[n] += P (16 x 64, bf16 [16][LDP]) . T (64 x D, row-major [64][D]).
template <int D>
__device__ __forceinline__ void accumulate_pt(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16], const bf16* p,
    const bf16* t) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
    wmma::load_matrix_sync(pf, p + kk * 16, LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> tf;
      wmma::load_matrix_sync(tf, t + kk * 16 * D + n * 16, D);
      wmma::mma_sync(acc[n], pf, tf, acc[n]);
    }
  }
}

// Round a warp's 16 x D fp32 fragments to bf16 rows row0.. of dst (rows at
// or past n_rows are dropped), through the warp's fp32 scratch.
template <int D>
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16], float* scratch,
    bf16* dst, long long row_stride, int row0, int n_rows) {
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1, half = lane & 1;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(scratch, acc[n], LDS, wmma::mem_row_major);
    __syncwarp();
    if (row0 + r < n_rows) {
      lrt::Vec8 w;
#pragma unroll
      for (int e = 0; e < 8; ++e) w.h[e] = __float2bfloat16(scratch[r * LDS + half * 8 + e]);
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * row_stride + n * 16 + half * 8) =
          w.u;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------- pass A

template <int D, int MODE>
__global__ void __launch_bounds__(NTHREADS) fa_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  typedef SmemA<D> L;
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sG = reinterpret_cast<bf16*>(smem + L::g_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sS = reinterpret_cast<float*>(smem + L::s_off) + warp * WROWS * LDS;
  float* sDP = reinterpret_cast<float*>(smem + L::dp_off) + warp * WROWS * LDS;
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p_off) + warp * WROWS * LDP;
  int* sM = reinterpret_cast<int*>(smem + L::m_off);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.n_rep;
  const int q0 = qt * BQ;
  const int kvs = a.kv_start[b];
  const bf16* kb = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + hk * a.v_sh;

  load_rows<D>(sQ, a.q + b * a.q_sb + h * a.q_sh, a.q_ss, q0, a.S);
  load_rows<D>(sG, a.g + b * a.g_sb + h * a.g_sh, a.g_ss, q0, a.S);
  int k_begin, k_end;
  key_range(a, q0, kvs, &k_begin, &k_end);

  // each lane pair owns one query row; lane & 1 picks its half of the keys
  const int r = lane >> 1, half = lane & 1;
  const int qrow = q0 + warp * WROWS + r;
  const bf16* sQw = sQ + warp * WROWS * D;
  const bf16* sGw = sG + warp * WROWS * D;
  int lo, hi;
  row_keys(a, qrow, kvs, &lo, &hi);
  const int* mrow = MODE != 0 ? a.mask + (long long)b * a.S : nullptr;
  // a query past S takes id 0, which no key matches: its row is never written
  const int qseg = (MODE == 2 && qrow < a.S) ? mrow[qrow] : 0;

  // sweep 1: row max, row sum and rowsum(e * dp), rescaled online
  float m = MASK_FILL, l = 0.f, dn = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows<D>(sK, kb, a.k_ss, k0, a.S);
    load_rows<D>(sV, vb, a.v_ss, k0, a.S);
    if (MODE != 0) load_ids(sM, mrow, k0, a.S);
    __syncthreads();
    rows_times_tile_t<D>(sS, sQw, sK);
    rows_times_tile_t<D>(sDP, sGw, sV);
    __syncwarp();
    float tmax = MASK_FILL;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int kc = lane_col(j, r, half);
      const int kp = k0 + kc;
      const float s =
          key_open<MODE>(kp, lo, hi, sM, kc, qseg) ? sS[r * LDS + kc] * a.scale : MASK_FILL;
      tmax = fmaxf(tmax, s);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f, dsum = 0.f;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int kc = lane_col(j, r, half);
      const int kp = k0 + kc;
      const float s =
          key_open<MODE>(kp, lo, hi, sM, kc, qseg) ? sS[r * LDS + kc] * a.scale : MASK_FILL;
      // mask modes: a key past S never counts, also not for a fully masked row
      const float e = (MODE == 0 || kp < a.S) ? __expf(s - m_new) : 0.f;
      psum += e;
      dsum += e * sDP[r * LDS + kc];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    l = l * alpha + psum;
    dn = dn * alpha + dsum;
    m = m_new;
    __syncwarp();
  }
  const float inv_l = l > 0.f ? 1.f / l : 0.f;
  const float delta = dn * inv_l;
  if (half == 0 && qrow < a.S) {
    const long long si = ((long long)b * a.H + h) * a.S + qrow;
    a.row_m[si] = m;
    a.row_inv_l[si] = inv_l;
    a.row_delta[si] = delta;
  }

  // sweep 2: p, ds (bf16) and dq = ds . K
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq[n], 0.f);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows<D>(sK, kb, a.k_ss, k0, a.S);
    load_rows<D>(sV, vb, a.v_ss, k0, a.S);
    if (MODE != 0) load_ids(sM, mrow, k0, a.S);
    __syncthreads();
    rows_times_tile_t<D>(sS, sQw, sK);
    rows_times_tile_t<D>(sDP, sGw, sV);
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int kc = lane_col(j, r, half);
      const int kp = k0 + kc;
      const float s =
          key_open<MODE>(kp, lo, hi, sM, kc, qseg) ? sS[r * LDS + kc] * a.scale : MASK_FILL;
      const float p = (MODE == 0 || kp < a.S) ? __expf(s - m) * inv_l : 0.f;
      const float ds = p * (sDP[r * LDS + kc] - delta) * a.scale;
      sP[r * LDP + kc] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate_pt<D>(dq, sP, sK);
    __syncwarp();
  }
  __syncthreads();
  store_rows<D>(dq, sS, a.dq + b * a.dq_sb + h * a.dq_sh, a.dq_ss, q0 + warp * WROWS, a.S);
}

// ---------------------------------------------------------------- pass B

template <int D, int MODE>
__global__ void __launch_bounds__(NTHREADS) fa_bwd_dkdv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  typedef SmemB<D> L;
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sG = reinterpret_cast<bf16*>(smem + L::g_off);
  float* sStat = reinterpret_cast<float*>(smem + L::stat_off);  // m, inv_l, delta
  int* sMq = reinterpret_cast<int*>(smem + L::m_off);  // MODE 2: the q tile's segment ids
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sS = reinterpret_cast<float*>(smem + L::s_off) + warp * WROWS * LDS;
  float* sDP = reinterpret_cast<float*>(smem + L::dp_off) + warp * WROWS * LDS;
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p_off) + warp * WROWS * LDP;
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds_off) + warp * WROWS * LDP;

  const int kt = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int kvs = a.kv_start[b];
  load_rows<D>(sK, a.k + b * a.k_sb + hk * a.k_sh, a.k_ss, k0, a.S);
  load_rows<D>(sV, a.v + b * a.v_sb + hk * a.v_sh, a.v_ss, k0, a.S);

  // each lane pair owns one key row of the warp's 16; lane & 1 picks its
  // half of the 64 query columns
  const int r = lane >> 1, half = lane & 1;
  const int krow = k0 + warp * WROWS + r;
  const bf16* sKw = sK + warp * WROWS * D;
  const bf16* sVw = sV + warp * WROWS * D;
  int lo, hi;
  key_queries(a, krow, kvs, &lo, &hi);
  const int* mrow = MODE != 0 ? a.mask + (long long)b * a.S : nullptr;
  // this key's mask value or segment id; a zero closes the key for every query
  const int kid = (MODE != 0 && krow < a.S) ? mrow[krow] : 0;
  if (MODE != 0 && kid == 0) hi = 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[D / 16], dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }
  const int n_qt = (a.S + BQ - 1) / BQ;
  const int qt_lo = a.causal ? kt : 0;  // BQ == BK: earlier q tiles stop before k0
  for (int rep = 0; rep < a.n_rep; ++rep) {
    const int h = hk * a.n_rep + rep;
    const long long stat0 = ((long long)b * a.H + h) * a.S;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      int k_begin, k_end;
      key_range(a, q0, kvs, &k_begin, &k_end);
      if (k0 < k_begin || k0 >= k_end) continue;  // block-uniform
      __syncthreads();
      load_rows<D>(sQ, a.q + b * a.q_sb + h * a.q_sh, a.q_ss, q0, a.S);
      load_rows<D>(sG, a.g + b * a.g_sb + h * a.g_sh, a.g_ss, q0, a.S);
      if (threadIdx.x < BQ) {
        const int qr = q0 + threadIdx.x;
        const bool in = qr < a.S;
        sStat[threadIdx.x] = in ? a.row_m[stat0 + qr] : 0.f;
        sStat[BQ + threadIdx.x] = in ? a.row_inv_l[stat0 + qr] : 0.f;
        sStat[2 * BQ + threadIdx.x] = in ? a.row_delta[stat0 + qr] : 0.f;
      }
      if (MODE == 2) load_ids(sMq, mrow, q0, a.S);
      __syncthreads();
      rows_times_tile_t<D>(sS, sKw, sQ);   // s^T: keys x queries
      rows_times_tile_t<D>(sDP, sVw, sG);  // dp^T
      __syncwarp();
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int qc = lane_col(j, r, half);
        const int qp = q0 + qc;
        bool ok = qp >= lo && qp < hi;
        if (MODE == 2) ok = ok && sMq[qc] == kid;
        const float s = ok ? sS[r * LDS + qc] * a.scale : MASK_FILL;
        const float p = __expf(s - sStat[qc]) * sStat[BQ + qc];
        const float ds = p * (sDP[r * LDS + qc] - sStat[2 * BQ + qc]) * a.scale;
        sP[r * LDP + qc] = __float2bfloat16(p);
        sDS[r * LDP + qc] = __float2bfloat16(ds);
      }
      __syncwarp();
      accumulate_pt<D>(dv, sP, sG);
      accumulate_pt<D>(dk, sDS, sQ);
      __syncwarp();
    }
  }
  store_rows<D>(dk, sS, a.dk + b * a.dk_sb + hk * a.dk_sh, a.dk_ss, k0 + warp * WROWS, a.S);
  store_rows<D>(dv, sS, a.dv + b * a.dv_sb + hk * a.dv_sh, a.dv_ss, k0 + warp * WROWS, a.S);
}

template <int D, int MODE>
int launch(const Args& a, int B, int Hk, cudaStream_t stream) {
  const size_t smem_a = SmemA<D>::bytes, smem_b = SmemB<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(fa_bwd_dq_kernel<D, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<D, MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (e != cudaSuccess) return (int)e;
  const int n_t = (a.S + BQ - 1) / BQ;
  fa_bwd_dq_kernel<D, MODE><<<dim3(n_t, a.H, B), NTHREADS, smem_a, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dkdv_kernel<D, MODE><<<dim3(n_t, Hk, B), NTHREADS, smem_b, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mode(const Args& a, int mode, int B, int Hk, cudaStream_t st) {
  switch (mode) {
    case 0: return launch<D, 0>(a, B, Hk, st);
    case 1: return launch<D, 1>(a, B, Hk, st);
    default: return launch<D, 2>(a, B, Hk, st);
  }
}

}  // namespace

// B8: q, g (B, H, S, D) and k, v (B, Hk, S, D) bf16 with any element strides
// and a unit last-dim stride -> dq (B, H, S, D), dk, dv (B, Hk, S, D) through
// their own strides. ``stats`` is fp32 scratch of 3*B*H*S. mask: a contiguous
// int32 (B, S) row read as a key mask (mask_mode 1) or segment ids (2), or
// null with mask_mode 0. Two launches on ``stream``; returns
// cudaGetLastError() after them.
extern "C" int lrt_fa_bwd(const void* q, const void* k, const void* v, const void* g,
                          const void* kv_start, void* dq, void* dk, void* dv, void* stats,
                          const void* mask, int B, int H, int Hk, int S, int D,
                          const long long* strides, int q_len, int causal, int window,
                          int mask_mode, float scale, void* stream) {
  if ((mask_mode != 0) != (mask != nullptr) || mask_mode < 0 || mask_mode > 2)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.mask = static_cast<const int*>(mask);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.g = static_cast<const bf16*>(g);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  float* st = static_cast<float*>(stats);
  const long long n = (long long)B * H * S;
  a.row_m = st;
  a.row_inv_l = st + n;
  a.row_delta = st + 2 * n;
  a.kv_start = static_cast<const int*>(kv_start);
  // strides: (batch, head, seq) of q, k, v, g, dq, dk, dv in that order
  long long* dst[21] = {&a.q_sb,  &a.q_sh,  &a.q_ss,  &a.k_sb,  &a.k_sh,  &a.k_ss,  &a.v_sb,
                        &a.v_sh,  &a.v_ss,  &a.g_sb,  &a.g_sh,  &a.g_ss,  &a.dq_sb, &a.dq_sh,
                        &a.dq_ss, &a.dk_sb, &a.dk_sh, &a.dk_ss, &a.dv_sb, &a.dv_sh, &a.dv_ss};
  for (int i = 0; i < 21; ++i) *dst[i] = strides[i];
  a.H = H;
  a.S = S;
  a.n_rep = H / Hk;
  a.q_len = q_len;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_mode<64>(a, mask_mode, B, Hk, st_);
    case 80: return launch_mode<80>(a, mask_mode, B, Hk, st_);
    case 96: return launch_mode<96>(a, mask_mode, B, Hk, st_);
    case 128: return launch_mode<128>(a, mask_mode, B, Hk, st_);
    default: return (int)cudaErrorInvalidValue;
  }
}
