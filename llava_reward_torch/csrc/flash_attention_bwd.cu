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
// causal and sliding window. head_dim is 64, 80, 96 or 128.
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
// left-pad tile skipping a pad row is uniform over the visited keys only
// (lrt::key_tile_begin / key_tile_end, the forward's rule, in both passes);
// its dq is never compared, and its g is zero on the training path.
//
// What bounds it on an H100: five products of 2*D operations per unmasked
// (query, key) pair against 7 tensors of S*D bf16 moved once; at the
// decoder's S = 2560, D = 96 that is far past the ~295 operations per byte
// ridge, so the bound is tensor-core operations. The design (after
// FlashAttention-3's backward) runs seven products where the first slice ran
// nine, all as wgmma fed by TMA, in three launches (one fa_bwd call):
//   stats, per (b, h, 128 query rows): a producer warpgroup (24 registers)
//     keeps a 4-stage TMA ring of K/V tiles in flight; two consumer
//     warpgroups of 64 rows (240 registers) run
//     S = Q.K^T and dP = dO.V^T (2 products; the next tile's are issued before
//     this tile's update, so they overlap it) and keep the row max m, the row
//     sum l and delta online in registers (rescaled like the forward's
//     softmax, base 2). They store m, 1/l and delta per 64-row tile, padded
//     to whole tiles so that the main pass fetches them by bulk copy;
//   main, per (b, q head, 64-key tile): the key-stationary pass. K and V stay
//     in shared memory; the producer (setmaxnreg down to 24) streams the q
//     tiles that reach this key tile, Q, dO by TMA and their statistics (and
//     segment ids) by bulk copy, through a 2-stage ring. One consumer
//     warpgroup (232 registers) recomputes S^T = K.Q^T and dP^T = V.dO^T,
//     forms P and dS in registers from the statistics, accumulates
//     dV += P^T.dO and dK += dS^T.Q with P and dS as the register A operand
//     (4 products), writes dS^T to shared memory and runs dQ = dS.K there in
//     two halves of head_dim (1 product, MN-major operands), staging each in
//     fp32 in the ring slot Q and dO leave free and adding it into an fp32
//     workspace with one TMA reduce-add (cp.reduce.async.bulk) per half;
//   finish: rounds the fp32 dq (and, with GQA, dk and dv) to bf16 into the
//     callers' strides; without GQA the main pass rounds dk and dv itself.
// The grid of the main pass is (q head, b, key tile): 1568 blocks at Qwen's
// GQA shape (2, 28/4, 1792, 128), two resident per SM, key tile slowest so
// that the heaviest causal tiles start first; dk and dv of the reps of one kv
// head are fp32 partials summed by fp32 atomics before the one rounding.
// Determinism: the fp32 sums of dq (over key tiles) and of dk/dv (over reps)
// take the order in which blocks finish, so two runs may differ by the last
// fp32 bits, which can move a bf16 rounding by one unit; chip_smoke.py prints
// the max |dq1 - dq2| of two launches. With n_rep == 1 dk and dv are
// deterministic.
#include "common.cuh"
#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;      // query rows per tile
constexpr int BK = 64;      // keys per tile
constexpr float MASK_FILL = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int STAT_FLOATS = 3 * BQ;  // m (base 2), 1/l, delta of one 64-row tile

struct Common {
  const int* kv_start;
  const int* mask;  // (B, S_pad) int32 key mask or segment ids, 0 past S; null in MODE 0
  float* stats;     // (B, H, S_pad / 64, 3, 64)
  int H, S, S_pad, n_rep, q_len, causal, window;
  float scale, scale_log2;
};

// ---------------------------------------------------------------- stats pass

struct StatsArgs {
  CUtensorMap tq, tg;  // (8, S, D/8, H, B), box 128 rows
  CUtensorMap tk, tv;  // (8, S, D/8, Hk, B), box 64 rows
  Common c;
};

template <int D>
struct StatsSmem {
  // K/V ring depth: the consumers' update is short, so the loads of the next
  // tiles must already be in flight when a tile is released (4 measured
  // 11-21 % faster than 2)
  static constexpr int STAGES = 4;
  static constexpr size_t q_off = 0;
  static constexpr size_t g_off = q_off + (size_t)2 * BQ * D * 2;
  static constexpr size_t k_off = g_off + (size_t)2 * BQ * D * 2;
  static constexpr size_t v_off = k_off + (size_t)STAGES * BK * D * 2;
  static constexpr size_t id_off = v_off + (size_t)STAGES * BK * D * 2;
  static constexpr size_t bar_off = id_off + (size_t)STAGES * BK * 4;
  // qg_full, then per stage k_full, v_full, empty
  static constexpr size_t bytes = bar_off + (1 + 3 * STAGES) * 8;
};

template <int D, int MODE>
__global__ void __launch_bounds__(384, 1) fa_bwd_stats_kernel(const __grid_constant__ StatsArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  typedef StatsSmem<D> L;
  constexpr int STAGES = L::STAGES;
  const Common& c = a.c;
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sG = reinterpret_cast<bf16*>(smem + L::g_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  int* sId = reinterpret_cast<int*>(smem + L::id_off);
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* k_full = qg_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / c.n_rep;
  const int q0 = qt * 2 * BQ;
  const int kvs = c.kv_start[b];
  const int k_begin = lrt::key_tile_begin(q0, kvs, c.causal, c.window);
  const int k_end = lrt::key_tile_end(q0 + BQ, c.S, c.q_len, c.causal);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qg_full, 1);
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
    sm90::reg_dealloc<24>();
    if (t != 0) return;
    // ---- producer: one thread keeps the TMA ring full
    sm90::mbar_expect_tx(qg_full, 2 * 2 * BQ * D * 2);
    sm90::tma_load_5d(sQ, &a.tq, qg_full, 0, q0, 0, h, b);
    sm90::tma_load_5d(sG, &a.tg, qg_full, 0, q0, 0, h, b);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES, ph = (i / STAGES) & 1;
      const int k0 = k_begin + i * BK;
      sm90::mbar_wait(&empty[st], ph ^ 1);
      sm90::mbar_expect_tx(&k_full[st], BK * D * 2 + (MODE != 0 ? BK * 4 : 0));
      sm90::tma_load_5d(sK + st * BK * D, &a.tk, &k_full[st], 0, k0, 0, hk, b);
      if (MODE != 0)
        sm90::bulk_load(sId + st * BK, c.mask + (long long)b * c.S_pad + k0, BK * 4, &k_full[st]);
      sm90::mbar_expect_tx(&v_full[st], BK * D * 2);
      sm90::tma_load_5d(sV + st * BK * D, &a.tv, &v_full[st], 0, k0, 0, hk, b);
    }
    return;
  }

  // ---- consumers: 64 query rows each
  sm90::reg_alloc<240>();
  const int wq0 = q0 + (wg - 1) * BQ;
  const int my_begin = lrt::key_tile_begin(wq0, kvs, c.causal, c.window);
  const int my_end = lrt::key_tile_end(wq0, c.S, c.q_len, c.causal);
  const bf16* sQw = sQ + (wg - 1) * BQ * 8;
  const bf16* sGw = sG + (wg - 1) * BQ * 8;
  const int qrow[2] = {wq0 + sm90::acc_row(t, 0), wq0 + sm90::acc_row(t, 2)};
  int lo[2], hi[2], qseg[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    lo[j] = kvs;
    hi[j] = c.q_len;
    if (c.causal) {
      hi[j] = min(hi[j], qrow[j] + 1);
      if (c.window > 0) lo[j] = max(lo[j], qrow[j] - c.window + 1);
    }
    // a query past S takes id 0, which no key matches
    qseg[j] = (MODE == 2 && qrow[j] < c.S) ? c.mask[(long long)b * c.S_pad + qrow[j]] : 0;
  }
  float m[2] = {MASK_FILL, MASK_FILL}, l[2] = {0.f, 0.f}, dn[2] = {0.f, 0.f};
  sm90::mbar_wait(qg_full, 0);

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
  // S = Q.K^T and dP = dO.V^T of tile i, one wgmma group
  auto products = [&](int i, float(&s)[32], float(&dp)[32]) {
    const int st = i % STAGES, ph = (i / STAGES) & 1;
    sm90::mbar_wait(&k_full[st], ph);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::Wgmma<64>::template ss<0, 0>(s, sm90::desc_k<2 * BQ>(sQw, kk),
                                         sm90::desc_k<BK>(sK + st * BK * D, kk), kk > 0);
    sm90::mbar_wait(&v_full[st], ph);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::Wgmma<64>::template ss<0, 0>(dp, sm90::desc_k<2 * BQ>(sGw, kk),
                                         sm90::desc_k<BK>(sV + st * BK * D, kk), kk > 0);
    sm90::wg_commit();
  };
  for (int i = 0; i < i_lo; ++i) skip(i);
  float s[32], dp[32], s_next[32], dp_next[32];
  if (i_lo < i_hi) {
    products(i_lo, s, dp);
    sm90::wg_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
  }
  for (int it = i_lo; it < i_hi; ++it) {
    const int st = it % STAGES;
    const int k0 = k_begin + it * BK;
    // the next tile's products run on the tensor cores during this update
    if (it + 1 < i_hi) products(it + 1, s_next, dp_next);

    const int* ids = sId + st * BK;
    float tmax[2] = {MASK_FILL, MASK_FILL};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1;
      const int kc = sm90::acc_col(t, i);
      const int kp = k0 + kc;
      bool ok = kp >= lo[j] && kp < hi[j];
      if (MODE == 1) ok = ok && ids[kc] != 0;
      if (MODE == 2) ok = ok && ids[kc] != 0 && ids[kc] == qseg[j];
      s[i] = ok ? s[i] * c.scale_log2 : MASK_FILL;
      tmax[j] = fmaxf(tmax[j], s[i]);
    }
    float alpha[2], psum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
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
      // mask modes: a key past S never counts, also not for a fully masked row
      const float e =
          (MODE == 0 || k0 + sm90::acc_col(t, i) < c.S) ? exp2f(s[i] - m[j]) : 0.f;
      psum[j] += e;
      dsum[j] += e * dp[i];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      psum[j] += __shfl_xor_sync(0xffffffffu, psum[j], 1);
      psum[j] += __shfl_xor_sync(0xffffffffu, psum[j], 2);
      dsum[j] += __shfl_xor_sync(0xffffffffu, dsum[j], 1);
      dsum[j] += __shfl_xor_sync(0xffffffffu, dsum[j], 2);
      l[j] = l[j] * alpha[j] + psum[j];
      dn[j] = dn[j] * alpha[j] + dsum[j];
    }
    sm90::wg_wait<0>();
    sm90::fence_regs(s_next);
    sm90::fence_regs(dp_next);
    sm90::mbar_arrive(&empty[st]);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = s_next[i];
      dp[i] = dp_next[i];
    }
  }
  for (int i = i_hi; i < n_tiles; ++i) skip(i);

  // rows past S (up to the padded S_pad) get zeros: p = 0 there in the main pass
  if (t % 4 == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = qrow[j];
      if (q >= c.S_pad) continue;
      const bool in = q < c.S;
      const float inv_l = in && l[j] > 0.f ? 1.f / l[j] : 0.f;
      float* sp = c.stats + ((((long long)b * c.H + h) * (c.S_pad / BQ) + q / BQ) * 3) * BQ +
                  q % BQ;
      sp[0] = in ? m[j] : 0.f;
      sp[BQ] = inv_l;
      sp[2 * BQ] = in ? dn[j] * inv_l : 0.f;
    }
  }
}

// ---------------------------------------------------------------- main pass

struct Out {
  const float* acc;  // (B, n, S_pad, D), or dq's tiles in halves (B, n, S_pad / 64, 2, 64, D / 2)
  bf16* dst;
  long long sb, sh, ss;  // element strides of dst
  int n;                 // heads
  int halves;            // 1: rows of D; 2: dq's tiles
};

struct MainArgs {
  CUtensorMap tq, tg;  // (8, S, D/8, H, B), box 64 rows
  CUtensorMap tk, tv;  // (8, S, D/8, Hk, B), box 64 rows
  Common c;
  float* dq_acc;  // (B, H, S_pad / 64, 2, 64, D / 2) fp32, zeroed: 64-row tiles in halves
  float* dk_acc;  // with GQA: (B, Hk, S_pad, D) fp32, zeroed, the reps' sums
  float* dv_acc;
  Out dk, dv;     // without GQA the main pass rounds dk and dv itself
};

template <int D>
struct MainSmem {
  // Q/dO ring depth (3 measured no faster: the consumer's chain of products
  // per q tile, not the loads, sets the pace)
  static constexpr int STAGES = 2;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + (size_t)BK * D * 2;
  static constexpr size_t q_off = v_off + (size_t)BK * D * 2;
  static constexpr size_t g_off = q_off + (size_t)STAGES * BQ * D * 2;
  static constexpr size_t ds_off = g_off + (size_t)STAGES * BQ * D * 2;
  static constexpr size_t st_off = ds_off + (size_t)BK * BQ * 2;
  static constexpr size_t id_off = st_off + (size_t)STAGES * STAT_FLOATS * 4;
  static constexpr size_t bar_off = id_off + (size_t)STAGES * BQ * 4;
  // kv_full, then per stage full, empty
  static constexpr size_t bytes = bar_off + (1 + 2 * STAGES) * 8;
};

// whether the q tile at q0 visits the key tile at k0 (the forward's rule)
__device__ __forceinline__ bool visits(const Common& c, int q0, int k0, int kvs) {
  return k0 >= lrt::key_tile_begin(q0, kvs, c.causal, c.window) &&
         k0 < lrt::key_tile_end(q0, c.S, c.q_len, c.causal);
}

template <int D, int MODE>
__global__ void __launch_bounds__(256, 2) fa_bwd_main_kernel(const __grid_constant__ MainArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  typedef MainSmem<D> L;
  constexpr int STAGES = L::STAGES;
  const Common& c = a.c;
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sG = reinterpret_cast<bf16*>(smem + L::g_off);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::ds_off);
  float* sSt = reinterpret_cast<float*>(smem + L::st_off);
  int* sId = reinterpret_cast<int*>(smem + L::id_off);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int hk = h / c.n_rep;
  const int k0 = kt * BK;
  const int kvs = c.kv_start[b];
  const int n_qt = c.S_pad / BQ;
  const int qt_lo = c.causal ? kt : 0;  // BQ == BK: earlier q tiles stop before k0

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 0) {
    // ---- producer: one thread streams the q tiles that reach this key tile
    sm90::reg_dealloc<24>();
    if (t == 0) {
      sm90::mbar_expect_tx(kv_full, 2 * BK * D * 2);
      sm90::tma_load_5d(sK, &a.tk, kv_full, 0, k0, 0, hk, b);
      sm90::tma_load_5d(sV, &a.tv, kv_full, 0, k0, 0, hk, b);
      const float* stats = c.stats + ((long long)b * c.H + h) * n_qt * STAT_FLOATS;
      int i = 0;
      for (int qt = qt_lo; qt < n_qt; ++qt) {
        const int q0 = qt * BQ;
        if (!visits(c, q0, k0, kvs)) continue;
        const int st = i % STAGES, ph = (i / STAGES) & 1;
        ++i;
        sm90::mbar_wait(&empty[st], ph ^ 1);
        sm90::mbar_expect_tx(&full[st], 2 * BQ * D * 2 + STAT_FLOATS * 4 + (MODE == 2 ? BQ * 4 : 0));
        sm90::tma_load_5d(sQ + st * BQ * D, &a.tq, &full[st], 0, q0, 0, h, b);
        sm90::tma_load_5d(sG + st * BQ * D, &a.tg, &full[st], 0, q0, 0, h, b);
        sm90::bulk_load(sSt + st * STAT_FLOATS, stats + qt * STAT_FLOATS, STAT_FLOATS * 4, &full[st]);
        if (MODE == 2)
          sm90::bulk_load(sId + st * BQ, c.mask + (long long)b * c.S_pad + q0, BQ * 4, &full[st]);
      }
    }
  } else {
    // ---- consumer: 64 keys, dK and dV in registers
    sm90::reg_alloc<232>();
    // this thread's two key rows and the queries each one is open to: [qlo, qhi)
    int krow[2], qlo[2], qhi[2], kid[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      krow[j] = k0 + sm90::acc_row(t, 2 * j);
      const bool open = krow[j] >= kvs && krow[j] < c.q_len;
      qlo[j] = c.causal ? krow[j] : 0;
      qhi[j] = !open ? 0 : (c.causal && c.window > 0) ? krow[j] + c.window : 0x7fffffff;
      // the key's mask value or segment id; a zero closes it for every query
      kid[j] = MODE != 0 ? c.mask[(long long)b * c.S_pad + krow[j]] : 1;
      if (kid[j] == 0) qhi[j] = 0;
    }
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    bool any = false;
    sm90::mbar_wait(kv_full, 0);

    int i = 0;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      if (!visits(c, q0, k0, kvs)) continue;
      const int st = i % STAGES, ph = (i / STAGES) & 1;
      ++i;
      any = true;
      const bf16* q_t = sQ + st * BQ * D;
      const bf16* g_t = sG + st * BQ * D;
      sm90::mbar_wait(&full[st], ph);

      // S^T = K.Q^T and dP^T = V.dO^T: keys x queries
      float s[32], dp[32];
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<64>::template ss<0, 0>(s, sm90::desc_k<BK>(sK, kk), sm90::desc_k<BQ>(q_t, kk),
                                           kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<64>::template ss<0, 0>(dp, sm90::desc_k<BK>(sV, kk),
                                           sm90::desc_k<BQ>(g_t, kk), kk > 0);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      // P and dS from the rows' statistics (m in base 2, 1/l, delta)
      const float* sm_ = sSt + st * STAT_FLOATS;
      const int* qids = sId + st * BQ;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int j = (e >> 1) & 1;
        const int qc = sm90::acc_col(t, e);
        const float2 mm = *reinterpret_cast<const float2*>(sm_ + qc);
        const float2 il = *reinterpret_cast<const float2*>(sm_ + BQ + qc);
        const float2 dl = *reinterpret_cast<const float2*>(sm_ + 2 * BQ + qc);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int qp = q0 + qc + u;
          bool ok = qp >= qlo[j] && qp < qhi[j];
          if (MODE == 2) ok = ok && qids[qc + u] == kid[j];
          const float sv = ok ? s[e + u] * c.scale_log2 : MASK_FILL;
          const float p = exp2f(sv - (u ? mm.y : mm.x)) * (u ? il.y : il.x);
          dp[e + u] = p * (dp[e + u] - (u ? dl.y : dl.x)) * c.scale;
          s[e + u] = p;
        }
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::acc_to_a(s, kk, pa[kk]);
        sm90::acc_to_a(dp, kk, da[kk]);
      }

      // dS^T to shared memory (keys x queries, chunk-major), for dQ = dS.K
      sm90::bar_sync(1, 128);  // the previous step's dQ products are done
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = sm90::acc_row(t, (x & 1) * 2);
          const int qc = kk * 16 + (x >> 1) * 8 + (t % 4) * 2;
          *reinterpret_cast<uint32_t*>(sDS + (qc / 8) * BK * 8 + r * 8 + qc % 8) = da[kk][x];
        }
      }
      sm90::fence_async_smem();
      sm90::bar_sync(1, 128);

      // dV += P^T.dO, dK += dS^T.Q (queries are K, head_dim is N: MN-major)
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::Wgmma<D>::template rs<1>(dv, pa[kk], sm90::desc_mn<BQ>(g_t, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::Wgmma<D>::template rs<1>(dk, da[kk], sm90::desc_mn<BQ>(q_t, kk), 1);
      sm90::wg_commit();

      // dQ = dS.K in two halves of head_dim. Each half is staged in fp32 in
      // the slot Q (then dO) of this stage leaves free, and added into the
      // workspace by one TMA reduce-add of the 64 x D/2 block
      float* dq_tile = a.dq_acc + ((((long long)b * c.H + h) * n_qt + qt) * 2) * BQ * (D / 2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float dq[D / 4];
        sm90::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm90::Wgmma<D / 2>::template ss<1, 1>(dq, sm90::desc_mn<BK>(sDS, kk),
                                                sm90::desc_mn<BK>(sK + half * (D / 16) * BK * 8, kk),
                                                kk > 0);
        sm90::wg_commit();
        sm90::wg_wait<0>();  // also dV and dK: Q and dO are read
        sm90::fence_regs(dq);
        if (half == 0) {
          sm90::fence_regs(dk);
          sm90::fence_regs(dv);
        }
        float* stage = reinterpret_cast<float*>(half == 0 ? sQ + st * BQ * D : sG + st * BQ * D);
#pragma unroll
        for (int e = 0; e < D / 4; e += 2)
          *reinterpret_cast<float2*>(stage + sm90::acc_row(t, e) * (D / 2) + sm90::acc_col(t, e)) =
              make_float2(dq[e], dq[e + 1]);
        sm90::fence_async_smem();
        sm90::bar_sync(1, 128);
        if (t == 0) {
          sm90::bulk_reduce_add(dq_tile + half * BQ * (D / 2), stage, BQ * (D / 2) * 4);
          sm90::bulk_commit();
        }
      }
      if (t == 0) sm90::bulk_wait_read();
      sm90::mbar_arrive(&empty[st]);  // Q, dO, the statistics and both stagings are read
    }

    if (c.n_rep == 1) {
      // the whole sum of each key row is here (zero if no q tile reached it)
#pragma unroll
      for (int e = 0; e < D / 2; e += 2) {
        const int kr = k0 + sm90::acc_row(t, e);
        if (kr >= c.S) continue;
        const int col = sm90::acc_col(t, e);
        *reinterpret_cast<uint32_t*>(a.dk.dst + b * a.dk.sb + hk * a.dk.sh + kr * a.dk.ss + col) =
            sm90::pack_bf16(dk[e], dk[e + 1]);
        *reinterpret_cast<uint32_t*>(a.dv.dst + b * a.dv.sb + hk * a.dv.sh + kr * a.dv.ss + col) =
            sm90::pack_bf16(dv[e], dv[e + 1]);
      }
    } else if (any) {
      const long long row0 = ((long long)b * (c.H / c.n_rep) + hk) * c.S_pad;
#pragma unroll
      for (int e = 0; e < D / 2; ++e) {
        const long long off = (row0 + k0 + sm90::acc_row(t, e)) * D + sm90::acc_col(t, e);
        atomicAdd(a.dk_acc + off, dk[e]);
        atomicAdd(a.dv_acc + off, dv[e]);
      }
    }
  }
}

// ---------------------------------------------------------------- finish

struct FinishArgs {
  Out o[3];  // dq, dk, dv
  int B, S, S_pad, D;
};

// One thread rounds 8 columns of one row of one gradient; blockIdx.y picks it.
__global__ void __launch_bounds__(256) fa_bwd_finish_kernel(const __grid_constant__ FinishArgs f) {
  const Out& o = f.o[blockIdx.y];
  const int ch = f.D / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)f.B * o.n * f.S;
  if (idx >= rows * ch) return;
  const int cc = idx % ch;
  const long long row = idx / ch;
  const int s = row % f.S;
  const int bh = row / f.S;
  const int h = bh % o.n, b = bh / o.n;
  const int hd = f.D / o.halves, col = cc * 8;  // a chunk never straddles a half
  const long long tile = ((long long)bh * f.S_pad + s) / 64;
  const float* src = o.acc + ((tile * o.halves + col / hd) * 64 + s % 64) * hd + col % hd;
  const float4 x = *reinterpret_cast<const float4*>(src);
  const float4 y = *reinterpret_cast<const float4*>(src + 4);
  uint4 w;
  w.x = sm90::pack_bf16(x.x, x.y);
  w.y = sm90::pack_bf16(x.z, x.w);
  w.z = sm90::pack_bf16(y.x, y.y);
  w.w = sm90::pack_bf16(y.z, y.w);
  *reinterpret_cast<uint4*>(o.dst + b * o.sb + h * o.sh + s * o.ss + cc * 8) = w;
}

template <int D, int MODE>
int launch(const StatsArgs& sa, const MainArgs& ma, const FinishArgs& fa, int B,
           cudaStream_t stream) {
  const Common& c = sa.c;
  cudaError_t e = cudaFuncSetAttribute(fa_bwd_stats_kernel<D, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)StatsSmem<D>::bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fa_bwd_main_kernel<D, MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MainSmem<D>::bytes);
  if (e != cudaSuccess) return (int)e;
  fa_bwd_stats_kernel<D, MODE><<<dim3((c.S + 2 * BQ - 1) / (2 * BQ), c.H, B), 384,
                                 StatsSmem<D>::bytes, stream>>>(sa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fa_bwd_main_kernel<D, MODE><<<dim3(c.H, B, c.S_pad / BK), 256, MainSmem<D>::bytes, stream>>>(ma);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long threads = (long long)B * c.H * c.S * (D / 8);  // dq has the most rows
  fa_bwd_finish_kernel<<<dim3((unsigned)((threads + 255) / 256), c.n_rep == 1 ? 1 : 3), 256, 0,
                         stream>>>(fa);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mode(const StatsArgs& sa, const MainArgs& ma, const FinishArgs& fa, int mode, int B,
                cudaStream_t st) {
  switch (mode) {
    case 0: return launch<D, 0>(sa, ma, fa, B, st);
    case 1: return launch<D, 1>(sa, ma, fa, B, st);
    default: return launch<D, 2>(sa, ma, fa, B, st);
  }
}

}  // namespace

// B8: q, g (B, H, S, D) and k, v (B, Hk, S, D) bf16 with any element strides
// (multiples of 8) and a unit last-dim stride -> dq (B, H, S, D), dk, dv
// (B, Hk, S, D) through their own strides. Scratch from the caller: ``stats``
// fp32 of 3*B*H*S_pad and ``acc`` fp32 of B*H*S_pad*D, zeroed, plus
// 2*B*Hk*S_pad*D with GQA (H > Hk), with S_pad = S rounded up to 64. mask: a contiguous int32 (B, S_pad) row, zero
// past S, read as a key mask (mask_mode 1) or segment ids (2), or null with
// mask_mode 0. Three launches on ``stream``; returns cudaGetLastError() after
// them.
extern "C" int lrt_fa_bwd(const void* q, const void* k, const void* v, const void* g,
                          const void* kv_start, void* dq, void* dk, void* dv, void* stats,
                          void* acc, const void* mask, int B, int H, int Hk, int S, int D,
                          const long long* strides, int q_len, int causal, int window,
                          int mask_mode, float scale, void* stream) {
  if ((mask_mode != 0) != (mask != nullptr) || mask_mode < 0 || mask_mode > 2)
    return (int)cudaErrorInvalidValue;
  if (D != 64 && D != 80 && D != 96 && D != 128) return (int)cudaErrorInvalidValue;
  Common c;
  c.kv_start = static_cast<const int*>(kv_start);
  c.mask = static_cast<const int*>(mask);
  c.stats = static_cast<float*>(stats);
  c.H = H;
  c.S = S;
  c.S_pad = (S + BQ - 1) / BQ * BQ;
  c.n_rep = H / Hk;
  c.q_len = q_len;
  c.causal = causal;
  c.window = window;
  c.scale = scale;
  c.scale_log2 = scale * LOG2E;
  // strides: (batch, head, seq) of q, k, v, g, dq, dk, dv in that order
  const long long* sq = strides;
  const long long* sk = strides + 3;
  const long long* sv = strides + 6;
  const long long* sg = strides + 9;
  StatsArgs sa;
  MainArgs ma;
  sa.c = ma.c = c;
  const int q_outer[2] = {H, B}, kv_outer[2] = {Hk, B};
  const long long q_os[2] = {sq[1], sq[0]}, g_os[2] = {sg[1], sg[0]};
  const long long k_os[2] = {sk[1], sk[0]}, v_os[2] = {sv[1], sv[0]};
  int e = 0;
  e = e ? e : sm90_host::tile_map(&sa.tq, q, S, sq[2], D / 8, 2 * BQ, D / 8, 2, q_outer, q_os);
  e = e ? e : sm90_host::tile_map(&sa.tg, g, S, sg[2], D / 8, 2 * BQ, D / 8, 2, q_outer, g_os);
  e = e ? e : sm90_host::tile_map(&sa.tk, k, S, sk[2], D / 8, BK, D / 8, 2, kv_outer, k_os);
  e = e ? e : sm90_host::tile_map(&sa.tv, v, S, sv[2], D / 8, BK, D / 8, 2, kv_outer, v_os);
  e = e ? e : sm90_host::tile_map(&ma.tq, q, S, sq[2], D / 8, BQ, D / 8, 2, q_outer, q_os);
  e = e ? e : sm90_host::tile_map(&ma.tg, g, S, sg[2], D / 8, BQ, D / 8, 2, q_outer, g_os);
  if (e != 0) return e;
  ma.tk = sa.tk;
  ma.tv = sa.tv;
  float* acc_f = static_cast<float*>(acc);
  ma.dq_acc = acc_f;
  ma.dk_acc = H == Hk ? nullptr : acc_f + (long long)B * H * c.S_pad * D;
  ma.dv_acc = H == Hk ? nullptr : ma.dk_acc + (long long)B * Hk * c.S_pad * D;
  FinishArgs fa;
  fa.B = B;
  fa.S = S;
  fa.S_pad = c.S_pad;
  fa.D = D;
  const float* srcs[3] = {ma.dq_acc, ma.dk_acc, ma.dv_acc};
  void* dsts[3] = {dq, dk, dv};
  const int heads[3] = {H, Hk, Hk};
  for (int i = 0; i < 3; ++i) {
    fa.o[i].acc = srcs[i];
    fa.o[i].dst = static_cast<bf16*>(dsts[i]);
    fa.o[i].sb = strides[12 + 3 * i];
    fa.o[i].sh = strides[13 + 3 * i];
    fa.o[i].ss = strides[14 + 3 * i];
    fa.o[i].n = heads[i];
    fa.o[i].halves = i == 0 ? 2 : 1;
  }
  ma.dk = fa.o[1];
  ma.dv = fa.o[2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_mode<64>(sa, ma, fa, mask_mode, B, st);
    case 80: return launch_mode<80>(sa, ma, fa, mask_mode, B, st);
    case 96: return launch_mode<96>(sa, ma, fa, mask_mode, B, st);
    default: return launch_mode<128>(sa, ma, fa, mask_mode, B, st);
  }
}
