// Quantizing epilogues written by hand for Hopper (sm_90a).
//
// norm_quant_kernel<T, OP, NV, FULL> replaces three kernels of
// llava_reward_tpu/ops/quant_epilogue.py:
//   OP_RMS: _rms_quant_kernel (B4): Phi-3 RMSNorm (fp32 variance,
//   x * 1/sqrt(var+eps), bf16 rounding before and after the weight multiply
//   for bf16 input), then per-row int8 codes and the row amax;
//   OP_LN: _ln_quant_kernel (B9): LayerNorm in fp32 (mean, centred
//   variance, xc * 1/sqrt(var+eps) * w + b), with NO bf16 rounding of the
//   result (ln_quant quantizes the fp32 LayerNorm output), then codes and
//   amax. It feeds the CLIP tower's W8A8 qkv and fc1 projections.
// silu_mul_quant_kernel replaces _silu_mul_quant_kernel (B5): from the fused
//   (M, 2I) gate_up, y = g * sigmoid(g) * u in fp32 (gate in the first I
//   columns), rounded to bf16 for bf16 input, then codes and amax.
// norm_quant_kernel with OP_ROW and row_quant_kernel replace
//   _row_quant_kernel (B6): codes and amax of x.
// norm_quant_kernel with OP_RMS_NORM and OP_LN_NORM (the norm mode) replaces
//   no TPU kernel: it carries ops/norms.rms_norm and layer_norm for bf16 rows
//   on the card (the JAX package leaves them to XLA's fusions), storing the
//   normalised row itself instead of its codes: RMSNorm in Phi-3's cast order
//   (bf16(x * 1/sqrt(var+eps)), then the weight's product rounded to bf16),
//   LayerNorm as B9 computes it, rounded once to bf16, for rows of up to
//   2048 (the vision towers' widths). One read of 2 bytes
//   and one write of 2 an element, where the plain route's passes over fp32
//   temporaries move 36 (RMSNorm) and 64 (LayerNorm).
//
// B5 and B6 have two more modes for a row split over tensor-parallel ranks
// (each rank holds some of the row's columns), so that the codes are those of
// the whole row: with codes == nullptr the kernel writes the raw row absmax
// (no amax := 1; the ranks' values go to a MAX all-reduce), and with a given
// amax_in (the all-reduced, tp-global amax) it skips the row reduction and
// writes codes = rint(y * (127 / amax)) with that amax (amax := 1 for zero)
// in one pass, and copies the amax out.
//
// All emit codes = rint(y * (127 / amax)) (round half to even) with
// amax := 1 for an all-zero row, and write amax itself as the row scale.
// The arithmetic uses the _rn intrinsics (IEEE division, sqrt, reciprocal,
// no FMA contraction) and IEEE expf, so each element is computed as the
// plain PyTorch version computes it. Only the row sums of B4 (x^2) and B9 (x,
// then xc^2) are taken in another order than the plain version's torch.sum,
// which can move a code by one at a rounding boundary.
//
// What bounds them on an H100: a few operations per element against 2 bytes
// read and 1 written (B5: 4 read, 1 written), far below the card's ~295
// operations-per-byte ridge, so they are bound by memory bytes.
//
// B4, B9 and the norm mode stream. A persistent grid (as many blocks as fit
// the SMs) walks tiles of R consecutive rows; a tile of the contiguous (M, H)
// input is one span of R * H * sizeof(T) bytes (at most 32 KiB), which ONE
// cp.async.bulk brings into a ring of S = 2 stages in shared memory, issued
// by one thread of a producer warp. The R consumer warps (7 up to H = 2048, 4 beyond) own
// one row of a tile each: the row goes into registers with 16-byte loads
// (lane l holds the 8-element chunks l, l + 32, ...; NV chunks at most, all
// of them without a branch where H = 256 NV), the stage is released once the
// first pass has used the values, and the row's sums and max are warp
// shuffles, with no block barrier in the row math; B9's centred variance is
// a second pass over the registers. The weight and bias are widened to fp32
// once per block into shared memory, from bf16 or f32. The codes of a tile
// go to one of two staging buffers and leave by one bulk store of R * H
// bytes; the amax values are stored directly. The norm mode stages its bf16
// row the same way and stores R * H * 2 bytes a tile.
// ops/quant_epilogue.py:tile_plan sizes R and the shared memory (norm mode:
// ops/norms.py:norm_plan). On an H100 the kernel was paced by its row
// math more than by the bytes in flight: more stages or more, smaller blocks
// ran slower (tools/epilogue_timing.py --sweep), while a branch per chunk
// (which also pulled the row's divisions into every chunk) and one bf16
// conversion per value, in place of one per pair, were slower still.
//
// B6 (redesigned for Hopper): what bounds it is bytes, 2 (bf16) or 4 (f32)
// read and 1 written an element, with one max and one multiply an element;
// at the rows it meets (a tp rank's 14336 x 1792 is 51 MB, 15 us at 3.35
// TB/s) the host's launch path also counts. It takes one of two forms:
//   the warp form, H a multiple of 16 up to 3584: norm_quant_kernel with
//   OP_ROW, B4's persistent streaming template with no weight and no first
//   pass (tiles of R rows by one bulk copy into the 2-stage ring, a warp a
//   row); the row stays in registers as it came (bf16: half the registers of
//   its fp32 widening), its max is taken by shuffles and its codes leave
//   straight from the registers with 8-byte stores: no staging, no bulk
//   store and no block barrier a tile. At 1536, 1792 and 2560 (a tp-2 rank's
//   o_proj) a lane holds 6, 7 or 10 whole chunks (FULL instantiations B6
//   alone has: they ran 1-6 % faster than the branch a chunk);
//   the block form, any other multiple of 8 (4096 and 5120, the 6912-18944
//   wide rows): a block of 256 threads a row that reads the row once with
//   16-byte loads and, in the whole-row mode, keeps it in shared memory as
//   it came (37 KB of bf16 at 18944, where the fp32 widening of the kernel
//   before the redesign took 74 KB; a row above 112 KiB is read again
//   instead). That kernel already read 77-94 % of its bound at every wide
//   shape on an H100 and outran the warp form at 4096 and 5120; a
//   persistent block with a bulk-copy ring of whole rows read slower at the
//   wide shapes and was dropped (PERF.md).
// In the absmax mode neither writes codes; in the given-amax mode neither
// reduces. ops/quant_epilogue.py:row_plan chooses the form, R and S; the
// warp form's grid comes from one occupancy query a plan, and the kernels'
// attributes are set once per kernel and device, not per launch.
//
// B5: one block of 256 threads owns one row: it reads the row once from
// device memory with 16-byte loads, keeps the fp32 values in shared memory
// (32 KB at I = 8192), reduces in registers and shared memory, and writes the
// codes with 8-byte stores. The absmax-only and given-amax modes keep nothing
// in shared memory: the first reads the row and reduces, the second reads it
// and writes its codes.
#include <mutex>
#include <utility>
#include <vector>

#include "common.cuh"
#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;  // threads per block of B5 and of B6's block form; a block a row

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

// ------------------------------------------------------------------ B4, B9

constexpr int NQ_HEAD = 128;         // the ring's barriers, before the ring
constexpr int NQ_SMEM_MAX = 232448;  // 227 KiB, a block's most
constexpr int OP_RMS = 0, OP_LN = 1, OP_ROW = 2;  // norm_quant_kernel's operation
constexpr int OP_RMS_NORM = 3, OP_LN_NORM = 4;     // ... in the norm mode: the row, no codes

// The kernels' shared-memory attributes, set once per kernel and device, not
// on every launch: the most dynamic shared memory the card allows beside the
// kernel's static array, and (carveout) the L1 / shared split all shared.
int set_smem_once(const void* kernel, bool carveout) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& d : done)
    if (d.first == kernel && d.second == dev) return 0;
  int optin = 0;
  cudaFuncAttributes fa;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);
  if (e == cudaSuccess && carveout)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  done.emplace_back(kernel, dev);
  return 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;  // the same bits in every lane: each step adds the same two values
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// a lane's 8 partial sums (one per position in its chunks) in a fixed tree
__device__ __forceinline__ float sum8(const float (&p)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])),
                   __fadd_rn(__fadd_rn(p[4], p[5]), __fadd_rn(p[6], p[7])));
}

// rint(v) for |v| <= 2^22 as the low byte of a float's bits: adding 1.5 * 2^23
// leaves a float whose unit is 1, rounded half to even as rintf rounds, and
// whose low byte is the int8 code
__device__ __forceinline__ uint32_t code_bits(float v) {
  return __float_as_uint(__fadd_rn(v, 12582912.f));
}

__device__ __forceinline__ uint32_t pack_codes(float a, float b, float c, float d) {
  return __byte_perm(__byte_perm(code_bits(a), code_bits(b), 0x0040),
                     __byte_perm(code_bits(c), code_bits(d), 0x0040), 0x5410);
}

// the codes of 4 values, q = 127 / amax, packed
__device__ __forceinline__ uint32_t codes4(const float* v, float q) {
  return pack_codes(__fmul_rn(v[0], q), __fmul_rn(v[1], q), __fmul_rn(v[2], q),
                    __fmul_rn(v[3], q));
}

// B6's 8 values of a row as they are read (16 bytes of bf16: half the
// registers of their fp32 widening), widened where used
template <typename T>
struct Raw8;
template <>
struct Raw8<bf16> {
  uint4 u;
};
template <>
struct Raw8<float> {
  float4 a, b;
};

template <typename T>
__device__ __forceinline__ Raw8<T> load_raw(const T* p);
template <>
__device__ __forceinline__ Raw8<bf16> load_raw<bf16>(const bf16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}
template <>
__device__ __forceinline__ Raw8<float> load_raw<float>(const float* p) {
  return {*reinterpret_cast<const float4*>(p), *reinterpret_cast<const float4*>(p + 4)};
}

__device__ __forceinline__ void widen(const Raw8<bf16>& r, float* v) {
  lrt::Vec8 w;
  w.u = r.u;
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(w.h[e]);
}
__device__ __forceinline__ void widen(const Raw8<float>& r, float* v) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

template <typename T>
__device__ __forceinline__ float abs_max8(const Raw8<T>& r) {
  float v[8];
  widen(r, v);
  return fmaxf(fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3]))),
               fmaxf(fmaxf(fabsf(v[4]), fabsf(v[5])), fmaxf(fabsf(v[6]), fabsf(v[7]))));
}

// the fp32 weight of chunk c (8 elements) from its two 16-byte halves: the
// first four elements of every chunk lie in wsm[0, H/2), the last four in
// wsm[H/2, H), so that a warp's loads of consecutive chunks are contiguous
__device__ __forceinline__ void weight8(const float* wsm, int H, int c, float (&wv)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(wsm + c * 4);
  const float4 hi = *reinterpret_cast<const float4*>(wsm + H / 2 + c * 4);
  wv[0] = lo.x; wv[1] = lo.y; wv[2] = lo.z; wv[3] = lo.w;
  wv[4] = hi.x; wv[5] = hi.y; wv[6] = hi.z; wv[7] = hi.w;
}

// Whether lane holds chunk k of a row of nch chunks: always, when the row is
// exactly 32 NV chunks (FULL: the model widths 1024, 3072, 3584 and 5120 are);
// otherwise by a branch per chunk, into each of which the compiler also
// sinks the row's divisions (on an H100 the unbranched form is the faster).
template <bool FULL>
__device__ __forceinline__ bool holds(int lane, int k, int nch) {
  return FULL || lane + 32 * k < nch;
}

// The first pass over a row in registers, per position e of the chunks:
// B4 sums x^2, B9 sums x.
template <bool LN, bool FULL, int NV>
__device__ __forceinline__ void first_pass(const float (&v)[NV][8], int nch, int lane,
                                           float (&p)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) p[e] = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (holds<FULL>(lane, k, nch)) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        p[e] = __fadd_rn(p[e], LN ? v[k][e] : __fmul_rn(v[k][e], v[k][e]));
    }
}

// B4's row from the first pass p: v becomes y; returns the row's max |y|.
// bf16 input rounds twice (Phi-3's cast order), two values to one packed
// conversion at a time.
template <typename T, bool FULL, int NV>
__device__ __forceinline__ float rms_row(float (&v)[NV][8], const float (&p)[8],
                                         const float* wsm, int H, int lane, float eps) {
  const int nch = H / 8;
  const float var = __fdiv_rn(warp_sum(sum8(p)), (float)H);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  float mx = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (holds<FULL>(lane, k, nch)) {
      float wv[8];
      weight8(wsm, H, lane + 32 * k, wv);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float y0 = __fmul_rn(v[k][e], inv), y1 = __fmul_rn(v[k][e + 1], inv);
        if (sizeof(T) == 2) {
          const __nv_bfloat162 r = __floats2bfloat162_rn(y0, y1);
          const __nv_bfloat162 z = __floats2bfloat162_rn(__fmul_rn(wv[e], __low2float(r)),
                                                         __fmul_rn(wv[e + 1], __high2float(r)));
          y0 = __low2float(z);
          y1 = __high2float(z);
        } else {
          y0 = __fmul_rn(wv[e], y0);
          y1 = __fmul_rn(wv[e + 1], y1);
        }
        v[k][e] = y0;
        v[k][e + 1] = y1;
        mx = fmaxf(mx, fmaxf(fabsf(y0), fabsf(y1)));
      }
    }
  return warp_max(mx);
}

// B9's row from the first pass p: v becomes y; returns the row's max |y|
// (MX; the norm mode takes no max and gets 0)
template <bool FULL, int NV, bool MX = true>
__device__ __forceinline__ float ln_row(float (&v)[NV][8], const float (&p)[8],
                                        const float* wsm, int H, int lane, float eps) {
  const int nch = H / 8;
  const float mean = __fdiv_rn(warp_sum(sum8(p)), (float)H);
  float q[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (holds<FULL>(lane, k, nch)) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[k][e] = __fsub_rn(v[k][e], mean);
        q[e] = __fadd_rn(q[e], __fmul_rn(v[k][e], v[k][e]));
      }
    }
  const float var = __fdiv_rn(warp_sum(sum8(q)), (float)H);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  float mx = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (holds<FULL>(lane, k, nch)) {
      float wv[8], bv[8];
      weight8(wsm, H, lane + 32 * k, wv);
      weight8(wsm + H, H, lane + 32 * k, bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(v[k][e], inv), wv[e]), bv[e]);
        v[k][e] = y;
        if (MX) mx = fmaxf(mx, fabsf(y));
      }
    }
  return MX ? warp_max(mx) : 0.f;
}

// The norm mode's RMSNorm row from the first pass p, as ops/norms.rms_norm
// computes it (Phi-3's cast order): y = x * 1/sqrt(var+eps) rounded to bf16,
// then w * y in fp32 (v becomes it); store_row rounds it to bf16 once more.
// The arithmetic is B4's for bf16 input.
template <bool FULL, int NV>
__device__ __forceinline__ void rms_norm_row(float (&v)[NV][8], const float (&p)[8],
                                             const float* wsm, int H, int lane, float eps) {
  const int nch = H / 8;
  const float var = __fdiv_rn(warp_sum(sum8(p)), (float)H);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (holds<FULL>(lane, k, nch)) {
      float wv[8];
      weight8(wsm, H, lane + 32 * k, wv);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const __nv_bfloat162 r =
            __floats2bfloat162_rn(__fmul_rn(v[k][e], inv), __fmul_rn(v[k][e + 1], inv));
        v[k][e] = __fmul_rn(wv[e], __low2float(r));
        v[k][e + 1] = __fmul_rn(wv[e + 1], __high2float(r));
      }
    }
}

// The norm mode's row from registers into its staging tile, chunk c = lane
// + 32 k at its place in the row: 8 bf16 values (16 bytes, rounded to
// nearest even).
template <bool FULL, int NV>
__device__ __forceinline__ void store_row(const float (&v)[NV][8], int nch, int lane,
                                          unsigned char* out) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (holds<FULL>(lane, k, nch)) {
      union {
        uint4 u;
        __nv_bfloat162 h[4];
      } w;
#pragma unroll
      for (int e = 0; e < 4; ++e) w.h[e] = __floats2bfloat162_rn(v[k][2 * e], v[k][2 * e + 1]);
      *reinterpret_cast<uint4*>(out + (size_t)(lane + 32 * k) * 16) = w.u;
    }
}

// Consumer warps a block at most: 7 where a lane holds up to 8 chunks (a
// block of 8 warps with its producer), 4 beyond. Rows of up to 4 chunks a
// lane fit in 128 registers a thread, two blocks an SM; the wider ones may
// take all 255: on an H100 the kernel ran faster so (one block of 5 warps an
// SM at H = 3072) than with more blocks of fewer registers each.
template <int NV>
constexpr int nq_rows_max() {
  return NV <= 8 ? 7 : 4;
}

// x (M, H) contiguous; w (and b, OP_LN) (H,) bf16 or f32 (wflags bit 0: w
// is bf16, bit 1: b is bf16) -> codes (M, H), amax (M,). blockDim = 32 (R +
// 1): warps 0..R-1 consume, warp R produces. H % 16 == 0 and H <= 256 NV.
// OP_ROW (B6) reads no weight; with codes == nullptr it writes the raw row
// absmax alone, and with amax_in it writes the codes on that amax. The norm
// mode (OP_RMS_NORM, OP_LN_NORM) writes the normalised row to codes' bytes
// as (M, H) bf16, and no amax.
template <typename T, int OP, int NV, bool FULL>
__global__ void __launch_bounds__(32 * (nq_rows_max<NV>() + 1), NV <= 4 ? 2 : 1)
    norm_quant_kernel(const T* __restrict__ x, const void* __restrict__ w,
                      const void* __restrict__ b, int wflags, int8_t* __restrict__ codes,
                      float* __restrict__ amax_out, const float* __restrict__ amax_in, int M,
                      int H, float eps, int R, int S) {
  constexpr bool NORM = OP == OP_RMS_NORM || OP == OP_LN_NORM;
  constexpr bool LN = OP == OP_LN || OP == OP_LN_NORM, ROW = OP == OP_ROW;
  const bool absmax_only = ROW && codes == nullptr, given = ROW && amax_in != nullptr;
  // bytes an output element: a code, or the norm mode's bf16 value
  constexpr int ob = NORM ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  const int row_bytes = H * (int)sizeof(T);
  const int stage_bytes = R * row_bytes;
  unsigned char* ring = smem + NQ_HEAD;
  int8_t* staging = reinterpret_cast<int8_t*>(ring + (size_t)S * stage_bytes);  // two tiles
  float* wsm = reinterpret_cast<float*>(staging + 2 * R * H * ob);  // w, then b (LN)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (M + R - 1) / R;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], R);
    }
    sm90::mbar_init_fence();
  }
  for (int i = threadIdx.x; i < (ROW ? 0 : H); i += blockDim.x) {
    const int at = (i % 8 < 4 ? 0 : H / 2) + (i / 8) * 4 + i % 4;
    wsm[at] = (wflags & 1) ? __bfloat162float(static_cast<const bf16*>(w)[i])
                           : static_cast<const float*>(w)[i];
    if (LN)
      wsm[H + at] = (wflags & 2) ? __bfloat162float(static_cast<const bf16*>(b)[i])
                                 : static_cast<const float*>(b)[i];
  }
  __syncthreads();

  if (warp == R) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      int j = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++j) {
        const int s = j % S;
        if (j >= S) sm90::mbar_wait(&empty[s], (j / S - 1) & 1);
        const uint32_t bytes = (uint32_t)(min(R, M - t * R) * row_bytes);  // the tail: fewer
        sm90::mbar_expect_tx(&full[s], bytes);
        sm90::bulk_load(ring + (size_t)s * stage_bytes, x + (long long)t * R * H, bytes,
                        &full[s]);
      }
    }
    return;
  }

  const int nch = H / 8;
  if constexpr (ROW) {
    // B6: a warp's row stays in registers as it came (16 bytes a chunk), its
    // max is taken by shuffles, and its codes go straight to device memory
    // from the registers, 8 bytes a chunk: no staging and no block barrier
    for (int t = blockIdx.x, j = 0; t < n_tiles; t += gridDim.x, ++j) {
      const int s = j % S;
      const long long row = (long long)t * R + warp;
      const bool live = warp < min(R, M - t * R);
      Raw8<T> r[NV];
      float mx = 0.f;
      sm90::mbar_wait(&full[s], (j / S) & 1);
      if (live) {
        const T* xr = reinterpret_cast<const T*>(ring + (size_t)s * stage_bytes +
                                                 (size_t)warp * row_bytes);
#pragma unroll
        for (int k = 0; k < NV; ++k)
          if (holds<FULL>(lane, k, nch)) r[k] = load_raw<T>(xr + (lane + 32 * k) * 8);
      }
      sm90::fence_async_smem();  // as below: the loads, before the stage is released
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
      if (!live) continue;
      if (!given) {
#pragma unroll
        for (int k = 0; k < NV; ++k)
          if (holds<FULL>(lane, k, nch)) mx = fmaxf(mx, abs_max8(r[k]));
        mx = warp_max(mx);
      }
      if (absmax_only) {  // the raw row absmax: one float a row
        if (lane == 0) amax_out[row] = mx;
        continue;
      }
      if (given) mx = amax_in[row];
      const float amax = mx > 0.f ? mx : 1.f;
      const float q = __fdiv_rn(127.f, amax);
      int8_t* cr = codes + row * H;
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (holds<FULL>(lane, k, nch)) {
          float v[8];
          widen(r[k], v);
          const uint2 u = {codes4(v, q), codes4(v + 4, q)};
          *reinterpret_cast<uint2*>(cr + (lane + 32 * k) * 8) = u;
        }
      if (lane == 0) amax_out[row] = amax;
    }
    return;
  }
  int j = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++j) {
    const int s = j % S;
    const bool live = warp < min(R, M - t * R);
    float v[NV][8], p[8];
    sm90::mbar_wait(&full[s], (j / S) & 1);
    if (live) {
      const T* xr = reinterpret_cast<const T*>(ring + (size_t)s * stage_bytes +
                                               (size_t)warp * row_bytes);
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (holds<FULL>(lane, k, nch)) load8<T>(xr + (lane + 32 * k) * 8, v[k]);
      first_pass<LN, FULL, NV>(v, nch, lane, p);
    }
    // The stage is released after a proxy fence: the next bulk copy writes it
    // through the async proxy, to which these loads (the generic proxy) are
    // not ordered otherwise. Without it a copy overwrote chunks that loads in
    // flight had not read (seen on an H100 with f32 tiles of 32 KiB: a few
    // chunks of some rows wrong).
    sm90::fence_async_smem();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);

    // the staging buffer of this tile was read by the bulk store of two
    // tiles ago, which the barrier of the last tile waited for
    int8_t* st = staging + (j & 1) * R * H * ob;
    if (live) {
      if constexpr (NORM) {
        if constexpr (LN)
          ln_row<FULL, NV, false>(v, p, wsm, H, lane, eps);
        else
          rms_norm_row<FULL, NV>(v, p, wsm, H, lane, eps);
        store_row<FULL, NV>(v, nch, lane,
                            reinterpret_cast<unsigned char*>(st) + (size_t)warp * H * ob);
      } else {
        const float mx =
            LN ? ln_row<FULL, NV>(v, p, wsm, H, lane, eps)
               : rms_row<T, FULL, NV>(v, p, wsm, H, lane, eps);
        const float amax = mx > 0.f ? mx : 1.f;
        const float q = __fdiv_rn(127.f, amax);
        int8_t* cr = st + warp * H;
#pragma unroll
        for (int k = 0; k < NV; ++k)
          if (holds<FULL>(lane, k, nch)) {
            uint2 u;
            u.x = pack_codes(__fmul_rn(v[k][0], q), __fmul_rn(v[k][1], q),
                             __fmul_rn(v[k][2], q), __fmul_rn(v[k][3], q));
            u.y = pack_codes(__fmul_rn(v[k][4], q), __fmul_rn(v[k][5], q),
                             __fmul_rn(v[k][6], q), __fmul_rn(v[k][7], q));
            *reinterpret_cast<uint2*>(cr + (lane + 32 * k) * 8) = u;
          }
        if (lane == 0) amax_out[(long long)t * R + warp] = amax;
      }
    }
    sm90::fence_async_smem();  // the codes written here, seen by the bulk store
    if (threadIdx.x == 0) sm90::bulk_wait_read();  // the last tile's store has read its buffer
    sm90::bar_sync(1, 32 * R);
    if (threadIdx.x == 0) {
      sm90::bulk_store(codes + (long long)t * R * H * ob, st,
                       (uint32_t)(min(R, M - t * R) * H * ob));
      sm90::bulk_commit();
    }
  }
  if (threadIdx.x == 0) sm90::bulk_wait();  // the stores are done before the block's memory goes
}

// Dynamic shared memory of a plan: barriers, S stages of R rows, two staging
// tiles of codes, the fp32 weight (and bias). ops/quant_epilogue.py:tile_plan
// computes the same.
inline size_t nq_smem(int H, int elem, bool ln, int R, int S) {
  return NQ_HEAD + (size_t)S * R * H * elem + 2 * (size_t)R * H + (size_t)H * 4 * (ln ? 2 : 1);
}

template <typename T, bool LN, int NV, bool FULL>
int launch_norm_quant(const T* x, const void* w, const void* b, int wflags, int8_t* codes,
                      float* amax, int M, int H, float eps, int R, int S, cudaStream_t st) {
  auto kernel = norm_quant_kernel<T, LN ? OP_LN : OP_RMS, NV, FULL>;
  const size_t smem = nq_smem(H, (int)sizeof(T), LN, R, S);
  if (smem > (size_t)NQ_SMEM_MAX || R > nq_rows_max<NV>())
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = (cudaError_t)set_smem_once((const void*)kernel, true);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * (R + 1), smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (M + R - 1) / R;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  kernel<<<grid, 32 * (R + 1), smem, st>>>(x, w, b, wflags, codes, amax, nullptr, M, H, eps, R,
                                            S);
  return (int)cudaGetLastError();
}

// the instantiation that holds H / 8 chunks in NV per lane, FULL where exactly
template <typename T, bool LN>
int norm_quant(const void* x, const void* w, const void* b, int wflags, void* codes,
               void* amax, int M, int H, float eps, int R, int S, cudaStream_t st) {
  if (H <= 0 || H % 16 || R < 1 || S < 1 || 2 * S * 8 > NQ_HEAD)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const T* xp = static_cast<const T*>(x);
  int8_t* cp = static_cast<int8_t*>(codes);
  float* ap = static_cast<float*>(amax);
  const int nv = (H / 8 + 31) / 32;
#define LRT_NQ(N)                                                                          \
  if (nv <= N)                                                                             \
    return H == 256 * N                                                                    \
               ? launch_norm_quant<T, LN, N, true>(xp, w, b, wflags, cp, ap, M, H, eps, R, S, st) \
               : launch_norm_quant<T, LN, N, false>(xp, w, b, wflags, cp, ap, M, H, eps, R, S, st)
  LRT_NQ(1);
  LRT_NQ(2);
  LRT_NQ(4);
  LRT_NQ(8);
  LRT_NQ(12);
  LRT_NQ(14);
  LRT_NQ(16);
  LRT_NQ(20);
#undef LRT_NQ
  return (int)cudaErrorInvalidValue;  // wider than 5120
}

// ------------------------------------------------------------------ B5, B6

// y of B5 for 8 consecutive columns of a row: silu(g) * u in fp32, rounded
// to bf16 for bf16 input.
template <typename T>
__device__ __forceinline__ void silu_mul8(const T* gr, int I, int c, float* y) {
  float g[8], u[8];
  load8<T>(gr + c * 8, g);
  load8<T>(gr + I + c * 8, u);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g[e])));
    y[e] = __fmul_rn(__fmul_rn(g[e], sig), u[e]);
    if (sizeof(T) == 2) y[e] = bf16_round(y[e]);
  }
}

// Codes of 8 values on the row's amax (given mode): q = 127 / amax.
__device__ __forceinline__ void store_codes8(const float* v, float q, int8_t* codes) {
  union {
    uint2 u;
    int8_t b[8];
  } w;
#pragma unroll
  for (int e = 0; e < 8; ++e) w.b[e] = (int8_t)rintf(__fmul_rn(v[e], q));
  *reinterpret_cast<uint2*>(codes) = w.u;
}

// B5. Modes: codes and amax of the row (amax_in == nullptr, codes set); the
// raw row absmax alone (codes == nullptr); codes on a given amax (amax_in).
template <typename T>
__global__ void __launch_bounds__(NT)
    silu_mul_quant_kernel(const T* __restrict__ gu, int8_t* __restrict__ codes,
                          float* __restrict__ amax_out, const float* __restrict__ amax_in,
                          int I) {
  extern __shared__ float ys[];
  __shared__ float red[NT / 32];
  const long long row = blockIdx.x;
  const T* gr = gu + row * 2LL * I;
  if (amax_in != nullptr) {
    const float amax = amax_in[row] > 0.f ? amax_in[row] : 1.f;
    const float q = __fdiv_rn(127.f, amax);
    for (int c = threadIdx.x; c < I / 8; c += NT) {
      float y[8];
      silu_mul8<T>(gr, I, c, y);
      store_codes8(y, q, codes + row * I + c * 8);
    }
    if (threadIdx.x == 0) amax_out[row] = amax;
    return;
  }
  float mx = 0.f;
  for (int c = threadIdx.x; c < I / 8; c += NT) {
    float y[8];
    silu_mul8<T>(gr, I, c, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (codes != nullptr) ys[c * 8 + e] = y[e];
      mx = fmaxf(mx, fabsf(y[e]));
    }
  }
  mx = block_reduce<true>(mx, red);
  if (codes == nullptr) {
    if (threadIdx.x == 0) amax_out[row] = mx;
    return;
  }
  write_codes(ys, I, mx, codes + row * I, amax_out + row);
}

// ------------------------------------------------------------------ B6

// B6's block form, for the rows the warp form does not take (wider than
// 3584, or 8 k but not 16 k wide): one block of 256 threads a row, which
// reads the row once with 16-byte loads and, in the whole-row mode, keeps it
// (keep) in shared memory as it came for its codes after the block's max (37
// KB of bf16 at H = 18944, where its fp32 widening took 74 KB); a row too
// large to keep is read again for its codes. The absmax and given-amax modes
// keep nothing.
template <typename T>
__global__ void __launch_bounds__(NT, 8)  // 32 registers: eight blocks an SM
    row_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
                     float* __restrict__ amax_out, const float* __restrict__ amax_in, int H,
                     int keep) {
  extern __shared__ __align__(16) unsigned char xs[];
  __shared__ float red[NT / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * H;
  Raw8<T>* rs = reinterpret_cast<Raw8<T>*>(xs);
  float v[8];
  if (amax_in != nullptr) {
    const float amax = amax_in[row] > 0.f ? amax_in[row] : 1.f;
    const float q = __fdiv_rn(127.f, amax);
    for (int c = threadIdx.x; c < H / 8; c += NT) {
      widen(load_raw<T>(xr + c * 8), v);
      *reinterpret_cast<uint2*>(codes + row * H + c * 8) = {codes4(v, q), codes4(v + 4, q)};
    }
    if (threadIdx.x == 0) amax_out[row] = amax;
    return;
  }
  float mx = 0.f;
  for (int c = threadIdx.x; c < H / 8; c += NT) {
    const Raw8<T> r = load_raw<T>(xr + c * 8);
    if (keep) rs[c] = r;
    mx = fmaxf(mx, abs_max8(r));
  }
  mx = block_reduce<true>(mx, red);
  if (codes == nullptr) {
    if (threadIdx.x == 0) amax_out[row] = mx;
    return;
  }
  const float amax = mx > 0.f ? mx : 1.f;
  const float q = __fdiv_rn(127.f, amax);
  for (int c = threadIdx.x; c < H / 8; c += NT) {
    widen(keep ? rs[c] : load_raw<T>(xr + c * 8), v);
    *reinterpret_cast<uint2*>(codes + row * H + c * 8) = {codes4(v, q), codes4(v + 4, q)};
  }
  if (threadIdx.x == 0) amax_out[row] = amax;
}

// B6's kernel for a plan: form 0 (the warp form, norm_quant_kernel OP_ROW at
// NV chunks a lane, FULL where H == 256 NV) or 1 (the block form); nullptr
// for a plan no instantiation takes.
template <typename T>
const void* row_kernel_t(int form, int nv, int H) {
  if (form == 1) return (const void*)row_quant_kernel<T>;
  if (form != 0 || H > 256 * nv) return nullptr;
#define LRT_RQ(N)                                                             \
  if (nv == N)                                                                \
    return H == 256 * N ? (const void*)norm_quant_kernel<T, OP_ROW, N, true> \
                        : (const void*)norm_quant_kernel<T, OP_ROW, N, false>;
#define LRT_RQ_FULL(N) \
  if (nv == N) return H == 256 * N ? (const void*)norm_quant_kernel<T, OP_ROW, N, true> : nullptr;
  LRT_RQ(1);
  LRT_RQ(2);
  LRT_RQ(4);
  LRT_RQ_FULL(6);
  LRT_RQ_FULL(7);
  LRT_RQ(8);
  LRT_RQ_FULL(10);
  LRT_RQ(12);
  LRT_RQ(14);
#undef LRT_RQ
#undef LRT_RQ_FULL
  return nullptr;
}

inline int rq_rows_max(int nv) { return nv <= 8 ? 7 : 4; }  // nq_rows_max<NV>()

// A plan's kernel, threads a block and dynamic shared memory, checked;
// nullptr for a plan the kernels do not take. keep: the block form keeps the
// row in shared memory (whole-row mode).
const void* row_plan_kernel(int is_bf16, int form, int nv, int H, int rows, int stages,
                            bool keep, int* threads, size_t* smem) {
  const size_t elem = is_bf16 ? 2 : 4;
  if (H <= 0 || H % 8) return nullptr;
  if (form == 0) {
    if (H % 16 || rows < 1 || rows > rq_rows_max(nv) || stages < 1 || 2 * stages * 8 > NQ_HEAD)
      return nullptr;
    *threads = 32 * (rows + 1);
    *smem = NQ_HEAD + (size_t)stages * rows * H * elem;
  } else {
    *threads = NT;
    *smem = keep ? (size_t)H * elem : 0;
  }
  if (*smem > (size_t)NQ_SMEM_MAX) return nullptr;
  return is_bf16 ? row_kernel_t<bf16>(form, nv, H) : row_kernel_t<float>(form, nv, H);
}

// ------------------------------------------------------------------ the norm mode

// The norm mode's kernel at nv chunks a lane, FULL where H == 256 nv (at 5
// chunks, Qwen2.5-VL's vision width 1280, the whole-lane form alone); nullptr
// for a plan no instantiation takes. LayerNorm runs in the vision towers
// alone, so its ladder stops at 8 chunks (H <= 2048); RMSNorm's is B4's.
template <int OP>
const void* norm_kernel_t(int nv, int H) {
  if (H > 256 * nv) return nullptr;
#define LRT_NM(N)                                                            \
  if (nv == N)                                                               \
    return H == 256 * N ? (const void*)norm_quant_kernel<bf16, OP, N, true> \
                        : (const void*)norm_quant_kernel<bf16, OP, N, false>;
  LRT_NM(1);
  LRT_NM(2);
  LRT_NM(4);
  if (nv == 5) return H == 256 * 5 ? (const void*)norm_quant_kernel<bf16, OP, 5, true> : nullptr;
  LRT_NM(8);
  if constexpr (OP == OP_RMS_NORM) {
    LRT_NM(12);
    LRT_NM(14);
    LRT_NM(16);
    LRT_NM(20);
  }
#undef LRT_NM
  return nullptr;
}

// A norm-mode plan's kernel and dynamic shared memory (barriers, S stages of
// R bf16 rows, two staging tiles of the bf16 output, the fp32 weight and
// bias), checked; nullptr for a plan the kernels do not take.
const void* norm_plan_kernel(int ln, int nv, int H, int rows, int stages, size_t* smem) {
  if (H <= 0 || H % 16 || rows < 1 || rows > rq_rows_max(nv) || stages < 1 ||
      2 * stages * 8 > NQ_HEAD)
    return nullptr;
  *smem = NQ_HEAD + (size_t)stages * rows * H * 2 + 2 * (size_t)rows * H * 2 +
          (size_t)H * 4 * (ln ? 2 : 1);
  if (*smem > (size_t)NQ_SMEM_MAX) return nullptr;
  return ln ? norm_kernel_t<OP_LN_NORM>(nv, H) : norm_kernel_t<OP_RMS_NORM>(nv, H);
}

// The blocks of a persistent kernel that fit the card at once (blocks an SM
// x SMs) at threads a block and smem bytes, or minus a CUDA error; also sets
// the kernel's shared-memory attributes.
int blocks_at_once(const void* kernel, int threads, size_t smem) {
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = (cudaError_t)set_smem_once(kernel, true);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  return per_sm * sms;
}

// Launch one block of NT threads per row with smem bytes of dynamic shared
// memory.
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int M, size_t smem, cudaStream_t st, Args... args) {
  if (M == 0) return 0;
  const int e = set_smem_once((const void*)kernel, false);
  if (e != 0) return e;
  kernel<<<M, NT, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// B4: x (M, H) bf16 (x_bf16) or f32, weight (H,) bf16 (w_bf16) or f32 ->
// codes (M, H) int8, amax (M,) f32. H a multiple of 16, at most 5120; x
// 16-byte aligned; R rows a tile, S stages (ops/quant_epilogue.py:tile_plan).
extern "C" int lrt_rms_quant(const void* x, const void* w, void* codes, void* amax, int M,
                             int H, float eps, int x_bf16, int w_bf16, int R, int S,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wf = w_bf16 ? 1 : 0;
  if (x_bf16) return norm_quant<bf16, false>(x, w, nullptr, wf, codes, amax, M, H, eps, R, S, st);
  return norm_quant<float, false>(x, w, nullptr, wf, codes, amax, M, H, eps, R, S, st);
}

// B9: as B4, with a bias (H,) bf16 (b_bf16) or f32.
extern "C" int lrt_ln_quant(const void* x, const void* w, const void* b, void* codes,
                            void* amax, int M, int H, float eps, int x_bf16, int w_bf16,
                            int b_bf16, int R, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wf = (w_bf16 ? 1 : 0) | (b_bf16 ? 2 : 0);
  if (x_bf16) return norm_quant<bf16, true>(x, w, b, wf, codes, amax, M, H, eps, R, S, st);
  return norm_quant<float, true>(x, w, b, wf, codes, amax, M, H, eps, R, S, st);
}

// B5: gate_up (M, 2I) bf16 or f32 -> codes (M, I) int8, amax (M,) f32. With
// codes null: the raw row absmax only; with amax_in (M,) f32: codes on it.
extern "C" int lrt_silu_mul_quant(const void* gate_up, void* codes, void* amax,
                                  const void* amax_in, int M, int I, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* cp = static_cast<int8_t*>(codes);
  float* ap = static_cast<float*>(amax);
  const float* ai = static_cast<const float*>(amax_in);
  // whole-row codes stage the row's fp32 values in shared memory
  const size_t smem = cp != nullptr && ai == nullptr ? (size_t)I * sizeof(float) : 0;
  if (is_bf16)
    return launch_rows(silu_mul_quant_kernel<bf16>, M, smem, st,
                       static_cast<const bf16*>(gate_up), cp, ap, ai, I);
  return launch_rows(silu_mul_quant_kernel<float>, M, smem, st,
                     static_cast<const float*>(gate_up), cp, ap, ai, I);
}

// B6: x (M, H) bf16 or f32 -> codes (M, H) int8, amax (M,) f32; with codes
// null the raw row absmax only; with amax_in (M,) f32 the codes on it. The
// plan (form, nv, rows, stages, keep) and the grid (the warp form's: tiles,
// at most the blocks lrt_row_quant_blocks reports; the block form's: M)
// come from ops/quant_epilogue.py:row_plan; x 16-byte aligned.
extern "C" int lrt_row_quant(const void* x, void* codes, void* amax, const void* amax_in, int M,
                             int H, int is_bf16, int form, int nv, int rows, int stages, int keep,
                             int grid, void* stream) {
  int threads = 0;
  size_t smem = 0;
  keep = keep && codes != nullptr && amax_in == nullptr;  // only whole rows are kept
  const void* kernel =
      row_plan_kernel(is_bf16, form, nv, H, rows, stages, keep, &threads, &smem);
  if (kernel == nullptr || grid < 1) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int e = set_smem_once(kernel, form == 0);
  if (e != 0) return e;
  const void* w = nullptr;
  int wflags = 0;
  float eps = 0.f;
  void* args_warp[] = {(void*)&x, (void*)&w, (void*)&w, &wflags, &codes, &amax,
                       (void*)&amax_in, &M, &H, &eps, &rows, &stages};
  void* args_block[] = {(void*)&x, &codes, &amax, (void*)&amax_in, &H, &keep};
  const cudaError_t err = cudaLaunchKernel(kernel, dim3(grid), dim3(threads),
                                           form == 0 ? args_warp : args_block, smem,
                                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();  // not left for the next launch's check
  return (int)err;
}

// The warp form's blocks of a B6 plan that fit the card at once (blocks an
// SM x SMs), or minus a CUDA error; also sets the kernel's shared-memory
// attributes.
extern "C" int lrt_row_quant_blocks(int is_bf16, int nv, int H, int rows, int stages) {
  int threads = 0;
  size_t smem = 0;
  const void* kernel =
      row_plan_kernel(is_bf16, 0, nv, H, rows, stages, false, &threads, &smem);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  return blocks_at_once(kernel, threads, smem);
}

// The norm mode (ops/norms.py): x (M, H) bf16, w (and b, ln) (H,) bf16
// (w_bf16, b_bf16) or f32 -> out (M, H) bf16. The plan (chunks a lane, rows a
// tile, stages) and the grid (tiles, at most the blocks lrt_norm_blocks
// reports) come from ops/norms.py:norm_plan; x and out 16-byte aligned.
extern "C" int lrt_norm(const void* x, const void* w, const void* b, void* out, int M, int H,
                        float eps, int ln, int w_bf16, int b_bf16, int nv, int rows, int stages,
                        int grid, void* stream) {
  size_t smem = 0;
  const void* kernel = norm_plan_kernel(ln, nv, H, rows, stages, &smem);
  if (kernel == nullptr || grid < 1) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int e = set_smem_once(kernel, true);
  if (e != 0) return e;
  int wflags = (w_bf16 ? 1 : 0) | (b_bf16 ? 2 : 0);
  float* amax = nullptr;
  const float* amax_in = nullptr;
  void* args[] = {(void*)&x, (void*)&w,    (void*)&b, &wflags, &out, &amax,
                  (void*)&amax_in, &M,     &H,        &eps,    &rows, &stages};
  const cudaError_t err = cudaLaunchKernel(kernel, dim3(grid), dim3(32 * (rows + 1)), args, smem,
                                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();  // not left for the next launch's check
  return (int)err;
}

// The blocks of a norm-mode plan that fit the card at once, or minus a CUDA
// error; also sets the kernel's shared-memory attributes.
extern "C" int lrt_norm_blocks(int ln, int nv, int H, int rows, int stages) {
  size_t smem = 0;
  const void* kernel = norm_plan_kernel(ln, nv, H, rows, stages, &smem);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  return blocks_at_once(kernel, 32 * (rows + 1), smem);
}
