// Hopper building blocks of the port's kernels (sm_90a): mbarriers,
// TMA tile loads, wgmma descriptors and fences, register reallocation, and the
// host-side tensor maps.
//
// Tile layout. Every bf16 tile in shared memory is R rows x C columns stored
// chunk-major: element (r, c) at (c / 8) * R * 8 + r * 8 + c % 8. That is
// what one TMA box {8, R, C / 8} writes when the tensor map views a row-major
// matrix as (8 columns, rows, column chunks), and it is wgmma's unswizzled
// ("interleave") layout: each 8 x 8 core matrix is 128 contiguous bytes. It
// takes any C that is a multiple of 8 (head_dim 80 and 96 included), with no
// swizzle atom to fit. The same tile serves as a K-major operand (rows on M/N,
// columns on K) or as an MN-major one (rows on K, columns on M/N).
//
// The int8 GEMM's tiles are the other layout: K-major rows of exactly 128
// bytes (one 128-deep K step of int8), written by TMA with 128-byte swizzle
// (the 16-byte chunk c of row r lands at chunk c ^ (r % 8)), in 8-row atoms of
// 1024 bytes that start on a 1024-byte boundary. desc_sw128 describes them to
// wgmma; a k-step of 32 bytes inside the row is an offset of the start
// address, as the swizzle is applied to the address the hardware forms.
//
// Tensor maps are encoded on the host through cudaGetDriverEntryPointByVersion
// (cuTensorMapEncodeTiled is a driver-API call), so the library links with
// nvcc -shared alone, without -lcuda. Kernels take them as __grid_constant__
// parameters.
#pragma once

#include <cuda.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also tells the barrier how many bytes TMA will deliver
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the phase with this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// a box from shared memory to the tensor, clipped at its bounds; completion
// is tracked by bulk groups
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// a contiguous run of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// dst[i] += src[i] in global memory for `bytes` of fp32 (16-byte aligned),
// done by the TMA unit; completion is tracked by bulk groups
__device__ __forceinline__ void bulk_reduce_add(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
// a contiguous run of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from shared to global memory; completion is tracked by bulk groups
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// the shared-memory sources of every committed bulk group have been read
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// every committed bulk group is complete (its writes done)
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// generic-proxy writes to shared memory made visible to TMA and wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ------------------------------------------------------------------ warpgroups

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// named barrier over `threads` threads (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: lbo / sbo in bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// A K-major tile in the 128-byte swizzle layout (see the top of the file):
// layout type 1, sbo one 1024-byte atom of 8 rows; lbo is not used when the
// K extent of the product lies inside one swizzle row.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return desc(p, 16, 1024) | (1ull << 62);
}

// k-step kk (16 deep) of an R-row tile used K-major: rows on M/N, columns on K.
// lbo: next 8 columns (K); sbo: next 8 rows (M/N).
template <int R>
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  return desc(static_cast<const char*>(tile) + kk * 2 * R * 16, R * 16, 128);
}

// k-step kk (16 deep) of an R-row tile used MN-major: rows on K, columns on
// M/N. Unswizzled MN-major: lbo steps along K (next 8 rows), sbo along M/N
// (next 8 columns).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
  return desc(static_cast<const char*>(tile) + kk * 256, 128, R * 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k-step kk from an m64nN accumulator in registers (its
// columns 16kk..16kk+15 become A's K), rounded to bf16.
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// Accumulator element i of thread t (0..127) of the warpgroup: row and column
// of the 64 x N tile. Columns come in pairs (i, i + 1 share a row).
__device__ __forceinline__ int acc_row(int t, int i) {
  return (t / 32) * 16 + (t % 32) / 4 + ((i & 2) ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return (i / 4) * 8 + (t % 4) * 2 + (i & 1);
}

}  // namespace sm90

// ------------------------------------------------------------------ host

namespace sm90_host {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor seen as (8 columns, rows, column chunks, outer...) so that a
// box {8, box_rows, chunks, 1...} lands in shared memory chunk-major (see the
// top of sm90.cuh). `outer` / `outer_strides` (elements) list up to two outer
// dimensions (batch, head). Rows past `rows` read as zeros. Returns 0 or a
// CUDA error code.
inline int tile_map(CUtensorMap* map, const void* base, int rows, long long row_stride,
                    int chunks, int box_rows, int box_chunks, int n_outer, const int* outer,
                    const long long* outer_strides) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[5] = {8, (cuuint64_t)rows, (cuuint64_t)chunks, 1, 1};
  cuuint64_t strides[4] = {(cuuint64_t)row_stride * 2, 16, 0, 0};
  cuuint32_t box[5] = {8, (cuuint32_t)box_rows, (cuuint32_t)box_chunks, 1, 1};
  cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < n_outer; ++i) {
    dims[3 + i] = (cuuint64_t)outer[i];
    strides[2 + i] = (cuuint64_t)outer_strides[i] * 2;
  }
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3 + n_outer, const_cast<void*>(base),
                  dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A (rows, cols) row-major matrix of `elem` bytes per element (row stride in
// bytes, a multiple of 16) cut into boxes of 128 bytes of columns x box_rows
// rows, in the 128-byte swizzle layout in shared memory. Loads read zeros
// past `cols` and `rows`; stores are clipped there. Returns 0 or a CUDA error
// code.
inline int sw128_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
                     int rows, int cols, long long row_stride, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)row_stride};
  cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace sm90_host
