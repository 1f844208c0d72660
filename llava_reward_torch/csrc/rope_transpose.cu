// RoPE-and-relayout pass written by hand for Hopper (sm_90a).
//
// prep_kernel replaces llava_reward_tpu/ops/flash_attention.py:_prep_kernel
//   (B2, reached through rope_transpose): it slices n_heads heads' columns out
//   of the fused (B, S, C) qkv projection, applies rotate-half RoPE (none for
//   V) and writes head-major (B, n_heads, S, D) for the head-major attention
//   kernel.
//
// What bounds it on an H100: ~6 FLOPs per element against 2 bytes read (x)
// plus 4 (cos, sin) and 2 written, so it is bound by memory bytes. Each
// thread moves one 16-byte chunk (8 bf16) of one head row, RoPE in fp32 with
// one rounding to bf16; consecutive threads write consecutive 16-byte chunks
// of the output, so the stores coalesce.
#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

template <int D, bool ROPE>
__global__ void __launch_bounds__(256)
    prep_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cos,
                const bf16* __restrict__ sin, bf16* __restrict__ out, int S, long long C,
                int col_offset, int n_heads, long long total_chunks) {
  constexpr int CH = D / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total_chunks) return;
  // output chunk order is (b, h, s, c): idx * 8 is its element offset
  const int c = (int)(idx % CH);
  long long t = idx / CH;
  const int s = (int)(t % S);
  t /= S;
  const int h = (int)(t % n_heads);
  const long long b = t / n_heads;
  const long long bs = b * S + s;
  const bf16* row = x + bs * C + col_offset + (long long)h * D;
  lrt::Vec8 val;
  val.u = *reinterpret_cast<const uint4*>(row + c * 8);
  if (ROPE) {
    lrt::Vec8 par, cv, sv;
    par.u = *reinterpret_cast<const uint4*>(row + ((c + CH / 2) % CH) * 8);
    cv.u = *reinterpret_cast<const uint4*>(cos + bs * D + c * 8);
    sv.u = *reinterpret_cast<const uint4*>(sin + bs * D + c * 8);
    val = lrt::rope_chunk(val, par, cv, sv, c < CH / 2);
  }
  *reinterpret_cast<uint4*>(out + idx * 8) = val.u;
}

template <int D>
int launch(const bf16* x, const bf16* cos, const bf16* sin, bf16* out, int B, int S,
           long long C, int col_offset, int n_heads, cudaStream_t st) {
  const long long total = (long long)B * n_heads * S * (D / 8);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (cos != nullptr)
    prep_kernel<D, true><<<blocks, threads, 0, st>>>(x, cos, sin, out, S, C, col_offset,
                                                     n_heads, total);
  else
    prep_kernel<D, false><<<blocks, threads, 0, st>>>(x, cos, sin, out, S, C, col_offset,
                                                      n_heads, total);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, S, C) bf16, heads start at column col_offset; cos/sin (B, S, D) or
// both null for no RoPE; out (B, n_heads, S, D) bf16 contiguous.
extern "C" int lrt_rope_transpose(const void* x, const void* cos, const void* sin, void* out,
                                  int B, int S, long long C, int col_offset, int n_heads,
                                  int D, void* stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* cp = static_cast<const bf16*>(cos);
  const bf16* sp = static_cast<const bf16*>(sin);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(xp, cp, sp, op, B, S, C, col_offset, n_heads, st);
    case 96: return launch<96>(xp, cp, sp, op, B, S, C, col_offset, n_heads, st);
    case 128: return launch<128>(xp, cp, sp, op, B, S, C, col_offset, n_heads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
