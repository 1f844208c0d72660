// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lrt {

// 8 bf16 values moved as one 16-byte word.
union Vec8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

// Rotate-half RoPE of one 8-wide chunk of a head row, in fp32 with one
// rounding to bf16 at the end: out[d] = x[d]*cos[d] + rot[d]*sin[d], where
// rot[d] = -x[d+D/2] for d < D/2 and x[d-D/2] otherwise. ``partner`` is the
// chunk D/2 columns away; ``first_half`` says which side this chunk is on.
// The _rn intrinsics keep the compiler from contracting to an FMA, so the
// result is bit-identical to the plain PyTorch version's fp32 arithmetic.
__device__ __forceinline__ Vec8 rope_chunk(const Vec8& x, const Vec8& partner,
                                           const Vec8& c, const Vec8& s,
                                           bool first_half) {
  Vec8 out;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float xv = __bfloat162float(x.h[e]);
    float pv = __bfloat162float(partner.h[e]);
    float rot = first_half ? -pv : pv;
    out.h[e] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(xv, __bfloat162float(c.h[e])),
                                             __fmul_rn(rot, __bfloat162float(s.h[e]))));
  }
  return out;
}

// The 64-key tiles [key_tile_begin, key_tile_end) that a 64-row query tile
// starting at q0 visits: the left pad (kv_start) and, causal, the window
// below and the diagonal above, then the q_len tail. The attention forward
// and both passes of its backward visit exactly these tiles, so a fully
// masked row is uniform over the same keys in all of them.
__device__ __forceinline__ int key_tile_begin(int q0, int kv_start, int causal, int window) {
  int b = (kv_start / 64) * 64;
  if (causal && window > 0) {
    const int lo = q0 - window + 1;
    if (lo > 0) b = max(b, (lo / 64) * 64);
  }
  return b;
}

__device__ __forceinline__ int key_tile_end(int q0, int S, int q_len, int causal) {
  return min(causal ? min(q0 + 64, S) : S, q_len);
}

}  // namespace lrt
