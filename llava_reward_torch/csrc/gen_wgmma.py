"""Write ``wgmma.cuh``: the bf16 -> fp32 ``wgmma.mma_async`` m64nNk16 forms
the attention kernels use and the s8 -> s32 m64nNk32 forms of the int8 GEMM,
one per output width N.

PTX lists every accumulator register of a ``wgmma`` by name, so each width
is its own block of inline assembly; this script writes them all from one
template. Run it after changing ``WIDTHS`` and commit its output:

    python3 llava_reward_torch/csrc/gen_wgmma.py
"""

from pathlib import Path

# 64: scores (64 keys or queries); 64/80/96/128: P.V, dS^T.Q, P^T.dO at each
# head_dim; 32/40/48: dQ = dS.K in two halves of head_dim 64/80/96
WIDTHS = (32, 40, 48, 64, 80, 96, 128)
# the int8 GEMM's 64 x 256 warpgroup tile
S8_WIDTHS = (256,)


def _block(n: int) -> str:
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    ss = (
        f'    asm volatile(\n'
        f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"\n'
        f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
        f'        "{{{regs}}}, %{r}, %{r + 1}, p, 1, 1, %{r + 3}, %{r + 4};\\n}}\\n"\n'
        f'        : {outs}\n'
        f'        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));\n'
    )
    rs = (
        f'    asm volatile(\n'
        f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
        f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
        f'        "{{{regs}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, %{r + 6};\\n}}\\n"\n'
        f'        : {outs}\n'
        f'        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));\n'
    )
    return (
        f"template <>\nstruct Wgmma<{n}> {{\n"
        f"  // A and B from shared memory (descriptors); TA / TB: 0 K-major, 1 MN-major\n"
        f"  template <int TA, int TB>\n"
        f"  static __device__ __forceinline__ void ss(float (&d)[{r}], uint64_t da, uint64_t db,\n"
        f"                                            int scale_d) {{\n{ss}  }}\n"
        f"  // A from registers (four bf16x2 words a thread), B from shared memory\n"
        f"  template <int TB>\n"
        f"  static __device__ __forceinline__ void rs(float (&d)[{r}], const uint32_t (&a)[4],\n"
        f"                                            uint64_t db, int scale_d) {{\n{rs}  }}\n"
        f"}};\n"
    )


def _s8_block(n: int) -> str:
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+r"(d[{i}])' for i in range(r))
    return (
        f"template <>\nstruct WgmmaS8<{n}> {{\n"
        f"  // A and B K-major from shared memory (descriptors): s8 has no transpose\n"
        f"  static __device__ __forceinline__ void ss(int (&d)[{r}], uint64_t da, uint64_t db,\n"
        f"                                            int scale_d) {{\n"
        f'    asm volatile(\n'
        f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"\n'
        f'        "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "\n'
        f'        "{{{regs}}}, %{r}, %{r + 1}, p;\\n}}\\n"\n'
        f'        : {outs}\n'
        f'        : "l"(da), "l"(db), "r"(scale_d));\n'
        f"  }}\n}};\n"
    )


def main() -> None:
    head = (
        "// Generated by gen_wgmma.py: do not edit by hand.\n"
        "//\n"
        "// wgmma.mma_async m64nNk16, bf16 inputs, fp32 accumulators d[N/2] in the\n"
        "// warpgroup's accumulator layout (Wgmma<N>), and m64nNk32, s8 inputs, s32\n"
        "// accumulators in the same layout (WgmmaS8<N>). scale_d 0 overwrites d, 1\n"
        "// adds to it.\n"
        "#pragma once\n\n#include <stdint.h>\n\nnamespace sm90 {\n\ntemplate <int N>\nstruct Wgmma;\n"
        "template <int N>\nstruct WgmmaS8;\n\n"
    )
    body = "\n".join([_block(n) for n in WIDTHS] + [_s8_block(n) for n in S8_WIDTHS])
    out = Path(__file__).with_name("wgmma.cuh")
    out.write_text(head + body + "\n}  // namespace sm90\n")


if __name__ == "__main__":
    main()
