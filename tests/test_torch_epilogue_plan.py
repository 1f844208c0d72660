"""Host-side pieces of the streaming B4 / B9 kernel and of chip_smoke.py's
checks, on the CPU (the kernels themselves run only on the card:
tests/test_torch_cuda_kernels.py).

- ``ops/quant_epilogue.tile_plan``: rows a tile (R), ring stages (S) and the
  dynamic shared memory of a block, per width and dtype. Every plan fits an
  H100 block's 227 KiB; two blocks share an SM at the main paths' widths;
  the widths the kernel does not take raise ValueError.
- ``ops/quant_epilogue.row_plan`` (B6): the form (the warp form, B4's
  streaming tiles; the block form, a block a row), R, the stages and the
  dynamic shared memory, per width, dtype and mode, at every width B6 meets
  on the main paths, at 8 k widths that are not 16 k, and the widths no
  form takes (ValueError).
- ``chip_smoke._scale_leaf_errors``: the conditioned error of a one-number
  LoRA scale leaf, |d dscale| / (||g_b|| ||b|| / |scale|), on synthetic
  tensors: a cancelling sum reads small, g_b moved by a relative e reads e.
- ``chip_smoke._kernel_name``: ptxas's mangled kernel names, read back.
- ``chip_smoke._scale_identity``: dscale = <g_b, b> / scale on a route's own
  gradients holds far below its bound in f32 and bf16, and a cut or
  mis-wired scale gradient breaks it.
- ``chip_smoke._scale_bias``: a kernel whose softmax scale is off by
  (1 + e) reads about e / 0.01; a sound one, rounded to bf16, near 0.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from llava_reward_torch.ops import quant_epilogue as qe

WIDTHS = [16, 128, 384, 1024, 1280, 3072, 3584, 4096, 5120]
# an H100's shared memory: a block's most (227 KiB), an SM's (228 KiB) with
# 1 KiB of it reserved for each block
SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED = 232448, 233472, 1024


@pytest.mark.parametrize("ln", [False, True], ids=["rms", "ln"])
@pytest.mark.parametrize("x_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("H", WIDTHS)
def test_tile_plan_fits_the_card(H, x_bytes, ln):
    for M in (1, 3, 131, 87040):
        p = qe.tile_plan(H, x_bytes, ln, M)
        row = H * x_bytes
        # a block is the producer warp and one consumer warp per row: 7 rows
        # at most up to H = 2048, 4 beyond (csrc nq_rows_max)
        assert 1 <= p.rows <= min(7 if H <= 2048 else 4, M) and p.stages == 2
        # the kernel's layout: barriers, S stages of R rows, two staging
        # tiles of codes, the fp32 weight (and bias)
        assert p.smem == (qe.NQ_HEAD + p.stages * p.rows * row + 2 * p.rows * H
                          + 4 * H * (2 if ln else 1))
        assert p.smem <= SMEM_PER_BLOCK
        # a stage is one bulk copy: 16-byte multiples, at most 32 KiB
        assert (p.rows * row) % 16 == 0 and (p.rows * H) % 16 == 0
        assert p.rows == 1 or p.rows * row <= qe.NQ_STAGE_BYTES


@pytest.mark.parametrize("name,H,ln,rows,blocks", [
    ("B9 CLIP", 1024, True, 7, 4),
    ("B4 phi3v", 3072, False, 4, 2),
    ("B4 qwen", 3584, False, 4, 2),
])
def test_tile_plan_at_the_main_paths_widths(name, H, ln, rows, blocks):
    """The plans measured fastest on an H100 at the widths the W8A8 paths
    run (bf16, B=8 rows; tools/epilogue_timing.py --sweep), with shared
    memory for two blocks an SM or more."""
    p = qe.tile_plan(H, 2, ln, 14336)
    assert (p.rows, p.stages) == (rows, 2), name
    assert SMEM_PER_SM // (p.smem + SMEM_RESERVED) == blocks, name


@pytest.mark.parametrize("H", [8, 136, 1000, qe.NQ_MAX_WIDTH + 16, 5376, 8192])
def test_tile_plan_refuses_widths_the_kernel_does_not_take(H):
    """A width that is a multiple of 8 (the old kernel's rule) but not of 16,
    or wider than the 5120 the kernel holds in registers, raises."""
    with pytest.raises(ValueError, match="row width"):
        qe.tile_plan(H, 2, True, 100)


def test_every_supported_model_width_plans():
    """Every width ``supported`` lets through up to the widest model of the
    repository (5120, LLaVA-NeXT-13B) has a plan, for both dtypes."""
    for H in range(128, qe.NQ_MAX_WIDTH + 1, 128):
        x = torch.zeros(2, H)
        assert qe.supported(x)
        for x_bytes in (2, 4):
            for ln in (False, True):
                qe.tile_plan(H, x_bytes, ln, 4096)


# B6's widths on the main paths: the W8A8 decoders' o_proj and LoRA inputs
# (hidden = q), the CLIP tower's out / fc2 inputs, down_proj's input, a tp-2
# rank's o / down blocks; the warp form takes the multiples of 16 up to 3584
B6_FORMS = {1024: 0, 1536: 0, 1792: 0, 2560: 0, 3072: 0, 3584: 0, 4096: 1, 5120: 1,
            6912: 1, 8192: 1, 9472: 1, 13824: 1, 18944: 1}
# the warp form's rows a tile, bf16 / f32: 7 up to 8 chunks a lane, 4 beyond,
# within a 32 KiB stage
B6_ROWS = {1024: (7, 7), 1536: (7, 5), 1792: (7, 4), 2560: (4, 3), 3072: (4, 2),
           3584: (4, 2)}


@pytest.mark.parametrize("mode", qe.ROW_MODES)
@pytest.mark.parametrize("x_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("H", sorted(B6_FORMS))
def test_row_plan_at_the_main_paths_widths(H, x_bytes, mode):
    p = qe.row_plan(H, x_bytes, mode)
    assert p.form == B6_FORMS[H]
    assert p.smem <= SMEM_PER_BLOCK
    if p.form == 0:
        # B4's tiles with no weight and no staged codes: R rows of one bulk
        # copy (16-byte multiples, 32 KiB at most), two tiles in the ring
        assert (p.rows, p.stages) == (B6_ROWS[H][x_bytes // 4], 2)
        assert p.rows * H * x_bytes <= qe.NQ_STAGE_BYTES and (p.rows * H * x_bytes) % 16 == 0
        assert p.smem == qe.NQ_HEAD + 2 * p.rows * H * x_bytes
        # an instantiation the kernel has: a whole number of chunks a lane
        # where B6 has one (1536, 1792, 2560 and B4's widths), else the branch
        assert 256 * p.nv >= H and (p.nv in qe.NQ_CHUNKS_PER_LANE or 256 * p.nv == H)
        assert (256 * p.nv == H) == (H in (1024, 1536, 1792, 2560, 3072, 3584))
        assert p.keep == 0
        # at least two blocks an SM
        assert SMEM_PER_SM // (p.smem + SMEM_RESERVED) >= 2
    else:
        # a block a row; the whole-row mode keeps the row as it came (every
        # main-path row fits: 18944 f32 is 74 KB)
        assert (p.nv, p.rows, p.stages, p.keep) == (0, 1, 1, int(mode == "whole"))
        assert p.smem == p.keep * H * x_bytes


@pytest.mark.parametrize("x_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("H", [8, 136, 1000, 5128, 18952, 24584])
def test_row_plan_gives_widths_of_8_k_the_block_form(H, x_bytes):
    """A multiple of 8 that is not one of 16 (or is, above 5120) has the block
    form in every mode."""
    for mode in qe.ROW_MODES:
        p = qe.row_plan(H, x_bytes, mode)
        assert p.form == 1 and p.keep == int(mode == "whole")
        assert p.smem == p.keep * H * x_bytes


@pytest.mark.parametrize("H", [0, -16, 4, 12, 1001, 5124])
def test_row_plan_refuses_widths_no_form_takes(H):
    for mode in qe.ROW_MODES:
        with pytest.raises(ValueError, match="multiple of 8"):
            qe.row_plan(H, 2, mode)


def test_row_plan_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        qe.row_plan(1024, 2, "codes")


def test_row_plan_reads_a_row_too_large_to_keep_twice():
    """The block form's whole-row mode keeps a row of up to 112 KiB in shared
    memory (two blocks an SM: 28672 f32, 57344 bf16); a larger row is read
    again for its codes, with no shared memory, so that every multiple of 8
    runs in every mode (the earlier kernel kept fp32 for both dtypes and
    could not go past 227 KiB of it)."""
    assert qe.row_plan(28672, 4, "whole").smem == qe.ROW_KEEP_BYTES
    assert qe.row_plan(57344, 2, "whole").smem == qe.ROW_KEEP_BYTES
    for H, x_bytes in ((28680, 4), (57352, 2), (58112, 4), (1 << 20, 2)):
        for mode in qe.ROW_MODES:
            assert qe.row_plan(H, x_bytes, mode) == qe.RowPlan(1, 0, 1, 1, 0, 0)


def test_every_multiple_of_8_plans():
    """Every width the kernel took before its redesign (any multiple of 8) has
    a plan in every mode and dtype that fits a block."""
    for H in range(8, 20000 + 1, 8):
        for x_bytes in (2, 4):
            for mode in qe.ROW_MODES:
                assert qe.row_plan(H, x_bytes, mode).smem <= SMEM_PER_BLOCK


def _lora_case(rng, L=3, r=4, n=64):
    b = rng.standard_normal((L, r, n)).astype(np.float32)
    gb = rng.standard_normal((L, r, n)).astype(np.float32)
    scale = np.full((L,), 2.0, np.float32)
    return b, gb, scale


def _names_and_grads(gb, dscale):
    names = ["lora/q/a", "lora/q/b", "lora/q/scale", "head/w"]
    grads = [torch.zeros(1), torch.from_numpy(gb), torch.from_numpy(dscale), torch.ones(2)]
    return names, grads


def test_scale_leaf_error_reads_a_relative_move_of_g_b():
    rng = np.random.default_rng(0)
    b, gb, scale = _lora_case(rng)
    values = {"lora/q/b": torch.from_numpy(b), "lora/q/scale": torch.from_numpy(scale)}
    dscale = np.einsum("lrn,lrn->l", gb, b) / scale
    names, ref = _names_and_grads(gb, dscale)
    for e in (1e-3, 0.05, 0.3):
        # g_b moved by a relative e along b: the worst case of Cauchy-Schwarz
        bhat = b / np.linalg.norm(b.reshape(3, -1), axis=1)[:, None, None]
        gb2 = gb + e * np.linalg.norm(gb.reshape(3, -1), axis=1)[:, None, None] * bhat
        _, got = _names_and_grads(gb2, np.einsum("lrn,lrn->l", gb2, b) / scale)
        err = cs._scale_leaf_errors(names, got, ref, values)
        assert set(err) == {"lora/q/scale"}
        assert err["lora/q/scale"] == pytest.approx(e, rel=1e-4)
    # a fault in one layer only: the worst over layers reads it
    moved = dscale.copy()
    moved[1] += 0.1 * np.linalg.norm(gb[1]) * np.linalg.norm(b[1]) / scale[1]
    _, got = _names_and_grads(gb, moved)
    assert cs._scale_leaf_errors(names, got, ref, values)["lora/q/scale"] == pytest.approx(
        0.1, rel=1e-5)


def test_scale_leaf_error_reads_a_move_of_its_own_direction_as_e_over_sqrt_n():
    """g_b moved by a relative e in a random direction moves dscale by about
    e ||g_b|| ||b|| / sqrt(N) over N terms: the measure reads ~e / sqrt(N),
    which is why it bounds nothing at the LoRA factors' sizes."""
    rng = np.random.default_rng(2)
    b, gb, scale = _lora_case(rng, L=4, r=16, n=1024)
    values = {"lora/q/b": torch.from_numpy(b), "lora/q/scale": torch.from_numpy(scale)}
    dscale = np.einsum("lrn,lrn->l", gb, b) / scale
    names, ref = _names_and_grads(gb, dscale)
    e, N = 0.1, 16 * 1024
    d = rng.standard_normal(gb.shape).astype(np.float32)
    d *= e * np.linalg.norm(gb.reshape(4, -1), axis=1)[:, None, None] / np.linalg.norm(
        d.reshape(4, -1), axis=1)[:, None, None]
    _, got = _names_and_grads(gb + d, np.einsum("lrn,lrn->l", gb + d, b) / scale)
    err = cs._scale_leaf_errors(names, got, ref, values)["lora/q/scale"]
    assert 0.2 * e / N ** 0.5 < err < 5 * e / N ** 0.5


def test_scale_leaf_error_is_small_where_the_sum_cancels():
    """g_b nearly orthogonal to b: dscale is a sum that cancels, so a one-ulp
    change of a term is a large relative error of the leaf, and a small one
    in the conditioned measure."""
    rng = np.random.default_rng(1)
    b, gb, scale = _lora_case(rng, L=2, r=8, n=512)
    for l in range(2):  # remove g_b's component along b
        gb[l] -= (gb[l] * b[l]).sum() / (b[l] * b[l]).sum() * b[l]
    values = {"lora/q/b": torch.from_numpy(b), "lora/q/scale": torch.from_numpy(scale)}
    terms = (gb * b).reshape(2, -1)
    exact = terms.astype(np.float64).sum(1) / scale
    noisy = exact + np.abs(terms).max(1) * 2.0 ** -8 / scale  # one bf16 ulp of the largest term
    names, ref = _names_and_grads(gb, exact.astype(np.float32))
    _, got = _names_and_grads(gb, noisy.astype(np.float32))
    rel = cs._rel_err(got[2], ref[2])
    cond = cs._scale_leaf_errors(names, got, ref, values)["lora/q/scale"]
    assert rel > 1.0 and cond < 1e-3


def test_over_holds_each_reading_to_its_floor():
    errs = {"a": 0.3, "b": 0.3, "c": 0.1}
    floor = {"a": 0.1, "b": 0.25}
    assert cs._over(errs, floor, 0.25, 1.5) == {"a": 0.3}
    assert cs._over(errs, floor, 0.25, 0.0) == {"a": 0.3, "b": 0.3}


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_117norm_quant_kernelI13__nv_bfloat16Lb1ELi4EEEvPKT_PKvS6_iPaPfiiffii",
     "norm_quant_kernel<__nv_bfloat16,1,4>"),
    ("_ZN12_GLOBAL__N_117norm_quant_kernelIfLb0ELi20EEEvPKT_PKvS6_iPaPfiiffii",
     "norm_quant_kernel<float,0,20>"),
    ("_ZN12_GLOBAL__N_118fa_bwd_main_kernelILi64ELi0EEEvN", "fa_bwd_main_kernel<64,0>"),
    ("_ZN12_GLOBAL__N_116row_quant_kernelI13__nv_bfloat16EEvPKT_PaPfi",
     "row_quant_kernel<__nv_bfloat16>"),
    ("_ZN12_GLOBAL__N_118int8_matmul_kernelIfEEvN", "int8_matmul_kernel<float>"),
])
def test_kernel_names_from_ptxas(mangled, name):
    assert cs._kernel_name(mangled) == name


def _lora_grads(dtype, cut_scale=False, seed=0):
    """One LoRA layer applied as the models apply it (``x @ a @ b * scale``
    in the activations' dtype), its a / b / scale gradients by autograd."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(512, 384, generator=gen).to(dtype)
    g = torch.randn(512, 1024, generator=gen).to(dtype)
    a = torch.randn(384, 16, generator=gen).mul_(0.1).requires_grad_()
    b = torch.randn(16, 1024, generator=gen).mul_(1e-2).requires_grad_()
    scale = torch.tensor(2.0, requires_grad=True)
    s = scale.detach() if cut_scale else scale  # a cut scale gradient
    out = (x @ a.to(dtype)) @ b.to(dtype) * s.to(dtype)
    if cut_scale:
        out = out + 0.0 * scale
    grads = torch.autograd.grad((out.float() * g.float()).sum(), [a, b, scale])
    names = ["lora/q/a", "lora/q/b", "lora/q/scale"]
    return names, grads, {"lora/q/a": a, "lora/q/b": b, "lora/q/scale": scale}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scale_identity_holds_on_any_route(dtype):
    """dscale = <g_b, b> / scale: far below the bound in f32 and in bf16 (the
    rounding reads ~2^-9 / sqrt(M) of the bound over M outputs)."""
    names, grads, values = _lora_grads(dtype)
    got = cs._scale_identity(names, grads, values)
    assert set(got) == {"lora/q/scale"}
    assert got["lora/q/scale"] < cs.SCALE_IDENTITY_TOL / 3


def test_scale_identity_catches_a_cut_or_miswired_scale_gradient():
    """A cut scale gradient reads |<g_b, b> / scale| over its bound, about
    1 / sqrt(N) over the N = r x out terms of the sum (16384 here), and a
    gradient of another layer about as much."""
    names, grads, values = _lora_grads(torch.float32, cut_scale=True)
    assert cs._scale_identity(names, grads, values)["lora/q/scale"] > 10 * cs.SCALE_IDENTITY_TOL
    names, grads, values = _lora_grads(torch.float32)
    other = _lora_grads(torch.float32, seed=1)[1]
    wired = [grads[0], grads[1], other[2]]  # another layer's scale gradient
    assert cs._scale_identity(names, wired, values)["lora/q/scale"] > 10 * cs.SCALE_IDENTITY_TOL


@pytest.mark.parametrize("e", [0.0, 0.003, 0.01, -0.01])
def test_scale_bias_reads_a_softmax_scale_fault(e):
    """r = <kernel - p(s), d> / <d, d>: a kernel at scale s (1 + e) reads
    about e / 0.01; rounding noise on a sound one reads near 0."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 4, 256, 32, generator=gen) for _ in range(3))
    s = 32 ** -0.5

    def attn(scale):
        return torch.softmax(q @ k.transpose(-1, -2) * scale, -1) @ v

    p, p2 = attn(s), attn(s * cs.SCALE_STEP)
    kernel = attn(s * (1 + e)).bfloat16().float()  # rounded as a bf16 kernel's output
    r = cs._scale_bias([(kernel, p, p2)])
    assert abs(r - e / (cs.SCALE_STEP - 1)) < 0.02 + 0.05 * abs(e) / 0.01
    if e == 0.0:
        assert abs(r) < cs.SCALE_BIAS_TOL / 3


def test_scale_bias_direction_from_unrounded_outputs():
    """A sound kernel and a plain version that both round their output to
    bf16: with d from the plain version's own bf16 outputs, the plain
    version's rounding sits in both kernel - p and d and reads as a positive
    bias; with d from the unrounded (fp32) outputs it reads near 0, while a
    x1.003 scale still reads about 0.3."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 4, 256, 32, generator=gen) for _ in range(3))
    s = 32 ** -0.5

    def attn(scale):
        return torch.softmax(q @ k.transpose(-1, -2) * scale, -1) @ v

    def rounded(t, noise=0.0):  # a bf16 output, from a value off by fp32 noise
        return (t * (1 + noise * torch.randn(t.shape, generator=gen))).bfloat16().float()

    q1, q2 = attn(s), attn(s * cs.SCALE_STEP)
    p = rounded(q1)
    sound = rounded(q1, 1e-3)  # the kernel's own roundings (p in bf16, another order)
    biased = cs._scale_bias([(sound, p, rounded(q2))])
    clean = cs._scale_bias([(sound, p, q1, q2)])
    assert biased > 5 * abs(clean) and abs(clean) < 0.02
    assert abs(cs._scale_bias([(rounded(attn(s * 1.003), 1e-3), p, q1, q2)]) - 0.3) < 0.05
