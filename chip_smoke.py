#!/usr/bin/env python3
"""Drive the PyTorch port's reward-scoring path on one CUDA card.

Phases, each printing its own lines; any failure exits non-zero:
  1. the card: nvidia-smi name and power limit, torch / CUDA versions;
  2. build the hand-written CUDA kernels from llava_reward_torch/csrc/;
  3. hold each kernel against its plain PyTorch version on the card, in
     bf16, at the serving path's shapes (with left-padded rows), and time
     kernel, plain version and one library call beside the card's bound;
     The W8A8 kernels (B4-B7) are checked the same way at the W8A8 path's
     B=8 shapes (M = 20480 rows);
  4. serve requests at full Phi-3.5-vision width (random bf16 weights from a
     fixed seed, GPM dim 2 + SkipCA) through RewardAdaptor.make_score_fn():
     one pair at B=2 (one side left-padded: B2 + B3 in the decoder) and four
     pairs at B=8, seq 2560, 16+1 crops (B1 in the decoder); B1 runs in the
     CLIP tower for both. The launch counters must show every kernel on
     that path, and the B=2 rewards must match the same forward through the
     plain versions;
  5. the same requests with the decoder quantized W8A8 on the card
     (--load_in_8bit; CLIP stays bf16): B4 x2, B5, B6 and four int8 GEMMs per
     decoder layer, counted and checked the same way;
  6. one JSON line listing every kernel, then the result line.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from llava_reward_torch.core.config import RewardConfig, phi35_vision_config
from llava_reward_torch.evalx.adaptor import RewardAdaptor
from llava_reward_torch.models import phi3v
from llava_reward_torch.ops import cuda_lib
from llava_reward_torch.ops import flash_attention as fa
from llava_reward_torch.ops import int8_matmul as im
from llava_reward_torch.ops import quant_epilogue as qe
from llava_reward_torch.ops.rope import rope_cos_sin_for_config
from llava_reward_torch.preprocess.phi3v_processor import build_img_gather_idx
from llava_reward_torch.reward.model import RewardBatch, init_head_params
from llava_reward_torch.reward.preference import preference_prob
from llava_reward_torch.utils.quantize import quantize_stacked_layers

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores (data sheet)
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# attention: |kernel - plain| <= ATTN_ATOL + ATTN_RTOL * |plain| on valid rows,
# about one bf16 ulp (2^-7 relative): the two round the probabilities at
# different points (online vs full-row softmax), and the output to bf16
ATTN_ATOL, ATTN_RTOL = 8e-3, 2 ** -7
ATTN_TOL_TEXT = f"{ATTN_ATOL:g} + {ATTN_RTOL:g}*|plain|"
PREP_TOL = 0.0  # rope in fp32 with one rounding on both sides: bit-exact
REWARD_TOL = 5e-3  # bf16 forward through 55 attention layers, |reward| ~ 2e-2
# B4 sums x^2 in another order than its plain version: a value at a rounding
# boundary may take the neighbouring code. B5: the JAX package's rule for
# sigmoid's rounding (tests/test_quant_epilogue.py). B6 and B7 are exact.
CODE_SHARE = {"rms_quant": 1e-3, "silu_mul_quant": 0.02, "row_quant": 0.0}

KERNELS = {
    "fa_direct": dict(
        route="cuda", source="llava_reward_torch/csrc/flash_attention.cu",
        replaces="llava_reward_tpu/ops/flash_attention.py:975"),
    "prep": dict(
        route="cuda", source="llava_reward_torch/csrc/rope_transpose.cu",
        replaces="llava_reward_tpu/ops/flash_attention.py:849"),
    "fa_hm": dict(
        route="cuda", source="llava_reward_torch/csrc/flash_attention.cu",
        replaces="llava_reward_tpu/ops/flash_attention.py:45"),
    "rms_quant": dict(
        route="cuda", source="llava_reward_torch/csrc/quant_epilogue.cu",
        replaces="llava_reward_tpu/ops/quant_epilogue.py:46"),
    "silu_mul_quant": dict(
        route="cuda", source="llava_reward_torch/csrc/quant_epilogue.cu",
        replaces="llava_reward_tpu/ops/quant_epilogue.py:126"),
    "row_quant": dict(
        route="cuda", source="llava_reward_torch/csrc/quant_epilogue.cu",
        replaces="llava_reward_tpu/ops/quant_epilogue.py:183"),
    "int8_matmul": dict(
        route="cuda", source="llava_reward_torch/csrc/int8_matmul.cu",
        replaces="llava_reward_tpu/ops/int8_matmul.py:55"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def launches() -> dict:
    return {**fa.LAUNCHES, **qe.LAUNCHES, **im.LAUNCHES}


def reset_counters() -> None:
    for mod in (fa, qe, im):
        mod.reset_counters()


# ------------------------------------------------------------------ phase 1


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ------------------------------------------------------------------ phase 2


def phase_build() -> None:
    t0 = time.perf_counter()
    cuda_lib.load()
    say("build", f"kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda_lib.build_seconds if cuda_lib.build_seconds is not None else 'cached'})")
    for line in cuda_lib.build_logs().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            say("ptxas", line.strip())


# ------------------------------------------------------------------ phase 3


def _pairs_allowed(S, kv_start, q_len, causal):
    """(query, key) pairs the masks leave open, summed over the batch."""
    n = 0
    for s0 in kv_start:
        if causal:
            m = min(S, q_len) - s0
            n += m * (m + 1) // 2
        else:
            n += S * (q_len - s0)
    return n


def _leftpad_rows(kv_start, S, device):
    rows = torch.arange(S, device=device)[None, :]
    return rows >= torch.as_tensor(kv_start, device=device)[:, None]


def _cos_sin(cfg, kv_start, S, device):
    mask = _leftpad_rows(kv_start, S, device).to(torch.int32)
    pos = torch.cumsum(mask, -1) - 1
    pos = torch.where(mask == 0, torch.ones_like(pos), pos)
    return rope_cos_sin_for_config(pos, cfg.decoder, dtype=torch.bfloat16)


def _sdpa_mask(kv_start, S, q_len, causal, device):
    k = torch.arange(S, device=device)
    ok = (k[None, :] < q_len) & (k[None, :] >= torch.as_tensor(kv_start, device=device)[:, None])
    ok = ok[:, None, None, :]
    if causal:
        ok = ok & (k[None, :] <= k[:, None])[None, None]
    return ok


def check_direct(name, gen, B, S, H, D, causal, rope, kv_start, q_len, cfg):
    dev = "cuda"
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device=dev, dtype=torch.bfloat16)
    cos = sin = None
    if rope:
        cos, sin = _cos_sin(cfg, kv_start, S, dev)
    kv = torch.tensor(kv_start, dtype=torch.int32, device=dev)
    kw = dict(n_heads=H, head_dim=D, causal=causal, sliding_window=None, scale=D ** -0.5,
              valid_len=q_len if q_len != S else None)
    run = lambda: fa._fused_qkv_attention_direct(qkv, cos, sin, kv, **kw)  # noqa: E731
    out = run()
    ref = fa.fa_direct_plain(qkv, cos, sin, kv, **kw)
    torch.cuda.synchronize()
    valid = _leftpad_rows(kv_start, S, dev) & (torch.arange(S, device=dev) < q_len)[None]
    err, within = _attn_err(out[valid], ref[valid])
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(run)
    plain_ms = time_ms(lambda: fa.fa_direct_plain(qkv, cos, sin, kv, **kw), iters=2, warmup=1)
    # library yardstick: SDPA on the same roped q/k and v, same masks
    q = qkv[..., : H * D].reshape(B, S, H, D)
    k = qkv[..., H * D : 2 * H * D].reshape(B, S, H, D)
    v = qkv[..., 2 * H * D :].reshape(B, S, H, D)
    if rope:
        q, k = fa._rope_plain(q, cos, sin), fa._rope_plain(k, cos, sin)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    mask = _sdpa_mask(kv_start, S, q_len, causal, dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=D ** -0.5))
    flops = 4 * D * H * _pairs_allowed(S, kv_start, q_len, causal)
    nbytes = 2 * B * S * 3 * H * D + 2 * B * S * H * D + (4 * B * S * D if rope else 0)
    b_ms, b_by = bound_ms(flops, nbytes)
    return _report(name, "fa_direct", err, ATTN_TOL_TEXT, within, finite, ms, plain_ms, lib_ms, b_ms, b_by,
                   f"qkv {tuple(qkv.shape)} H={H} D={D} causal={causal} rope={rope} "
                   f"kv_start={kv_start if len(set(kv_start)) > 1 else f'[{kv_start[0]}]*{B}'} q_len={q_len}")


def check_prep_and_hm(gen, cfg):
    dev = "cuda"
    B, S, H, D = 2, 2560, 32, 96
    kv_start = [0, 300]
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device=dev, dtype=torch.bfloat16)
    cos, sin = _cos_sin(cfg, kv_start, S, dev)
    kw = dict(col_offset=0, n_heads=H, head_dim=D)
    q = fa.rope_transpose(qkv, cos, sin, **kw)
    k = fa.rope_transpose(qkv, cos, sin, col_offset=H * D, n_heads=H, head_dim=D)
    v = fa.rope_transpose(qkv, None, None, col_offset=2 * H * D, n_heads=H, head_dim=D)
    errs = [
        (q.float() - fa.rope_transpose_plain(qkv, cos, sin, **kw).float()).abs().max().item(),
        (k.float() - fa.rope_transpose_plain(qkv, cos, sin, col_offset=H * D, n_heads=H,
                                             head_dim=D).float()).abs().max().item(),
        (v.float() - fa.rope_transpose_plain(qkv, None, None, col_offset=2 * H * D,
                                             n_heads=H, head_dim=D).float()).abs().max().item(),
    ]
    finite = bool(torch.isfinite(q).all() and torch.isfinite(k).all() and torch.isfinite(v).all())
    ms = time_ms(lambda: fa.rope_transpose(qkv, cos, sin, **kw))
    plain_ms = time_ms(lambda: fa.rope_transpose_plain(qkv, cos, sin, **kw), iters=5)
    # one roped call: read the q columns and cos/sin, write head-major q
    nbytes = 2 * B * S * H * D + 4 * B * S * D + 2 * B * S * H * D
    b_ms, b_by = bound_ms(6 * B * S * H * D, nbytes)
    rows = [_report("B2 prep (2,2560,9216) -> 3 x (2,32,2560,96)", "prep", max(errs), "0 (exact)",
                    max(errs) <= PREP_TOL, finite, ms, plain_ms, None, b_ms, b_by, "q/k roped, v not; timed: q call")]

    kv = torch.tensor(kv_start, dtype=torch.int32, device=dev)
    args = (kv, None, True, None, D ** -0.5)
    run = lambda: fa._flash_fwd_hm(q, k, v, *args, q_len=S)  # noqa: E731
    out = run()
    ref = fa.flash_fwd_hm_plain(q, k, v, kv, causal=True, sliding_window=None,
                                scale=D ** -0.5, q_len=S)
    torch.cuda.synchronize()
    valid = _leftpad_rows(kv_start, S, dev)  # (B, S) query rows
    err, within = _attn_err(out.transpose(1, 2)[valid], ref.transpose(1, 2)[valid])
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(run)
    plain_ms = time_ms(lambda: fa.flash_fwd_hm_plain(
        q, k, v, kv, causal=True, sliding_window=None, scale=D ** -0.5, q_len=S), iters=2,
        warmup=1)
    mask = _sdpa_mask(kv_start, S, S, True, dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=D ** -0.5))
    flops = 4 * D * H * _pairs_allowed(S, kv_start, S, True)
    b_ms, b_by = bound_ms(flops, 2 * 4 * B * H * S * D)
    rows.append(_report("B3 fa_hm q/k/v (2,32,2560,96)", "fa_hm", err, ATTN_TOL_TEXT, within,
                        finite, ms,
                        plain_ms, lib_ms, b_ms, b_by, f"causal kv_start={kv_start}"))
    return rows


def _attn_err(out, ref):
    """Max abs error on valid rows, and whether every element is within
    ATTN_ATOL + ATTN_RTOL * |ref|."""
    diff = (out.float() - ref.float()).abs()
    within = bool((diff <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()).all())
    return diff.max().item(), within


def _report(title, name, err, tol_text, within, finite, ms, plain_ms, lib_ms, b_ms, b_by, detail):
    ok = within and finite
    say("kernel", f"{title}: {detail}; max_abs_err {err:.3e} (tol {tol_text}) finite "
        f"{finite}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {b_ms:.4f} ms ({b_by}) "
        f"-> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{title} disagrees with its plain version")
    return dict(name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


W8A8_M = 8 * 2560  # decoder rows of a B=8 request


def _zero_rows(x):
    x[:: W8A8_M // 4] = 0  # amax := 1 on these rows
    return x


def _codes_report(title, name, got, ref, ms, plain_ms, nbytes, nops, detail):
    """Codes and amax of an epilogue kernel against its plain version."""
    (c, a), (rc, ra) = got, ref
    d = (c.int() - rc.int()).abs()
    dmax, share = d.max().item(), (d > 0).float().mean().item()
    amax_rel = ((a - ra).abs() / ra).max().item()
    rule = CODE_SHARE[name]
    if rule == 0:
        within, tol_text = share == 0 and amax_rel == 0, "0 (exact)"
    else:
        within = dmax <= 1 and share < rule and amax_rel <= 2 ** -7
        tol_text = f"|code diff| <= 1 on < {rule:g} of codes, amax within 2^-7"
    b_ms, b_by = bound_ms(nops, nbytes, PEAK_FP32_FLOPS)
    return _report(title, name, float(dmax), tol_text, within, bool(torch.isfinite(a).all()),
                   ms, plain_ms, None, b_ms, b_by,
                   f"{detail}; differing codes {share:.3e}, amax rel err {amax_rel:.3e}")


def check_quant_epilogues(gen, cfg):
    M, H, I = W8A8_M, cfg.decoder.hidden_size, cfg.decoder.intermediate_size
    eps = cfg.decoder.rms_norm_eps
    bf = torch.bfloat16
    x = _zero_rows(torch.randn(M, H, generator=gen, device="cuda", dtype=bf))
    w = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(bf)
    rows = [_codes_report(
        f"B4 rms_quant ({M},{H}) bf16", "rms_quant", qe.rms_quant(x, w, eps),
        qe.rms_quant_plain(x, w, eps), time_ms(lambda: qe.rms_quant(x, w, eps)),
        time_ms(lambda: qe.rms_quant_plain(x, w, eps), iters=3, warmup=1),
        M * H * 2 + H * 2 + M * H + M * 4, 8 * M * H, "zero rows every 5120")]
    gu = _zero_rows(torch.randn(M, 2 * I, generator=gen, device="cuda", dtype=bf).mul_(2))
    rows.append(_codes_report(
        f"B5 silu_mul_quant ({M},{2 * I}) bf16", "silu_mul_quant", qe.silu_mul_quant(gu),
        qe.silu_mul_quant_plain(gu), time_ms(lambda: qe.silu_mul_quant(gu)),
        time_ms(lambda: qe.silu_mul_quant_plain(gu), iters=3, warmup=1),
        M * 2 * I * 2 + M * I + M * 4, 10 * M * I, "-> codes (M, I)"))
    del gu
    rows.append(_codes_report(
        f"B6 row_quant ({M},{H}) bf16", "row_quant", qe.row_quant(x), qe.row_quant_plain(x),
        time_ms(lambda: qe.row_quant(x)), time_ms(lambda: qe.row_quant_plain(x), iters=3,
                                                  warmup=1),
        M * H * 2 + M * H + M * 4, 4 * M * H, "zero rows every 5120"))
    return rows


def _int_mm_scaled(codes, amax, wq, ws):
    """The library yardstick: cuBLASLt's s8 x s8 -> s32 plus the epilogue."""
    return (torch._int_mm(codes, wq).float() * (amax / 127.0) * ws).to(torch.bfloat16)


def check_int8_matmul(gen, cfg):
    M, H = W8A8_M, cfg.decoder.hidden_size
    I, qkv = cfg.decoder.intermediate_size, cfg.decoder.q_size + 2 * cfg.decoder.kv_size
    bf = torch.bfloat16
    rows = []

    def weights(K, N):
        wq = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        return wq, torch.rand(1, N, generator=gen, device="cuda") * 1e-3 + 1e-4

    # the dynamic form at the qkv shape: B6's kernel, then the GEMM
    wq, ws = weights(H, qkv)
    x = _zero_rows(torch.randn(M, H, generator=gen, device="cuda", dtype=bf))
    out, ref = im.w8a8_matmul(x, wq, ws), im.w8a8_matmul_plain(x, wq, ws)
    codes, amax = qe.row_quant_plain(x)
    rows.append(_gemm_report(f"B7 dynamic qkv ({M},{H})x({H},{qkv})", out, ref,
                             lambda: im.w8a8_matmul(x, wq, ws),
                             lambda: im.w8a8_matmul_plain(x, wq, ws),
                             lambda: _int_mm_scaled(codes, amax, wq, ws), M, H, qkv, 2,
                             "x bf16 -> B6 codes -> GEMM; library: _int_mm on the codes"))
    # the pre-quantized form at the four decoder shapes (gate_up last: the
    # kernels line reports it)
    for tag, K, N in (("qkv", H, qkv), ("o", H, H), ("down", I, H), ("gate_up", H, 2 * I)):
        wq, ws = weights(K, N)
        codes = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                              dtype=torch.int8)
        amax = torch.rand(M, 1, generator=gen, device="cuda") * 4 + 0.1
        out = im.int8_matmul_pre(codes, amax, wq, ws)
        ref = im.int8_matmul_pre_plain(codes, amax, wq, ws, bf)
        # cuBLASLt's s32 product alone, with w as the tree holds it (N
        # contiguous) and K-major, for information
        wq_k = wq.t().contiguous().t()
        mm_ms = time_ms(lambda: torch._int_mm(codes, wq))
        mm_k_ms = time_ms(lambda: torch._int_mm(codes, wq_k))
        rows.append(_gemm_report(
            f"B7 {tag} ({M},{K})x({K},{N})", out, ref,
            lambda: im.int8_matmul_pre(codes, amax, wq, ws),
            lambda: im.int8_matmul_pre_plain(codes, amax, wq, ws, bf),
            lambda: _int_mm_scaled(codes, amax, wq, ws), M, K, N, 1,
            f"pre-quantized codes; _int_mm alone {mm_ms:.4f} ms, K-major w {mm_k_ms:.4f} ms"))
        del wq_k
        del out, ref
        torch.cuda.empty_cache()
    return rows


def _gemm_report(title, out, ref, run, plain, lib, M, K, N, x_bytes, detail):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    exact = torch.equal(out, ref)
    ms = time_ms(run)
    plain_ms = time_ms(plain, iters=2, warmup=1)
    lib_ms = time_ms(lib)
    b_ms, b_by = bound_ms(2 * M * K * N, M * K * x_bytes + K * N + M * 4 + N * 4 + M * N * 2,
                          PEAK_INT8_OPS)
    return _report(title, "int8_matmul", err, "0 (exact)", exact, bool(torch.isfinite(out).all()),
                   ms, plain_ms, lib_ms, b_ms, b_by,
                   f"{detail}; {2 * M * K * N / ms / 1e9:.1f} TOPS")


def phase_kernels(cfg):
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = [
        check_direct("B1 fa_direct CLIP", gen, 136, 640, 16, 64, False, False, [0] * 136, 577,
                     cfg),
        check_direct("B1 fa_direct decoder", gen, 8, 2560, 32, 96, True, True,
                     [0, 300, 0, 1000, 0, 7, 0, 64], 2560, cfg),
    ]
    rows += check_prep_and_hm(gen, cfg)
    torch.cuda.empty_cache()
    rows += check_quant_epilogues(gen, cfg)
    torch.cuda.empty_cache()
    rows += check_int8_matmul(gen, cfg)
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ phase 4


def make_request(cfg, gen, pairs, seq, left_pad, device="cuda"):
    """bench.py:219-250's geometry: 16+1 crops (4x4 grid), image tokens
    spliced after position 1. ``left_pad[i]`` pad tokens lead row i."""
    B = 2 * pairs
    nc = cfg.num_crops
    hc = wc = min(4, int(math.isqrt(nc)))
    n_img = (hc * wc + 1) * 144 + 1 + (hc + 1) * 12
    gidx = build_img_gather_idx(hc, wc, nc, budget=n_img)
    mask = np.ones((B, seq), np.int32)
    splice = np.full((B, seq), -1, np.int32)
    for i in range(B):
        p = left_pad.get(i, 0)
        mask[i, :p] = 0
        splice[i, p + 1 : p + 1 + n_img] = np.arange(n_img)
    ids = torch.randint(2, cfg.decoder.vocab_size - 2, (B, seq), generator=gen, device=device)
    mask_t = torch.from_numpy(mask).to(device)
    ids = torch.where(mask_t == 0, cfg.decoder.pad_token_id, ids).to(torch.int32)
    crop = cfg.vision.image_size
    pix = torch.rand(B, nc + 1, crop, crop, 3, generator=gen, device=device) - 0.5
    return RewardBatch(
        input_ids=ids, attention_mask=mask_t, pixel_values=pix,
        img_gather_idx=torch.from_numpy(np.tile(gidx[None], (B, 1))).to(device),
        splice_idx=torch.from_numpy(splice).to(device),
        num_img_tokens=torch.full((B,), n_img, dtype=torch.int32, device=device),
    )


def _serve(score, params, batch, reps):
    out = score(params, batch)  # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = score(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def _prob(r, pairs, rcfg):
    return preference_prob(r[:pairs].float(), r[pairs:].float(), is_general_preference=True,
                           value_head_dim=2, tau=rcfg.general_preference_tau)


def serve_and_check(tag, cfg, rcfg, params, req2, req8, per2, per8, reps):
    """Serve ``req2`` then ``req8`` (one warm + ``reps`` timed calls each)
    through make_score_fn(); the launch counters must equal ``per2`` /
    ``per8`` launches per request for every kernel; the B=2 rewards must
    match the same forward through the plain versions."""
    adaptor = RewardAdaptor(cfg, rcfg, params, device="cuda")
    score = adaptor.make_score_fn()
    if adaptor.make_score_fn() is not score:
        fail("make_score_fn is not memoised")
    calls = reps + 1

    reset_counters()  # the main path's run starts here
    r2, t2 = _serve(score, params, req2, reps)
    after2 = launches()
    r8, t8 = _serve(score, params, req8, reps)
    total = launches()  # ... and ends here
    say(tag, f"launches after B=2: {after2}; after B=8: {total}")
    want2 = {k: calls * per2.get(k, 0) for k in total}
    if after2 != want2:
        fail(f"{tag} B=2 launches {after2} != {want2}")
    d8 = {k: total[k] - after2[k] for k in total}
    want8 = {k: calls * per8.get(k, 0) for k in total}
    if d8 != want8:
        fail(f"{tag} B=8 launches {d8} != {want8}")

    timing = {}
    for name, r, t, pairs in (("B=2", r2, t2, 1), ("B=8", r8, t8, 4)):
        if r.shape != (2 * pairs, 2) or not bool(torch.isfinite(r).all()):
            fail(f"{tag} {name} rewards not finite / wrong shape: {r}")
        med = float(np.median(t))
        timing[name] = med
        say(tag, f"{name}: rewards {r.float().cpu().numpy().round(6).tolist()} "
            f"preference_prob {_prob(r, pairs, rcfg).cpu().numpy().round(6).tolist()}; "
            f"{med:.4f} s/request (median of {t}), {pairs / med:.3f} pairs/s")

    # the same B=2 forward through the kernels' plain versions
    plain = adaptor.make_score_fn(attn_impl="plain")
    before = launches()
    rp = plain(params, req2)
    torch.cuda.synchronize()
    if launches() != before:
        fail(f"{tag}: the plain forward launched a kernel")
    gap = (r2.float() - rp.float()).abs().max().item()
    p_k, p_p = _prob(r2, 1, rcfg), _prob(rp, 1, rcfg)
    same = bool(((p_k > 0.5) == (p_p > 0.5)).all())
    say(tag, f"B=2 kernels vs plain versions: rewards {r2.float().cpu().numpy().tolist()} vs "
        f"{rp.float().cpu().numpy().tolist()}; max gap {gap:.3e} (tol {REWARD_TOL:g}); "
        f"prob {p_k.item():.6f} vs {p_p.item():.6f}; same decision {same}")
    if gap > REWARD_TOL or not same:
        fail(f"{tag}: B=2 rewards through the kernels disagree with the plain versions")
    return total, (r2, r8), timing


def phase_serve(cfg, rcfg, reps=3):
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = {
        "backbone": phi3v.init_params(cfg, gen, torch.bfloat16, "cuda"),
        "head": init_head_params(cfg, rcfg, gen, torch.bfloat16, "cuda"),
    }
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    say("serve", f"random bf16 params: {n_params / 1e9:.3f} B in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    seq = 2560
    req2 = make_request(cfg, gen, 1, seq, {1: 40})
    req8 = make_request(cfg, gen, 4, seq, {})
    n_clip = cfg.vision.num_active_layers
    n_dec = cfg.decoder.num_layers
    # per request: B1 in CLIP; B2 x3 + B3 (B=2) or B1 (B=8) in the decoder
    attn2 = {"fa_direct": n_clip, "prep": 3 * n_dec, "fa_hm": n_dec}
    attn8 = {"fa_direct": n_clip + n_dec}
    bf16_launches, bf16_r, bf16_t = serve_and_check(
        "serve", cfg, rcfg, params, req2, req8, attn2, attn8, reps)

    # --load_in_8bit: the decoder's projections W8A8, quantized on the card;
    # CLIP and the head stay bf16 (bench.py:209-216)
    t0 = time.perf_counter()
    dec = params["backbone"]["decoder"]
    qparams = {**params, "backbone": {**params["backbone"], "decoder": {
        **dec, "layers": quantize_stacked_layers(dec["layers"], scheme="w8a8")}}}
    torch.cuda.synchronize()
    quantized = [k for k, v in qparams["backbone"]["decoder"]["layers"].items()
                 if isinstance(v, dict)]
    say("w8a8", f"decoder quantized in {time.perf_counter() - t0:.1f} s: {quantized}")
    # per decoder layer: B4 x2, B6, B5 and the four GEMMs
    w8 = {"rms_quant": 2 * n_dec, "silu_mul_quant": n_dec, "row_quant": n_dec,
          "int8_matmul": 4 * n_dec}
    w8_launches, w8_r, w8_t = serve_and_check(
        "w8a8", cfg, rcfg, qparams, req2, req8, {**attn2, **w8}, {**attn8, **w8}, reps)
    for name, rb, rq in (("B=2", bf16_r[0], w8_r[0]), ("B=8", bf16_r[1], w8_r[1])):
        say("w8a8", f"{name} rewards W8A8 {rq.float().cpu().numpy().round(6).tolist()} beside "
            f"bf16 {rb.float().cpu().numpy().round(6).tolist()} (same weights; for information)")
    for name in ("B=2", "B=8"):
        say("w8a8", f"{name}: W8A8 {w8_t[name]:.4f} s/request beside bf16 {bf16_t[name]:.4f}")
    # each kernel's count from the run of the path it belongs to
    return {**{k: bf16_launches[k] for k in fa.LAUNCHES},
            **{k: w8_launches[k] for k in (*qe.LAUNCHES, *im.LAUNCHES)}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------------ main


def main() -> int:
    phase_device()
    phase_build()
    cfg = phi35_vision_config()
    rcfg = RewardConfig(is_general_preference=True, value_head_dim=2,
                        add_cross_attention=True, layer_id=cfg.decoder.num_layers)
    rows = phase_kernels(cfg)
    counts = phase_serve(cfg, rcfg)

    kernels = []
    for name, meta in KERNELS.items():
        # one row per kernel: its last check (for B1 the decoder's shapes,
        # which dominate its time on the path; for the int8 GEMM gate_up's)
        row = [r for r in rows if r["name"] == name][-1]
        kernels.append({"name": name, **meta, "launches": counts[name],
                        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
