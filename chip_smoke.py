#!/usr/bin/env python3
"""Drive the PyTorch port's reward-scoring path on one CUDA card.

Phases, each printing its own lines; any failure exits non-zero:
  1. the card: nvidia-smi name and power limit, torch / CUDA versions;
  2. build the hand-written CUDA kernels from llava_reward_torch/csrc/;
  3. hold each kernel against its plain PyTorch version on the card, in
     bf16, at the serving path's shapes (with left-padded rows), and time
     kernel, plain version and one library call beside the card's bound;
  4. serve requests at full Phi-3.5-vision width (random bf16 weights from a
     fixed seed, GPM dim 2 + SkipCA) through RewardAdaptor.make_score_fn():
     one pair at B=2 (one side left-padded: B2 + B3 in the decoder) and four
     pairs at B=8, seq 2560, 16+1 crops (B1 in the decoder); B1 runs in the
     CLIP tower for both. The launch counters must show every kernel on
     that path, and the B=2 rewards must match the same forward through the
     plain versions;
  5. one JSON line listing every kernel, then the result line.

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
from llava_reward_torch.ops.rope import rope_cos_sin_for_config
from llava_reward_torch.preprocess.phi3v_processor import build_img_gather_idx
from llava_reward_torch.reward.model import RewardBatch, init_head_params
from llava_reward_torch.reward.preference import preference_prob

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# attention: |kernel - plain| <= ATTN_ATOL + ATTN_RTOL * |plain| on valid rows,
# about one bf16 ulp (2^-7 relative): the two round the probabilities at
# different points (online vs full-row softmax), and the output to bf16
ATTN_ATOL, ATTN_RTOL = 8e-3, 2 ** -7
ATTN_TOL_TEXT = f"{ATTN_ATOL:g} + {ATTN_RTOL:g}*|plain|"
PREP_TOL = 0.0  # rope in fp32 with one rounding on both sides: bit-exact
REWARD_TOL = 5e-3  # bf16 forward through 55 attention layers, |reward| ~ 2e-2

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


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    say("kernel", f"{title}: {detail}; max_abs_err {err:.3e} (tol {tol_text}) pad rows finite "
        f"{finite}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {b_ms:.4f} ms ({b_by}) "
        f"-> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{title} disagrees with its plain version")
    return dict(name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


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
    adaptor = RewardAdaptor(cfg, rcfg, params, device="cuda")
    score = adaptor.make_score_fn()
    if adaptor.make_score_fn() is not score:
        fail("make_score_fn is not memoised")
    seq = 2560
    req2 = make_request(cfg, gen, 1, seq, {1: 40})
    req8 = make_request(cfg, gen, 4, seq, {})
    n_clip = cfg.vision.num_active_layers
    n_dec = cfg.decoder.num_layers
    calls = reps + 1

    fa.reset_counters()  # the main path's run starts here
    r2, t2 = _serve(score, params, req2, reps)
    after2 = dict(fa.LAUNCHES)
    r8, t8 = _serve(score, params, req8, reps)
    launches = dict(fa.LAUNCHES)  # ... and ends here
    say("serve", f"launches after B=2: {after2}; after B=8: {launches}")
    want2 = {"fa_direct": calls * n_clip, "prep": calls * 3 * n_dec, "fa_hm": calls * n_dec}
    if after2 != want2:
        fail(f"B=2 launches {after2} != {want2} (B1 in CLIP, B2 x3 + B3 in the decoder)")
    d8 = {k: launches[k] - after2[k] for k in launches}
    want8 = {"fa_direct": calls * (n_clip + n_dec), "prep": 0, "fa_hm": 0}
    if d8 != want8:
        fail(f"B=8 launches {d8} != {want8} (B1 in CLIP and in the decoder)")
    if any(v == 0 for v in launches.values()):
        fail(f"a kernel of the path never launched: {launches}")

    for name, r, t, pairs in (("B=2", r2, t2, 1), ("B=8", r8, t8, 4)):
        if r.shape != (2 * pairs, 2) or not bool(torch.isfinite(r).all()):
            fail(f"{name} rewards not finite / wrong shape: {r}")
        prob = preference_prob(r[:pairs].float(), r[pairs:].float(), is_general_preference=True,
                               value_head_dim=2, tau=rcfg.general_preference_tau)
        med = float(np.median(t))
        say("serve", f"{name}: rewards {r.float().cpu().numpy().round(6).tolist()} "
            f"preference_prob {prob.cpu().numpy().round(6).tolist()}; "
            f"{med:.4f} s/request (median of {t}), {pairs / med:.3f} pairs/s")

    # the same B=2 forward through the kernels' plain versions
    plain = adaptor.make_score_fn(attn_impl="plain")
    before = dict(fa.LAUNCHES)
    rp = plain(params, req2)
    torch.cuda.synchronize()
    if dict(fa.LAUNCHES) != before:
        fail("the plain forward launched a kernel")
    gap = (r2.float() - rp.float()).abs().max().item()
    p_k = preference_prob(r2[:1].float(), r2[1:].float(), is_general_preference=True,
                          value_head_dim=2, tau=rcfg.general_preference_tau)
    p_p = preference_prob(rp[:1].float(), rp[1:].float(), is_general_preference=True,
                          value_head_dim=2, tau=rcfg.general_preference_tau)
    same = bool(((p_k > 0.5) == (p_p > 0.5)).all())
    say("serve", f"B=2 kernels vs plain versions: rewards {r2.float().cpu().numpy().tolist()} vs "
        f"{rp.float().cpu().numpy().tolist()}; max gap {gap:.3e} (tol {REWARD_TOL:g}); "
        f"prob {p_k.item():.6f} vs {p_p.item():.6f}; same decision {same}")
    if gap > REWARD_TOL or not same:
        fail("B=2 rewards through the kernels disagree with the plain versions")
    return launches


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
    launches = phase_serve(cfg, rcfg)

    kernels = []
    for name, meta in KERNELS.items():
        # one row per kernel: its last check (for B1 the decoder's shapes,
        # which dominate its time on the path)
        row = [r for r in rows if r["name"] == name][-1]
        kernels.append({"name": name, **meta, "launches": launches[name],
                        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
