"""Readings behind chip_smoke.py's softmax-scale and LoRA scale-leaf checks,
on one H100, for the port in a given checkout.

The measuring code is this tree's chip_smoke.py; the package and its CUDA
kernels come from ``--root`` (this checkout by default), so the same readings
can be taken of another commit unpacked beside it (``git archive <commit> |
tar -x -C scratch/other``, a directory that .gitignore lists):

    python tools/scale_leaf_readings.py [--root DIR] [--label NAME] [--controls]
                                        [--swap-b3] [--fp64]

Each reading is one ``READING {json}`` line:

- ``fwd``: B3's output against an fp64 softmax on valid rows, beside the plain
  version's, at the Qwen2.5-VL decoder's GQA shape and Phi-3.5-V's decoder
  shape (relative L2 error; ``shrink``, the error's projection on the exact
  output, a scale bias; the mean error).
- ``fp64-bias`` (alone with ``--fp64``): at each of phase 3's B1 and B3
  shapes and inputs' distributions, the kernel and the plain version each
  against an fp64 softmax on valid rows: the scale-bias reading r of each
  against the exact output (``r_kernel``, ``r_plain``: the projection of its
  error on d = exact(SCALE_STEP s) - exact(s), over <d, d>), beside phase 3's
  r of the kernel against the plain version, and each side's relative L2
  error. The side whose r is nonzero carries the bias.
- ``bias``: phase 3's attention checks (B1 at CLIP's and the decoder's
  shapes, B3 at its three, B8 at its five) at seeds 0-3: the scale-bias
  reading ``r`` of each, and which bound fails it (``tensor``: the kernel
  against its plain version; ``r``: the scale-bias bound); with
  ``--controls`` also with a fault planted at the kernel's launch (softmax
  scale x1.003 and x1.01, kv_start off by one, q/k rounded to fp8 e4m3).
- ``phi3v-layer``: phase 6's one-decoder-layer check at seeds 0-3: every
  leaf's relative L2 gradient error against the plain versions through the
  kernels (twice), and through the reference attention (``xla``); with
  ``--controls`` also through B3 with each planted fault.
- ``phi3v-route``, ``qwen-route``: phase 6's and phase 6q's full-depth LoRA
  step at seeds 0-3: the scale leaves' errors through the kernels (twice)
  and the reference attention, the worst other leaf and layer slice; with
  the kernel route's B8 swapped for its plain version, with ``--swap-b3``
  also its B3, and with ``--controls`` through B3 with each planted fault.

Each scale leaf is read three ways: ``rel``, its relative L2 error against
the plain route; ``cond``, the conditioned error (``_scale_leaf_errors``:
|d dscale| / (||g_b|| ||b|| / |scale|)); and ``ident``, the route's own
identity reading (``_scale_identity``), which chip_smoke.py's checks bound.
Each run carries ``caught``: whether the tensor leaves' bounds fail it
(``tensors``), and whether the identity bound does (``identity``). Two more
faults are planted into the kernel route's scale gradients themselves: cut
(zero), and (in the step) each layer's taken from the next layer.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
ap.add_argument("--label", default="tree")
ap.add_argument("--controls", action="store_true")
ap.add_argument("--swap-b3", action="store_true")
ap.add_argument("--fp64", action="store_true", help="only the fp64-bias readings")
args = ap.parse_args()
ROOT = os.path.abspath(args.root)
sys.path.insert(0, ROOT)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

import numpy as np  # noqa: E402
import torch  # noqa: E402

fa = cs.fa
assert fa.__file__.startswith(ROOT), fa.__file__
T0 = time.time()
CONTROLS = ("scale*1.003", "scale*1.01", "kv_start+1", "fp8 q/k")


def emit(kind, **kw):
    print("READING " + json.dumps({"label": args.label, "kind": kind, **kw,
                                   "t": round(time.time() - T0, 1)}), flush=True)


def _fp8(t):
    return t.to(torch.float8_e4m3fn).to(t.dtype)


def _planted(name, scale, kv_start):
    if name == "scale*1.003":
        scale = scale * 1.003
    elif name == "scale*1.01":
        scale = scale * 1.01
    elif name == "kv_start+1":
        kv_start = kv_start + 1
    return scale, kv_start


def planted_b3(name):
    """B3 with a fault planted at its launch wrapper."""
    real = fa._launch_fa_hm

    def launch(qt, kt, vt, kv_start, causal, window, scale, q_len, key_mask=None,
               segments=False):
        scale, kv_start = _planted(name, scale, kv_start)
        if name == "fp8 q/k":
            qt, kt = _fp8(qt), _fp8(kt)
        return real(qt, kt, vt, kv_start, causal, window, scale, q_len, key_mask, segments)
    return launch


def planted_b1(name):
    """B1 with a fault planted at its launch wrapper (fp8: the q and k
    columns of the fused projection)."""
    real = fa._launch_fa_direct

    def launch(qkv, cos, sin, kv_start, n_heads, D, causal, window, scale, q_len):
        scale, kv_start = _planted(name, scale, kv_start)
        if name == "fp8 q/k":
            qkv = torch.cat([_fp8(qkv[..., : 2 * n_heads * D]), qkv[..., 2 * n_heads * D:]], -1)
        return real(qkv, cos, sin, kv_start, n_heads, D, causal, window, scale, q_len)
    return launch


def planted_b8(name):
    """B8 with a fault planted at its launch wrapper."""
    real = fa._launch_fa_bwd

    def launch(qt, kt, vt, gt, kv_start, causal, window, scale, q_len, key_mask=None,
               segments=False):
        scale, kv_start = _planted(name, scale, kv_start)
        if name == "fp8 q/k":
            qt, kt = _fp8(qt), _fp8(kt)
        return real(qt, kt, vt, gt, kv_start, causal, window, scale, q_len, key_mask, segments)
    return launch


def b3_plain(qt, kt, vt, kv_start, causal, window, scale, q_len, key_mask=None, segments=False):
    return fa.flash_fwd_hm_plain(qt, kt, vt, kv_start, causal=causal, sliding_window=window,
                                 scale=scale, q_len=q_len, key_mask=key_mask, segments=segments)


def b8_plain(qt, kt, vt, gt, kv_start, causal, window, scale, q_len, key_mask=None,
             segments=False):
    return fa.flash_bwd_plain(qt, kt, vt, gt, kv_start, causal=causal, sliding_window=window,
                              scale=scale, q_len=q_len, key_mask=key_mask, segments=segments)


class patched:
    """Replace one launch function of ops/flash_attention.py for a block."""

    def __init__(self, attr, fn):
        self.attr, self.fn = attr, fn

    def __enter__(self):
        self.real = getattr(fa, self.attr)
        if self.fn is not None:
            setattr(fa, self.attr, self.fn)

    def __exit__(self, *exc):
        setattr(fa, self.attr, self.real)


def fwd_accuracy():
    shapes = {"qwen-gqa": (2, 28, 4, 1792, 128, [0, 40]),
              "phi3v": (2, 32, 32, 2560, 96, [0, 300])}
    for name, (B, H, Hk, S, D, kvs) in shapes.items():
        for sharp in (1.0, 4.0):  # score spread: q scaled by this
            gen = torch.Generator(device="cuda").manual_seed(5)
            q = (torch.randn(B, H, S, D, generator=gen, device="cuda") * sharp).bfloat16()
            k = torch.randn(B, Hk, S, D, generator=gen, device="cuda").bfloat16()
            v = torch.randn(B, Hk, S, D, generator=gen, device="cuda").bfloat16()
            kv = torch.tensor(kvs, dtype=torch.int32, device="cuda")
            scale = D ** -0.5
            outs = {"kernel": fa._launch_fa_hm(q, k, v, kv, True, None, scale, S),
                    "plain": fa.flash_fwd_hm_plain(q, k, v, kv, causal=True, sliding_window=None,
                                                   scale=scale, q_len=S)}
            sums = {key: [0.0, 0.0, 0.0] for key in outs}
            den = gap = 0.0
            pos = torch.arange(S, device="cuda")
            for b in range(B):
                rows = pos >= kvs[b]
                kb = k[b].double().repeat_interleave(H // Hk, 0)
                vb = v[b].double().repeat_interleave(H // Hk, 0)
                s = q[b].double() @ kb.transpose(-1, -2) * scale
                s = s.masked_fill(~((pos[None, :] <= pos[:, None]) & (pos[None, :] >= kvs[b])),
                                  float("-inf"))
                ref = (torch.softmax(s, -1) @ vb)[:, rows]
                del s
                den += float((ref * ref).sum())
                for key, o in outs.items():
                    e = o[b][:, rows].double() - ref
                    sums[key][0] += float((e * e).sum())
                    sums[key][1] += float((e * ref).sum())
                    sums[key][2] += float(e.sum())
                gap += float(((outs["kernel"][b][:, rows].double()
                               - outs["plain"][b][:, rows].double()) ** 2).sum())
            n = B * H * S * D
            emit("fwd", shape=name, sharp=sharp, kernel_vs_plain_rel_l2=(gap / den) ** 0.5,
                 **{key: {"rel_l2_vs_fp64": (a / den) ** 0.5, "shrink_vs_fp64": p / den,
                          "mean_err": m / n} for key, (a, p, m) in sums.items()})
            del q, k, v, outs
            torch.cuda.empty_cache()


def _exact(q, k, v, allowed, scale):
    """softmax(q k^T scale) v in fp64 over ``allowed`` (S, S) keys, q / k / v
    (H, S, D) (GQA: k / v repeated); rows with no key come out zero."""
    q, k, v = (t.double() for t in (q, k, v))
    k, v = (t.repeat_interleave(q.shape[0] // t.shape[0], 0) for t in (k, v))
    out = torch.zeros_like(q)
    for h in range(0, q.shape[0], 4):
        sc = (q[h:h + 4] @ k[h:h + 4].transpose(-1, -2) * scale).masked_fill(~allowed,
                                                                             float("-inf"))
        p = torch.softmax(sc, -1).nan_to_num(0.0)
        out[h:h + 4] = p @ v[h:h + 4]
    return out


def _rope64(x, cos, sin):
    """rotate_half RoPE in fp64 on (S, H, D) with (S, D) tables."""
    x = x.double()
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos.double()[:, None] + rot * sin.double()[:, None]


def fp64_bias(seeds):
    """B1 and B3 at phase 3's shapes: kernel and plain version against fp64."""
    cfg, qcfg = cs.phi35_vision_config(), cs.qwen25_vl_7b_config()
    tc = qcfg.text
    step = cs.SCALE_STEP

    def direct(gen, B, S, H, D, causal, rope, kv_start, q_len):
        qkv = torch.randn(B, S, 3 * H * D, generator=gen, device="cuda", dtype=torch.bfloat16)
        cos = sin = None
        if rope:
            cos, sin = cs._cos_sin(cfg, kv_start, S, "cuda")
        kv = torch.tensor(kv_start, dtype=torch.int32, device="cuda")
        kw = dict(n_heads=H, head_dim=D, causal=causal, sliding_window=None, scale=D ** -0.5,
                  valid_len=q_len if q_len != S else None)
        outs = {"kernel": fa._fused_qkv_attention_direct(qkv, cos, sin, kv, **kw),
                "plain": fa.fa_direct_plain(qkv, cos, sin, kv, **kw),
                "plain2": fa.fa_direct_plain(qkv, cos, sin, kv,
                                             **{**kw, "scale": kw["scale"] * step})}
        pos = torch.arange(S, device="cuda")
        for b in range(B):
            x = qkv[b].reshape(S, 3, H, D)
            q, k, v = x[:, 0], x[:, 1], x[:, 2]
            if rope:
                q, k = _rope64(q, cos[b], sin[b]), _rope64(k, cos[b], sin[b])
            allowed = (pos[None, :] >= kv_start[b]) & (pos[None, :] < q_len)
            if causal:
                allowed = allowed & (pos[None, :] <= pos[:, None])
            rows = (pos >= kv_start[b]) & (pos < q_len)
            ex = [_exact(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1), allowed,
                         D ** -0.5 * f).transpose(0, 1)[rows] for f in (1, step)]
            yield {n: o[b][rows].reshape(int(rows.sum()), H, D) for n, o in outs.items()}, ex

    def head_major(gen, B, H, Hk, S, D, causal, kv_start, seg=None):
        q = torch.randn(B, H, S, D, generator=gen, device="cuda", dtype=torch.bfloat16)
        k, v = (torch.randn(B, Hk, S, D, generator=gen, device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        kv = torch.tensor(kv_start, dtype=torch.int32, device="cuda")
        kw = dict(causal=causal, sliding_window=None, scale=D ** -0.5, q_len=S)
        seg_kw = dict(key_mask=seg, segments=True) if seg is not None else {}
        outs = {"kernel": fa._flash_fwd_hm(q, k, v, kv, seg, segments=seg is not None, **kw),
                "plain": fa.flash_fwd_hm_plain(q, k, v, kv, **kw, **seg_kw),
                "plain2": fa.flash_fwd_hm_plain(q, k, v, kv, **seg_kw,
                                                **{**kw, "scale": kw["scale"] * step})}
        pos = torch.arange(S, device="cuda")
        for b in range(B):
            if seg is not None:
                allowed = (seg[b][None, :] != 0) & (seg[b][None, :] == seg[b][:, None])
                rows = seg[b] != 0
            else:
                allowed = (pos[None, :] >= kv_start[b]) & (pos[None, :] <= pos[:, None])
                rows = pos >= kv_start[b]
            ex = [_exact(q[b], k[b], v[b], allowed, D ** -0.5 * f)[:, rows] for f in (1, step)]
            yield {n: o[b][:, rows] for n, o in outs.items()}, ex

    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        seg = torch.from_numpy(np.stack([cs.windowize(g)[1] for g in cs.QWEN_GRIDS] * 4)
                               .astype(np.int32)).cuda()
        cases = [
            ("B1 CLIP (136,640,16,64)", lambda: direct(gen, 136, 640, 16, 64, False, False,
                                                       [0] * 136, 577)),
            ("B1 decoder (8,2560,32,96) rope", lambda: direct(
                gen, 8, 2560, 32, 96, True, True, [0, 300, 0, 1000, 0, 7, 0, 64], 2560)),
            ("B3 phi3v (2,32,2560,96)", lambda: head_major(gen, 2, 32, 32, 2560, 96, True,
                                                           [0, 300])),
            ("B3 qwen GQA (8,28/4,1792,128)", lambda: head_major(
                gen, 8, tc.num_heads, tc.num_kv_heads, cs.QWEN_SEQ, tc.head_dim, True,
                [0, 40, 0, 0, 0, 0, 0, 0])),
            ("B3 segments (8,16,1280,80)", lambda: head_major(
                gen, 8, 16, 16, cs.QWEN_PATCHES, 80, False, [0] * 8, seg)),
        ]
        for name, run in cases:
            acc = {k: [0.0, 0.0] for k in ("kernel", "plain", "kernel_vs_plain")}
            dd = pp = ref2 = 0.0
            for outs, (e1, e2) in run():
                d = e2 - e1
                dd += float((d * d).sum())
                ref2 += float((e1 * e1).sum())
                for side in ("kernel", "plain"):
                    err = outs[side].double() - e1
                    acc[side][0] += float((err * d).sum())
                    acc[side][1] += float((err * err).sum())
                dp = outs["plain2"].double() - outs["plain"].double()
                kp = outs["kernel"].double() - outs["plain"].double()
                acc["kernel_vs_plain"][0] += float((kp * dp).sum())
                pp += float((dp * dp).sum())
            emit("fp64-bias", seed=seed, shape=name,
                 r_kernel=acc["kernel"][0] / dd, r_plain=acc["plain"][0] / dd,
                 r_kernel_vs_plain=acc["kernel_vs_plain"][0] / pp,
                 rel_l2_kernel=(acc["kernel"][1] / ref2) ** 0.5,
                 rel_l2_plain=(acc["plain"][1] / ref2) ** 0.5)
            torch.cuda.empty_cache()


def _cut(names, grads, roll=False):
    """The gradients with every LoRA scale leaf's zeroed, or (``roll``) each
    layer's taken from the next layer."""
    return [(torch.roll(g, 1, 0) if roll else torch.zeros_like(g))
            if n.endswith("/scale") else g for n, g in zip(names, grads)]


def bias_checks(seeds):
    """Phase 3's attention checks, the kernels sound and with each planted
    fault, at each seed (the check's inputs drawn from a generator of that
    seed; timing skipped)."""
    cfg, qcfg = cs.phi35_vision_config(), cs.qwen25_vl_7b_config()
    tc = qcfg.text
    variants = ["sound"] + (list(CONTROLS) if args.controls else [])
    launch = {"B1": ("_launch_fa_direct", planted_b1), "B3": ("_launch_fa_hm", planted_b3),
              "B8": ("_launch_fa_bwd", planted_b8)}
    seg = None

    def checks(gen):
        nonlocal seg
        if seg is None:
            seg = torch.from_numpy(np.stack([cs.windowize(g)[1] for g in cs.QWEN_GRIDS])
                                   .astype(np.int32)).cuda()
        return [
            ("B1", "CLIP", lambda: cs.check_direct("B1 CLIP", gen, 136, 640, 16, 64, False,
                                                   False, [0] * 136, 577, cfg)),
            ("B1", "decoder", lambda: cs.check_direct(
                "B1 decoder", gen, 8, 2560, 32, 96, True, True, [0, 300, 0, 1000, 0, 7, 0, 64],
                2560, cfg)),
            ("B3", "phi3v", lambda: cs.check_prep_and_hm(gen, cfg)[-1]),
            ("B3", "qwen GQA", lambda: cs.check_hm_gqa(gen, qcfg)),
            ("B3", "segments", lambda: cs.check_hm_segments(gen)),
            ("B8", "segments", lambda: cs.check_bwd("B8 segments", gen, 2, 16, cs.QWEN_PATCHES,
                                                    80, False, [0, 0], mask=seg, segments=True)),
            ("B8", "key mask", lambda: cs.check_bwd("B8 key mask", gen, 2, 16, cs.QWEN_PATCHES,
                                                    80, False, [0, 0],
                                                    mask=(seg != 0).to(torch.int32))),
            ("B8", "qwen GQA", lambda: cs.check_bwd("B8 GQA", gen, 2, tc.num_heads, cs.QWEN_SEQ,
                                                    tc.head_dim, True, [0, 40],
                                                    Hk=tc.num_kv_heads)),
            ("B8", "CLIP", lambda: cs.check_bwd("B8 CLIP", gen, 34, 16, 577, 64, False,
                                                [0] * 34)),
            ("B8", "decoder", lambda: cs.check_bwd("B8 decoder", gen, 2, 32, 2560, 96, True,
                                                   [0, 40])),
        ]

    failures = []
    real = (cs.fail, cs.time_ms, cs._launch_split)
    cs.fail = failures.append
    cs.time_ms = lambda fn, iters=10, warmup=2: float("nan")
    cs._launch_split = lambda fn, names, reps=3: "not timed"
    try:
        for seed in seeds:
            for variant in variants:
                gen = torch.Generator(device="cuda").manual_seed(seed)
                read = {}
                for kernel, shape, run in checks(gen):
                    attr, plant = launch[kernel]
                    del failures[:]
                    with patched(attr, None if variant == "sound" else plant(variant)):
                        row = run()
                    read[f"{kernel} {shape}"] = {
                        "r": row["scale_bias"], "max_abs_err": row["max_abs_err"],
                        "caught": {"tensor": any("disagrees" in f for f in failures),
                                   "r": any("scale bias" in f for f in failures)}}
                    torch.cuda.empty_cache()
                emit("bias", seed=seed, variant=variant, read=read)
    finally:
        cs.fail, cs.time_ms, cs._launch_split = real


def phi_layer(seeds):
    """Phase 6's one-layer check (chip_smoke._layer_parity) at each seed,
    from the generator state phase 6 reaches it with."""
    cfg = cs.phi35_vision_config()
    rcfg = cs.RewardConfig(is_general_preference=True, value_head_dim=2,
                           add_cross_attention=True, layer_id=cfg.decoder.num_layers)
    dcfg = cfg.decoder
    runs = ["auto", "auto#2", "plain", "xla"] + (list(CONTROLS) if args.controls else [])
    for seed in seeds:
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        frozen = {"backbone": cs.phi3v.init_params(cfg, gen, torch.bfloat16, "cuda")}
        trainable = cs._trainable(cfg, rcfg, gen)
        batch, _ = cs._halves(cs.make_request(cfg, gen, 1, 2560, {1: 40}), 1)
        mask = torch.ones(2, batch.input_ids.shape[1], dtype=torch.int32, device="cuda")
        mask[1, :40] = 0
        pos = torch.cumsum(mask, -1) - 1
        pos = torch.where(mask == 0, torch.ones_like(pos), pos)
        cos, sin = cs.rope_cos_sin_for_config(pos, dcfg, dtype=torch.bfloat16)
        h = torch.randn(2, mask.shape[1], dcfg.hidden_size, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn(h.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        w = w * mask[:, :, None].to(w.dtype)
        lp = cs.layer_slice(frozen["backbone"]["decoder"]["layers"], 0)
        del frozen
        names = ["h"] + [n for n, _ in cs._named_leaves(trainable["lora"])]
        grads = {}
        for run in runs:
            impl = run if run in ("plain", "xla") else "auto"
            with patched("_launch_fa_hm", planted_b3(run) if run in CONTROLS else None):
                x = h.clone().requires_grad_()
                lora = cs.tree_map(lambda t: t[0].detach().requires_grad_(), trainable["lora"])
                out = cs.phi3.decoder_layer(x, lp, dcfg, cos, sin, mask, impl, lora)
                grads[run] = torch.autograd.grad((out.float() * w.float()).sum(),
                                                 [x] + cs.tree_leaves(lora))
        values = dict(cs._named_leaves(lora))
        rel = {r: {n: cs._rel_err(a, b) for n, a, b in zip(names, g, grads["plain"])}
               for r, g in grads.items() if r != "plain"}
        cond = {r: cs._scale_leaf_errors(names, g, grads["plain"], values)
                for r, g in grads.items() if r != "plain"}
        ident = {r: cs._scale_identity(names, g, values) for r, g in grads.items()}
        # planted into the scale gradient itself: cut (zero)
        ident["cut dscale"] = cs._scale_identity(names, _cut(names, grads["auto"]), values)
        tol = cs.LAYER_GRAD_TOL

        def caught(r):
            return {"tensors": any(v > tol for v in cs._tensor_leaves(rel[r]).values()),
                    "identity": any(v > cs.SCALE_IDENTITY_TOL for v in ident[r].values())}

        emit("phi3v-layer", seed=seed, rel=rel, cond=cond, ident=ident,
             caught={**{r: caught(r) for r in rel if r != "xla"}, "cut dscale": {
                 "identity": any(v > cs.SCALE_IDENTITY_TOL
                                 for v in ident["cut dscale"].values())}},
             scale_grad={r: {n: float(t.float()) for n, t in zip(names, g)
                             if n.endswith("/scale")} for r, g in grads.items()})
        del grads, lp, trainable


def _phi3v_setup(seed):
    """Phase 6's state and pair, from the generator state phase 6 draws them
    with; its route check holds each leaf to the bound alone (floor factor 0)."""
    cfg = cs.phi35_vision_config()
    rcfg = cs.RewardConfig(is_general_preference=True, value_head_dim=2,
                           add_cross_attention=True, layer_id=cfg.decoder.num_layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frozen = {"backbone": cs.phi3v.init_params(cfg, gen, torch.bfloat16, "cuda")}
    trainable = cs._trainable(cfg, rcfg, gen)
    chosen, rejected = cs._halves(cs.make_request(cfg, gen, 1, 2560, {1: 40}), 1)

    def make_loss(impl):
        return cs.make_pairwise_loss_fn(cfg, rcfg, attn_impl=impl, remat=True)
    return frozen, trainable, chosen, rejected, make_loss, 0.0


def _qwen_setup(seed):
    """Phase 6q's state and pair; its route check holds each leaf to the
    larger of the bound and FLOOR_FACTOR times its drift floor."""
    qcfg = cs.qwen25_vl_7b_config()
    rcfg = cs.RewardConfig(is_general_preference=True, value_head_dim=2,
                           add_cross_attention=True, layer_id=qcfg.text.num_layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frozen = {"backbone": cs.qwen25_vl.init_params(qcfg, gen, torch.bfloat16, "cuda")}
    trainable = cs._qwen_trainable(qcfg, rcfg, gen, frozen["backbone"])
    rng = np.random.default_rng(seed)
    chosen, rejected = cs._halves(cs.qwen_request(qcfg, rng, cs.QWEN_GRIDS, {1: 40}), 1)

    def make_loss(impl):
        return cs.make_pairwise_loss_fn(qcfg, rcfg, attn_impl=impl, remat=True,
                                        projector_path=cs.PROJECTOR_PATHS["qwen"])
    return frozen, trainable, chosen, rejected, make_loss, cs.FLOOR_FACTOR


def route(kind, setup, seeds):
    """A full-depth LoRA step's route check (chip_smoke._route_parity's
    readings) at each seed: phase 6's (``phi3v-route``) or phase 6q's
    (``qwen-route``)."""
    runs = {"xla": ("xla", None), "auto": ("auto", None), "auto#2": ("auto", None),
            "B3 + plain B8": ("auto", ("_launch_fa_bwd", b8_plain))}
    if args.swap_b3:
        runs["plain B3 + B8"] = ("auto", ("_launch_fa_hm", b3_plain))
    if args.controls:
        runs.update({c: ("auto", ("_launch_fa_hm", planted_b3(c))) for c in CONTROLS})
    for seed in seeds:
        torch.cuda.empty_cache()
        frozen, trainable, chosen, rejected, make_loss, ff = setup(seed)

        def step(impl):
            return cs._loss_and_grads(make_loss(impl), trainable, frozen, chosen, rejected)

        names = [n for n, _ in cs._named_leaves(trainable)]
        values = dict(cs._named_leaves(trainable))
        lp, gp = step("plain")
        read, floor = {"plain": {"ident": cs._scale_identity(names, gp, values)}}, None
        for key, (impl, swap) in runs.items():
            with patched(*(swap or ("_launch_fa_hm", None))):
                lk, gk = step(impl)
            (_, leaves), (piece, slices) = cs._grad_errors(names, gk, gp, cs._lora_factor)
            cond = cs._scale_leaf_errors(names, gk, gp, values)
            ident = cs._scale_identity(names, gk, values)
            if floor is None:  # the reference attention's, read first
                floor = (cs._tensor_leaves(leaves), slices)
            gap = abs(lk.item() - lp.item()) > cs.TRAIN_LOSS_TOL
            sl = bool(cs._over(slices, floor[1], cs.TRAIN_SLICE_TOL, ff))
            tensors = cs._tensor_leaves(leaves)
            read[key] = {
                "loss": lk.item(),
                "scale": {n: v for n, v in leaves.items() if n.endswith("/scale")},
                "cond": cond,
                "ident": ident,
                "worst_other": max((v, n) for n, v in tensors.items()),
                "worst_slice": (slices[piece], piece),
                "caught": {
                    "tensors": gap or sl or bool(cs._over(tensors, floor[0], cs.TRAIN_GRAD_TOL,
                                                          ff)),
                    "identity": any(v > cs.SCALE_IDENTITY_TOL for v in ident.values())},
            }
            if key == "auto":  # planted into the scale gradients: cut, and shifted a layer
                for name, g in (("cut dscale", _cut(names, gk)),
                                ("dscale of the next layer", _cut(names, gk, roll=True))):
                    idt = cs._scale_identity(names, g, values)
                    read[name] = {"ident": idt, "caught": {
                        "identity": any(v > cs.SCALE_IDENTITY_TOL for v in idt.values())}}
            del gk
        emit(kind, seed=seed, plain_loss=lp.item(), read=read)
        del frozen, trainable, gp


cs.phase_device()
cs.phase_build()
if args.fp64:
    fp64_bias([0, 1])
else:
    fwd_accuracy()
    bias_checks([0, 1, 2, 3])
    phi_layer([0, 1, 2, 3])
    route("phi3v-route", _phi3v_setup, [0, 1, 2, 3])
    route("qwen-route", _qwen_setup, [0, 1, 2, 3])
emit("done")
