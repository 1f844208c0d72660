"""Qwen2.5-VL's hooks: its chat template, its rows' shapes and work, its
seeded weights' layout, the port's config for it and its plain reference.
A configuration file with ``"family": "qwen"`` reads this file."""

from __future__ import annotations

from ..harness import flops, geometry
from ..harness.weights import Leaf, head_spec

DECODER = "text"  # the decoder's subtree in the port's backbone


def chat_template(content) -> str:
    body = " ".join("<|vision_start|> <|image_pad|> <|vision_end|>"
                    if c["type"] == "image" else c["text"] for c in content)
    return ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
            f"<|im_start|> user {body} <|im_end|>" + "\n<|im_start|>assistant\n")


def render(tokenizer, prompt: str) -> str:
    """The prompt as the port's dataset layer renders it: Qwen's template
    sliced [58:-23] and stripped."""
    msg = [{"role": "user", "content": [{"type": "image"}, {"type": "text", "text": prompt}]}]
    return tokenizer.apply_chat_template(msg, tokenize=False,
                                         add_generation_prompt=True)[58:-23].strip()


def row_shape(cfg: dict, tok, text: str, width: int, height: int) -> tuple:
    """(valid tokens, merged units, (gh, gw) patches)."""
    from ..reference.qwen import row_tokens

    return row_tokens(cfg, tok, text, width, height)


def row_work(c: dict, shape: tuple, slots: int, w8a8: bool = False) -> flops.Work:
    """One row: ``gh * gw`` patches through the vision tower (its window and
    full blocks), the merger, the decoder over ``n`` valid tokens (its
    projections at the int8 peak when ``w8a8``), SkipCA over the image's
    merged units."""
    n, _, (gh, gw) = shape
    t, v = c["text"], c["vision"]
    w = flops.Work()
    Hv, Iv, Lv = v["hidden_size"], v["intermediate_size"], v["depth"]
    nhv = v["num_heads"]
    P = gh * gw
    pd = v["in_channels"] * v["temporal_patch_size"] * v["patch_size"] ** 2
    w.mm(2 * P * pd * Hv)
    w.mm(2 * P * Lv * (4 * Hv * Hv + 3 * Hv * Iv))
    full = len(v["fullatt_block_indexes"])
    flops.attn(w, "attn.vfull", nhv, nhv, Hv // nhv, P, full, False, 2 * P * 4 * Hv)
    for wp in geometry.qwen_windows(gh, gw, v):
        flops.attn(w, "attn.vwin", nhv, nhv, Hv // nhv, wp, Lv - full, False, 2 * wp * 4 * Hv)
    mm = v["spatial_merge_size"] ** 2
    U = P // mm
    w.mm(2 * U * (mm * Hv * mm * Hv + mm * Hv * v["out_hidden_size"]))
    H, I = t["hidden_size"], t["intermediate_size"]
    L, nh, nkv = t["num_hidden_layers"], t["num_attention_heads"], t["num_key_value_heads"]
    d = H // nh
    qkv = (nh + 2 * nkv) * d
    proj = {"qkv": (H, qkv), "o": (nh * d, H), "gate_up": (H, 2 * I), "down": (I, H)}
    peak = flops.INT8 if w8a8 else flops.BF16
    for name, (K, N) in proj.items():
        w.mm(2 * n * K * N * L, peak)
        if w8a8:
            # the GEMM: codes in, the output out, the int8 weight once a call
            w.term(f"w8a8.gemm.{name}", 2 * n * K * N, n * K + 2 * n * N + 4 * n, flops.INT8,
                   L, fixed_bytes=K * N)
    if w8a8:
        # the epilogues that make the codes: RMSNorm -> qkv and gate_up (B4),
        # the attention output -> o (B6), silu(gate) * up -> down (B5)
        for name, K in (("rms_qkv", H), ("rms_gate_up", H), ("row_o", nh * d)):
            w.term(f"w8a8.quant.{name}", 0.0, n * (2 * K + K + 4), flops.INT8, L)
        w.term("w8a8.quant.silu_down", 0.0, n * (2 * 2 * I + I + 4), flops.INT8, L)
    flops.attn(w, "attn.dec", nh, nkv, d, n, L, True, 2 * n * (qkv + nh * d + 2 * d))
    w.mm(2 * n * H * H + 4 * U * H * H + 4 * n * U * H)
    return w


def weight_spec(c: dict):
    t, v = c["text"], c["vision"]
    H, I, L, V = t["hidden_size"], t["intermediate_size"], t["num_hidden_layers"], t["vocab_size"]
    hd = H // t["num_attention_heads"]
    q, kv = t["num_attention_heads"] * hd, t["num_key_value_heads"] * hd
    Hv, Iv, Lv = v["hidden_size"], v["intermediate_size"], v["depth"]
    pd = v["in_channels"] * v["temporal_patch_size"] * v["patch_size"] ** 2
    mm = v["spatial_merge_size"] ** 2
    r = 0.02
    vis: list[Leaf] = [("visual/patch_embed", (pd, Hv), "randn", r),
                       ("visual/blocks/norm1", (Lv, Hv), "ones", 0),
                       ("visual/blocks/norm2", (Lv, Hv), "ones", 0),
                       ("visual/blocks/qkv/kernel", (Lv, Hv, 3 * Hv), "randn", r),
                       ("visual/blocks/qkv/bias", (Lv, 3 * Hv), "zeros", 0),
                       ("visual/blocks/proj/kernel", (Lv, Hv, Hv), "randn", r),
                       ("visual/blocks/proj/bias", (Lv, Hv), "zeros", 0)]
    for n, (i, o) in (("gate", (Hv, Iv)), ("up", (Hv, Iv)), ("down", (Iv, Hv))):
        vis += [(f"visual/blocks/mlp/{n}/kernel", (Lv, i, o), "randn", r),
                (f"visual/blocks/mlp/{n}/bias", (Lv, o), "zeros", 0)]
    vis += [("visual/merger/ln_q", (Hv,), "ones", 0),
            ("visual/merger/fc1/kernel", (mm * Hv, mm * Hv), "randn", r),
            ("visual/merger/fc1/bias", (mm * Hv,), "zeros", 0),
            ("visual/merger/fc2/kernel", (mm * Hv, v["out_hidden_size"]), "randn", r),
            ("visual/merger/fc2/bias", (v["out_hidden_size"],), "zeros", 0)]
    layers = [("text/layers/input_layernorm", (L, H), "ones", 0)]
    for n, o in (("q_proj", q), ("k_proj", kv), ("v_proj", kv)):
        layers += [(f"text/layers/{n}/kernel", (L, H, o), "randn", r),
                   (f"text/layers/{n}/bias", (L, o), "zeros", 0)]
    layers += [("text/layers/o_proj/kernel", (L, q, H), "randn", r),
               ("text/layers/post_attention_layernorm", (L, H), "ones", 0),
               ("text/layers/gate_proj/kernel", (L, H, I), "randn", r),
               ("text/layers/up_proj/kernel", (L, H, I), "randn", r),
               ("text/layers/down_proj/kernel", (L, I, H), "randn", r)]
    rest = [("text/embed_tokens", (V, H), "randn", r),
            ("text/final_layernorm", (H,), "ones", 0)]
    return {"vision": vis, "layers": layers, "rest": rest,
            "head": head_spec(c, H, 1.0 / (H + 1))}


def port_config(cfg: dict):
    from llava_reward_torch.core import config as C

    t, v = cfg["text"], cfg["vision"]
    text = C.QwenTextConfig(
        vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
        intermediate_size=t["intermediate_size"], num_layers=t["num_hidden_layers"],
        num_heads=t["num_attention_heads"], num_kv_heads=t["num_key_value_heads"],
        rms_norm_eps=t["rms_norm_eps"], rope_theta=t["rope_theta"],
        max_position_embeddings=t["max_position_embeddings"],
        mrope_section=tuple(t["rope_scaling"]["mrope_section"]),
        sliding_window=t["sliding_window"] if t["use_sliding_window"] else None,
        hidden_act=t["hidden_act"], pad_token_id=t["pad_token_id"],
        eos_token_id=t["eos_token_id"], image_token_id=t["image_token_id"])
    vis = C.QwenVisionConfig(**{k: (tuple(x) if isinstance(x, list) else x)
                                for k, x in v.items()})
    return C.Qwen25VLConfig(text=text, vision=vis, min_pixels=cfg["min_pixels"],
                            max_pixels=cfg["max_pixels"])


def ref_reward(cfg: dict, weights: dict, tok, text: str, png: bytes, slots: int, device,
               w8a8: bool = False):
    """The plain reference's reward of one row, its decoder W8A8 when the
    cell states it (SkipCA pads to the row's own units)."""
    from ..reference import qwen

    return qwen.reward(cfg, weights, tok, text, png, device, w8a8=w8a8)
