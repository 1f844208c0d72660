"""Phi-3.5-vision's hooks: its chat template, its rows' shapes and work, its
seeded weights' layout, the port's config for it and its plain reference.
A configuration file with ``"family": "phi3v"`` reads this file."""

from __future__ import annotations

from ..harness import flops, geometry
from ..harness.weights import Leaf, head_spec

DECODER = "decoder"  # the decoder's subtree in the port's backbone


def chat_template(content) -> str:
    return f"<|user|> {content} " + "<|end|>\n<|assistant|>\n"


def render(tokenizer, prompt: str) -> str:
    """The prompt as the port's dataset layer renders it: Phi-3's template
    less its 22-character assistant cue, with EOS."""
    msg = [{"role": "user", "content": f"<|image_1|>\n{prompt}"}]
    return tokenizer.apply_chat_template(msg, tokenize=False,
                                         add_generation_prompt=True)[:-22] + tokenizer.eos_token


def row_shape(cfg: dict, tok, text: str, width: int, height: int) -> tuple:
    """(valid tokens, image tokens, (hc, wc) crops)."""
    from ..reference.phi3v import row_tokens

    return row_tokens(cfg, tok, text, width, height)


def row_work(c: dict, shape: tuple, slots: int, w8a8: bool = False) -> flops.Work:
    """One row: ``hc * wc`` crops and the global view through the CLIP
    tower's active layers, the projector over the image tokens, the decoder
    over ``n`` valid tokens, SkipCA over ``slots`` vision slots."""
    n, _, (hc, wc) = shape
    t, v = c["text"], c["vision"]
    w = flops.Work()
    Hv, Iv = v["hidden_size"], v["intermediate_size"]
    Lv = v["num_hidden_layers"] + v["feature_layer"] + 1
    P = v["patch_size"]
    T = (v["image_size"] // P) ** 2 + 1
    crops = hc * wc + 1
    rows = crops * T
    w.mm(2 * crops * (T - 1) * P * P * v["num_channels"] * Hv)
    w.mm(2 * rows * Lv * (4 * Hv * Hv + 2 * Hv * Iv))
    for _ in range(crops):
        flops.attn(w, "attn.clip", v["num_attention_heads"], v["num_attention_heads"],
                   Hv // v["num_attention_heads"], T, Lv, False, 2 * T * 4 * Hv)
    H, I = t["hidden_size"], t["intermediate_size"]
    m = geometry.phi3v_tokens(hc, wc)
    w.mm(2 * m * (4 * c["image_dim_out"] * H + H * H))
    L, nh, nkv = t["num_hidden_layers"], t["num_attention_heads"], t["num_key_value_heads"]
    d = H // nh
    w.mm(2 * n * L * (H * (nh + 2 * nkv) * d + nh * d * H + 3 * H * I))
    flops.attn(w, "attn.dec", nh, nkv, d, n, L, True, 2 * n * ((2 * nh + 2 * nkv) * d + 2 * d))
    w.mm(2 * n * H * H + 4 * slots * H * H + 4 * n * slots * H)
    return w


def weight_spec(c: dict):
    t, v = c["text"], c["vision"]
    H, I, L, V = t["hidden_size"], t["intermediate_size"], t["num_hidden_layers"], t["vocab_size"]
    hd = H // t["num_attention_heads"]
    q, kv = t["num_attention_heads"] * hd, t["num_key_value_heads"] * hd
    Hv, Iv, Lv = v["hidden_size"], v["intermediate_size"], v["num_hidden_layers"]
    P = v["patch_size"]
    npos = (v["image_size"] // P) ** 2 + 1
    D = 4 * c["image_dim_out"]
    r = 0.02
    vis: list[Leaf] = [("vision/clip/class_embedding", (Hv,), "randn", r),
                       ("vision/clip/patch_proj", (P * P * v["num_channels"], Hv), "randn", r),
                       ("vision/clip/position_embedding", (npos, Hv), "randn", r),
                       ("vision/clip/pre_layernorm/weight", (Hv,), "ones", 0),
                       ("vision/clip/pre_layernorm/bias", (Hv,), "zeros", 0),
                       ("vision/clip/post_layernorm/weight", (Hv,), "ones", 0),
                       ("vision/clip/post_layernorm/bias", (Hv,), "zeros", 0)]
    for ln in ("ln1", "ln2"):
        vis += [(f"vision/clip/layers/{ln}/weight", (Lv, Hv), "ones", 0),
                (f"vision/clip/layers/{ln}/bias", (Lv, Hv), "zeros", 0)]
    for n in ("q", "k", "v", "out"):
        vis += [(f"vision/clip/layers/attn/{n}/kernel", (Lv, Hv, Hv), "randn", r),
                (f"vision/clip/layers/attn/{n}/bias", (Lv, Hv), "zeros", 0)]
    vis += [("vision/clip/layers/mlp/fc1/kernel", (Lv, Hv, Iv), "randn", r),
            ("vision/clip/layers/mlp/fc1/bias", (Lv, Iv), "zeros", 0),
            ("vision/clip/layers/mlp/fc2/kernel", (Lv, Iv, Hv), "randn", r),
            ("vision/clip/layers/mlp/fc2/bias", (Lv, Hv), "zeros", 0),
            ("vision/glb_GN", (D,), "zeros", 0), ("vision/sub_GN", (D,), "zeros", 0),
            ("vision/img_projection/fc1/kernel", (D, H), "randn", r),
            ("vision/img_projection/fc1/bias", (H,), "zeros", 0),
            ("vision/img_projection/fc2/kernel", (H, H), "randn", r),
            ("vision/img_projection/fc2/bias", (H,), "zeros", 0)]
    layers = [("decoder/layers/input_layernorm", (L, H), "ones", 0),
              ("decoder/layers/qkv_proj", (L, H, q + 2 * kv), "randn", r),
              ("decoder/layers/o_proj", (L, q, H), "randn", r),
              ("decoder/layers/post_attention_layernorm", (L, H), "ones", 0),
              ("decoder/layers/gate_up_proj", (L, H, 2 * I), "randn", r),
              ("decoder/layers/down_proj", (L, I, H), "randn", r)]
    rest = [("decoder/embed_tokens", (V, H), "randn", r),
            ("decoder/final_layernorm", (H,), "ones", 0)]
    return {"vision": vis, "layers": layers, "rest": rest,
            "head": head_spec(c, H, 1.0 / (H + 1))}


def port_config(cfg: dict):
    from llava_reward_torch.core import config as C

    t, v = cfg["text"], cfg["vision"]
    rs = t["rope_scaling"]
    dec = C.DecoderConfig(
        vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
        intermediate_size=t["intermediate_size"], num_layers=t["num_hidden_layers"],
        num_heads=t["num_attention_heads"], num_kv_heads=t["num_key_value_heads"],
        rms_norm_eps=t["rms_norm_eps"], rope_theta=t["rope_theta"],
        max_position_embeddings=t["max_position_embeddings"],
        original_max_position_embeddings=t["original_max_position_embeddings"],
        rope_scaling=C.RopeScalingConfig(rope_type=rs["type"],
                                         short_factor=tuple(rs["short_factor"]),
                                         long_factor=tuple(rs["long_factor"])),
        sliding_window=t["sliding_window"], hidden_act=t["hidden_act"],
        pad_token_id=t["pad_token_id"], eos_token_id=t["eos_token_id"])
    vis = C.VisionConfig(
        hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
        num_layers=v["num_hidden_layers"], num_heads=v["num_attention_heads"],
        image_size=v["image_size"], patch_size=v["patch_size"],
        num_channels=v["num_channels"], layer_norm_eps=v["layer_norm_eps"],
        hidden_act=v["hidden_act"], feature_layer_idx=v["feature_layer"])
    return C.Phi3VConfig(decoder=dec, vision=vis, num_crops=cfg["num_crops"],
                         image_dim_out=cfg["image_dim_out"])


def ref_reward(cfg: dict, weights: dict, tok, text: str, png: bytes, slots: int, device,
               w8a8: bool = False):
    """The plain reference's reward of one row; ``slots``: the image tokens
    SkipCA pads to in the row's device call."""
    from ..reference import phi3v

    return phi3v.reward(cfg, weights, tok, text, png, slots, device)
