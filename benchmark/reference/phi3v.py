"""Plain float32 Phi-3.5-vision reward model: from the image bytes and the
prompt to the reward, after the published processor and modeling files
(processing_phi3_v.py, modeling_phi3_v.py) and the reward model's SkipCA and
value head. It reads the seeded weights in float32 one layer at a time and
imports nothing of the port.

Departures, each equal in value to the published code: the CLIP tower runs
only the layers whose output is read (the penultimate hidden state); SkipCA
and the value head are evaluated at the last position only, the one the
reward is read at.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..harness import geometry
from .common import (CLIP_MEAN, CLIP_STD, attention, decode, f32, layer_norm, low, product,
                     rms_norm, rotate_half, skipca_last)

CROP = 336


def pixels(png: bytes, num_crops: int):
    """HD transform: (global view, crops) normalised float32 (n, 336, 336, 3),
    and the crop grid."""
    from PIL import Image

    img = decode(png)
    w, h = img.size
    new_w, new_h, target_h, transposed = geometry.phi3v_hd(w, h, num_crops, CROP)
    if transposed:
        img = img.transpose(Image.TRANSPOSE)
    arr = np.asarray(img.resize((new_w, new_h), Image.BILINEAR), dtype=np.uint8)
    top = (target_h - new_h) // 2
    arr = np.pad(arr, ((top, target_h - new_h - top), (0, 0), (0, 0)), constant_values=255)
    if transposed:
        arr = arr.transpose(1, 0, 2)
    x = (arr.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    H, W = x.shape[:2]
    hc, wc = H // CROP, W // CROP
    t = torch.from_numpy(np.ascontiguousarray(x))
    glb = F.interpolate(t.permute(2, 0, 1)[None], size=(CROP, CROP), mode="bicubic",
                        align_corners=False)[0].permute(1, 2, 0)
    crops = t.reshape(hc, CROP, wc, CROP, 3).permute(0, 2, 1, 3, 4).reshape(-1, CROP, CROP, 3)
    return torch.cat([glb[None], crops]), (hc, wc)


def clip_features(clip: dict, v: dict, imgs: torch.Tensor) -> torch.Tensor:
    """(n, 336, 336, 3) -> (n, 576, C): the penultimate layer, CLS dropped."""
    P = v["patch_size"]
    n = imgs.shape[0]
    g = CROP // P
    x = imgs.reshape(n, g, P, g, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(n, g * g, P * P * 3)
    h = low(low(x) @ f32(clip["patch_proj"]))
    cls = f32(clip["class_embedding"]).expand(n, 1, -1)
    h = low(torch.cat([cls, h], 1) + f32(clip["position_embedding"])[None])
    eps = v["layer_norm_eps"]
    h = layer_norm(h, clip["pre_layernorm"]["weight"], clip["pre_layernorm"]["bias"], eps)
    L = v["num_hidden_layers"] + v["feature_layer"] + 1
    heads = v["num_attention_heads"]
    d = v["hidden_size"] // heads
    lp = clip["layers"]
    for i in range(L):
        def lin(p, x):
            return low(product(x, p["kernel"][i]) + f32(p["bias"][i]))

        x = layer_norm(h, lp["ln1"]["weight"][i], lp["ln1"]["bias"][i], eps)
        a = lp["attn"]
        out = torch.stack([attention(*(lin(a[k], x[j]).reshape(-1, heads, d)
                                       for k in ("q", "k", "v"))) for j in range(n)])
        h = low(h + lin(a["out"], out))
        x = layer_norm(h, lp["ln2"]["weight"][i], lp["ln2"]["bias"][i], eps)
        x = lin(lp["mlp"]["fc1"], x)
        h = low(h + lin(lp["mlp"]["fc2"], low(x * torch.sigmoid(1.702 * x))))
    return h[:, 1:]


def image_tokens(params: dict, v: dict, feats: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """HD feature transform: 2x2 merges, sub crops in their grid with a
    newline a row, the separator, the global view with its newlines; then
    the projector."""
    n, L, C = feats.shape
    g = int(math.isqrt(L))
    m = feats.reshape(n, g // 2, 2, g // 2, 2, C).permute(0, 1, 3, 2, 4, 5).reshape(
        n, g // 2, g // 2, 4 * C)
    vis = params["vision"]
    sub_gn, glb_gn = f32(vis["sub_GN"]), f32(vis["glb_GN"])
    G = g // 2
    sub = m[1:].reshape(hc, wc, G, G, 4 * C).permute(0, 2, 1, 3, 4).reshape(hc * G, wc * G, 4 * C)
    sub = torch.cat([sub, sub_gn.expand(hc * G, 1, 4 * C)], 1).reshape(-1, 4 * C)
    glb = torch.cat([m[0], sub_gn.expand(G, 1, 4 * C)], 1).reshape(-1, 4 * C)
    seq = torch.cat([sub, glb_gn[None], glb])
    proj = vis["img_projection"]
    x = low(F.gelu(low(low(seq @ f32(proj["fc1"]["kernel"])) + f32(proj["fc1"]["bias"]))))
    return low(low(x @ f32(proj["fc2"]["kernel"])) + f32(proj["fc2"]["bias"]))


def rope(t: dict, n: int, device) -> tuple:
    """su-scaled rotary tables for positions 0..n-1 (the short factors below
    the original context, the long ones beyond)."""
    d = t["hidden_size"] // t["num_attention_heads"]
    rs = t["rope_scaling"]
    orig, mx = t["original_max_position_embeddings"], t["max_position_embeddings"]
    ext = torch.tensor(rs["long_factor"] if n > orig else rs["short_factor"],
                       dtype=torch.float32, device=device)
    inv = 1.0 / (ext * t["rope_theta"] ** (torch.arange(0, d, 2, device=device).float() / d))
    freqs = torch.arange(n, device=device).float()[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], -1)
    scale = math.sqrt(1 + math.log(mx / orig) / math.log(orig)) if mx > orig else 1.0
    return low(torch.cos(emb) * scale), low(torch.sin(emb) * scale)


def decoder_last(dec: dict, t: dict, x: torch.Tensor) -> torch.Tensor:
    """The decoder over one row's embeddings (n, H) -> the last position's
    final hidden state."""
    n, H = x.shape
    nh, nkv = t["num_attention_heads"], t["num_key_value_heads"]
    d = H // nh
    eps = t["rms_norm_eps"]
    cos, sin = rope(t, n, x.device)
    lp = dec["layers"]
    I = t["intermediate_size"]
    for i in range(t["num_hidden_layers"]):
        y = product(rms_norm(x, lp["input_layernorm"][i], eps), lp["qkv_proj"][i])
        q = y[:, :nh * d].reshape(n, nh, d)
        k = y[:, nh * d:(nh + nkv) * d].reshape(n, nkv, d)
        v = y[:, (nh + nkv) * d:].reshape(n, nkv, d)
        q = low(q * cos[:, None] + rotate_half(q) * sin[:, None])
        k = low(k * cos[:, None] + rotate_half(k) * sin[:, None])
        x = low(x + product(attention(q, k, v, causal=True), lp["o_proj"][i]))
        y = product(rms_norm(x, lp["post_attention_layernorm"][i], eps), lp["gate_up_proj"][i])
        x = low(x + product(low(y[:, I:] * low(F.silu(y[:, :I]))), lp["down_proj"][i]))
    return rms_norm(x[-1], dec["final_layernorm"], eps)


def reward(cfg: dict, weights: dict, tokenizer, text: str, png: bytes, skipca_slots: int,
           device) -> np.ndarray:
    """The reward of one row: ``text`` is the prompt as the dataset layer
    renders it (one ``<|image_1|>`` tag), ``skipca_slots`` the image-token
    count SkipCA pads to (the largest in the row's device call)."""
    import re

    t = cfg["text"]
    params, head = weights["backbone"], weights["head"]
    imgs, (hc, wc) = pixels(png, cfg["num_crops"])
    with torch.no_grad():
        feats = clip_features(params["vision"]["clip"], cfg["vision"], imgs.to(device))
        img = image_tokens(params, cfg["vision"], feats, hc, wc)
        before, after = re.split(r"<\|image_\d+\|>", text)
        ids = [torch.tensor(tokenizer(s)["input_ids"], dtype=torch.long, device=device)
               for s in (before, after)]
        emb = f32(params["decoder"]["embed_tokens"])
        x = torch.cat([emb[ids[0]], img, emb[ids[1]]])
        last = decoder_last(params["decoder"], t, x)
        if cfg["reward"]["add_cross_attention"]:
            last = skipca_last(head, last, img, skipca_slots, t["rms_norm_eps"])
        r = low(last @ f32(head["value_head"]["kernel"]))
    return r.double().cpu().numpy()


def row_tokens(cfg: dict, tokenizer, text: str, width: int, height: int) -> tuple:
    """(valid tokens, image tokens) of a row, for the work counters."""
    import re

    hc, wc = geometry.phi3v_grid(width, height, cfg["num_crops"], CROP)
    m = geometry.phi3v_tokens(hc, wc)
    n = sum(len(tokenizer(s)["input_ids"]) for s in re.split(r"<\|image_\d+\|>", text))
    return n + m, m, (hc, wc)
