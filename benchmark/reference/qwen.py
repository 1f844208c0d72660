"""Plain float32 Qwen2.5-VL reward model: from the image bytes and the prompt
to the reward, after the published processor (qwen_vl_utils smart_resize,
Qwen2VLImageProcessor's patch order), modeling file (the window-attention
vision tower with its full blocks, the merger, M-RoPE, the GQA decoder) and
the reward model's SkipCA and value head. With ``w8a8`` every decoder
projection is computed as W8A8 does it (``common.product``), from the
float weights it is handed. It reads the seeded weights in float32 one
layer at a time and imports nothing of the port.

Departures, each equal in value to the published code: window attention is
a mask over the patches in their own order, where the published tower
permutes them into window order and back; SkipCA and the value head are
evaluated at the last position only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..harness import geometry
from .common import (CLIP_MEAN, CLIP_STD, attention, decode, f32, low, rms_norm, rotate_half,
                     product, skipca_last)


def patches(png: bytes, cfg: dict):
    """(gh * gw, C * tps * ps * ps) normalised float32 patches in
    merged-block order, and (gh, gw)."""
    from PIL import Image

    v = cfg["vision"]
    ps, m, tps = v["patch_size"], v["spatial_merge_size"], v["temporal_patch_size"]
    img = decode(png)
    w, h = img.size
    hb, wb = geometry.qwen_resize(h, w, ps * m, cfg["min_pixels"], cfg["max_pixels"])
    x = np.asarray(img.resize((wb, hb), Image.BICUBIC), dtype=np.float32)
    x = ((x / 255.0 - CLIP_MEAN) / CLIP_STD).transpose(2, 0, 1)
    x = np.tile(x[None], (tps, 1, 1, 1))
    gh, gw = hb // ps, wb // ps
    x = x.reshape(tps, 3, gh // m, m, ps, gw // m, m, ps).transpose(2, 5, 3, 6, 1, 0, 4, 7)
    return torch.from_numpy(np.ascontiguousarray(x.reshape(gh * gw, -1))), (gh, gw)


def _block_positions(gh: int, gw: int, m: int):
    """(h, w) of each patch in merged-block order, and its window's index."""
    hpos = np.arange(gh)[:, None].repeat(gw, 1)
    wpos = np.arange(gw)[None, :].repeat(gh, 0)

    def order(p):
        return p.reshape(gh // m, m, gw // m, m).transpose(0, 2, 1, 3).reshape(-1)

    return order(hpos), order(wpos)


def vision(params: dict, cfg: dict, x: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    v = cfg["vision"]
    m, H = v["spatial_merge_size"], v["hidden_size"]
    heads = v["num_heads"]
    d = H // heads
    eps = v["rms_norm_eps"]
    P = x.shape[0]
    hp, wp = _block_positions(gh, gw, m)
    win = v["window_size"] // v["patch_size"]  # patches a window side
    wid = torch.from_numpy((hp // win) * 100000 + wp // win).to(x.device)
    same_window = wid[:, None] == wid[None, :]
    q4 = d // 4
    inv = 1.0 / (10000.0 ** (torch.arange(q4, device=x.device).float() / q4))
    pos = torch.stack([torch.from_numpy(hp), torch.from_numpy(wp)], -1).to(x.device).float()
    half = (pos[..., None] * inv).reshape(P, -1)
    emb = torch.cat([half, half], -1)
    cos, sin = torch.cos(emb)[:, None], torch.sin(emb)[:, None]
    vp = params["visual"]
    h = low(low(x) @ f32(vp["patch_embed"]))
    b = vp["blocks"]
    full = set(v["fullatt_block_indexes"])
    for i in range(v["depth"]):
        y = low(low(rms_norm(h, b["norm1"][i], eps) @ f32(b["qkv"]["kernel"][i]))
                + f32(b["qkv"]["bias"][i]))
        q, k, vv = y.reshape(P, 3, heads, d).unbind(1)
        q = low(q * cos + rotate_half(q) * sin)
        k = low(k * cos + rotate_half(k) * sin)
        a = attention(q, k, vv, mask=None if i in full else same_window)
        h = low(h + low(low(a @ f32(b["proj"]["kernel"][i])) + f32(b["proj"]["bias"][i])))
        y = rms_norm(h, b["norm2"][i], eps)
        mp = b["mlp"]

        def lin(n, t):
            return low(low(t @ f32(mp[n]["kernel"][i])) + f32(mp[n]["bias"][i]))

        h = low(h + lin("down", low(low(F.silu(lin("gate", y))) * lin("up", y))))
    mg = vp["merger"]
    y = rms_norm(h, mg["ln_q"], eps).reshape(P // (m * m), -1)
    y = low(F.gelu(low(low(y @ f32(mg["fc1"]["kernel"])) + f32(mg["fc1"]["bias"]))))
    return low(low(y @ f32(mg["fc2"]["kernel"])) + f32(mg["fc2"]["bias"]))


def mrope_positions(ids: list, image_id: int, lh: int, lw: int) -> np.ndarray:
    """(3, n): text advances every axis; the image's run holds t and sweeps
    (h, w) over its merged grid, and the text after it starts past the
    run's largest position."""
    pos, cur, i = [], 0, 0
    while i < len(ids):
        if ids[i] != image_id:
            pos.append((cur, cur, cur))
            cur += 1
            i += 1
            continue
        for r in range(lh):
            for c in range(lw):
                pos.append((cur, cur + r, cur + c))
        cur += max(lh, lw)
        i += lh * lw
    return np.asarray(pos, np.int64).T


def decoder_last(tp: dict, t: dict, x: torch.Tensor, pos: np.ndarray, w8a8: bool):
    n, H = x.shape
    nh, nkv = t["num_attention_heads"], t["num_key_value_heads"]
    d = H // nh
    eps = t["rms_norm_eps"]
    sec = t["rope_scaling"]["mrope_section"]
    inv = 1.0 / (t["rope_theta"] ** (torch.arange(0, d, 2, device=x.device).float() / d))
    freqs = torch.from_numpy(pos).to(x.device).float()[..., None] * inv  # (3, n, d/2)
    emb = torch.cat([freqs, freqs], -1)
    axis = torch.cat([torch.full((s,), j % 3) for j, s in enumerate(list(sec) * 2)]).to(x.device)
    pick = axis[None, :].expand(n, d)
    cos = low(torch.gather(torch.cos(emb).permute(1, 2, 0), 2, pick[..., None])[..., 0][:, None])
    sin = low(torch.gather(torch.sin(emb).permute(1, 2, 0), 2, pick[..., None])[..., 0][:, None])
    lp = tp["layers"]

    def lin(name, i, y):
        w = lp[name]["kernel"][i]
        out = product(y, w, "w8a8" if w8a8 else "bf16")
        return low(out + f32(lp[name]["bias"][i])) if "bias" in lp[name] else out

    for i in range(t["num_hidden_layers"]):
        y = rms_norm(x, lp["input_layernorm"][i], eps)
        q = lin("q_proj", i, y).reshape(n, nh, d)
        k = lin("k_proj", i, y).reshape(n, nkv, d)
        v = lin("v_proj", i, y).reshape(n, nkv, d)
        q = low(q * cos + rotate_half(q) * sin)
        k = low(k * cos + rotate_half(k) * sin)
        x = low(x + lin("o_proj", i, attention(q, k, v, causal=True)))
        y = rms_norm(x, lp["post_attention_layernorm"][i], eps)
        x = low(x + lin("down_proj", i, low(low(F.silu(lin("gate_proj", i, y)))
                                              * lin("up_proj", i, y))))
    return rms_norm(x[-1], tp["final_layernorm"], eps)


def reward(cfg: dict, weights: dict, tokenizer, text: str, png: bytes, device,
           w8a8: bool = False) -> np.ndarray:
    """The reward of one row; ``text`` holds one ``<|image_pad|>`` token."""
    t, v = cfg["text"], cfg["vision"]
    params, head = weights["backbone"], weights["head"]
    image_id = t["image_token_id"]
    x, (gh, gw) = patches(png, cfg)
    m = v["spatial_merge_size"]
    with torch.no_grad():
        img = vision(params, cfg, x.to(device), gh, gw)
        ids = tokenizer(text)["input_ids"]
        p = ids.index(image_id)
        U = img.shape[0]
        ids = ids[:p] + [image_id] * U + ids[p + 1:]
        emb = f32(params["text"]["embed_tokens"])
        xs = emb[torch.tensor(ids, device=device)]
        xs[p:p + U] = img
        pos = mrope_positions(ids, image_id, gh // m, gw // m)
        last = decoder_last(params["text"], t, xs, pos, w8a8)
        if cfg["reward"]["add_cross_attention"]:
            last = skipca_last(head, last, img, U, t["rms_norm_eps"])
        r = low(last @ f32(head["value_head"]["kernel"]))
    return r.double().cpu().numpy()


def row_tokens(cfg: dict, tokenizer, text: str, width: int, height: int) -> tuple:
    """(valid tokens, merged units, (gh, gw)) of a row, for the work counters."""
    gh, gw = geometry.qwen_grid(width, height, cfg["vision"], cfg["min_pixels"],
                                cfg["max_pixels"])
    U = gh * gw // cfg["vision"]["spatial_merge_size"] ** 2
    return len(tokenizer(text)["input_ids"]) - 1 + U, U, (gh, gw)
