"""Batch reward scoring (``llava_reward_tpu/evalx/batch_inference.py``), the
counterpart of the reference's eval/batch_inference_rm_{phi,ft_phi,
phi_user_input}.py.

As in the JAX package: pairwise or pointwise is sniffed from the rows
(``cls_based`` forces pointwise); chosen and rejected go through the model
in one stacked call per batch; batches stream through ``PrefetchLoader``,
whose producer thread also moves each batch to the adaptor's device, so the
copy overlaps the previous batch's work; per-batch forward time is kept,
and ``profile_dir`` records a ``torch.profiler`` trace of the run on every
thread, with the loader's spans and ``eval.step`` (``utils/profiling``).

The card's work runs under ``torch.inference_mode()`` on the adaptor's
explicit device. The preference probabilities are computed on the card and
fetched once a batch.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data.datasets import is_pairwise
from ..data.loader import PrefetchLoader
from ..data.sampler import DistributedSampler
from ..ops.pixels import _HALF, PRECISION_BITS, hd_resize_u8_bank, prepare_pixel_bank
from ..preprocess.collate import collate_samples, to_reward_batch
from ..reward.model import RewardBatch
from ..reward.preference import preference_prob
from ..utils.profiling import span
from ..utils.profiling import trace as profiler_trace
from .metrics import pairwise_metrics, pointwise_metrics


def _merge_resize_tabs(a: dict, b: dict) -> dict:
    """Stack chosen / rejected device-resize tap tables on the batch axis
    (``batch_inference.py:33-71``), reconciling the bucket-dependent shapes:
    the tap count (last axis of hw / vw) pads with zero-weight taps; the
    crop bucket (nc axis) pads with white rows and an identity slot_perm.
    Both are inert by construction."""
    white_bias = _HALF + (255 << PRECISION_BITS)
    nc = max(a["vidx"].shape[1], b["vidx"].shape[1])
    k_h = max(a["hw"].shape[-1], b["hw"].shape[-1])
    k_v = max(a["vw"].shape[-1], b["vw"].shape[-1])

    def fix(t):
        t = dict(t)
        t["hw"] = F.pad(t["hw"], (0, k_h - t["hw"].shape[-1]))
        dn = nc - t["vidx"].shape[1]
        t["vw"] = F.pad(t["vw"], (0, k_v - t["vw"].shape[-1], 0, 0, 0, dn))
        t["vidx"] = F.pad(t["vidx"], (0, 0, 0, dn))
        # pad slots render white (zero taps + the white bias), as every other
        # u8-source table does (build_hd_resize_tables)
        t["vbias"] = F.pad(t["vbias"], (0, 0, 0, dn), value=white_bias)
        t["col_start"] = F.pad(t["col_start"], (0, dn))
        if dn:
            B = t["slot_perm"].shape[0]
            extra = torch.arange(nc - dn, nc, dtype=t["slot_perm"].dtype,
                                 device=t["slot_perm"].device)[None].expand(B, dn)
            t["slot_perm"] = torch.cat([t["slot_perm"], extra], dim=1)
        return t

    a, b = fix(a), fix(b)
    return {k: torch.cat([a[k], b[k]]) for k in a}


def _pixel_kind(rb: RewardBatch) -> str:
    pv = rb.pixel_values
    if pv is None:
        return "none"
    if rb.resize_tabs is not None:
        return "u8src"
    return "u8" if pv.dtype == torch.uint8 else "f32"


def _materialize_f32(rb: RewardBatch) -> RewardBatch:
    """A device-prepared batch (u8 crops, or a u8 source with its tap tables)
    as the f32 [global, crops...] bank, on its device
    (``batch_inference.py:116-135``), so a pair whose sides fell into
    different pixel modes (one took the extreme-aspect host fallback) still
    stacks into one call."""
    pv = rb.pixel_values
    if rb.resize_tabs is not None:
        t = rb.resize_tabs
        pv = hd_resize_u8_bank(pv, t["hidx"], t["hw"], t["vidx"], t["vw"], t["vbias"],
                               t["col_start"], t["slot_perm"], t["tflag"])
    bank = prepare_pixel_bank(pv, rb.crop_grid, dtype=torch.float32)
    return rb._replace(pixel_values=bank, resize_tabs=None, crop_grid=None)


def stack_pair(cb: RewardBatch, rb: RewardBatch) -> RewardBatch:
    """Chosen and rejected as one batch (``batch_inference.py:210-257``):
    sides in different pixel kinds are unified on the f32 bank, crop buckets
    and source sizes zero-padded to the larger, M-RoPE positions joined on
    their batch axis 1, tap tables merged."""
    kc, kr = _pixel_kind(cb), _pixel_kind(rb)
    if kc != kr and "none" not in (kc, kr):
        cb = cb if kc == "f32" else _materialize_f32(cb)
        rb = rb if kr == "f32" else _materialize_f32(rb)
    fields = {}
    for name, a, b in zip(RewardBatch._fields, cb, rb):
        if a is None:
            fields[name] = None
        elif name == "position_ids":  # (3, B, S)
            fields[name] = torch.cat([a, b], dim=1)
        elif name == "resize_tabs":
            fields[name] = _merge_resize_tabs(a, b)
        else:
            if name == "pixel_values" and a.ndim == 5 and a.shape[1] != b.shape[1]:
                # different crop buckets: zero-pad the smaller (the bank's
                # leading sentinel rows keep the gather indices valid)
                nc = max(a.shape[1], b.shape[1])
                a, b = (F.pad(x, (0, 0, 0, 0, 0, 0, 0, nc - x.shape[1])) for x in (a, b))
            if name == "pixel_values" and a.ndim == 4 and a.shape[1:3] != b.shape[1:3]:
                # device-resize sources in different size buckets: zero-pad
                # spatially (tap weights are zero past each true extent)
                hs, ws = max(a.shape[1], b.shape[1]), max(a.shape[2], b.shape[2])
                a, b = (F.pad(x, (0, 0, 0, ws - x.shape[2], 0, hs - x.shape[1]))
                        for x in (a, b))
            fields[name] = torch.cat([a, b])
    return RewardBatch(**fields)


def batch_rm_inference(
    adaptor,
    rows: Sequence[dict],
    tokenizer,
    processor,
    *,
    batch_size: int = 8,
    seq_len: int = 2944,
    max_samples: Optional[int] = None,
    num_workers: int = 8,
    image_root: Optional[str] = None,
    attn_impl: str = "auto",
    profile_dir: Optional[str] = None,
    progress: bool = True,
    cls_based: bool = False,
) -> Dict[str, float]:
    """Score ``rows`` and return the reference's metrics (pairwise:
    accuracy, tie-excluded accuracy, mean prob; pointwise: accuracy, F1,
    recall) plus ``mean_forward_s`` (``batch_inference.py:138-310``)."""
    from ..core.registry import get_family

    rows = list(rows)[: max_samples or None]
    family = get_family(adaptor.model_type)
    pad_id = family.decoder_cfg(adaptor.cfg).pad_token_id
    pairwise = is_pairwise(rows) and not cls_based
    ds_cls = family.pairwise_dataset if pairwise else family.pointwise_dataset
    ds = ds_cls(rows, processor, tokenizer, image_root)
    device = adaptor.device

    def device_put(batch):
        # from the loader's producer thread: the copy overlaps the card's work
        if pairwise:
            chosen, rejected, c_rate, r_rate = batch
            return (to_reward_batch(chosen, device), to_reward_batch(rejected, device),
                    c_rate, r_rate)
        b, y = batch
        return to_reward_batch(b, device), y

    loader = PrefetchLoader(
        ds, DistributedSampler(len(ds), shuffle=False), batch_size,
        collate_fn=lambda items: ds.collate(items, seq_len, pad_id),
        num_workers=num_workers, device_put=device_put, drop_last=False,
    )
    score = adaptor.make_score_fn(attn_impl=attn_impl, training=False)
    params, rcfg = adaptor.params, adaptor.rcfg

    probs, rewards, labels, fwd_times = [], [], [], []
    profiling = profiler_trace(profile_dir) if profile_dir else contextlib.nullcontext()
    with profiling, torch.inference_mode():
        for batch in loader:
            t0 = time.perf_counter()
            with span("eval.step"):
                if pairwise:
                    chosen, rejected, _, _ = batch
                    r = score(params, stack_pair(chosen, rejected))
                    n = r.shape[0] // 2
                    p = preference_prob(r[:n], r[n:],
                                        is_general_preference=rcfg.is_general_preference,
                                        value_head_dim=rcfg.value_head_dim,
                                        tau=rcfg.general_preference_tau)
                    probs.extend(p.float().cpu().tolist())
                else:
                    b, y = batch
                    rewards.extend(score(params, b)[:, 0].float().cpu().tolist())
                    labels.extend(np.asarray(y).astype(int).tolist())
            fwd_times.append(time.perf_counter() - t0)
            if progress:
                print(f"\rscored {len(probs) or len(rewards)}/{len(ds)}", end="", flush=True)
    if progress:
        print()

    metrics = pairwise_metrics(probs) if pairwise else pointwise_metrics(rewards, labels)
    if fwd_times:
        metrics["mean_forward_s"] = float(np.mean(fwd_times[1:] or fwd_times))
    return metrics


def score_user_input(
    adaptor,
    tokenizer,
    processor,
    caption: str,
    image_paths: Sequence[str],
    *,
    seq_len: int = 2944,
    attn_impl: str = "auto",
) -> np.ndarray:
    """The _user_input harness (batch_inference_rm_phi_user_input.py:38-170;
    ``batch_inference.py:313-338``): one caption against N images, returns
    (N, value_head_dim)."""
    from PIL import Image

    from ..preprocess.phi3v_processor import apply_phi3v_chat_template

    text = apply_phi3v_chat_template(tokenizer, caption)
    samples = [processor(text, [Image.open(p).convert("RGB")]) for p in image_paths]
    batch = to_reward_batch(
        collate_samples(samples, seq_len, adaptor.cfg.decoder.pad_token_id), adaptor.device)
    score = adaptor.make_score_fn(attn_impl=attn_impl, training=False)
    return score(adaptor.params, batch).float().cpu().numpy()
