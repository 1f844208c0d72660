"""The work counters against hand counts at tiny shapes, the metrics'
counters over them, and the geometry they rest on against the port's
processors."""

import json
import os

import pytest

from helpers import HERE

from benchmark.families import phi3v, qwen
from benchmark.harness import family, flops, geometry, peaks


def _cfg(name):
    with open(os.path.join(HERE, "data", f"{name}.json")) as f:
        return json.load(f)


def test_phi3v_decoder_and_attention_by_hand():
    c = _cfg("tiny_phi3v")  # H 64, I 128, 2 layers, 4 heads of 16; CLIP 32 wide, 1 active layer
    n, hc, wc, slots = 10, 1, 2, 5
    w = phi3v.row_work(c, (n, None, (hc, wc)), slots)
    crops, T = 3, 577
    clip = 2 * crops * 576 * 588 * 32 + 2 * crops * T * 1 * (4 * 32 * 32 + 2 * 32 * 128)
    clip_attn = crops * 4 * 4 * 8 * T * T
    m = (2 * 1 + 1) * 144 + 1 + 2 * 12
    proj = 2 * m * (4 * 32 * 64 + 64 * 64)
    dec = 2 * n * 2 * (64 * 192 + 64 * 64 + 3 * 64 * 128)
    dec_attn = 2 * 4 * 4 * 16 * n * (n + 1) / 2
    skipca = 2 * n * 64 * 64 + 4 * slots * 64 * 64 + 4 * n * slots * 64
    total = clip + clip_attn + proj + dec + dec_attn + skipca
    assert w.ideal_s == pytest.approx(total / peaks.BF16_FLOPS, rel=1e-12)
    # the decoder's attention: per layer 4*h*d*n(n+1)/2 ops; bytes of qkv in,
    # the output out and the rope tables, bf16
    ops = 4 * 4 * 16 * n * (n + 1) / 2
    nbytes = 2 * n * ((2 * 4 + 2 * 4) * 16 + 2 * 16)
    want = 2 * max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)
    got = w.bound_s("attn.dec")
    assert got == pytest.approx(want, rel=1e-12)


def test_w8a8_weights_are_read_once_a_call():
    c = _cfg("tiny_qwen")
    one = qwen.row_work(c, (20, 4, (4, 4)), 4, True)
    two = flops.Work()
    two += one
    two += qwen.row_work(c, (20, 4, (4, 4)), 4, True)
    H, I, L = 64, 128, 2
    K, N = H, 2 * I  # gate_up
    ops, nbytes = 2 * 20 * K * N, 20 * K + 2 * 20 * N + 4 * 20
    assert one.bound_s("w8a8.gemm.gate_up") == pytest.approx(
        L * max(ops / peaks.INT8_OPS, (nbytes + K * N) / peaks.HBM_BYTES))
    assert two.bound_s("w8a8.gemm.gate_up") == pytest.approx(
        L * max(2 * ops / peaks.INT8_OPS, (2 * nbytes + K * N) / peaks.HBM_BYTES))
    assert two.ideal_s == pytest.approx(2 * one.ideal_s)
    # the epilogues are bytes only: B5 reads gate_up, writes codes and amax
    assert one.bound_s("w8a8.quant.silu_down") == pytest.approx(
        L * 20 * (2 * 2 * I + I + 4) / peaks.HBM_BYTES)


def test_qwen_projections_at_the_int8_peak_only_under_w8a8():
    c = _cfg("tiny_qwen")
    bf16 = qwen.row_work(c, (30, 4, (4, 4)), 4, False)
    w8 = qwen.row_work(c, (30, 4, (4, 4)), 4, True)
    H, I, L, d = 64, 128, 2, 16
    proj = 2 * 30 * L * (H * (4 + 4) * d + 4 * d * H + H * 2 * I + I * H)
    assert bf16.ideal_s - w8.ideal_s == pytest.approx(
        proj / peaks.BF16_FLOPS - proj / peaks.INT8_OPS, rel=1e-9)
    assert bf16.bound_s("w8a8") == 0.0


@pytest.mark.parametrize("wh", [(512, 512), (768, 768), (1024, 1024), (1216, 832), (832, 1216),
                                (100, 1600), (64, 96)])
def test_geometry_matches_the_port(wh):
    from llava_reward_torch.preprocess.phi3v_processor import (calc_hd_transform_size,
                                                                num_img_tokens_for)
    from llava_reward_torch.preprocess.qwen_vision import smart_resize, windowize

    w, h = wh
    pw, ph = calc_hd_transform_size(w, h, 16)
    assert geometry.phi3v_grid(w, h) == (ph // 336, pw // 336)
    assert geometry.phi3v_tokens(*geometry.phi3v_grid(w, h)) == num_img_tokens_for(ph, pw)
    with open(os.path.join(HERE, "..", "configs", "qwen25vl7b.json")) as f:
        q = json.load(f)
    gh, gw = geometry.qwen_grid(w, h, q["vision"], q["min_pixels"], q["max_pixels"])
    hh, ww = smart_resize(h, w, 28, q["min_pixels"], q["max_pixels"])
    assert (gh, gw) == (hh // 14, ww // 14)
    _, valid, _, nw = windowize((1, gh, gw))
    assert geometry.qwen_windows(gh, gw, q["vision"]) == list(valid.reshape(nw, -1).sum(1))


@pytest.mark.parametrize("metric,prefix", [("attn_roofline.eval", "attn"),
                                           ("w8a8_roofline.serve", "w8a8"),
                                           ("step_mfu.serve", None)])
def test_each_metric_counts_its_own_terms(metric, prefix):
    """A metric's counter over a call's work: the bound of its own terms (or
    the matmul time), summed by the harness over the window and the traced
    calls."""
    from benchmark.harness import common

    c = _cfg("tiny_qwen")
    calls = [family.row_work(c, (20 + k, 4, (4, 4)), 4, True) for k in range(3)]
    mod = common.load_metric(metric)
    want = [w.bound_s(prefix) if prefix else w.ideal_s for w in calls]
    assert all(x > 0 for x in want)
    data = {"role": metric.rsplit(".", 1)[1], "calls": calls, "traced": [False, True, True],
            "wall_s": 2.0, "trace": {"spans": {"bench.attn": 1.0, "bench.w8a8": 1.0}}}
    got = common.read_layer_metric(mod, data)
    share = sum(want) / 2.0 if prefix is None else want[1] + want[2]
    assert got == pytest.approx(100.0 * share, rel=1e-12)
