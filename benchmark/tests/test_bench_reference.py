"""The plain references against the port on the CPU at tiny sizes: with the
port in float32 the two are one model, through the whole timed path (files,
processor, batching, SkipCA's padding, the HTTP server)."""

import io
import json
import os
import time

import pytest
import torch

from helpers import HERE, TINY_EVAL, TINY_SERVE, REPO

from benchmark.harness import common, inputs, program, weights

common.set_environment()


def _load(kind, name):
    with open(os.path.join(REPO, "benchmark", kind, f"{name}.json")) as f:
        return json.load(f)


def _cfg(name):
    with open(os.path.join(HERE, "data", f"{name}.json")) as f:
        return json.load(f)


def _float32(monkeypatch):
    """The port served in float32: the witness that the reference is the model."""
    build = program.adaptor
    monkeypatch.setattr(program, "adaptor",
                        lambda *a, **kw: build(*a, **dict(kw, dtype=torch.float32)))


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_phi3v_eval_in_float32_is_the_reference(seed, monkeypatch):
    from benchmark.harness.drivers import eval as drv

    _float32(monkeypatch)
    traffic = dict(_load("traffic", "eval.bf16"), **TINY_EVAL)
    traffic.update(image_sizes=[[64, 64], [96, 64], [64, 96], [300, 40]])
    out = drv.run(_cfg("tiny_phi3v"), traffic, {"reward_gap": 1e-5}, seed=seed, seconds=2,
                  trace=False, device="cpu", t_start=time.perf_counter())
    assert out["gaps"]["reward_gap"] < 1e-5
    assert out["correct"]


def test_qwen_serve_in_float32_is_the_reference(monkeypatch):
    from benchmark.harness.drivers import serve as drv

    _float32(monkeypatch)
    traffic = dict(_load("traffic", "serve.w8a8"), **TINY_SERVE)
    traffic.update(quantize=None)
    out = drv.run(_cfg("tiny_qwen"), traffic, {"reward_gap": 1e-5}, seed=4, seconds=2,
                  trace=False, device="cpu", t_start=time.perf_counter())
    assert out["gaps"]["reward_gap"] < 1e-5
    assert out["correct"] and out["attempted"] > 0


def test_qwen_w8a8_reference_takes_the_port_codes():
    """Float32 activations, W8A8 decoder: the reference's codes and the
    port's are the same, and so are the rewards."""
    from PIL import Image

    from llava_reward_torch.data.datasets import _qwen_budgets
    from llava_reward_torch.preprocess.collate import collate_qwen_samples, to_reward_batch

    from benchmark.reference import qwen as ref

    cfg, seed = _cfg("tiny_qwen"), 5
    tok = inputs.WordTokenizer("qwen", cfg["tokens"], cfg["text"]["vocab_size"], seed)
    ad = program.adaptor(cfg, weights.make_weights(cfg, seed, device="cpu"), quantize="w8a8",
                         device="cpu", dtype=torch.float32, min_size=0)
    proc = program.processor(cfg, tok, ad.cfg)
    png = inputs.png_bytes(inputs.pixels(seed, inputs.Image(0, 96, 64)))
    text = inputs.render("qwen", tok, "w1 w2 w3 w4")
    s = proc(text, [Image.open(io.BytesIO(png)).convert("RGB")])
    batch = to_reward_batch(collate_qwen_samples([s], 256, 500, *_qwen_budgets(proc, None, None)),
                            "cpu")
    got = ad.make_score_fn()(ad.params, batch)[0].double().numpy()
    want = ref.reward(cfg, weights.make_weights(cfg, seed, device="cpu"), tok, text, png, "cpu",
                      w8a8=True)
    assert abs(got - want).max() <= 1e-6 * abs(want).max()
