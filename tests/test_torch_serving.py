"""Serving in the port against the JAX package, fp32 on the CPU: the HTTP
server, batch evaluation, ``score_user_input`` and the profiling hooks, on
one tiny param tree (JAX init, carried across) and this repository's sample
data (``data/sample_test``).

- ``RewardService`` behind a ``ThreadingHTTPServer``: ``/healthz``,
  ``/score_pair`` on two sample PNG paths, ``/score`` on base64 images; the
  rewards are the JAX ``RewardService``'s within 2.03e-05 (PARITY.md), the
  probabilities within 1e-5 (PROB_TOL); concurrent requests are coalesced into one
  device call whose rewards are each request's own;
- ``batch_rm_inference`` on the pairwise and the pointwise sample rows, for
  phi3v and qwen: the same probabilities (rewards) and metrics as the JAX
  function;
- a pair whose sides fall into different pixel kinds (decoded u8 originals
  against the host f32 bank) and crop buckets stacks into one call and
  scores as its sides do alone; the tap-table merge and the bank the pair is
  unified on equal the JAX package's;
- ``score_user_input``; ``span``, ``trace`` and ``device_memory_stats``; the
  service's spans and counters (a ``serve.queue`` a request, the real rows
  counted) and the loader's (a ``loader.wait`` a batch, the producer's spans in
  ``trace.json`` from its own thread).

JAX twins: tests/test_server.py; tests/test_e2e_sample_data.py (which reads
a reference checkout and skips here: this file reads data/sample_test);
tests/test_tp_and_eval_harness.py::test_batch_inference_qwen_family.
"""

import base64
import json
import os
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import llava_reward_tpu.evalx.batch_inference as jbi
import llava_reward_tpu.evalx.server as jsrv
import llava_reward_torch.evalx.batch_inference as tbi
import llava_reward_torch.evalx.server as tsrv
from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.core.config import phi3v_tiny_config, qwen_tiny_config
from llava_reward_tpu.evalx.adaptor import RewardAdaptor as JAdaptor
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.models import qwen25_vl as jqwen
from llava_reward_tpu.preprocess import collate as jcollate
from llava_reward_tpu.preprocess import phi3v_processor as jpp
from llava_reward_tpu.preprocess import qwen_vision as jqv
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.evalx.adaptor import RewardAdaptor as TAdaptor
from llava_reward_torch.io.convert import to_torch
from llava_reward_torch.preprocess import collate as tcollate
from llava_reward_torch.preprocess import phi3v_processor as tpp
from llava_reward_torch.preprocess import qwen_vision as tqv
from llava_reward_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "data/sample_test/pairwise_sample.json")
POINTS = os.path.join(ROOT, "data/sample_test/non_pairwise_sample.json")
PARITY_BAR = 2.03e-05
# probabilities sigmoid((c0 r1 - c1 r0) / tau), tau 0.1: a reward gap d moves
# one by at most (1 / (4 tau)) * 2 * max|r| * d, ~1e-5 at these rewards (|r| < 0.2)
PROB_TOL = 1e-5
SEQ = 896


class Tok:
    eos_token = "</s>"
    pad_token_id = 0

    def __call__(self, text):
        return {"input_ids": [sum(map(ord, w)) % 400 + 3 for w in text.split()] or [3]}

    def apply_chat_template(self, msgs, tokenize=False, add_generation_prompt=True):
        return "".join(m["content"] for m in msgs) + " " + "x" * 22


def _rows(path):
    with open(path) as f:
        rows = json.load(f)
    for r in rows:  # repository-relative paths, wherever the tests run from
        for k in ("chosen_path", "reject_path", "path"):
            if k in r:
                r[k] = os.path.join(ROOT, r[k])
    return rows


def _phi3v_adaptors(gpm=True):
    cfg = phi3v_tiny_config(num_crops=4)
    kw = dict(is_general_preference=gpm, value_head_dim=2, layer_id=cfg.decoder.num_layers)
    jr, tr = JRewardConfig(**kw), tconfig.RewardConfig(**kw)
    tree = jax.tree_util.tree_map(np.asarray, {
        "backbone": jphi3v.init_params(jax.random.PRNGKey(0), cfg),
        "head": j_init_head(jax.random.PRNGKey(1), cfg, jr)})
    ja = JAdaptor(cfg=cfg, rcfg=jr, params=jax.tree_util.tree_map(jnp.asarray, tree),
                  model_type="phi3v")
    ta = TAdaptor(tconfig.phi3v_tiny_config(num_crops=4), tr, to_torch(tree, "cpu"),
                  model_type="phi3v", device="cpu")
    return ja, ta


@pytest.fixture(scope="module")
def phi3v():
    return _phi3v_adaptors()


def _serve(service):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tsrv.make_handler(service))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}"


@pytest.fixture(scope="module")
def server(phi3v):
    ja, ta = phi3v
    tok = Tok()
    service = tsrv.RewardService(ta, tok, tpp.Phi3VProcessor(tok, num_crops=4), seq_len=SEQ,
                                 max_batch=2)
    jservice = jsrv.RewardService(ja, tok, jpp.Phi3VProcessor(tok, num_crops=4), seq_len=SEQ,
                                  max_batch=2, batch_window_ms=0)
    jservice._score = ja.make_score_fn(attn_impl="xla", training=False)
    srv, url = _serve(service)
    yield url, service, jservice
    srv.shutdown()


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _b64(path):
    with open(path, "rb") as f:
        return "data:image/png;base64," + base64.b64encode(f.read()).decode()


def test_healthz(server):
    url, _, _ = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"ok": True}
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(url + "/nothing", timeout=30)


def test_score_pair_matches_the_jax_service(server):
    url, _, jservice = server
    row = _rows(PAIRS)[0]
    out = _post(url + "/score_pair", {"prompt": row["prompt"], "chosen": row["chosen_path"],
                                      "rejected": row["reject_path"]})
    j = jservice.score(row["prompt"], [row["chosen_path"], row["reject_path"]])
    t = np.asarray([out["chosen_reward"], out["rejected_reward"]])
    np.testing.assert_allclose(t, j, rtol=0, atol=PARITY_BAR)
    assert abs(out["prob"] - jservice.preference(j[:1], j[1:2])) <= PROB_TOL


def test_score_base64_matches_the_jax_service(server):
    url, _, jservice = server
    row = _rows(PAIRS)[1]
    imgs = [_b64(row["chosen_path"]), _b64(row["reject_path"])]
    out = _post(url + "/score", {"caption": row["prompt"], "images": imgs})
    j = jservice.score(row["prompt"], imgs)
    np.testing.assert_allclose(np.asarray(out["rewards"]), j, rtol=0, atol=PARITY_BAR)
    assert abs(out["prob_first_over_second"] - jservice.preference(j[:1], j[1:2])) <= PROB_TOL
    one = _post(url + "/score", {"caption": row["prompt"], "images": imgs[:1]})
    assert len(one["rewards"]) == 1 and "prob_first_over_second" not in one


def test_batcher_coalesces_concurrent_requests(monkeypatch):
    """Concurrent score() calls within the window share one device call (the
    JAX test's fake scorer)."""
    svc = tsrv.RewardService.__new__(tsrv.RewardService)
    svc.max_batch, svc.batch_window_ms = 8, 60.0
    calls = []

    def fake_score_samples(samples):
        calls.append(len(samples))
        assert torch.is_inference_mode_enabled()  # the batcher thread's own mode
        time.sleep(0.02)
        return np.arange(len(samples), dtype=np.float32)[:, None]

    svc._score_samples = fake_score_samples
    svc._template = lambda c: c
    svc.processor = lambda text, imgs: ("sample", text)
    svc._start_batcher()
    monkeypatch.setattr(tsrv, "_load_image", lambda s: s)
    results = {}

    def req(name):
        results[name] = svc.score(name, ["img"])

    threads = [threading.Thread(target=req, args=(f"r{i}",)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(results) == 4 and all(v.shape == (1, 1) for v in results.values())
    assert sum(calls) == 4 and len(calls) < 4, calls


def test_concurrent_pairs_share_one_b8_call(phi3v):
    """Four /score_pair requests from four threads at once become one B=8
    device call; each answer equals its pair scored alone."""
    _, ta = phi3v
    tok = Tok()
    proc = tpp.Phi3VProcessor(tok, num_crops=4)
    service = tsrv.RewardService(ta, tok, proc, seq_len=SEQ, max_batch=8, batch_window_ms=1500)
    alone = tsrv.RewardService(ta, tok, proc, seq_len=SEQ, max_batch=8, batch_window_ms=0)
    sizes, score = [], service._score

    def counted(params, batch):  # the rows of every device call
        sizes.append(batch.input_ids.shape[0])
        return score(params, batch)

    service._score = counted
    srv, url = _serve(service)
    rows, out = _rows(PAIRS), {}
    try:
        def req(i):
            r = rows[i]
            out[i] = _post(url + "/score_pair", {"prompt": r["prompt"], "chosen": r["chosen_path"],
                                                 "rejected": r["reject_path"]})

        threads = [threading.Thread(target=req, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        srv.shutdown()
    assert sizes == [8] and sorted(out) == [0, 1, 2, 3]
    for i, r in enumerate(rows):
        want = alone.score(r["prompt"], [r["chosen_path"], r["reject_path"]])
        got = np.asarray([out[i]["chosen_reward"], out[i]["rejected_reward"]])
        np.testing.assert_allclose(got, want, rtol=0, atol=PARITY_BAR)


# ------------------------------------------------------------ call shapes

# (width, height) of each row's image and its caption's length in words: the
# rows of a call differ on both axes
SHAPE_ROWS = [((300, 200), 3), ((120, 100), 40), ((410, 330), 12), ((90, 260), 25),
              ((250, 250), 7)]
QWEN_MAX_PIXELS = 96 * 28 * 28  # up to 384 patches an image: several windows
SHAPE_SEQ = 1280  # above the longest row's length rounded up to 128, in both families


def _qwen_adaptor():
    cfg = qwen_tiny_config(num_layers=2, vision_depth=2)
    kw = dict(is_general_preference=True, value_head_dim=2, layer_id=cfg.text.num_layers)
    jr, tr = JRewardConfig(**kw), tconfig.RewardConfig(**kw)
    tree = jax.tree_util.tree_map(np.asarray, {
        "backbone": jqwen.init_params(jax.random.PRNGKey(0), cfg),
        "head": j_init_head(jax.random.PRNGKey(1), cfg, jr)})
    tcfg = tconfig.qwen_tiny_config(num_layers=2, vision_depth=2)
    return cfg, TAdaptor(tcfg, tr, to_torch(tree, "cpu"), model_type="qwen", device="cpu")


@pytest.fixture(scope="module")
def qwen():
    return _qwen_adaptor()


def _shape_service(family, phi3v, qwen, seq_len):
    """A service of the family's tiny adaptor, no batcher, and its samples of
    SHAPE_ROWS."""
    if family == "qwen":
        cfg, ta = qwen
        tok = QTok(cfg.text.image_token_id)
        proc = tqv.Qwen25VLProcessor(tok, min_pixels=cfg.min_pixels, max_pixels=QWEN_MAX_PIXELS,
                                     image_token_id=cfg.text.image_token_id)
    else:
        ta = phi3v[1]
        tok = Tok()
        proc = tpp.Phi3VProcessor(tok, num_crops=4)
    service = tsrv.RewardService(ta, tok, proc, seq_len=seq_len, max_batch=8, batch_window_ms=0)
    samples = [proc(service._template(" ".join(f"w{j}" for j in range(words))),
                    [_image(w, h, 10 + i)])
               for i, ((w, h), words) in enumerate(SHAPE_ROWS)]
    return service, samples


def _static(service, samples):
    """The samples collated at the static shapes every call had before: the
    whole ``seq_len`` and, for qwen, the processor's patch and unit budgets."""
    pad = service.adaptor.cfg
    pad = (pad.decoder if hasattr(pad, "decoder") else pad.text).pad_token_id
    if service.adaptor.model_type == "qwen":
        from llava_reward_torch.data.datasets import _qwen_budgets

        return tcollate.collate_qwen_samples(samples, service.seq_len, pad,
                                             *_qwen_budgets(service.processor, None, None))
    return tcollate.collate_samples(samples, service.seq_len, pad, crop_buckets=None)


def _up(x, m=128):
    return -(-x // m) * m


def _collated(service):
    seen, collate = [], service._collate_family

    def rec(samples):
        seen.append(collate(samples))
        return seen[-1]

    service._collate_family = rec
    return seen


@pytest.mark.parametrize("family,n", [("qwen", 1), ("qwen", 3), ("qwen", 5),
                                      ("phi3v", 1), ("phi3v", 3), ("phi3v", 5)])
def test_a_call_is_shaped_to_its_rows(phi3v, qwen, family, n):
    """A call of n rows of different image sizes and prompt lengths computes
    exactly its rows, its tokens left-padded to the longest row rounded up to
    128 and, for qwen, its windowed patches to the longest row's rounded up
    to 128 and its units to the longest row's. Its rewards are each row's
    scored alone and the rows' at the static shapes; the counters hold the
    valid and the computed tokens and patches."""
    service, samples = _shape_service(family, phi3v, qwen, SHAPE_SEQ)
    samples = samples[:n]
    seen = _collated(service)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = service._score_samples(samples)
    (host,) = seen
    lens = [len(s.input_ids) for s in samples]
    S = _up(max(lens))
    assert S < SHAPE_SEQ
    assert host["input_ids"].shape == host["attention_mask"].shape == (n, S)
    counts = profiling.session().counts
    assert counts["serve.rows"] == n and counts["serve.pad_rows"] == 0
    assert (counts["serve.tokens"], counts["serve.tokens_padded"]) == (sum(lens), n * S)
    if family == "qwen":
        P = _up(max(s.patches.shape[0] for s in samples))
        U = max(s.unit_gather.shape[0] for s in samples)
        assert host["pixel_values"].shape[:2] == host["patch_valid"].shape == (n, P)
        assert host["rot_pos"].shape[:2] == (n, P) and host["unit_gather"].shape == (n, U)
        assert host["position_ids"].shape == (3, n, S)
        real = sum(int(np.count_nonzero(s.patch_valid)) for s in samples)
        assert (counts["serve.patches"], counts["serve.patches_padded"]) == (real, n * P)
    else:
        assert host["pixel_values"].shape[1] == 5  # the crop budget, whatever the image
        assert "serve.patches" not in counts and "serve.patches_padded" not in counts
    assert got.shape == (n, 2)
    alone = np.concatenate([service._score_samples([s]) for s in samples])
    np.testing.assert_allclose(got, alone, rtol=0, atol=PARITY_BAR)
    static = service._score(service.adaptor.params,
                            tcollate.to_reward_batch(_static(service, samples), "cpu"))
    np.testing.assert_allclose(got, static.float().numpy(), rtol=0, atol=PARITY_BAR)


@pytest.mark.parametrize("family", ["qwen", "phi3v"])
def test_a_row_longer_than_seq_len_is_cut_as_before(phi3v, qwen, family):
    """``seq_len`` still caps a row: a call holding a row longer than it runs
    at ``seq_len``, its tokens cut from the right exactly as the static
    collation cuts them, with the same rewards."""
    _, samples = _shape_service(family, phi3v, qwen, SHAPE_SEQ)
    longest = max(len(s.input_ids) for s in samples)
    seq = longest - 37  # below the longest row, no multiple of 128
    service, samples = _shape_service(family, phi3v, qwen, seq)
    seen = _collated(service)
    got = service._score_samples(samples)
    (host,) = seen
    static = _static(service, samples)
    for key in ("input_ids", "attention_mask", "splice_idx") + (
            ("position_ids",) if family == "qwen" else ()):
        np.testing.assert_array_equal(host[key], static[key], err_msg=key)
    assert host["input_ids"].shape == (len(samples), seq)
    want = service._score(service.adaptor.params, tcollate.to_reward_batch(static, "cpu"))
    np.testing.assert_allclose(got, want.float().numpy(), rtol=0, atol=PARITY_BAR)


# ------------------------------------------------------------ batch_rm_inference


def _recording(monkeypatch, module, name):
    seen = []
    orig = getattr(module, name)

    def rec(*args):
        seen.append([list(a) for a in args])
        return orig(*args)

    monkeypatch.setattr(module, name, rec)
    return seen


def _both(monkeypatch, ja, ta, rows, proc_j, proc_t, tok, metric, **kw):
    j_seen = _recording(monkeypatch, jbi, metric)
    t_seen = _recording(monkeypatch, tbi, metric)
    common = dict(batch_size=4, num_workers=2, progress=False, **kw)
    jm = jbi.batch_rm_inference(ja, rows, tok, proc_j, attn_impl="xla", **common)
    tm = tbi.batch_rm_inference(ta, rows, tok, proc_t, **common)
    return jm, tm, j_seen[0], t_seen[0]


def _assert_metrics(tm, jm):
    assert set(tm) == set(jm)
    for k in jm:
        if k != "mean_forward_s":
            assert tm[k] == pytest.approx(jm[k], abs=PROB_TOL), k


def test_pairwise_sample_rows_match_jax(phi3v, monkeypatch):
    ja, ta = phi3v
    tok = Tok()
    jm, tm, (jp,), (tp,) = _both(monkeypatch, ja, ta, _rows(PAIRS),
                                 jpp.Phi3VProcessor(tok, num_crops=4),
                                 tpp.Phi3VProcessor(tok, num_crops=4), tok, "pairwise_metrics",
                                 seq_len=SEQ)
    assert tm["num_pairs"] == 4 and tm["mean_forward_s"] > 0
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)
    np.testing.assert_array_equal(np.asarray(tp) > 0.5, np.asarray(jp) > 0.5)
    _assert_metrics(tm, jm)


def test_pointwise_sample_rows_match_jax(monkeypatch):
    ja, ta = _phi3v_adaptors(gpm=False)
    tok = Tok()
    jm, tm, (jr, jl), (tr, tl) = _both(monkeypatch, ja, ta, _rows(POINTS),
                                       jpp.Phi3VProcessor(tok, num_crops=4),
                                       tpp.Phi3VProcessor(tok, num_crops=4), tok,
                                       "pointwise_metrics", seq_len=SEQ)
    assert tm["num_samples"] == 8 and tl == jl
    np.testing.assert_allclose(tr, jr, rtol=0, atol=PARITY_BAR)
    _assert_metrics(tm, jm)


def test_cls_based_forces_pointwise_on_pairwise_rows(monkeypatch):
    """``cls_based`` sends rows that sniff as pairwise down the pointwise
    path, as in the JAX package."""
    ja, ta = _phi3v_adaptors(gpm=False)
    tok = Tok()
    rows = [dict(p, chosen_path=p["path"], reject_path=p["path"]) for p in _rows(POINTS)[:4]]
    jm, tm, (jr, _), (tr, _) = _both(monkeypatch, ja, ta, rows,
                                     jpp.Phi3VProcessor(tok, num_crops=4),
                                     tpp.Phi3VProcessor(tok, num_crops=4), tok,
                                     "pointwise_metrics", seq_len=SEQ, cls_based=True)
    assert tm["num_samples"] == 4
    np.testing.assert_allclose(tr, jr, rtol=0, atol=PARITY_BAR)
    _assert_metrics(tm, jm)


class QTok:
    def __init__(self, image_token_id):
        self.image_token_id = image_token_id

    def __call__(self, text):
        return {"input_ids": [self.image_token_id if t == "<img>" else sum(map(ord, t)) % 300 + 3
                              for t in text.split()]}

    def apply_chat_template(self, msgs, tokenize=False, add_generation_prompt=True):
        def flat(c):
            if isinstance(c, str):
                return c
            return " ".join("<img>" if p.get("type") == "image" else p.get("text", "")
                            for p in c)

        return "x" * 58 + " ".join(flat(m["content"]) for m in msgs) + "x" * 23


def test_qwen_family_through_batch_rm_inference(monkeypatch):
    """Registry dispatch and the M-RoPE position stacking (batch axis 1)."""
    cfg = qwen_tiny_config(num_layers=2, vision_depth=2)
    kw = dict(is_general_preference=True, value_head_dim=2, layer_id=cfg.text.num_layers)
    jr, tr = JRewardConfig(**kw), tconfig.RewardConfig(**kw)
    tree = jax.tree_util.tree_map(np.asarray, {
        "backbone": jqwen.init_params(jax.random.PRNGKey(0), cfg),
        "head": j_init_head(jax.random.PRNGKey(1), cfg, jr)})
    ja = JAdaptor(cfg=cfg, rcfg=jr, params=jax.tree_util.tree_map(jnp.asarray, tree),
                  model_type="qwen")
    tcfg = tconfig.qwen_tiny_config(num_layers=2, vision_depth=2)
    ta = TAdaptor(tcfg, tr, to_torch(tree, "cpu"), model_type="qwen", device="cpu")
    tok = QTok(cfg.text.image_token_id)
    pk = dict(min_pixels=cfg.min_pixels, max_pixels=cfg.max_pixels,
              image_token_id=cfg.text.image_token_id)
    jm, tm, (jp,), (tp,) = _both(monkeypatch, ja, ta, _rows(PAIRS),
                                 jqv.Qwen25VLProcessor(tok, **pk), tqv.Qwen25VLProcessor(tok, **pk),
                                 tok, "pairwise_metrics", seq_len=128)
    assert tm["num_pairs"] == 4
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)
    _assert_metrics(tm, jm)


# ------------------------------------------------------------ mixed pixel kinds


def _image(w, h, seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def test_mixed_pixel_kinds_and_buckets_stack_into_one_call():
    """One pair, two ways. (a) Chosen: a decoded u8 original resized on the
    device (4x4 grid, 17 crops); rejected: the host f32 bank of a 3x4-grid
    image (the 13-crop bucket; its gather indices padded to the chosen
    side's budget). (b) Chosen and rejected both u8 originals, in the 672
    and the 1008 source buckets. ``stack_pair`` unifies (a) on the f32 bank
    and pads its crop axis, pads (b)'s sources and merges their tap tables;
    each stacked call's rewards are its sides' alone. The bank (a) is
    unified on equals the JAX package's."""
    cfg = phi3v_tiny_config(num_crops=16)
    kw = dict(is_general_preference=True, value_head_dim=2, layer_id=cfg.decoder.num_layers)
    tree = jax.tree_util.tree_map(np.asarray, {
        "backbone": jphi3v.init_params(jax.random.PRNGKey(0), cfg),
        "head": j_init_head(jax.random.PRNGKey(1), cfg, JRewardConfig(**kw))})
    ta = TAdaptor(tconfig.phi3v_tiny_config(num_crops=16), tconfig.RewardConfig(**kw),
                  to_torch(tree, "cpu"), model_type="phi3v", device="cpu")
    tok = Tok()
    text = tpp.apply_phi3v_chat_template(tok, "<|image_1|>\nwhich is better?")
    src = tpp.Phi3VProcessor(tok, num_crops=16, device_preproc=True, device_resize=True)
    host = tpp.Phi3VProcessor(tok, num_crops=16)
    S = 2560
    small = tcollate.collate_samples([src(text, [_image(300, 280, 1)])], S, 0)
    big = tcollate.collate_samples([src(text, [_image(1000, 900, 2)])], S, 0)
    budget = small["img_gather_idx"].shape[1]
    f32 = tcollate.collate_samples([host(text, [_image(200, 150, 4)])], S, 0,
                                   img_token_budget=budget)
    assert f32["pixel_values"].shape[1] == 13 and small["pixel_values"].shape[1:3] == (672, 672)
    assert big["pixel_values"].shape[1:3] == (1008, 1008)
    score = ta.make_score_fn()
    batches = {k: tcollate.to_reward_batch(b, "cpu") for k, b in
               (("small", small), ("big", big), ("f32", f32))}
    alone = {k: score(ta.params, b) for k, b in batches.items()}
    for chosen, rejected, kind in (("small", "f32", "f32"), ("small", "big", "u8src")):
        stacked = tbi.stack_pair(batches[chosen], batches[rejected])
        assert tbi._pixel_kind(stacked) == kind
        torch.testing.assert_close(score(ta.params, stacked),
                                   torch.cat([alone[chosen], alone[rejected]]),
                                   rtol=0, atol=PARITY_BAR)

    # the bank the mixed pair is unified on, in both packages
    jbank = np.asarray(jbi._materialize_f32(jcollate.to_reward_batch(
        {k: v for k, v in small.items()})).pixel_values)
    tbank = tbi._materialize_f32(tcollate.to_reward_batch(small, "cpu")).pixel_values.numpy()
    assert tbank.shape == jbank.shape == (1, 17, 336, 336, 3)
    np.testing.assert_allclose(tbank, jbank, rtol=0, atol=1e-5)


def test_resize_tables_merge_like_jax():
    """Two u8-source batches of different crop buckets and tap counts: the
    merged tap tables equal the JAX package's; pad slots render white."""
    tok = Tok()
    text = tpp.apply_phi3v_chat_template(tok, "<|image_1|>\nok")
    src = tpp.Phi3VProcessor(tok, num_crops=16, device_preproc=True, device_resize=True)
    a = tcollate.collate_samples([src(text, [_image(300, 280, 1)])], 2560, 0)
    b = tcollate.collate_samples([src(text, [_image(1300, 1000, 2)])], 2560, 0)
    ta_, tb_ = a["resize_tabs"], b["resize_tabs"]
    assert ta_["vidx"].shape[1] != tb_["vidx"].shape[1] or ta_["hw"].shape != tb_["hw"].shape
    t = tbi._merge_resize_tabs({k: torch.from_numpy(np.asarray(v)) for k, v in ta_.items()},
                               {k: torch.from_numpy(np.asarray(v)) for k, v in tb_.items()})
    j = jbi._merge_resize_tabs({k: jnp.asarray(v) for k, v in ta_.items()},
                               {k: jnp.asarray(v) for k, v in tb_.items()})
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)


# ------------------------------------------------------------ user input, profiling


def test_score_user_input_matches_jax(phi3v):
    ja, ta = phi3v
    tok = Tok()
    row = _rows(PAIRS)[2]
    imgs = [row["chosen_path"], row["reject_path"]]
    j = jbi.score_user_input(ja, tok, jpp.Phi3VProcessor(tok, num_crops=4), row["prompt"], imgs,
                             seq_len=SEQ, attn_impl="xla")
    t = tbi.score_user_input(ta, tok, tpp.Phi3VProcessor(tok, num_crops=4), row["prompt"], imgs,
                             seq_len=SEQ)
    assert t.shape == (2, 2)
    np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=PARITY_BAR)


def test_step_timer_and_profiling_hooks(tmp_path):
    """``span`` records inside ``trace`` and shows in its trace; ``trace``
    writes the file; no card, no memory stats."""
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("serve.step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert any(e.key == "serve.step" for e in prof.key_averages())
    (r,) = profiling.session().named("serve.step")
    assert r.end_ns > r.start_ns and r.thread == threading.get_native_id()
    with profiling.span("serve.step"):  # the profiler is off again
        pass
    assert len(profiling.session().named("serve.step")) == 1
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() is None


def test_trace_refuses_to_run_untraced(tmp_path, monkeypatch):
    import torch.profiler as tp

    class Broken:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr(tp, "profile", Broken)
    ran = []
    with pytest.raises(RuntimeError, match="untraced"):
        with profiling.trace(str(tmp_path)):
            ran.append(1)
    assert not ran


def test_batch_inference_writes_a_profile(phi3v, tmp_path):
    _, ta = phi3v
    tok = Tok()
    m = tbi.batch_rm_inference(ta, _rows(PAIRS)[:2], tok, tpp.Phi3VProcessor(tok, num_crops=4),
                               batch_size=4, seq_len=SEQ, num_workers=1, progress=False,
                               profile_dir=str(tmp_path / "prof"))
    assert m["num_pairs"] == 2 and os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_service_spans_and_counters_under_the_profiler(phi3v):
    """After a request of one image, two concurrent requests of three images
    coalesce into one batch of six rows, scored as a call of four and a
    follow-up of two that carries the second request's last rows: one
    ``serve.queue`` per request, up to the start of that call, the real rows
    counted, each call naming its requests, the batcher's wait between."""
    _, ta = phi3v
    tok = Tok()
    proc = tpp.Phi3VProcessor(tok, num_crops=4)
    service = tsrv.RewardService(ta, tok, proc, seq_len=SEQ, max_batch=4, batch_window_ms=1500)
    rows, out = _rows(PAIRS), {}

    def req(i):
        r = rows[i]
        out[i] = service.score(r["prompt"], [r["chosen_path"], r["reject_path"], r["chosen_path"]])

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        service.score(rows[2]["prompt"], [rows[2]["chosen_path"]])  # then the batcher waits
        threads = [threading.Thread(target=req, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert sorted(out) == [0, 1] and not any(t.is_alive() for t in threads)
    s = profiling.session()
    assert {k: v for k, v in s.counts.items() if not k.startswith("serve.tokens")} == {
        "serve.calls": 3, "serve.rows": 7, "serve.pad_rows": 0}

    def tokens(i, key):
        text = service._template(rows[i]["prompt"])
        return len(proc(text, [tsrv._load_image(rows[i][key])]).input_ids)

    want = tokens(2, "chosen_path") + sum(2 * tokens(i, "chosen_path") + tokens(i, "reject_path")
                                          for i in (0, 1))
    assert s.counts["serve.tokens"] == want
    assert want <= s.counts["serve.tokens_padded"] <= 7 * SEQ
    assert s.counts["serve.tokens_padded"] % 128 == 0
    preps = sorted(s.named("serve.prep"), key=lambda r: r.start_ns)
    assert [r.attrs for r in preps] == [{"images": 1}, {"images": 3}, {"images": 3}]
    queued = {r.request: r for r in s.named("serve.queue")}
    assert sorted(queued) == sorted(r.request for r in preps)
    single, *calls = sorted(s.named("serve.call"), key=lambda r: r.start_ns)
    assert single.attrs == {"rows": 1, "requests": [preps[0].request]}
    assert [c.attrs["rows"] for c in calls] == [4, 2]
    first, second = calls[0].attrs["requests"]
    assert calls[1].attrs["requests"] == [second]
    assert queued[first].end_ns <= calls[0].start_ns < queued[second].end_ns
    assert queued[second].end_ns <= calls[1].start_ns
    for name in ("serve.collate", "serve.step"):
        assert sorted(r.parent for r in s.named(name)) == sorted(c.id for c in [single] + calls)
    # the wait between the single call and the coalesced one
    (wait,) = [w for w in s.named("serve.wait")
               if single.end_ns <= w.start_ns and w.end_ns <= calls[0].start_ns]
    assert wait.seconds > 0


def test_loader_waits_once_a_batch_and_the_trace_holds_every_thread(phi3v, tmp_path):
    _, ta = phi3v
    tok = Tok()
    tbi.batch_rm_inference(ta, _rows(PAIRS)[:3], tok, tpp.Phi3VProcessor(tok, num_crops=4),
                           batch_size=1, seq_len=SEQ, num_workers=1, progress=False,
                           profile_dir=str(tmp_path))
    s = profiling.session()
    assert len(s.named("loader.wait")) == len(s.named("eval.step")) == 3
    for name in ("loader.decode_wait", "loader.collate", "loader.device_put"):
        assert len(s.named(name)) == 3, name
    consumer = {r.thread for r in s.named("eval.step")}
    assert {r.thread for r in s.named("loader.collate")}.isdisjoint(consumer)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    tids = {e["name"]: e.get("tid") for e in events if e.get("ph") == "X"}
    assert "loader.collate" in tids and "eval.step" in tids
    assert tids["loader.collate"] != tids["eval.step"]
