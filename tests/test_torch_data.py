"""The port's host data path against the JAX package's, on the same rows and
images:

- ``collate_samples`` in its f32, u8 and u8-source forms, the mixed-batch
  fallbacks and ``crop_buckets=None``: equal arrays in both packages;
  ``to_reward_batch`` carries ``crop_grid`` and ``resize_tabs``;
- the datasets read ``data/sample_test`` and ``data/Unsafebench`` rows into
  the same items (phi3v and qwen forms); blending, row parsing, path rewrite;
- the samplers give the same index order over seeds, epochs and ranks;
- ``PrefetchLoader`` keeps the order, and its threads end when the iteration
  is exhausted, abandoned or raises (each run under its own timeout);
- ``build_train_parser().parse_args([])`` has the same defaults.

Twins: tests/test_resume_and_samplers.py, test_safety_pointwise_data.py.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from llava_reward_tpu.core.args import build_train_parser as j_parser
from llava_reward_tpu.data import datasets as jds
from llava_reward_tpu.data import sampler as jsampler
from llava_reward_tpu.preprocess import collate as jcollate
from llava_reward_tpu.preprocess import phi3v_processor as jpp
from llava_reward_tpu.preprocess import qwen_vision as jqv
from llava_reward_torch.core.args import build_train_parser as t_parser
from llava_reward_torch.data import datasets as tds
from llava_reward_torch.data import sampler as tsampler
from llava_reward_torch.data.loader import PrefetchLoader
from llava_reward_torch.preprocess import collate as tcollate
from llava_reward_torch.preprocess import phi3v_processor as tpp
from llava_reward_torch.preprocess import qwen_vision as tqv
from llava_reward_torch.reward.model import RewardBatch
from test_torch_processor import ROOT, SAMPLE_IMAGES, QTok, Tok, _assert_samples_equal, synthetic

SEQ = 400
LOADER_TIMEOUT = 60  # seconds for one whole loader run, threads joined


def _assert_batches_equal(t, j):
    assert sorted(t) == sorted(j)
    for k, b in j.items():
        a = t[k]
        if isinstance(b, dict):
            _assert_batches_equal(a, b)
        elif b is None:
            assert a is None, k
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def _proc(pkg, mode, n=4):
    proc = pkg.Phi3VProcessor(Tok(), num_crops=n, device_preproc=mode != "f32")
    proc.device_resize = mode == "u8src"
    return proc


def _sample(pkg, mode, img, n=4):
    return _proc(pkg, mode, n)("<|image_1|> a picture", [img])


# name -> (image, num_crops); the 16x1 panorama takes the host f32 path in
# every mode (its grid is over ops/pixels.MAX_GRID)
IMAGES = {"sample": (lambda: Image.open(SAMPLE_IMAGES[2]).convert("RGB"), 4),
          "wide": (lambda: synthetic(260, 130, 21), 4),
          "panorama": (lambda: synthetic(1700, 100, 22), 16)}

# (name, the images' pixel modes, crop_buckets): uniform batches, the mixed
# fallbacks (a u8 or u8-source batch holding a host-f32 sample, a u8-source
# batch holding a u8 one), text-only rows, and the fixed-shape contract
CASES = [
    ("f32", [("sample", "f32"), ("wide", "f32")], jcollate.CROP_BUCKETS),
    ("u8", [("sample", "u8"), ("wide", "u8")], jcollate.CROP_BUCKETS),
    ("u8src", [("sample", "u8src"), ("wide", "u8src")], jcollate.CROP_BUCKETS),
    ("u8+f32", [("sample", "u8"), ("panorama", "u8")], jcollate.CROP_BUCKETS),
    ("u8src+f32", [("sample", "u8src"), ("panorama", "u8src")], jcollate.CROP_BUCKETS),
    ("u8src+u8", [("sample", "u8src"), ("wide", "u8")], jcollate.CROP_BUCKETS),
    ("u8src+text", [("sample", "u8src"), (None, "u8src")], jcollate.CROP_BUCKETS),
    ("f32-fixed", [("sample", "f32"), ("wide", "f32")], None),
    ("u8-fixed", [("sample", "u8"), ("wide", "u8")], None),
    ("u8src-fixed", [("sample", "u8src"), ("wide", "u8src")], None),
]


@pytest.mark.parametrize("name,spec,buckets", CASES, ids=[c[0] for c in CASES])
def test_collate_samples(name, spec, buckets):
    out = {}
    for pkg, collate in ((jpp, jcollate), (tpp, tcollate)):
        samples = [_sample(pkg, mode, IMAGES[img][0](), IMAGES[img][1]) if img else
                   _proc(pkg, mode)("text only", []) for img, mode in spec]
        out[pkg] = collate.collate_samples(samples, SEQ, 0, crop_buckets=buckets)
    t, j = out[tpp], out[jpp]
    _assert_batches_equal(t, j)
    assert isinstance(t, tcollate.Batch) and t.input_ids is t["input_ids"]
    kind = t["pixel_values"].dtype
    want = {"f32": np.float32, "u8": np.uint8, "u8src": np.uint8, "u8+f32": np.float32,
            "u8src+f32": np.float32, "u8src+u8": np.uint8, "u8src+text": np.uint8}
    assert kind == want.get(name, want[name.split("-")[0]])
    assert ("resize_tabs" in t) == (name in ("u8src", "u8src+text", "u8src-fixed"))
    rb = tcollate.to_reward_batch(t, device="cpu")
    assert isinstance(rb, RewardBatch)
    for field in RewardBatch._fields:
        v = t.get(field)
        if isinstance(v, dict):
            assert sorted(getattr(rb, field)) == sorted(v)
            for k in v:
                np.testing.assert_array_equal(getattr(rb, field)[k].numpy(), v[k])
        elif v is None:
            assert getattr(rb, field) is None, field
        else:
            np.testing.assert_array_equal(getattr(rb, field).numpy(), v, err_msg=field)


def _rows(path, n):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)[:n]


def _items_equal(ti, ji):
    assert len(ti) == len(ji)
    for a, b in zip(ti, ji):
        if hasattr(b, "input_ids"):
            _assert_samples_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("native", ["1", "0"])
def test_pairwise_dataset_sample_rows(native, monkeypatch):
    """data/sample_test pairs (their paths are relative to the repository)."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("LRT_NATIVE_IMG", native)
    rows = _rows("data/sample_test/pairwise_sample.json", 4)
    rows[1] = dict(rows[1], prompt=[rows[1]["prompt"], "another prompt"])
    tok = Tok()
    j = jds.PairwiseRewardDataset(rows, _proc(jpp, "u8"), tok)
    t = tds.PairwiseRewardDataset(rows, _proc(tpp, "u8"), tok)
    assert len(t) == len(j) == 4
    ti, ji = [t[i] for i in range(4)], [j[i] for i in range(4)]
    for a, b in zip(ti, ji):
        _items_equal(a, b)
    _assert_batches_equal(t.collate(ti, SEQ, 0)[0], j.collate(ji, SEQ, 0)[0])
    c, r = t.collate(ti, SEQ, 0)[2:]
    np.testing.assert_array_equal(c, [1, 1, 1, 1])
    np.testing.assert_array_equal(r, [0, 0, 0, 0])


def test_pointwise_datasets_unsafebench_rows():
    rows = _rows("data/Unsafebench/Unsafebench_train.json", 3)
    root = os.path.join(ROOT, "data")
    tok = Tok()
    j = jds.PointwiseRewardDataset(rows, _proc(jpp, "f32"), tok, image_root=root)
    t = tds.PointwiseRewardDataset(rows, _proc(tpp, "f32"), tok, image_root=root)
    ti, ji = [t[i] for i in range(3)], [j[i] for i in range(3)]
    for a, b in zip(ti, ji):
        _items_equal(a, b)
    tb, tl = t.collate(ti, SEQ, 0)
    jb, jl = j.collate(ji, SEQ, 0)
    _assert_batches_equal(tb, jb)
    np.testing.assert_array_equal(tl, jl)


def test_qwen_datasets(monkeypatch):
    monkeypatch.chdir(ROOT)
    kw = dict(min_pixels=4 * 28 * 28, max_pixels=64 * 28 * 28, image_token_id=7)
    tok = QTok()
    tok.apply_chat_template = lambda msgs, **_: "x" * 58 + "<pad7> " + msgs[0]["content"][1][
        "text"] + " " + "y" * 23
    jp, tp = jqv.Qwen25VLProcessor(tok, **kw), tqv.Qwen25VLProcessor(tok, **kw)
    rows = _rows("data/sample_test/pairwise_sample.json", 2)
    j = jds.QwenPairwiseRewardDataset(rows, jp, tok)
    t = tds.QwenPairwiseRewardDataset(rows, tp, tok)
    assert (t.patch_budget, t.unit_budget) == (j.patch_budget, j.unit_budget)
    ti, ji = [t[i] for i in range(2)], [j[i] for i in range(2)]
    for a, b in zip(ti, ji):
        _items_equal(a, b)
    for a, b in zip(t.collate(ti, 160, 0)[:2], j.collate(ji, 160, 0)[:2]):
        _assert_batches_equal(a, b)
    prow = _rows("data/sample_test/non_pairwise_sample.json", 2)
    j = jds.QwenPointwiseRewardDataset(prow, jp, tok, patch_budget=256, unit_budget=64)
    t = tds.QwenPointwiseRewardDataset(prow, tp, tok, patch_budget=256, unit_budget=64)
    for i in range(2):
        _items_equal(t[i], j[i])
    tb, tl = t.collate([t[0], t[1]], 160, 0)
    jb, jl = j.collate([j[0], j[1]], 160, 0)
    _assert_batches_equal(tb, jb)
    np.testing.assert_array_equal(tl, jl)


def test_blending_rows_and_paths(tmp_path):
    a = os.path.join(ROOT, "data/sample_test/pairwise_sample.json")
    b = os.path.join(ROOT, "data/Unsafebench/Unsafebench_cap_train.json")
    for kw in (dict(), dict(probs="0.3,0.7", seed=3), dict(train_split_ratio=0.75),
               dict(stopping_strategy="all_exhausted", return_eval=False)):
        assert tds.blending_datasets(f"{a},{b}", **kw) == jds.blending_datasets(f"{a},{b}", **kw)
    jl = tmp_path / "rows.jsonl"
    jl.write_text("\n".join(json.dumps(r) for r in _rows("data/sample_test/pairwise_sample.json",
                                                          3)))
    assert tds.load_json_dataset(str(jl)) == jds.load_json_dataset(str(jl))
    rows = _rows("data/sample_test/pairwise_sample.json", 8)
    for r in rows + _rows("data/Unsafebench/Unsafebench_train.json", 4):
        fn = "parse_pairwise_row" if "chosen_path" in r else "parse_pointwise_row"
        assert getattr(tds, fn)(r) == getattr(jds, fn)(r)
    assert tds.is_pairwise(rows) and not tds.is_pairwise(_rows(
        "data/Unsafebench/Unsafebench_train.json", 1))
    outs = [str(tmp_path / f"{p}.json") for p in ("t", "j")]
    nt = tds.rewrite_paths(a, "data/sample_test", "/elsewhere", outs[0])
    nj = jds.rewrite_paths(a, "data/sample_test", "/elsewhere", outs[1])
    assert nt == nj == 8  # 4 rows, two paths each
    assert tds.load_json_dataset(outs[0]) == jds.load_json_dataset(outs[1])
    with pytest.raises(ValueError, match="probabilities"):
        tds.blending_datasets(f"{a},{b}", probs="1.0")


@pytest.mark.parametrize("kind", ["distributed", "group"])
def test_samplers_same_order(kind):
    for n, replicas, kw in ((37, 4, {}), (10, 3, dict(drop_last=True)), (24, 2, dict(
            shuffle=False)), (50, 4, dict(group_size=4, sample_group_num=5)),
            (9, 1, dict(group_size=2))):
        if kind == "distributed":
            kw = {k: v for k, v in kw.items() if k not in ("group_size", "sample_group_num")}
        cls = {"distributed": "DistributedSampler", "group": "GroupSampler"}[kind]
        for seed in (0, 7):
            for rank in range(replicas):
                t = getattr(tsampler, cls)(n, replicas, rank, seed=seed, **kw)
                j = getattr(jsampler, cls)(n, replicas, rank, seed=seed, **kw)
                for epoch in (0, 1, 5):
                    t.set_epoch(epoch)
                    j.set_epoch(epoch)
                    assert [int(i) for i in t] == [int(i) for i in j]
                    assert len(t) == len(j)


class _Items:
    """A dataset whose items are their index; ``bad`` raises."""

    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise RuntimeError(f"item {i} is broken")
        return np.full((3,), i, np.int64)


def _loader_threads():
    return [t for t in threading.enumerate() if t.name.startswith("PrefetchLoader")]


def _run_with_timeout(fn):
    """Run ``fn`` in a thread under LOADER_TIMEOUT; its result or error."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except Exception as e:  # handed to the test below
            box["err"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(LOADER_TIMEOUT)
    assert not th.is_alive(), "the loader run did not finish in time"
    return box


@pytest.mark.parametrize("drop_last", [True, False])
def test_prefetch_loader_order_and_thread_end(drop_last):
    assert not _loader_threads()
    sampler = tsampler.DistributedSampler(23, seed=4)
    loader = PrefetchLoader(_Items(23), sampler, 4, lambda items: np.stack(items), num_workers=3,
                            prefetch_batches=2, device_put=torch.from_numpy,
                            drop_last=drop_last)
    idx = list(sampler)
    want = [np.stack([np.full((3,), i) for i in idx[k:k + 4]]) for k in range(0, 23, 4)]
    want = want[:5] if drop_last else want
    box = _run_with_timeout(lambda: [b.numpy() for b in loader])
    assert "err" not in box and len(box["out"]) == len(loader) == len(want)
    for a, b in zip(box["out"], want):
        np.testing.assert_array_equal(a, b)
    assert not _loader_threads()

    # abandoned after one batch: the generator is closed, the threads end
    def first():
        it = iter(loader)
        out = next(it)
        it.close()
        return out

    box = _run_with_timeout(first)
    np.testing.assert_array_equal(box["out"].numpy(), want[0])
    assert not _loader_threads()

    # a worker's error reaches the consumer, and the threads end
    bad = PrefetchLoader(_Items(23, bad=idx[9]), sampler, 4, lambda items: np.stack(items),
                         num_workers=3)
    box = _run_with_timeout(lambda: list(bad))
    assert isinstance(box.get("err"), RuntimeError) and "broken" in str(box["err"])
    assert not _loader_threads()


def test_train_parser_defaults():
    assert vars(t_parser().parse_args([])) == vars(j_parser().parse_args([]))
    argv = ["--model_type", "qwen", "--lora_rank", "8", "--load_in_8bit", "--bf16"]
    assert vars(t_parser().parse_args(argv)) == vars(j_parser().parse_args(argv))
