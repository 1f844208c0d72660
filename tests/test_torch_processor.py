"""The port's host processors against the JAX package's, on the same images:
every ``data/sample_test`` image (as a PIL image and as the file's bytes,
which take the native decode where it builds) and seeded synthetic ones (a
1x1 grid, a 16-crop grid, a portrait, a 16x1 panorama that falls back to the
host f32 path, a two-image prompt), through the Phi-3.5-V processor in its
three pixel modes (host f32, u8 crops, u8 originals) and the Qwen2.5-VL
processor (f32, u8).

Bar: every field of the processed samples equal (``np.array_equal`` for
integer and u8 fields; f32 banks within 1e-6). Tag errors raise in both.
Twins: tests/test_processor.py, test_multi_image.py, test_crop_bucketing.py.
"""

import dataclasses
import glob
import io
import os

import numpy as np
import pytest
from PIL import Image

from llava_reward_tpu.preprocess import phi3v_processor as jpp
from llava_reward_tpu.preprocess import qwen_vision as jqv
from llava_reward_torch.preprocess import phi3v_processor as tpp
from llava_reward_torch.preprocess import qwen_vision as tqv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE_IMAGES = sorted(glob.glob(os.path.join(ROOT, "data/sample_test/sample_img/*.png")))
F32_TOL = 1e-6


class Tok:
    """A deterministic word tokenizer with a chat template, enough for both
    packages' processors and templates."""

    eos_token = "</s>"
    pad_token_id = 0

    def __call__(self, text):
        return {"input_ids": [sum(map(ord, w)) % 400 + 3 for w in text.split()]}

    def apply_chat_template(self, msgs, tokenize=False, add_generation_prompt=True):
        content = msgs[0]["content"]
        if isinstance(content, list):
            content = " ".join(c.get("text", "<|image_pad|>") for c in content)
        return "x" * 58 + content + " " + "y" * 23


def synthetic(w, h, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (max(h // 8, 1), max(w // 8, 1), 3), dtype=np.uint8)
    img = Image.fromarray(base).resize((w, h), Image.BILINEAR)
    return Image.fromarray(np.asarray(img) ^ rng.integers(0, 32, (h, w, 3), dtype=np.uint8))


# (image, num_crops): the 1x1 grid (num_crops=1), a 4x4 grid of 16 crops, a
# portrait, a 16x1 panorama (over ops/pixels.MAX_GRID: host f32 fallback)
SYNTHETIC = {
    "grid1x1": ((300, 220, 1), 1),
    "grid4x4": ((340, 330, 2), 16),
    "portrait": ((150, 420, 3), 4),
    "panorama16x1": ((1700, 100, 4), 16),
}


def _bytes(img):
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _assert_samples_equal(t, j):
    assert type(t).__name__ == type(j).__name__
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.shape == b.shape and a.dtype == b.dtype, f.name
            if b.dtype == np.float32:
                np.testing.assert_allclose(a, b, rtol=0, atol=F32_TOL, err_msg=f.name)
            else:
                assert np.array_equal(a, b), f.name
        else:
            assert a == b, (f.name, a, b)


def _phi3v_pair(mode, num_crops, monkeypatch):
    """The two packages' processors in one pixel mode."""
    tok = Tok()
    pre = mode != "f32"
    monkeypatch.setenv("LRT_DEVICE_RESIZE", "1" if mode == "u8src" else "0")
    j = jpp.Phi3VProcessor(tok, num_crops=num_crops, device_preproc=pre)
    t = tpp.Phi3VProcessor(tok, num_crops=num_crops, device_preproc=pre,
                           device_resize=mode == "u8src")
    assert t.device_resize == j.device_resize == (mode == "u8src")
    return j, t


MODES = ("f32", "u8", "u8src")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("as_bytes", [False, True], ids=["pil", "bytes"])
def test_phi3v_sample_images(mode, as_bytes, monkeypatch):
    j, t = _phi3v_pair(mode, 16, monkeypatch)
    prompt = "<|image_1|>\na serene mountain lake at sunrise"
    for path in SAMPLE_IMAGES[::3] if as_bytes else SAMPLE_IMAGES:
        if as_bytes:
            with open(path, "rb") as f:
                img = f.read()
        else:
            img = Image.open(path).convert("RGB")
        _assert_samples_equal(t(prompt, [img]), j(prompt, [img]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_phi3v_synthetic_geometries(name, mode, monkeypatch):
    (w, h, seed), num_crops = SYNTHETIC[name]
    j, t = _phi3v_pair(mode, num_crops, monkeypatch)
    img = synthetic(w, h, seed)
    ts, js = t("<|image_1|> describe", [img]), j("<|image_1|> describe", [img])
    _assert_samples_equal(ts, js)
    hc, wc = ts.image_size[0] // 336, ts.image_size[1] // 336
    assert (hc, wc) == {"grid1x1": (1, 1), "grid4x4": (4, 4), "portrait": (2, 1),
                        "panorama16x1": (1, 16)}[name]
    if mode == "f32" or name == "panorama16x1":  # the host f32 bank
        assert ts.pixel_values.dtype == np.float32 and ts.crop_grid is None
    elif mode == "u8":
        assert ts.pixel_values.dtype == np.uint8 and ts.crop_grid == (hc, wc)
    else:
        assert ts.pixel_values is None and ts.src_u8 is not None and ts.crop_grid == (hc, wc)


@pytest.mark.parametrize("mode", MODES)
def test_phi3v_two_images_in_one_prompt(mode, monkeypatch):
    """A multi-image sample takes the host f32 path in every mode."""
    j, t = _phi3v_pair(mode, 4, monkeypatch)
    imgs = [Image.open(SAMPLE_IMAGES[0]).convert("RGB"), synthetic(200, 120, 5)]
    text = "first <|image_1|> then <|image_2|> compare"
    ts = t(text, imgs)
    _assert_samples_equal(ts, j(text, imgs))
    assert ts.pixel_values.shape[0] == 2 * 5 and ts.crop_grid is None


def test_phi3v_helpers_and_tag_errors():
    for w, h in ((96, 128), (1700, 100), (640, 480), (100, 1700)):
        for n in (1, 4, 16):
            assert tpp.calc_hd_transform_size(w, h, n) == jpp.calc_hd_transform_size(w, h, n)
            assert tpp.hd_transform_scale(w, h, n) == jpp.hd_transform_scale(w, h, n)
    for n in (1, 4, 16):
        assert tpp.max_num_img_tokens(n) == jpp.max_num_img_tokens(n)
    img = synthetic(200, 150, 6)
    np.testing.assert_array_equal(tpp.decode_to_u8(_bytes(img)), jpp.decode_to_u8(_bytes(img)))
    x = np.random.default_rng(0).standard_normal((3, 50, 70)).astype(np.float32)
    np.testing.assert_array_equal(tpp.resize_bicubic_np(x, (33, 41)),
                                  jpp.resize_bicubic_np(x, (33, 41)))
    tok = Tok()
    assert tpp.apply_phi3v_chat_template(tok, "hi") == jpp.apply_phi3v_chat_template(tok, "hi")
    for proc in (jpp.Phi3VProcessor(tok, num_crops=4), tpp.Phi3VProcessor(tok, num_crops=4)):
        with pytest.raises(ValueError, match="1..n"):
            proc("<|image_2|> x", [img])
        with pytest.raises(ValueError, match="image tags"):
            proc("<|image_1|> x", [img, img])


def _qwen_pair(layout):
    tok = Tok()
    kw = dict(min_pixels=4 * 28 * 28, max_pixels=256 * 28 * 28, image_token_id=7,
              device_preproc=layout == "u8")
    return jqv.Qwen25VLProcessor(tok, **kw), tqv.Qwen25VLProcessor(tok, **kw)


def _pad_prompt(n_images):
    return " ".join(["q"] + ["<pad7>"] * n_images + ["end"])


class QTok(Tok):
    """Tok with the qwen image pad as its own token (id 7)."""

    def __call__(self, text):
        return {"input_ids": [7 if w == "<pad7>" else sum(map(ord, w)) % 400 + 10
                              for w in text.split()]}


@pytest.mark.parametrize("layout", ["f32", "u8"])
def test_qwen_images(layout):
    j, t = _qwen_pair(layout)
    j.tokenizer = t.tokenizer = QTok()
    imgs = [Image.open(p).convert("RGB") for p in SAMPLE_IMAGES[:4]]
    imgs += [synthetic(500, 130, 7), synthetic(90, 300, 8)]
    for img in imgs:
        ts, js = t(_pad_prompt(1), [img]), j(_pad_prompt(1), [img])
        _assert_samples_equal(ts, js)
        assert ts.patches.dtype == (np.uint8 if layout == "u8" else np.float32)
    ts, js = t(_pad_prompt(2), imgs[:2]), j(_pad_prompt(2), imgs[:2])
    _assert_samples_equal(ts, js)
    assert set(np.unique(ts.patch_valid)) == {0, 1, 2} or set(np.unique(ts.patch_valid)) == {1, 2}


def test_qwen_helpers_and_errors():
    img = synthetic(333, 222, 9)
    for kw in (dict(), dict(min_pixels=4 * 28 * 28, max_pixels=64 * 28 * 28)):
        assert tqv.fetch_image(img, **kw).size == jqv.fetch_image(img, **kw).size
        np.testing.assert_array_equal(np.asarray(tqv.fetch_image(img, **kw)),
                                      np.asarray(jqv.fetch_image(img, **kw)))
    for layout in ("f32", "u8"):
        tp, tg = tqv.image_to_patches(img, max_pixels=64 * 28 * 28, layout=layout)
        jp, jg = jqv.image_to_patches(img, max_pixels=64 * 28 * 28, layout=layout)
        assert tg == jg and tp.dtype == jp.dtype
        np.testing.assert_array_equal(tp, jp)
    tok = Tok()
    assert tqv.apply_qwen_chat_template(tok, "a cat") == jqv.apply_qwen_chat_template(tok, "a cat")
    j, t = _qwen_pair("f32")
    j.tokenizer = t.tokenizer = QTok()
    with pytest.raises(AssertionError):
        j(_pad_prompt(1), [img, img])
    with pytest.raises(ValueError, match="image_pad"):
        t(_pad_prompt(1), [img, img])
    # a video: the prompt's one pad token (here id 7) as <|video_pad|>
    j.VIDEO_TOKEN_ID = t.VIDEO_TOKEN_ID = 7
    video = [np.zeros((2, 28, 28, 3), np.uint8)]
    _assert_samples_equal(t(_pad_prompt(1), videos=video), j(_pad_prompt(1), videos=video))
