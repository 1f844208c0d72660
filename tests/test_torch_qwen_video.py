"""Qwen2.5-VL video in the port against the JAX package's, on the CPU (the
twin of tests/test_qwen_video.py, on seeded numpy frames: this machine has
neither ``decord`` nor ``torchvision``):

- ``smart_nframes`` over its cases; ``fetch_video`` on an array with
  ``video_fps`` and on frame lists (PIL and arrays), the frames equal;
- ``frames_to_patches``, ``windowize_video`` and ``mrope_position_ids_video``
  (second_per_grid_t 1.0 and 0.5: the int() floor gives all-zero temporal
  steps at 0.5) equal as arrays;
- ``Qwen25VLProcessor(..., videos=[...])``'s sample equal field by field
  (segment ids t+1 per slice, the rotary positions tiled per slice);
- a video path raises the same ImportError in both;
- a two-slice video reward through ``RewardAdaptor(model_type="qwen")``
  within PARITY.md's 2.03e-05 of the JAX reward, on the reference route at
  the tiny config and on the kernel route's plain versions at the
  lane-aligned config (``attn_impl="pallas"``: B3's segment mode over two
  nonzero ids against the interpreted ``_fa_kernel``).
"""

import dataclasses

import numpy as np
import pytest
from PIL import Image

from llava_reward_tpu.preprocess import qwen_video as jqvid
from llava_reward_tpu.preprocess import qwen_vision as jqv
from llava_reward_tpu.reward.model import reward_forward as j_reward
from llava_reward_torch.evalx.adaptor import RewardAdaptor
from llava_reward_torch.ops import flash_attention as tfa
from llava_reward_torch.preprocess import collate as tcollate
from llava_reward_torch.preprocess import qwen_video as tqvid
from llava_reward_torch.preprocess import qwen_vision as tqv
from test_torch_qwen_reward import _assert_parity, _jb, _setup, _tb
from test_torch_qwen_model import jit_call, jtree

SMALL = dict(min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28)  # 56 x 56 frames stay 56 x 56


def _video(seed, T=4, H=56, W=56):
    return np.random.default_rng(seed).integers(0, 256, (T, H, W, 3)).astype(np.uint8)


def _equal(a, b):
    assert type(a) is type(b) or (isinstance(a, tuple) and isinstance(b, tuple))
    if isinstance(b, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("ele, total, fps", [
    ({}, 100, 25.0), ({}, 6, 30.0), ({"fps": 10}, 50, 25.0), ({"nframes": 7}, 50, 25.0),
    ({"min_frames": 6, "max_frames": 10}, 300, 30.0), ({"fps": 0.5}, 16, 4.0)])
def test_smart_nframes_matches_jax(ele, total, fps):
    assert tqvid.smart_nframes(ele, total, fps) == jqvid.smart_nframes(ele, total, fps)


def test_smart_nframes_semantics_and_errors():
    assert tqvid.smart_nframes({}, total_frames=100, video_fps=25.0) == 8  # 100 / 25 * 2
    assert tqvid.smart_nframes({}, total_frames=6, video_fps=30.0) == 4  # min_frames
    assert tqvid.smart_nframes({"fps": 10}, total_frames=50, video_fps=25.0) == 20
    assert tqvid.smart_nframes({"nframes": 7}, total_frames=50, video_fps=25.0) == 8
    for m in (tqvid, jqvid):
        with pytest.raises(ValueError):
            m.smart_nframes({"nframes": 80}, total_frames=50, video_fps=25.0)
        with pytest.raises(AssertionError):
            m.smart_nframes({"fps": 2, "nframes": 4}, total_frames=50, video_fps=25.0)
    assert tqvid.VIDEO_TOTAL_PIXELS == jqvid.VIDEO_TOTAL_PIXELS
    for ele, n in (({}, 4), ({"min_pixels": 8 * 784, "max_pixels": 64 * 784}, 6),
                   ({"total_pixels": 1000 * 784}, 16)):
        assert tqvid._video_max_pixels(ele, n) == jqvid._video_max_pixels(ele, n)


@pytest.mark.parametrize("case", ["array", "array_resized", "pil_list", "array_list"])
def test_fetch_video_matches_jax(case):
    vid = _video(1, T=30, H=60, W=90)
    if case == "array":
        ele = {"video": vid, "video_fps": 15.0}
    elif case == "array_resized":
        ele = {"video": vid[:8], "nframes": 4, "resized_height": 50, "resized_width": 70}
    elif case == "pil_list":  # three frames pad to four; no re-resize to the video budget
        ele = {"video": [Image.fromarray(vid[i]) for i in range(3)], **SMALL}
    else:
        ele = {"video": [vid[i] for i in range(5)], "fps": 3.0}
    tf, tfps = tqvid.fetch_video(dict(ele))
    jf, jfps = jqvid.fetch_video(dict(ele))
    assert tf.dtype == jf.dtype == np.float32 and tf.shape == jf.shape
    assert tf.shape[0] % tqvid.FRAME_FACTOR == 0
    assert tf.shape[1] % 28 == 0 and tf.shape[2] % 28 == 0
    np.testing.assert_array_equal(tf, jf)
    assert tfps == jfps
    if case == "array":
        assert tf.shape[0] == 4 and tfps == pytest.approx(15.0 * 4 / 30)


@pytest.mark.parametrize("spgt", [1.0, 0.5])
def test_patches_windows_and_positions_match_jax(spgt):
    frames = _video(2, T=4, H=56, W=84).astype(np.float32)
    tp, tg = tqvid.frames_to_patches(frames)
    jp, jg = jqvid.frames_to_patches(frames)
    assert tg == jg == (2, 4, 6)
    _equal(tp, jp)
    for grid in (tg, (3, 8, 12), (2, 10, 6)):
        _equal(tqvid.windowize_video(grid), jqvid.windowize_video(grid))
    src, seg, gather, n_win = tqvid.windowize_video((3, 8, 12))
    assert set(np.unique(seg).tolist()) == {0, 1, 2, 3}  # segment ids per slice, 0 for pads
    assert len(set(gather.tolist())) == gather.shape[0] and n_win == 3 * 2
    vid_id = 102
    n = 2 * 2 * 3
    ids = np.concatenate([[5, 6, 101], np.full(n, vid_id), [7, 8]]).astype(np.int32)
    tpos = tqvid.mrope_position_ids_video(ids, vid_id, tg, second_per_grid_t=spgt)
    jpos = jqvid.mrope_position_ids_video(ids, vid_id, jg, second_per_grid_t=spgt)
    _equal(tpos, jpos)
    steps = np.unique(tpos[0, 3:3 + n])
    assert (steps.size == 1) == (spgt == 0.5)  # int(0.5) = 0: no temporal step
    _equal(tqvid.mrope_position_ids_video(ids[:3], vid_id, tg),
           jqvid.mrope_position_ids_video(ids[:3], vid_id, jg))  # no video token


class VTok:
    """Word ids, with the video pad as token ``video_id``."""

    def __init__(self, video_id):
        self.video_id = video_id

    def __call__(self, text):
        return {"input_ids": [self.video_id if w == "<|video_pad|>" else sum(map(ord, w)) % 90 + 3
                              for w in text.split()]}


def _processors(video_id, window_size=112):
    out = []
    for m in (jqv, tqv):
        p = m.Qwen25VLProcessor(VTok(video_id), window_size=window_size, **SMALL)
        p.VIDEO_TOKEN_ID = video_id
        out.append(p)
    return out


@pytest.mark.parametrize("ele", [
    {"nframes": 4, **SMALL},
    {"video_fps": 4.0, **SMALL},  # sample fps 4: second_per_grid_t 0.5, no temporal step
    {"fps": 2.0, **SMALL}])
def test_call_video_matches_jax(ele):
    j, t = _processors(97)
    prompt = "rate <|video_pad|> this clip"
    ele = {"video": _video(3, T=8, H=56, W=84), **ele}
    js, ts = j(prompt, videos=[dict(ele)]), t(prompt, videos=[dict(ele)])
    for f in dataclasses.fields(js):
        _equal(getattr(ts, f.name), getattr(js, f.name))
    gt = ts.grid_thw[0]
    assert gt >= 2 and ts.num_img_tokens == gt * (ts.grid_thw[1] // 2) * (ts.grid_thw[2] // 2)
    assert set(np.unique(ts.patch_valid).tolist()) == set(range(gt + 1))
    with pytest.raises(NotImplementedError):
        t(prompt, videos=[dict(ele), dict(ele)])
    with pytest.raises(ValueError, match="video_pad"):
        t("rate this clip", videos=[dict(ele)])


def test_video_path_raises_the_same_import_error(tmp_path):
    path = str(tmp_path / "clip.mp4")
    with pytest.raises(ImportError) as jerr:
        jqvid.fetch_video({"video": path})
    with pytest.raises(ImportError) as terr:
        tqvid.fetch_video({"video": path})
    assert str(terr.value) == str(jerr.value) and "decord or torchvision" in str(terr.value)


def _video_pair(tcfg, seq_len=48):
    """Two videos of two temporal slices each (grid (2, 4, 4): 8 merged units,
    one padded window a slice), the second row left-padded by 5."""
    tc = tcfg.text
    _, t = _processors(tc.image_token_id, tcfg.vision.window_size)
    samples = [t(" ".join(["rate", "<|video_pad|>"] + ["w"] * n),
                 videos=[{"video": _video(10 + i), "nframes": 4, **SMALL}])
               for i, n in enumerate((seq_len - 9, seq_len - 14))]
    assert all(s.grid_thw == (2, 4, 4) for s in samples)
    return tcollate.collate_qwen_samples(samples, seq_len, tc.pad_token_id, patch_budget=128,
                                         unit_budget=32)


@pytest.mark.parametrize("aligned", [False, True], ids=["reference", "kernel_route"])
def test_video_reward_matches_jax(aligned):
    setup = _setup(aligned, fused=aligned)
    jcfg, tcfg, jr, tr, jt, tt = setup
    fields = _video_pair(tcfg)
    assert set(np.unique(fields["patch_valid"]).tolist()) == {0, 1, 2}
    impl = "pallas" if aligned else "auto"
    j = np.asarray(jit_call(lambda p, b: j_reward(p, jcfg, jr, b, training=False,
                                                  attn_impl=impl).reward,
                            jtree(jt), _jb(fields)))
    tfa.reset_counters()
    t = RewardAdaptor(tcfg, tr, tt, model_type="qwen", device="cpu").make_score_fn(
        attn_impl=impl)(tt, _tb(fields)).numpy()
    assert t.shape == (2, 2) and np.isfinite(t).all()
    if aligned:  # B2 x3 + B3 a decoder layer; B3 in segment mode in the full block and in
        # key-mask mode in the window block ("pallas" sends the short rows to it too)
        L = tcfg.text.num_layers
        assert tfa.PLAIN_CALLS == {"fa_direct": 0, "prep": 3 * L, "fa_hm": L + 2, "fa_bwd": 0}
        assert not any(tfa.LAUNCHES.values())
    _assert_parity(j, t, 1)
    assert not np.allclose(t[0], t[1])  # two videos, two rewards
