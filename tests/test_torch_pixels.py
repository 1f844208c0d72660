"""The port's device pixel ops (``llava_reward_torch/ops/pixels.py``) against
the JAX package's (``llava_reward_tpu/ops/pixels.py``), on CPU tensors:

- ``hd_resize_u8_bank``: bit-equal to JAX's and to the host's
  ``hd_transform_image`` crops, at mixed geometries (landscape, portrait,
  square, a 1x1 grid) in one batch;
- ``prepare_pixel_bank``: within 1e-5 of JAX's and of the host f32 bank;
- ``_fixedpoint_clip8``: an arithmetic shift, as ``shift_right_arithmetic``;
- the host tables (tap tables, band bank, weight matrix): equal.

Twins: tests/test_device_resize.py, test_device_preproc.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_reward_tpu.ops import pixels as jpx
from llava_reward_tpu.preprocess import collate as jcollate
from llava_reward_tpu.preprocess import phi3v_processor as jpp
from llava_reward_torch.ops import pixels as tpx
from llava_reward_torch.preprocess import collate as tcollate
from llava_reward_torch.preprocess import phi3v_processor as tpp
from test_torch_processor import Tok, synthetic

BANK_TOL = 1e-5
TAB_KEYS = ("hidx", "hw", "vidx", "vw", "vbias", "col_start", "slot_perm", "tflag")

# (w, h, seed, num_crops): landscape, portrait, square, and a 1x1 grid
GEOMETRIES = [(230, 170, 11, 4), (120, 300, 12, 4), (200, 200, 13, 4), (180, 140, 14, 1)]


def _samples(pkg, mode):
    tok = Tok()
    out = []
    for w, h, seed, n in GEOMETRIES:
        proc = pkg.Phi3VProcessor(tok, num_crops=n, device_preproc=mode != "f32")
        proc.device_resize = mode == "u8src"
        out.append(proc("<|image_1|> x", [synthetic(w, h, seed)]))
    return out


@pytest.fixture(scope="module")
def batches():
    """Each package's collated batch of the same images, in each mode."""
    return {(pkg.__name__, mode): collate.collate_samples(_samples(pkg, mode), 300, 0)
            for pkg, collate in ((jpp, jcollate), (tpp, tcollate))
            for mode in ("f32", "u8", "u8src")}


def _jtabs(b):
    return [jnp.asarray(b["resize_tabs"][k]) for k in TAB_KEYS]


def _ttabs(b):
    return [torch.from_numpy(np.asarray(b["resize_tabs"][k])) for k in TAB_KEYS]


def test_hd_resize_is_bit_exact(batches):
    jb, tb = batches[(jpp.__name__, "u8src")], batches[(tpp.__name__, "u8src")]
    for k in TAB_KEYS:
        np.testing.assert_array_equal(tb["resize_tabs"][k], jb["resize_tabs"][k], err_msg=k)
    np.testing.assert_array_equal(tb["pixel_values"], jb["pixel_values"])
    np.testing.assert_array_equal(tb["crop_grid"], jb["crop_grid"])
    t = tpx.hd_resize_u8_bank(torch.from_numpy(tb["pixel_values"]), *_ttabs(tb)).numpy()
    j = np.asarray(jax.jit(jpx.hd_resize_u8_bank)(jnp.asarray(jb["pixel_values"]), *_jtabs(jb)))
    assert t.dtype == np.uint8 and t.shape == j.shape
    np.testing.assert_array_equal(t, j)
    # ... and to the host's crops (u8 mode), slot for slot
    host = batches[(tpp.__name__, "u8")]
    np.testing.assert_array_equal(host["crop_grid"], tb["crop_grid"])
    for b, (hc, wc) in enumerate(tb["crop_grid"]):
        np.testing.assert_array_equal(t[b, : hc * wc], host["pixel_values"][b, : hc * wc])


def test_prepare_pixel_bank_matches_jax_and_host(batches):
    tb, jb = batches[(tpp.__name__, "u8")], batches[(jpp.__name__, "u8")]
    np.testing.assert_array_equal(tb["pixel_values"], jb["pixel_values"])
    t = tpx.prepare_pixel_bank(torch.from_numpy(tb["pixel_values"]),
                               torch.from_numpy(tb["crop_grid"])).numpy()
    j = np.asarray(jax.jit(jpx.prepare_pixel_bank)(jnp.asarray(jb["pixel_values"]),
                                                    jnp.asarray(jb["crop_grid"])))
    assert t.dtype == np.float32 and t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=BANK_TOL)
    # the host f32 bank (same bucket), on every real crop and the global view
    host = batches[(tpp.__name__, "f32")]["pixel_values"]
    assert host.shape[1] == t.shape[1]
    for b, (hc, wc) in enumerate(tb["crop_grid"]):
        np.testing.assert_allclose(t[b, : hc * wc + 1], host[b, : hc * wc + 1], rtol=0,
                                   atol=BANK_TOL)


def test_fixedpoint_clip8_shifts_arithmetically():
    acc = np.array([-(1 << 30), -(1 << 22) - 1, -1, 0, 1 << 21, 200 << 22, (300 << 22) + 5,
                    (1 << 31) - 1], np.int32)
    t = tpx._fixedpoint_clip8(torch.from_numpy(acc)).numpy()
    np.testing.assert_array_equal(t, np.asarray(jpx._fixedpoint_clip8(jnp.asarray(acc))))
    np.testing.assert_array_equal(t, [0, 0, 0, 0, 0, 200, 255, 255])


def test_host_tables_equal():
    np.testing.assert_array_equal(tpx._band_bank_np(3), jpx._band_bank_np(3))
    np.testing.assert_array_equal(tpx.bicubic_weight_matrix(700), jpx.bicubic_weight_matrix(700))
    for args in ((500, 1344, 7), (1344, 336, 9), (336, 336, 3)):
        for a, b in zip(tpx.pil_bilinear_taps(*args), jpx.pil_bilinear_taps(*args)):
            np.testing.assert_array_equal(a, b)
    for edge in (336, 672, 1000, 2688):
        assert tpx.taps_for_bucket(edge) == jpx.taps_for_bucket(edge)
    for geom in ((300, 400, 1344, 1008, False, 16, 9, 9), (220, 700, 672, 211, True, 8, 5, 5)):
        (t, tg), (j, jg) = tpx.build_hd_resize_tables(*geom), jpx.build_hd_resize_tables(*geom)
        assert tg == jg
        for k in TAB_KEYS:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    x = torch.arange(12, dtype=torch.uint8).reshape(2, 2, 3)
    np.testing.assert_array_equal(tpx.normalize_pixels(x).numpy(),
                                  np.asarray(jpx.normalize_pixels(jnp.asarray(x.numpy()))))
