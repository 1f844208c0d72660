"""The port's CLIP tower, Phi-3 decoder and Phi-3-V backbone against the
JAX package's at ``phi3v_tiny_config``, fp32 on the CPU: one param tree
(made by the JAX ``init_params``, carried across by ``io.convert``) and
one set of numpy inputs feed both. Tolerance 1e-4 on hidden states of
magnitude ~1 after 2-layer stacks (fp32, different matmul summation
orders); left-pad rows are not compared.

The W8A8 CLIP tower (``W8A8_ROUTES``) at a lane-aligned width (hidden 128,
4 heads of 32, 17 tokens): the dynamic route (every projection quantizes its
input by rows), the forced epilogue route (``attn_impl="pallas"``: ln2 -> fc1
through the LayerNorm quantizing epilogue, JAX with ``_on_tpu`` patched True
so that its Pallas ``ln_quant`` runs interpreted) and the fused route (the
port's ``on_card`` patched True in ``models/clip_vit`` as JAX's ``_on_tpu``
is: token axis padded to 64, ln1 -> one int8 qkv GEMM -> the direct attention,
every wrapper on its plain version because the tensors lie on the CPU).
Neither side is exact: the two sum LayerNorm's mean and variance in other
orders, a value next to a rounding boundary takes the neighbouring int8 code,
and one flipped code moves a projection's output by amax/127 * |w| ~ 4/127 *
0.02 ~ 6e-4 per column. At this size no code flips (features of magnitude up
to 3.8 differ by 4.8e-7 on all three routes); W8A8_TOL allows for three
flipped codes, should another platform's sums fall differently."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_reward_tpu.core.config import phi3v_tiny_config
from llava_reward_tpu.models import clip_vit as jclip
from llava_reward_tpu.models import phi3 as jphi3
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.preprocess.phi3v_processor import build_img_gather_idx
from llava_reward_tpu.core.config import VisionConfig as JVisionConfig
from llava_reward_tpu.utils import quantize as jq
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.io.convert import to_torch
from llava_reward_torch.ops import flash_attention as tfa
from llava_reward_torch.ops import int8_matmul as tim
from llava_reward_torch.ops import quant_epilogue as tqe
from llava_reward_torch.models import clip_vit as tclip
from llava_reward_torch.models import phi3 as tphi3
from llava_reward_torch.models import phi3v as tphi3v

TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    jcfg = phi3v_tiny_config()
    tcfg = tconfig.phi3v_tiny_config()
    params = jax.tree_util.tree_map(np.asarray, jphi3v.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, params, to_torch(params, device="cpu")


def _close(t, j, mask=None):
    t, j = t.numpy(), np.asarray(j)
    if mask is not None:
        t, j = t[mask], j[mask]
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


def test_clip_patch_features_match_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    pix = np.random.default_rng(0).uniform(-1, 1, (2, 336, 336, 3)).astype(np.float32)
    j = jclip.extract_patch_features(
        jax.tree_util.tree_map(jnp.asarray, jp["vision"]["clip"]), jcfg.vision, jnp.asarray(pix)
    )
    t = tclip.extract_patch_features(tp["vision"]["clip"], tcfg.vision, torch.from_numpy(pix))
    assert tuple(t.shape) == (2, jcfg.vision.num_patches, jcfg.vision.hidden_size)
    _close(t, j)


@pytest.mark.parametrize("collect", [None, 1], ids=["last", "collect_layer1"])
def test_phi3_decoder_matches_jax(tiny, collect):
    jcfg, tcfg, jp, tp = tiny
    B, S, H = 2, 40, jcfg.decoder.hidden_size
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((B, S, H)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :11] = 0
    pos = np.where(mask == 0, 1, np.cumsum(mask, -1) - 1).astype(np.int32)
    j = jphi3.forward(jax.tree_util.tree_map(jnp.asarray, jp["decoder"]), jcfg.decoder,
                      jnp.asarray(emb), jnp.asarray(mask), jnp.asarray(pos),
                      collect_layer_id=collect)
    t = tphi3.forward(tp["decoder"], tcfg.decoder, torch.from_numpy(emb),
                      torch.from_numpy(mask), torch.from_numpy(pos), collect_layer_id=collect)
    valid = mask.astype(bool)
    _close(t.last_hidden_state, j.last_hidden_state, valid)
    if collect is None:
        assert t.collected_hidden_state is None and j.collected_hidden_state is None
    else:
        _close(t.collected_hidden_state, j.collected_hidden_state, valid)


def test_phi3v_forward_matches_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    B, S = 2, 352
    n_img = 313  # 1x1 crop grid
    rng = np.random.default_rng(2)
    gidx = np.tile(build_img_gather_idx(1, 1, jcfg.num_crops, budget=n_img)[None], (B, 1))
    mask = np.ones((B, S), np.int32)
    splice = np.full((B, S), -1, np.int32)
    for i, pad in enumerate((0, 20)):
        mask[i, :pad] = 0
        splice[i, pad + 1 : pad + 1 + n_img] = np.arange(n_img)
    ids = rng.integers(2, jcfg.decoder.vocab_size - 2, (B, S)).astype(np.int32)
    pos = np.where(mask == 0, 1, np.cumsum(mask, -1) - 1).astype(np.int32)
    pix = rng.uniform(-1, 1, (B, jcfg.num_crops + 1, 336, 336, 3)).astype(np.float32)
    nimg = np.array([n_img, n_img - 100], np.int32)
    args = (ids, mask, pos, pix, gidx, splice, nimg)
    j = jphi3v.forward(jax.tree_util.tree_map(jnp.asarray, jp), jcfg,
                       *map(jnp.asarray, args), collect_layer_id=1)
    t = tphi3v.forward(tp, tcfg, *map(torch.from_numpy, args), collect_layer_id=1)
    valid = mask.astype(bool)
    _close(t.last_hidden_state, j.last_hidden_state, valid)
    _close(t.collected_hidden_state, j.collected_hidden_state, valid)
    _close(t.vision_embedding, j.vision_embedding)


W8A8_TOL = 2e-3
W8A8_ROUTES = {
    # name: (port attn_impl, JAX attn_impl, patch the "on the device" gates)
    "dynamic": ("auto", "xla", False),
    "epilogue": ("pallas", "xla", True),
    "fused": ("pallas", "pallas", True),
}
_VISION_KW = dict(hidden_size=128, intermediate_size=256, num_layers=3, num_heads=4,
                  image_size=32, patch_size=8)


@pytest.mark.parametrize("route", sorted(W8A8_ROUTES))
def test_w8a8_clip_tower_matches_jax(route, monkeypatch):
    timpl, jimpl, patch = W8A8_ROUTES[route]
    jcfg, tcfg = JVisionConfig(**_VISION_KW), tconfig.VisionConfig(**_VISION_KW)
    params = jax.tree_util.tree_map(
        np.asarray, jclip.init_params(jax.random.PRNGKey(3), jcfg, jnp.float32))
    params["layers"] = jq.quantize_stacked_layers(params["layers"], scheme="w8a8", min_size=0)
    assert jq.is_w8a8(params["layers"]["attn"]["q"]["kernel"])
    pix = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    if patch:
        monkeypatch.setattr(jclip, "_on_tpu", lambda: True)
    j = jclip.extract_patch_features(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                                     jnp.asarray(pix), attn_impl=jimpl)
    if route == "fused":
        monkeypatch.setattr(tclip, "on_card", lambda t: True)
    for mod in (tqe, tim, tfa):
        mod.reset_counters()
    t = tclip.extract_patch_features(to_torch(params, device="cpu"), tcfg, torch.from_numpy(pix),
                                     attn_impl=timpl)
    L = jcfg.num_active_layers
    want = {"dynamic": dict(ln_quant=0, row_quant=6 * L, int8_matmul=6 * L, fa_direct=0),
            "epilogue": dict(ln_quant=L, row_quant=5 * L, int8_matmul=6 * L, fa_direct=0),
            "fused": dict(ln_quant=2 * L, row_quant=2 * L, int8_matmul=4 * L, fa_direct=L)}[route]
    got = {"ln_quant": tqe.PLAIN_CALLS["ln_quant"], "row_quant": tqe.PLAIN_CALLS["row_quant"],
           "int8_matmul": tim.PLAIN_CALLS["int8_matmul"],
           "fa_direct": tfa.PLAIN_CALLS["fa_direct"]}
    assert got == want
    assert not any(v for mod in (tqe, tim, tfa) for v in mod.LAUNCHES.values())
    assert tuple(t.shape) == (2, jcfg.num_patches, jcfg.hidden_size)
    gap = np.abs(t.numpy() - np.asarray(j)).max()
    assert gap <= W8A8_TOL, gap


def test_w8a8_clip_tower_under_lora_stays_off_the_epilogue():
    """A vision LoRA tree turns the quantizing LayerNorm off (the adapters
    read the normalised activations), as ``clip_vit.py:126-131``; the W8A8
    leaves then quantize their input dynamically and gradients reach the
    adapters through the straight-through int8 matmul."""
    from llava_reward_torch.lora.lora import init_vision_lora
    from llava_reward_torch.utils import quantize as tq

    tcfg = tconfig.VisionConfig(**_VISION_KW)
    params = tclip.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    params["layers"] = tq.quantize_stacked_layers(params["layers"], scheme="w8a8", min_size=0)
    lora = init_vision_lora(tcfg, 4, 8.0, torch.Generator().manual_seed(1), device="cpu")
    for t in lora.values():
        t["b"].normal_(0, 0.02, generator=torch.Generator().manual_seed(2))
        t["a"].requires_grad_()
    tqe.reset_counters()
    pix = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    out = tclip.extract_patch_features(params, tcfg, pix, attn_impl="pallas", lora=lora)
    assert tqe.PLAIN_CALLS["ln_quant"] == 0 and tqe.PLAIN_CALLS["row_quant"] > 0
    out.square().sum().backward()
    assert all(bool(torch.isfinite(t["a"].grad).all()) and bool(t["a"].grad.any())
               for t in lora.values())
