"""Weights carried across: the JAX package's param trees -> the port's
tensors -> numpy, bit for bit (same keys, shapes, stacking and dtypes)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from llava_reward_tpu.core.config import RewardConfig, phi3v_tiny_config
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_torch.io.convert import to_numpy, to_torch


def _jax_tree(dtype):
    cfg = phi3v_tiny_config()
    rcfg = RewardConfig(is_general_preference=True, value_head_dim=2, add_cross_attention=True)
    tree = {
        "backbone": jphi3v.init_params(jax.random.PRNGKey(0), cfg, dtype),
        "head": j_init_head(jax.random.PRNGKey(1), cfg, rcfg, dtype),
    }
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_tree_round_trip_is_bit_exact(dtype):
    ref = _jax_tree(dtype)
    tt = to_torch(ref, device="cpu")
    back = _flat(to_numpy(tt))
    flat = _flat(ref)
    assert back.keys() == flat.keys()
    for k, a in flat.items():
        b = back[k]
        assert b.dtype == a.dtype and b.shape == a.shape, k
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


def test_port_tree_keeps_stacking():
    cfg = phi3v_tiny_config()
    tt = to_torch(_jax_tree(jnp.float32), device="cpu")
    layers = tt["backbone"]["decoder"]["layers"]
    assert tuple(layers["qkv_proj"].shape) == (
        cfg.decoder.num_layers, cfg.decoder.hidden_size, 3 * cfg.decoder.hidden_size
    )
    clip = tt["backbone"]["vision"]["clip"]["layers"]
    assert tuple(clip["attn"]["q"]["kernel"].shape[:1]) == (cfg.vision.num_layers,)
    assert tuple(tt["head"]["value_head"]["kernel"].shape) == (cfg.decoder.hidden_size, 2)
