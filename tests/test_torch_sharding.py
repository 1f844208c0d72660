"""The port's mesh and sharding rules against the JAX package's, in one
process with no process group (``llava_reward_torch/parallel/sharding.py``,
``core/mesh.py``).

- ``param_specs`` equals JAX's ``param_specs`` leaf for leaf on the tiny
  phi3v, qwen and llava trees: backbones, heads with SkipCA and the prompt
  head, decoder and vision LoRA, the projector, and W8A8 and NF4 decoders;
- on the meshes (1, 8, 1), (2, 4, 1), (4, 2, 1) and the hybrid (2, 4, 1)
  over 8 ranks, each rank's block of every leaf is exactly what JAX's
  ``NamedSharding(mesh, _divisible_spec(...))`` places on the device at
  that rank's mesh position: same shape (``shard_shape``) and same
  elements (``devices_indices_map``); W8A8 leaves stay whole and K-major;
- ``mesh_from_args`` gives JAX's mesh for ``--zero_stage 0``, ``--zpg 4``
  and the defaults at 8 ways, ``create_mesh`` refuses a mesh that does not
  match the world as JAX's does, and ``shard_batch`` takes JAX's rows.

JAX twins: tests/test_train_and_sharding.py, test_multifamily_sharding.py.
"""

import argparse

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from llava_reward_tpu.core import mesh as jmesh
from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.core.config import llava_tiny_config, phi3v_tiny_config, qwen_tiny_config
from llava_reward_tpu.lora import lora as jlora
from llava_reward_tpu.models import llava_next as jllava
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.models import qwen25_vl as jqwen
from llava_reward_tpu.parallel import sharding as js
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_tpu.utils.quantize import quantize_stacked_layers as j_quantize
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.core import mesh as tmesh
from llava_reward_torch.io.convert import to_torch
from llava_reward_torch.parallel import sharding as ts
from llava_reward_torch.reward.model import RewardBatch as TBatch
from llava_reward_torch.utils import quantize as tquant

MESHES = {"1x8x1": (1, 8, 1), "2x4x1": (2, 4, 1), "4x2x1": (4, 2, 1), "hybrid2x4x1": (2, 4, 1)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trees():
    """JAX-built trees (numpy) of every family and trainable kind."""
    out = {}
    pc = phi3v_tiny_config(num_crops=1)
    rc = JRewardConfig(is_general_preference=True, value_head_dim=4, add_cross_attention=True,
                       add_prompt_head=True, layer_id=2)
    pb = _np(jphi3v.init_params(jax.random.PRNGKey(0), pc))
    out["phi3v"] = {
        "backbone": pb,
        "head": _np(j_init_head(jax.random.PRNGKey(1), pc, rc)),
        "lora": _np(jlora.init_lora(jax.random.PRNGKey(2), pc.decoder, 4, 8)),
        "vision_lora": _np(jlora.init_vision_lora(jax.random.PRNGKey(3), pc.vision, 4, 8)),
        "projector": pb["vision"]["img_projection"],
    }
    for scheme in ("w8a8", "nf4"):
        q = dict(pb, decoder=dict(pb["decoder"]))
        q["decoder"]["layers"] = _np(j_quantize(pb["decoder"]["layers"], bits=4, min_size=0,
                                                scheme=scheme))
        out[f"phi3v_{scheme}"] = {"backbone": q}
    qc = qwen_tiny_config(num_layers=2, vision_depth=2)
    qb = _np(jqwen.init_params(jax.random.PRNGKey(4), qc))
    out["qwen"] = {
        "backbone": qb,
        "head": _np(j_init_head(jax.random.PRNGKey(5), qc, JRewardConfig(
            is_general_preference=True, value_head_dim=2, add_cross_attention=True))),
        "lora": _np(jlora.init_lora(jax.random.PRNGKey(6), qc.text, 4, 8,
                                    targets=jlora.QWEN_TARGETS)),
        "projector": qb["visual"]["merger"],
    }
    qq = dict(qb, text=dict(qb["text"]))
    qq["text"]["layers"] = _np(j_quantize(qb["text"]["layers"], bits=4, min_size=0,
                                          scheme="w8a8"))
    out["qwen_w8a8"] = {"backbone": qq}
    lc = llava_tiny_config(num_layers=2, vision_layers=2)
    lb = _np(jllava.init_params(jax.random.PRNGKey(7), lc))
    out["llava"] = {
        "backbone": lb,
        "head": _np(j_init_head(jax.random.PRNGKey(8), lc, JRewardConfig(
            is_general_preference=True, value_head_dim=2))),
        "lora": _np(jlora.init_lora(jax.random.PRNGKey(9), lc.text, 4, 8,
                                    targets=jlora.QWEN_TARGETS)),
        "projector": lb["vision"]["projector"],
    }
    return out


@pytest.fixture(scope="module")
def trees():
    return {k: (v, to_torch(v, "cpu")) for k, v in _trees().items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _jflat(tree):
    """{'a/b': leaf} of a JAX tree, with the package's own path strings."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)[0]
    return {js._path_str(p): leaf for p, leaf in flat if leaf is not None}


FAMILIES = ["phi3v", "phi3v_w8a8", "phi3v_nf4", "qwen", "qwen_w8a8", "llava"]


@pytest.mark.parametrize("name", FAMILIES)
def test_param_specs_equal_the_jax_rules(trees, name):
    jtree, ttree = trees[name]
    jspecs = _jflat(js.param_specs(jtree))
    tspecs = _flat(ts.param_specs(ttree))
    assert set(jspecs) == set(tspecs)
    assert {p: tuple(s) for p, s in jspecs.items()} == tspecs
    # the rules do reach every family's big stacked leaves
    assert any("fsdp" in s for s in tspecs.values())


def _jax_mesh(key, dp, fsdp, tp):
    if key.startswith("hybrid"):
        return js.create_hybrid_mesh(dp_dcn=dp, fsdp_ici=fsdp, tp=tp)
    return js.create_mesh(dp=dp, fsdp=fsdp, tp=tp)


def _port_mesh(key, dp, fsdp, tp, rank):
    make = ts.create_hybrid_mesh if key.startswith("hybrid") else ts.create_mesh
    return make(dp, fsdp, tp, world_size=8, rank=rank)


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("name", ["phi3v", "phi3v_w8a8", "qwen", "llava"])
def test_each_rank_holds_the_jax_shard(trees, name, mesh_key):
    """Every rank's block of every leaf is the JAX sharding's block on the
    device at that rank's mesh position."""
    dp, fsdp, tp = MESHES[mesh_key]
    jm = _jax_mesh(mesh_key, dp, fsdp, tp)
    jtree, ttree = trees[name]
    jleaves = _jflat(jtree)
    jspecs = _jflat(js.param_specs(jtree))
    devices = list(jm.devices.flat)
    for rank in range(8):
        tm = _port_mesh(mesh_key, dp, fsdp, tp, rank)
        local = _flat(ts.shard_params(ttree, tm))
        for path, leaf in jleaves.items():
            sharding = NamedSharding(jm, js._divisible_spec(jspecs[path], leaf, jm))
            got = local[path]
            block = got.local if isinstance(got, ts.Sharded) else got
            assert tuple(block.shape) == sharding.shard_shape(leaf.shape), path
            want = np.asarray(leaf)[sharding.devices_indices_map(leaf.shape)[devices[rank]]]
            np.testing.assert_array_equal(block.detach().numpy(), want, err_msg=path)
            if isinstance(got, ts.Sharded):
                assert block.is_contiguous(), path


def test_w8a8_leaves_stay_whole_and_k_major(trees):
    """A quantized decoder under fsdp: the W8A8 codes and scales are the
    very tensors given (replicated), codes K-major (strides (1, in))."""
    _, ttree = trees["phi3v_w8a8"]
    tm = ts.create_mesh(1, 8, 1, world_size=8, rank=5)
    sharded = ts.shard_params(ttree, tm)
    for name in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"):
        before = ttree["backbone"]["decoder"]["layers"][name]
        after = sharded["backbone"]["decoder"]["layers"][name]
        assert after["qvalues_w8a8"] is before["qvalues_w8a8"]
        assert after["scale"] is before["scale"]
        codes = after["qvalues_w8a8"]
        assert codes.stride()[1:] == (1, codes.shape[1]), name
    # the float leaves beside them still shard
    assert isinstance(sharded["backbone"]["decoder"]["embed_tokens"], ts.Sharded)


@pytest.mark.parametrize("flags", [
    {"zero_stage": 0}, {"zero_stage": 3, "zpg": 4}, {}, {"mesh_dp": 2}, {"mesh_dp": 2,
                                                                        "mesh_fsdp": 4}],
    ids=["zero_stage0", "zpg4", "defaults", "dp2", "dp2xfsdp4"])
def test_mesh_from_args_matches_jax_at_eight_ways(flags):
    args = argparse.Namespace(**flags)
    j = jmesh.mesh_from_args(args)
    for rank in (0, 3, 7):
        t = tmesh.mesh_from_args(args, world=8, rank=rank)
        assert t.shape == dict(j.shape)
        pos = np.argwhere(np.vectorize(lambda d: d.id)(j.devices) == jax.devices()[rank].id)[0]
        assert [t.coords[a] for a in ts.AXES] == pos.tolist()


@pytest.mark.parametrize("dp, fsdp", [(3, 2), (2, 2), (3, -1)])
def test_mesh_that_does_not_match_the_world_raises(dp, fsdp):
    with pytest.raises(AssertionError):
        js.create_mesh(dp=dp, fsdp=fsdp, tp=1)
    with pytest.raises(ValueError, match=f"mesh {dp}x{fsdp}x1"):
        ts.create_mesh(dp=dp, fsdp=fsdp, tp=1, world_size=8, rank=0)


def test_tensor_parallel_leaves_are_refused():
    """A tp that does not divide the heads, kv heads or MLP widths is refused
    with the widths named (XLA would split any width that divides: ROADMAP
    §C); so is a tp mesh with no config to place the fused blocks, and an NF4
    decoder whose rank's rows of a row-split projection are not whole 64-row
    blocks (§C: JAX keeps 4-bit leaves whole on every rank). A W8A8 leaf on
    that mesh places its blocks."""
    tree = {"embed_tokens": torch.zeros(8, 8)}
    tm = ts.create_mesh(1, 1, 8, world_size=8, rank=0)
    qwen = tconfig.qwen_tiny_config(num_layers=2, vision_depth=2)  # 4 heads, 2 kv heads
    with pytest.raises(ValueError, match=r"tp 8 does not divide .*'decoder heads': 4"):
        ts.shard_params(tree, tm, tconfig.phi3v_tiny_config(num_crops=1))
    with pytest.raises(ValueError, match=r"tp 4 does not divide \{'decoder kv heads': 2\}"):
        ts.shard_params(tree, ts.create_mesh(1, 2, 4, world_size=8, rank=0), qwen)
    with pytest.raises(ValueError, match="config"):
        ts.shard_params(tree, ts.create_mesh(1, 4, 2, world_size=8, rank=0))
    tq = ts.create_mesh(1, 4, 2, world_size=8, rank=1)
    nf4 = {"layers": {"o_proj": tquant.quantize_stacked_layers(
        {"k": torch.ones(2, 64, 64)}, bits=4, min_size=0, scheme="nf4")["k"]}}
    with pytest.raises(ValueError, match=r"tp 2 leaves each rank .*'decoder o_proj in': 32.* "
                                         r"nf4 .*64-row NF4 block"):
        ts.shard_params(nf4, tq, qwen)
    w8 = {"layers": {"o_proj": tquant.quantize_stacked_layers(
        {"k": torch.ones(2, 64, 64)}, min_size=0, scheme="w8a8")["k"]}}
    codes = ts.shard_params(w8, tq, qwen)["layers"]["o_proj"]["qvalues_w8a8"]
    assert isinstance(codes, ts.Sharded) and codes.dims == {"tp": 1}
    assert codes.local.shape == (2, 32, 64) and codes.local.mT.is_contiguous()


@pytest.mark.parametrize("mesh_key", ["2x4x1", "4x2x1"])
def test_shard_batch_takes_the_jax_rows(mesh_key):
    """Each data rank's rows (axis 1 for M-RoPE position ids) are the block
    JAX's batch sharding places on the device at that rank's position."""
    dp, fsdp, tp = MESHES[mesh_key]
    jm = js.create_mesh(dp=dp, fsdp=fsdp, tp=tp)
    rng = np.random.default_rng(0)
    fields = {"input_ids": rng.integers(0, 9, (8, 5)).astype(np.int32),
              "attention_mask": np.ones((8, 5), np.int32),
              "position_ids": rng.integers(0, 9, (3, 8, 5)).astype(np.int32)}
    jb = {k: jax.device_put(v, js._field_batch_sharding(jm, k, v)) for k, v in fields.items()}
    devices = list(jm.devices.flat)
    for rank in range(8):
        tb = ts.shard_batch(TBatch(pixel_values=None, img_gather_idx=None, splice_idx=None,
                                   num_img_tokens=None,
                                   **{k: torch.from_numpy(v) for k, v in fields.items()}),
                            ts.create_mesh(dp, fsdp, tp, world_size=8, rank=rank))
        for k, arr in jb.items():
            want = next(s.data for s in arr.addressable_shards if s.device == devices[rank])
            np.testing.assert_array_equal(getattr(tb, k).numpy(), np.asarray(want), err_msg=k)
        assert tb.pixel_values is None
