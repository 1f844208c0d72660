"""The port's single-chip compile check, ``llava_reward_torch.dryrun.entry``,
against ``__graft_entry__.entry``.

- The example trees and batch equal JAX's leaf for leaf in path, shape and
  dtype: JAX's through ``jax.eval_shape`` of its ``entry()``, the port's on
  the meta device, so neither full-width bf16 tree (~0.8 GB) is allocated.
- Both entries' forwards, at the tiny phi3v config under the same cuts (2
  decoder layers, 2 CLIP layers, 4 crops) and in fp32, on one tree carried
  across by ``io/convert.py``, give rewards within PARITY.md's 2.03e-05.
- ``python -m llava_reward_torch.dryrun entry --device cpu --tiny`` exits 0
  with a finite reward and a ``kernel launches`` line; ``--device cuda``
  without a card raises.
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from llava_reward_tpu.core import config as jconfig
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.reward import init_head_params as j_init_head
from llava_reward_tpu.reward.model import reward_forward as j_reward_forward
from llava_reward_torch import dryrun
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.io.convert import to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY_BAR = 2.03e-05  # PARITY.md: max reward gap in f32


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif tree is not None:
        yield "/".join(prefix), tree


def _batch_fields(batch):
    return {k: v for k, v in batch._asdict().items() if v is not None}


def _spec(x):
    """(shape, dtype name) of a JAX ShapeDtypeStruct or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), np.dtype(x.dtype).name


@pytest.fixture(scope="module")
def example_specs():
    jparams, jbatch = jax.eval_shape(lambda: graft.entry()[1])
    _, (tparams, tbatch) = dryrun.entry("meta")
    return jparams, jbatch, tparams, tbatch


def test_entry_trees_match_jax_in_path_shape_and_dtype(example_specs):
    jparams, _, tparams, _ = example_specs
    want = {p: _spec(x) for p, x in _leaves(jparams)}
    got = {p: _spec(x) for p, x in _leaves(tparams)}
    assert got.keys() == want.keys()
    for p in want:
        assert got[p] == want[p], p
    assert all(d == "bfloat16" for _, d in want.values())
    assert all(x.is_meta for _, x in _leaves(tparams))  # shapes only


def test_entry_batch_matches_jax_in_field_shape_and_dtype(example_specs):
    _, jbatch, _, tbatch = example_specs
    want = {k: _spec(v) for k, v in _batch_fields(jbatch).items()}
    got = {k: _spec(v) for k, v in _batch_fields(tbatch).items()}
    assert got == want
    assert want["input_ids"] == ((1, 512), "int32")
    assert want["pixel_values"] == ((1, 5, 336, 336, 3), "float32")


def test_entry_config_is_the_jax_entrys_cut():
    cfg, rcfg = dryrun.entry_config()
    full = tconfig.phi35_vision_config()
    assert (cfg.decoder.num_layers, cfg.vision.num_layers, cfg.num_crops) == (2, 2, 4)
    assert cfg.decoder.hidden_size == full.decoder.hidden_size == 3072
    assert cfg.vision.hidden_size == full.vision.hidden_size
    assert (rcfg.is_general_preference, rcfg.value_head_dim, rcfg.add_cross_attention,
            rcfg.layer_id) == (True, 2, True, 2)


def test_entry_forward_matches_jax_at_the_tiny_config():
    base = jconfig.phi3v_tiny_config()
    cfg = jconfig.replace(base, decoder=jconfig.replace(base.decoder, num_layers=2),
                          vision=jconfig.replace(base.vision, num_layers=2), num_crops=4)
    rcfg = jconfig.RewardConfig(is_general_preference=True, value_head_dim=2,
                                add_cross_attention=True, layer_id=cfg.decoder.num_layers)
    jparams = {"backbone": jphi3v.init_params(jax.random.PRNGKey(0), cfg),
               "head": j_init_head(jax.random.PRNGKey(1), cfg, rcfg)}
    jbatch = graft._tiny_image_batch(cfg, np.random.default_rng(0), batch=1, seq_len=512)
    want = np.asarray(j_reward_forward(jparams, cfg, rcfg, jbatch, training=False).reward)

    fn, (_, tbatch) = dryrun.entry("cpu", tconfig.phi3v_tiny_config(), torch.float32)
    for k, v in _batch_fields(jbatch).items():  # the same row from the same seed
        np.testing.assert_array_equal(getattr(tbatch, k).numpy(), np.asarray(v), err_msg=k)
    params = to_torch(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    with torch.no_grad():
        got = fn(params, tbatch).numpy()
    assert got.shape == want.shape == (1, 2)
    assert np.abs(got - want).max() <= PARITY_BAR


def _dryrun_entry(*args):
    return subprocess.run([sys.executable, "-m", "llava_reward_torch.dryrun", "entry", *args],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), text=True,
                          capture_output=True, timeout=120)


def test_dryrun_entry_command_scores_on_the_cpu():
    r = _dryrun_entry("--device", "cpu", "--tiny")
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("entry: reward "))
    rewards = json.loads(line[len("entry: reward "):].split("]")[0] + "]")
    assert len(rewards) == 2 and all(math.isfinite(v) for v in rewards)
    assert "finite True" in line
    launches = json.loads(next(ln for ln in r.stdout.splitlines()
                               if ln.startswith("kernel launches "))[len("kernel launches "):])
    assert set(dryrun.ENTRY_KERNELS) <= launches.keys()
    assert not any(launches.values())  # the CPU runs the plain versions


def test_dryrun_entry_command_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _dryrun_entry()
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
