"""The port's trainer and checkpoint contract against the JAX package's, on
the CPU, at a tiny text-only config.

- ``RewardTrainer.fit`` over a list loader writes an artifact that the JAX
  package's ``load_head_params``, ``peft_state_to_stacked`` and
  ``load_reward_config`` read back equal to the trained tree (rounded to
  the artifact's bf16, so bit for bit); an artifact written by the JAX
  package (heads, SkipCA, prompt head, projector, LoRA) loads into the port
  equal to it.
- the same both ways for a Qwen2.5-VL artifact: ``QWEN_TARGETS`` adapters, the
  merger's five ``visual.merger.*`` keys (``--ft_projector``), read by the JAX
  package's ``load_qwen_merger_params``, and ``merge_for_scoring`` of the read
  back artifact scores like the trained tree.
- ``reward_config.yaml``, written and read by hand (no PyYAML on the card),
  round-trips through ``yaml.safe_load`` / ``yaml.safe_dump`` both ways.
- ``save_train_ckpt`` then a new trainer's ``load_train_ckpt`` + ``fit``
  continues the same loss trajectory (same process, same ops: exact).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from llava_reward_tpu.core.config import RewardConfig as JRewardConfig
from llava_reward_tpu.core.config import phi3v_tiny_config, qwen_tiny_config
from llava_reward_tpu.io import artifact as jart
from llava_reward_tpu.io.torch_io import load_torch_state_dict
from llava_reward_tpu.lora import lora as jlora
from llava_reward_tpu.models import phi3v as jphi3v
from llava_reward_tpu.models import qwen25_vl as jqwen
from llava_reward_tpu.reward.model import init_head_params as j_init_head
from llava_reward_torch.core import config as tconfig
from llava_reward_torch.io import artifact as tart
from llava_reward_torch.io.convert import to_torch
from llava_reward_torch.lora import lora as tlora
from llava_reward_torch.train import optim as toptim
from llava_reward_torch.train import train_step as tts
from llava_reward_torch.train.trainer import RewardTrainer

S = 32
RCFG = dict(is_general_preference=True, value_head_dim=4, add_cross_attention=True,
            add_prompt_head=True, general_preference_tau=0.1)


def _bf16(x) -> np.ndarray:
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16).float().numpy()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg = phi3v_tiny_config(num_layers=2)
    tcfg = tconfig.phi3v_tiny_config(num_layers=2)
    kw = dict(RCFG, layer_id=jcfg.decoder.num_layers)
    jr, tr = JRewardConfig(**kw), tconfig.RewardConfig(**kw)
    backbone = _np(jphi3v.init_params(jax.random.PRNGKey(0), jcfg))
    head = _np(j_init_head(jax.random.PRNGKey(1), jcfg, jr))
    lora = _np(jlora.init_lora(jax.random.PRNGKey(2), jcfg.decoder, 4, 8))
    return jcfg, tcfg, jr, tr, backbone, head, lora


def _loader(cfg, n, seed=0):
    rng = np.random.default_rng(seed)

    def side(pad):
        ids = rng.integers(2, cfg.decoder.vocab_size - 2, (1, S)).astype(np.int32)
        mask = np.ones((1, S), np.int32)
        mask[0, :pad] = 0
        return {"input_ids": ids, "attention_mask": mask, "pixel_values": None,
                "splice_idx": np.full((1, S), -1, np.int32), "num_img_tokens": None}

    return [(side(0), side(5), np.array([1.0]), np.array([0.0])) for _ in range(n)]


def _trainer(tiny, tmp_path, loader, recorder=None, **kw):
    jcfg, tcfg, jr, tr, backbone, head, lora = tiny
    base = tts.make_pairwise_loss_fn(tcfg, tr, remat=False)

    def loss_fn(*args):
        loss, metrics = base(*args)
        if recorder is not None:
            recorder.append(loss.item())
        return loss, metrics

    trainable = to_torch({"head": head, "lora": lora}, "cpu")
    return RewardTrainer(
        cfg=tcfg, rcfg=tr, frozen={"backbone": to_torch(backbone, "cpu")}, trainable=trainable,
        tx=toptim.make_optimizer(1e-2, 10, warmup_ratio=0.0), loss_fn=loss_fn,
        train_loader=loader, save_path=str(tmp_path / "out"), lora_rank=4, lora_alpha=8,
        device="cpu", **kw)


def test_fit_writes_an_artifact_the_jax_package_reads(tiny, tmp_path):
    jcfg, tcfg, jr, tr, *_ = tiny
    trainer = _trainer(tiny, tmp_path, _loader(jcfg, 2))
    state = trainer.fit()
    assert state.step == 2 and trainer.last_train_logs["global_step"] == 2
    path = str(tmp_path / "out" / "epoch_0")
    assert tart.check_artifact_keys(path) == [] and jart.check_artifact_keys(path) == []

    head = jart.load_head_params(path, jr)
    for name, leaf_path in (("value_head", ("value_head", "kernel")),
                            ("prompt_head", ("prompt_head", "kernel")),
                            ("W_q", ("skipca", "W_q", "kernel")),
                            ("ca_layernorm", ("skipca", "ca_layernorm", "weight"))):
        j, t = head, state.trainable["head"]
        for k in leaf_path:
            j, t = j[k], t[k]
        np.testing.assert_array_equal(j, _bf16(t.detach()), err_msg=name)

    sd = load_torch_state_dict(os.path.join(path, "lora", "adapter_model.bin"))
    back = jlora.peft_state_to_stacked(sd, jcfg.decoder, 8, 4)
    for name, t in state.trainable["lora"].items():
        np.testing.assert_array_equal(back[name]["a"], _bf16(t["a"].detach()))
        np.testing.assert_array_equal(back[name]["b"], _bf16(t["b"].detach()))
    with open(os.path.join(path, "lora", "adapter_config.json")) as f:
        assert json.load(f) == jlora.peft_adapter_config(4, 8, 0.05)
    assert jart.load_reward_config(path).to_contract_dict() == tr.to_contract_dict()


def test_jax_artifact_loads_into_the_port(tiny, tmp_path):
    jcfg, tcfg, jr, tr, backbone, head, lora = tiny
    proj = backbone["vision"]["img_projection"]
    path = str(tmp_path / "jax")
    jart.save_reward_artifact(path, jr, head, projector_params=proj,
                              lora_state=jlora.stacked_to_peft_state(lora, jcfg.decoder),
                              lora_config=jlora.peft_adapter_config(4, 8, 0.05))
    t_head = tart.load_head_params(path, tr, device="cpu")
    for (jp, j), (tp, t) in zip(jax.tree_util.tree_flatten_with_path(head)[0],
                                jax.tree_util.tree_flatten_with_path(t_head)[0]):
        assert str(jp) == str(tp)
        np.testing.assert_array_equal(t.numpy(), _bf16(j))
    t_proj = tart.load_projector_params(path, device="cpu")
    for fc in ("fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(t_proj[fc][leaf].numpy(), _bf16(proj[fc][leaf]))
    sd = torch.load(os.path.join(path, "lora", "adapter_model.bin"), weights_only=True)
    t_lora = tlora.peft_state_to_stacked(sd, tcfg.decoder, 8, 4, device="cpu")
    for name in lora:
        np.testing.assert_array_equal(t_lora[name]["a"].numpy(), _bf16(lora[name]["a"]))
    assert tart.load_reward_config(path).to_contract_dict() == jr.to_contract_dict()


@pytest.mark.parametrize("tau", [0.1, 1.0, 1e-05, 2.5e20])
def test_reward_config_yaml_round_trips_with_pyyaml(tmp_path, tau):
    rc = tconfig.RewardConfig(is_general_preference=True, add_cross_attention=False,
                              value_head_dim=6, general_preference_tau=tau)
    tart.save_reward_config(str(tmp_path), rc)
    with open(tmp_path / "reward_config.yaml") as f:
        assert yaml.safe_load(f) == rc.to_contract_dict()
    with open(tmp_path / "reward_config.yaml", "w") as f:
        yaml.safe_dump(rc.to_contract_dict(), f)
    assert tart.load_reward_config(str(tmp_path)).to_contract_dict() == rc.to_contract_dict()


def test_resume_continues_the_loss_trajectory(tiny, tmp_path):
    jcfg = tiny[0]
    loader = _loader(jcfg, 3, seed=1)
    full = []
    a = _trainer(tiny, tmp_path, loader, recorder=full, ckpt_path=str(tmp_path / "ck"),
                 ckpt_steps=2)
    a.fit()
    assert len(full) == 3
    resumed = []
    b = _trainer(tiny, tmp_path, loader, recorder=resumed)
    b.load_train_ckpt(str(tmp_path / "ck"))
    assert b.state.step == 2
    b.fit()
    assert resumed == full[2:]
    for x, y in zip(toptim.tree_leaves(a.state.trainable), toptim.tree_leaves(b.state.trainable)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_clean_old_checkpoints_keeps_the_newest(tiny, tmp_path):
    trainer = _trainer(tiny, tmp_path, [], max_ckpt_num=2)
    out = tmp_path / "out"
    for i in range(4):
        d = out / f"global_step{i}"
        d.mkdir(parents=True)
        os.utime(d, (i, i))
    trainer.clean_old_checkpoints()
    assert sorted(os.listdir(out)) == ["global_step2", "global_step3"]


# ------------------------------------------------------------------ Qwen2.5-VL

QWEN_RCFG = dict(is_general_preference=True, value_head_dim=2, add_cross_attention=True)


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = qwen_tiny_config(num_layers=2), tconfig.qwen_tiny_config(num_layers=2)
    kw = dict(QWEN_RCFG, layer_id=jcfg.text.num_layers)
    jr, tr = JRewardConfig(**kw), tconfig.RewardConfig(**kw)
    backbone = _np(jqwen.init_params(jax.random.PRNGKey(0), jcfg))
    head = _np(j_init_head(jax.random.PRNGKey(1), jcfg, jr))
    lora = _np(jlora.init_lora(jax.random.PRNGKey(2), jcfg.text, 4, 8,
                               targets=jlora.QWEN_TARGETS))
    return jcfg, tcfg, jr, tr, backbone, head, lora


def _qwen_loader(cfg, n, seed=0):
    """Collated qwen pairs (one 8 x 12 and one 6 x 12 patch image, the rejected
    side left-padded), as the host collator hands them to the trainer."""
    from llava_reward_torch.preprocess.collate import collate_qwen_samples
    from test_torch_qwen_model import image_sample

    rng = np.random.default_rng(seed)

    def side(grid, pad):
        units = (grid[1] // 2) * (grid[2] // 2)
        sample = image_sample(cfg, rng, grid, n_before=2, n_after=64 - 3 - units - pad)
        return collate_qwen_samples([sample], 64, cfg.text.pad_token_id, patch_budget=128,
                                    unit_budget=24)

    return [(side((1, 8, 12), 0), side((1, 6, 12), 7), np.array([1.0]), np.array([0.0]))
            for _ in range(n)]


def test_qwen_fit_writes_an_artifact_the_jax_package_reads(qwen, tmp_path):
    from llava_reward_torch.evalx.adaptor import RewardAdaptor, merge_for_scoring
    from llava_reward_torch.preprocess.collate import to_reward_batch

    jcfg, tcfg, jr, tr, backbone, head, lora = qwen
    frozen = {"backbone": to_torch(backbone, "cpu")}
    trainable = to_torch({"head": head, "lora": lora,
                          "projector": backbone["visual"]["merger"]}, "cpu")
    loader = _qwen_loader(tcfg, 2)
    loss_fn = tts.make_pairwise_loss_fn(tcfg, tr, remat=True,
                                        projector_path=tts.PROJECTOR_PATHS["qwen"])
    trainer = RewardTrainer(
        cfg=tcfg, rcfg=tr, frozen=frozen, trainable=trainable,
        tx=toptim.make_optimizer(1e-2, 10, warmup_ratio=0.0), loss_fn=loss_fn,
        train_loader=loader, eval_loader=loader[:1], save_path=str(tmp_path / "out"),
        lora_rank=4, lora_alpha=8, model_type="qwen", device="cpu")
    state = trainer.fit()
    assert state.step == 2
    assert set(trainer.evaluate()) >= {"eval_acc", "eval_mean_prob"}
    path = str(tmp_path / "out" / "epoch_0")
    assert tart.check_artifact_keys(path) == [] and jart.check_artifact_keys(path) == []
    sd = load_torch_state_dict(os.path.join(path, "pytorch_model.bin"))
    assert {k for k in sd if "merger" in k} == {
        "visual.merger.ln_q.weight", "visual.merger.mlp.0.weight", "visual.merger.mlp.0.bias",
        "visual.merger.mlp.2.weight", "visual.merger.mlp.2.bias"}

    trained = state.trainable
    merger = jart.load_qwen_merger_params(path)
    np.testing.assert_array_equal(merger["ln_q"], _bf16(trained["projector"]["ln_q"].detach()))
    for fc in ("fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(merger[fc][leaf],
                                          _bf16(trained["projector"][fc][leaf].detach()))
    assert not np.array_equal(merger["fc1"]["kernel"],
                              _bf16(backbone["visual"]["merger"]["fc1"]["kernel"]))
    adapter = load_torch_state_dict(os.path.join(path, "lora", "adapter_model.bin"))
    back = jlora.peft_state_to_stacked(adapter, jcfg.text, 8, 4, targets=jlora.QWEN_TARGETS)
    for name, t in trained["lora"].items():
        np.testing.assert_array_equal(back[name]["a"], _bf16(t["a"].detach()))
        np.testing.assert_array_equal(back[name]["b"], _bf16(t["b"].detach()))
    with open(os.path.join(path, "lora", "adapter_config.json")) as f:
        assert json.load(f) == jlora.peft_adapter_config(4, 8, 0.05, targets=jlora.QWEN_TARGETS)
    assert jart.load_reward_config(path).to_contract_dict() == tr.to_contract_dict()

    # what training wrote, read back, merged and fused, scores like the trained
    # tree with its inline adapters (up to the artifact's bf16 rounding)
    t_sd = torch.load(os.path.join(path, "lora", "adapter_model.bin"), weights_only=True)
    t_lora = tlora.peft_state_to_stacked(t_sd, tcfg.text, 8, 4, targets=tlora.QWEN_TARGETS,
                                         device="cpu")
    scored = {"backbone": merge_for_scoring(
        frozen["backbone"], "qwen", lora=t_lora,
        projector=tart.load_qwen_merger_params(path, device="cpu")),
        "head": tart.load_head_params(path, tr, device="cpu")}
    assert "qkv_proj" in scored["backbone"]["text"]["layers"]
    batch = loader[0][0]
    got = RewardAdaptor(tcfg, tr, scored, model_type="qwen", device="cpu").make_score_fn()(
        scored, to_reward_batch(batch, device="cpu"))
    params, inline, _ = tts.assemble_params(frozen, trained, tts.PROJECTOR_PATHS["qwen"])
    from llava_reward_torch.reward.model import reward_forward
    with torch.no_grad():
        want = reward_forward(params, tcfg, tr, to_reward_batch(batch, device="cpu"),
                              lora=inline).reward
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=5e-3)


def test_jax_qwen_artifact_loads_into_the_port(qwen, tmp_path):
    jcfg, tcfg, jr, tr, backbone, head, lora = qwen
    merger = backbone["visual"]["merger"]
    path = str(tmp_path / "jax_qwen")
    jart.save_reward_artifact(
        path, jr, head, projector_params=merger, model_type="qwen",
        lora_state=jlora.stacked_to_peft_state(lora, jcfg.text),
        lora_config=jlora.peft_adapter_config(4, 8, 0.05, targets=jlora.QWEN_TARGETS))
    assert tart.check_artifact_keys(path) == []
    t_merger = tart.load_qwen_merger_params(path, device="cpu")
    assert set(t_merger) == {"ln_q", "fc1", "fc2"}
    np.testing.assert_array_equal(t_merger["ln_q"].numpy(), _bf16(merger["ln_q"]))
    for fc in ("fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(t_merger[fc][leaf].numpy(), _bf16(merger[fc][leaf]))
    assert tart.load_projector_params(path, device="cpu") is None  # no img_projection keys
    sd = torch.load(os.path.join(path, "lora", "adapter_model.bin"), weights_only=True)
    t_lora = tlora.peft_state_to_stacked(sd, tcfg.text, 8, 4, targets=tlora.QWEN_TARGETS,
                                         device="cpu")
    assert set(t_lora) == set(lora)
    for name in lora:
        np.testing.assert_array_equal(t_lora[name]["a"].numpy(), _bf16(lora[name]["a"]))
    t_head = tart.load_head_params(path, tr, device="cpu")
    np.testing.assert_array_equal(t_head["value_head"]["kernel"].numpy(),
                                  _bf16(head["value_head"]["kernel"]))


def test_trainer_refuses_a_family_it_cannot_train(qwen):
    jcfg, tcfg, jr, tr, *_ = qwen
    with pytest.raises(NotImplementedError, match="gpt"):
        RewardTrainer(cfg=tcfg, rcfg=tr, frozen={}, trainable={"head": {}}, tx=toptim.make_optimizer(
            1e-3, 2), loss_fn=None, train_loader=[], model_type="gpt", device="cpu")
