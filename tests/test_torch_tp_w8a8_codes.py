"""Where a W8A8 LoRA step on two tp ranks parts from one rank's: the
activation codes of every W8A8 projection, counted per layer.

A tiny phi3v (bf16 backbone, decoder quantized W8A8, fp32 head and LoRA)
takes one ``dryrun step`` on one rank and on two tp ranks (gloo, one thread
a rank), each rank recording, at every call of the int8 linear core, its
input rows, the codes it takes and the amax it takes them on. Then:
- every projection's codes on the two tp ranks, their row-split blocks put
  together, equal one rank's codes on every row whose input is one rank's
  bit for bit: the tp-global amax of ``parallel/tensor.row`` takes the one
  device's codes, and a code flips only where its input row rounded apart
  upstream (a row-split projection's partial sums, summed over tp);
- the flips are counted per pass, layer and projection, beside the rows
  whose input differs;
- grad_norm of the tp step against the one-rank step, relative: the W8A8
  step's is within the bf16 layout's bound, 2^-6 (chip_smoke.py's
  DIST_NORM_TOL), and no larger than the same step's on the bf16 decoder;
  quantizing on one rank's recorded amax (where it holds the tp row) keeps
  it within 2^-6 too; the whole gradient's relative L2 gap (recovered from
  the updates) is smallest on one rank's amax and no larger in W8A8 than in
  bf16.
"""

import numpy as np
import pytest
import torch

from llava_reward_torch.core.config import RewardConfig, phi3v_tiny_config
from llava_reward_torch.dryrun import tiny_image_batch
from llava_reward_torch.evalx.adaptor import cast_params
from llava_reward_torch.lora.lora import init_lora
from llava_reward_torch.models import phi3v
from llava_reward_torch.reward.model import init_head_params
from llava_reward_torch.utils.quantize import quantize_stacked_layers
from test_torch_multiprocess import _launch, _one_thread_a_rank  # noqa: F401 (autouse)

DIST_NORM_TOL = 2.0 ** -6  # chip_smoke.py: the bf16 layout's grad_norm bound
CFG = dict(num_crops=1, num_layers=3)
RCFG = dict(is_general_preference=True, value_head_dim=2, add_cross_attention=True,
            layer_id=3)
PROJ = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")  # a layer's calls, in order
# a rank of ``dryrun step`` that records each int8 linear call's input rows,
# codes and amax to ``REC.<rank>``; with REPLAY, a row-split call (an amax
# given) takes its codes on the amax REPLAY recorded at the same call, or on
# its own tp-global amax where that is larger (codes past 127 would wrap)
WORKER = """
import os, sys, torch
from llava_reward_torch import dryrun
from llava_reward_torch.ops import quant_epilogue as qe
from llava_reward_torch.utils import quantize as q
spec, out, rec, replay = sys.argv[1:5]
core, log = q._Int8LinearCore, []
given = None if replay == "-" else torch.load(replay, weights_only=True)
def apply(x2, w, scale, plain, amax=None, out_dtype=None):
    if given is not None and amax is not None:
        amax = torch.maximum(given[len(log)]["amax"].to(amax), amax)
    codes, used = qe.row_quant_plain(x2.detach(), None if amax is None else amax.detach())
    log.append({"x": x2.detach().clone(), "codes": codes, "amax": used.reshape(-1, 1).clone(),
                "split": amax is not None})
    return core.apply(x2, w, scale, plain, amax, out_dtype)
q._Int8LinearCore = type("Recording", (), {"apply": staticmethod(apply)})
dryrun.main(["step", spec, out, "--device", "cpu"])
torch.save(log, f"{rec}.{os.environ.get('LRT_PROCESS_ID', '0')}")
"""


def _spec(w8a8: bool, mesh: dict) -> dict:
    cfg = phi3v_tiny_config(**CFG)
    backbone = phi3v.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    if w8a8:
        dec = backbone["decoder"]
        backbone["decoder"] = {**dec, "layers": quantize_stacked_layers(
            dec["layers"], min_size=0, scheme="w8a8")}
    lora = init_lora(cfg.decoder, 4, 8, torch.Generator().manual_seed(2), device="cpu")
    g = torch.Generator().manual_seed(3)
    for t in lora.values():
        t["b"] = torch.randn(t["b"].shape, generator=g) * 0.05
    trainable = {"head": init_head_params(cfg, RewardConfig(**RCFG),
                                          torch.Generator().manual_seed(1), device="cpu"),
                 "lora": lora, "projector": None}
    rng = np.random.default_rng(4)
    chosen, rejected = (tiny_image_batch(cfg, rng, 4, 384) for _ in range(2))
    return {"family": "phi3v", "cfg": CFG, "rcfg": RCFG, "mesh": mesh,
            "optim": dict(lr=1.0, total_steps=10, eps=1.0, warmup_ratio=0.0),
            "loss": {"remat": True}, "frozen": {"backbone": cast_params(backbone, torch.bfloat16)},
            "trainable": trainable,
            "chosen": {k: torch.from_numpy(v) for k, v in chosen.items()},
            "rejected": {k: torch.from_numpy(v) for k, v in rejected.items()}}


def _step(tmp_path, tag, w8a8, tp, replay=None):
    """-> (rank 0's output, every rank's recorded calls)."""
    n = 2 if tp else 1
    spec = tmp_path / f"{tag}.pt"
    torch.save(_spec(w8a8, {"mesh_tp": 2} if tp else {}), spec)
    out, rec = tmp_path / f"{tag}.out", tmp_path / f"{tag}.rec"
    _launch(n, ["-c", WORKER, str(spec), str(out), str(rec), str(replay or "-")])
    outs = [torch.load(f"{out}.{r}", weights_only=True) for r in range(n)]
    for o in outs[1:]:
        assert o["metrics"] == outs[0]["metrics"]  # the tp ranks agree exactly
    return outs[0], [torch.load(f"{rec}.{r}", weights_only=True) for r in range(n)]


def _together(calls):
    """Two tp ranks' records of one call as one rank's: a row-split call's
    input columns and codes put together (its amax is the tp-global one);
    a column-split call's rows are whole on both ranks."""
    a, b = calls
    if not a["split"]:
        assert torch.equal(a["x"], b["x"]) and torch.equal(a["codes"], b["codes"])
        return a
    assert torch.equal(a["amax"], b["amax"])
    return {"x": torch.cat([a["x"], b["x"]], -1), "codes": torch.cat([a["codes"], b["codes"]], -1),
            "amax": a["amax"], "split": True}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_w8a8_codes")
    one, one_rec = _step(d, "one", True, False)
    tp, tp_rec = _step(d, "tp", True, True)
    replayed, replay_rec = _step(d, "replay", True, True, replay=d / "one.rec.0")
    bf16_one, _ = _step(d, "bf16_one", False, False)
    bf16_tp, _ = _step(d, "bf16_tp", False, True)
    return {"one": one, "one_rec": one_rec[0], "tp": tp,
            "tp_rec": [_together(c) for c in zip(*tp_rec)], "replay": replayed,
            "replay_rec": [_together(c) for c in zip(*replay_rec)],
            "bf16_one": bf16_one, "bf16_tp": bf16_tp}


def _gap(a, b):
    return abs(a["metrics"]["grad_norm"] - b["metrics"]["grad_norm"]) / b["metrics"]["grad_norm"]


def _grads(out, w8a8):
    """Every trainable leaf's gradient, flat, from its update: AdamW's first
    step at lr 1 and eps 1 is u = -g / (|g| + 1)."""
    start = _spec(w8a8, {})["trainable"]
    gs = []
    for name in ("head", "lora"):
        for k, t in sorted(_flat(start[name]).items()):
            u = _flat(out["trainable"][name])[k].double() - t.double()
            gs.append((-u / (1 - u.abs())).flatten())
    return torch.cat(gs)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _grad_gap(a, b, w8a8):
    ga, gb = _grads(a, w8a8), _grads(b, w8a8)
    return float((ga - gb).norm() / gb.norm())


def test_codes_flip_only_where_the_input_rounded_apart(runs):
    one, tp, replay = runs["one_rec"], runs["tp_rec"], runs["replay_rec"]
    layers = CFG["num_layers"]
    assert len(one) == len(tp) == len(replay) == 2 * layers * len(PROJ)  # with the recompute
    table, same_rows = [], 0
    for i, (o, t, r) in enumerate(zip(one, tp, replay)):
        assert t["split"] == (PROJ[i % 4] in ("o_proj", "down_proj"))
        assert o["x"].shape == t["x"].shape
        same = (o["x"] == t["x"]).all(-1)  # rows whose input is one rank's bit for bit
        flips = o["codes"] != t["codes"]
        assert not flips[same].any(), (i, PROJ[i % 4])
        assert torch.equal(o["amax"][same], t["amax"][same])
        same_rows += int(same.sum())
        k = i // 4
        table.append((("forward", "recompute")[k // layers], k % layers if k < layers
                      else layers - 1 - k % layers, PROJ[i % 4], int((~same).sum()),
                      int((t["amax"] > o["amax"]).sum()), int(flips.sum()),
                      int((o["codes"] != r["codes"]).sum()), flips.numel()))
    assert same_rows > 0
    assert sum(row[-2] for row in table) < sum(row[-3] for row in table)
    print("\npass, layer, projection, rows whose input differs, rows whose amax is above one "
          "rank's, codes flipped, codes flipped on one rank's amax, codes")
    for row in table:
        print(*row, sep=", ")


def test_one_ranks_amax_takes_the_tp_step_within_the_bf16_layouts_bound(runs):
    gaps = {"w8a8": _gap(runs["tp"], runs["one"]), "w8a8 one rank's amax":
            _gap(runs["replay"], runs["one"]), "bf16": _gap(runs["bf16_tp"], runs["bf16_one"])}
    l2 = {"w8a8": _grad_gap(runs["tp"], runs["one"], True), "w8a8 one rank's amax":
          _grad_gap(runs["replay"], runs["one"], True),
          "bf16": _grad_gap(runs["bf16_tp"], runs["bf16_one"], False)}
    print(f"\ngrad_norm, two tp ranks against one, relative: {gaps}; the gradients' relative "
          f"L2 gap: {l2}")
    assert gaps["w8a8"] <= DIST_NORM_TOL
    assert gaps["w8a8"] <= gaps["bf16"]
    assert gaps["w8a8 one rank's amax"] <= DIST_NORM_TOL
    # the whole gradient: W8A8 under tp parts from one rank no more than bf16
    # does, and less on one rank's amax
    assert l2["w8a8 one rank's amax"] <= l2["w8a8"] <= l2["bf16"]
