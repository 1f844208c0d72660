"""The single-chip compile check (the port's twin of
``__graft_entry__.py:entry``) and the multi-process dry runs (its
``dryrun_multichip``), the latter run as one process per rank:

  python -m llava_reward_torch.dryrun entry [--device cuda|cpu] [--tiny]
  python -m llava_reward_torch.dryrun multichip N [--device cpu]
  python -m llava_reward_torch.dryrun step SPEC OUT [--device cpu]
  python -m llava_reward_torch.dryrun score SPEC OUT [--device cpu]

Each process is launched by itself with ``LRT_COORDINATOR`` /
``LRT_NUM_PROCESSES`` / ``LRT_PROCESS_ID`` (or torchrun's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``), or through
``python -m torch.distributed.run --nproc_per_node N``; ``core/mesh.py``
picks NCCL or gloo.

``entry`` builds ``entry()``'s ``(fn, example_args)``: the phi3v reward
forward at inference, at Phi-3.5-vision's full widths cut to 2 decoder
layers, 2 CLIP layers and 4 crops, on bf16 weights from seeds 0 and 1 and one
row of seq 512. It calls ``fn(*args)`` once, waits for the device, and
prints the reward, whether it is finite, the seconds and a ``kernel
launches`` line; it exits non-zero on a non-finite reward, and on the card
when a kernel of the path (B1 in the CLIP tower, B2 and B3 in the decoder)
did not launch. ``--tiny`` cuts the tiny phi3v config the same way (a quick
check on the CPU).

``multichip N`` takes one FSDP LoRA step for each backbone family on tiny
configs, at the JAX dry run's shapes (a global batch of N rows, each rank
scoring its own): phi3v on a dp x fsdp mesh (dp 2 when N is even and above
2), phi3v on the zpg hybrid mesh when N >= 4, Qwen2.5-VL and LLaVA-NeXT.
Each prints ``dryrun[<name>]: ok, loss=...``. On the card the trees are
bf16 and the attention runs the kernels.

``step SPEC OUT`` takes the training steps that SPEC (a ``torch.save``d
dict: family, tiny-config and reward-config arguments, frozen and trainable
trees, chosen / rejected global batches, mesh flags, ``--mesh_tp`` among
them, optimizer and loss options) describes under this process group, and
writes this rank's metrics, step seconds, kernel launches (and plain
versions' calls), local shard shapes and the gathered trainable tree to
``OUT.<rank>``. The frozen tree may be quantized (W8A8, NF4, absmax int4),
also on a tp mesh, where each rank keeps its block of every split leaf.

``score SPEC OUT`` runs the reward forward of SPEC's ``params`` ({backbone,
head}) on each of its global ``batches`` under the mesh, once for each of
its ``impls`` (attention routes), and writes this rank's rewards (its data
rank's rows), kernel launches and plain versions' calls to ``OUT.<rank>``;
a W8A8 decoder runs its quantizing epilogues on the kernel route, on a tp
mesh too. The config is the tiny
one of SPEC's ``cfg`` arguments, or read from the ``config.json`` of its
``pretrain`` directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import zlib

import numpy as np
import torch

from .core import config as C
from .core.device import resolve_device
from .core.mesh import mesh_from_args, setup_distributed, world_size
from .core.registry import get_family
from .lora.lora import QWEN_TARGETS, init_lora
from .models import llava_next, phi3v, qwen25_vl
from .parallel.sharding import (DATA, Sharded, create_hybrid_mesh, create_mesh, gather_tree,
                                gather_unstacked, shard_batch, shard_params)
from .parallel.tensor import tensor_parallel
from .preprocess.collate import collate_qwen_samples, collate_samples, to_reward_batch
from .preprocess.phi3v_processor import build_img_gather_idx
from .reward.model import init_head_params, reward_forward
from .train.optim import make_optimizer, tree_map
from .train.train_step import (PROJECTOR_PATHS, init_train_state, make_pairwise_loss_fn,
                               make_train_step)
from .utils.profiling import kernel_launches, kernel_shapes, plain_calls

FAMILIES = {
    "phi3v": (C.phi3v_tiny_config, phi3v.init_params),
    "qwen": (C.qwen_tiny_config, qwen25_vl.init_params),
    "llava": (C.llava_tiny_config, llava_next.init_params),
}


class _WordTok:
    """crc32 word ids (the same in every process), ``image_tag`` to the
    image token."""

    def __init__(self, image_tag: str, image_token_id: int):
        self.image_tag, self.image_token_id = image_tag, image_token_id

    def __call__(self, text):
        return {"input_ids": [self.image_token_id if t == self.image_tag
                              else zlib.crc32(t.encode()) % 400 + 3 for t in text.split()]}


def tiny_image_batch(cfg, rng, batch: int, seq_len: int, img_budget: int = 512) -> dict:
    """phi3v rows with one 1x1-crop image each (``__graft_entry__.py:31-55``)."""
    nc, crop = cfg.num_crops, cfg.vision.image_size
    n_img = 2 * 144 + 1 + 2 * 12
    splice = np.full((batch, seq_len), -1, np.int32)
    splice[:, 1:1 + n_img] = np.arange(n_img)
    gidx = build_img_gather_idx(1, 1, nc, img_budget)
    return {
        "input_ids": rng.integers(2, cfg.decoder.vocab_size - 2, (batch, seq_len)).astype(
            np.int32),
        "attention_mask": np.ones((batch, seq_len), np.int32),
        "pixel_values": rng.standard_normal((batch, nc + 1, crop, crop, 3)).astype(np.float32),
        "img_gather_idx": np.tile(gidx[None], (batch, 1)).astype(np.int32),
        "splice_idx": splice,
        "num_img_tokens": np.full((batch,), n_img, np.int32),
    }


def tiny_qwen_batch(cfg, batch: int, seq_len: int = 80, seed: int = 0):
    """Qwen rows through the processor and collator (``__graft_entry__.py:83-116``)."""
    from PIL import Image

    from .preprocess.qwen_vision import Qwen25VLProcessor

    proc = Qwen25VLProcessor(_WordTok("<img>", cfg.text.image_token_id),
                             min_pixels=cfg.min_pixels, max_pixels=cfg.max_pixels,
                             image_token_id=cfg.text.image_token_id)
    rng = np.random.default_rng(seed)
    samples = [proc(f"<img> sample number {seed}-{i}",
                    [Image.fromarray((rng.random((90, 120, 3)) * 255).astype(np.uint8))])
               for i in range(batch)]
    return collate_qwen_samples(samples, seq_len, cfg.text.pad_token_id, patch_budget=512,
                                unit_budget=128)


def tiny_llava_batch(cfg, batch: int, seq_len: int = 64, seed: int = 1):
    """LLaVA rows through the anyres processor (``__graft_entry__.py:119-145``)."""
    from PIL import Image

    from .preprocess.llava_processor import LlavaNextProcessor

    proc = LlavaNextProcessor(_WordTok("<image>", cfg.text.image_token_id),
                              image_token_id=cfg.text.image_token_id,
                              grid_pinpoints=cfg.grid_pinpoints)
    rng = np.random.default_rng(seed)
    samples = [proc(f"<image> describe scene {seed}-{i}",
                    [Image.fromarray((rng.random((300, 400, 3)) * 255).astype(np.uint8))])
               for i in range(batch)]
    seq_len = max(seq_len, max(len(s.input_ids) for s in samples) + 2)
    return collate_samples(samples, seq_len, cfg.text.pad_token_id)


def _one_step(mesh, cfg, rcfg, frozen, trainable, chosen, rejected, *, projector_path,
              tx, loss_kw, steps=1, margin=None):
    """Shard both trees and the batches onto ``mesh``; ``steps`` train steps.
    -> (state, first step's metrics, wall seconds of each step)."""
    loss_fn = make_pairwise_loss_fn(cfg, rcfg, projector_path=projector_path, mesh=mesh,
                                    **loss_kw)
    train_step = make_train_step(loss_fn, tx, mesh)
    frozen, trainable = shard_params(frozen, mesh, cfg), shard_params(trainable, mesh, cfg)
    state = init_train_state(trainable, tx)
    chosen, rejected = shard_batch(chosen, mesh), shard_batch(rejected, mesh)
    margin = shard_batch(margin, mesh)
    first, times = None, []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = train_step(state, frozen, chosen, rejected, margin)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
        times.append(time.perf_counter() - t0)
        first = first or metrics
    return state, first, times


def _family_trees(family: str, cfg, rcfg, dev, dtype, seeds):
    """Frozen backbone, head + LoRA trainable tree (the JAX dry run's)."""
    g = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
    frozen = {"backbone": FAMILIES[family][1](cfg, g[0], dtype, dev)}
    dec = cfg.decoder if family == "phi3v" else cfg.text
    trainable = {
        "head": init_head_params(cfg, rcfg, g[1], torch.float32, dev),
        "lora": init_lora(dec, 4, 8, g[2], device=dev,
                          **({} if family == "phi3v" else {"targets": QWEN_TARGETS})),
        "projector": None,
    }
    return frozen, trainable


def multichip(n: int, device: str = "cuda") -> float:
    """One FSDP LoRA step a family on ``n`` processes (``__graft_entry__.py:
    210-306``); returns phi3v's loss."""
    dev = resolve_device(device)
    setup_distributed(device=dev.type)
    if world_size() != n:
        raise RuntimeError(f"multichip {n} needs {n} processes, this group has {world_size()}")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    dp = 2 if n % 2 == 0 and n > 2 else 1
    mesh = create_mesh(dp=dp, fsdp=-1, tp=1)
    B = n
    rng = np.random.default_rng(0)
    tx = make_optimizer(2e-4, 10, max_norm=1.0)
    loss_kw = {"remat": True}

    def run(name, mesh, cfg, rcfg, trees, chosen, rejected, family, timed=False):
        c, r = to_reward_batch(chosen, dev), to_reward_batch(rejected, dev)
        _, m, times = _one_step(mesh, cfg, rcfg, *trees, c, r, tx=tx, loss_kw=loss_kw,
                                projector_path=PROJECTOR_PATHS[family],
                                steps=2 if timed else 1)
        if not np.isfinite(m["preference_loss"]):
            raise RuntimeError(f"dryrun[{name}]: loss {m['preference_loss']}")
        extra = f", warm_step={times[-1]:.3f}s" if timed else ""
        print(f"dryrun[{name}]: ok, loss={m['preference_loss']:.4f}{extra}", flush=True)
        return m["preference_loss"]

    # phi3v: dp x fsdp, LoRA + head + projector (SkipCA on)
    cfg = C.phi3v_tiny_config(num_crops=4, hidden_size=64, num_layers=2, vision_layers=2)
    rcfg = C.RewardConfig(is_general_preference=True, value_head_dim=2,
                          add_cross_attention=True, layer_id=cfg.decoder.num_layers)
    frozen, trainable = _family_trees("phi3v", cfg, rcfg, dev, dtype, (0, 1, 2))
    trainable["projector"] = tree_map(lambda t: t.float().clone(),
                                      frozen["backbone"]["vision"]["img_projection"])
    loss = run(f"phi3v dp{dp}xfsdp{n // dp}", mesh, cfg, rcfg, (frozen, trainable),
               tiny_image_batch(cfg, rng, B, 384), tiny_image_batch(cfg, rng, B, 384),
               "phi3v", timed=True)
    if n >= 4:  # the zpg hybrid mesh (ZeRO++ hpZ)
        run(f"phi3v zpg hybrid dp2xfsdp{n // 2}", create_hybrid_mesh(2, n // 2), cfg, rcfg,
            (frozen, trainable), tiny_image_batch(cfg, rng, B, 384),
            tiny_image_batch(cfg, rng, B, 384), "phi3v")

    qcfg = C.qwen_tiny_config(num_layers=2, vision_depth=2)
    qrcfg = C.RewardConfig(is_general_preference=True, value_head_dim=2,
                           layer_id=qcfg.text.num_layers)
    run("qwen", mesh, qcfg, qrcfg, _family_trees("qwen", qcfg, qrcfg, dev, dtype, (3, 4, 5)),
        tiny_qwen_batch(qcfg, B, seed=10), tiny_qwen_batch(qcfg, B, seed=20), "qwen")

    lcfg = C.llava_tiny_config(num_layers=2, vision_layers=2)
    lrcfg = C.RewardConfig(is_general_preference=True, value_head_dim=2,
                           layer_id=lcfg.text.num_layers)
    run("llava", mesh, lcfg, lrcfg, _family_trees("llava", lcfg, lrcfg, dev, dtype, (6, 7, 8)),
        tiny_llava_batch(lcfg, B, seed=11), tiny_llava_batch(lcfg, B, seed=21), "llava")
    print(f"dryrun_multichip({n}): ok, loss={loss:.4f}", flush=True)
    return loss


# the kernels the entry's forward launches on the card: B1 in the CLIP tower
# (5 crops x 8 head groups >= 32), B2 three times a layer and B3 in the
# decoder (1 row x 8 head groups < 32)
ENTRY_KERNELS = ("fa_direct", "prep", "fa_hm")


def entry_config(full=None):
    """``full`` (``phi35_vision_config()`` by default) cut to 2 decoder
    layers, 2 CLIP layers and 4 crops, and the entry's reward config: GPM
    dim 2 with SkipCA on the last layer (``__graft_entry__.py:65-75``)."""
    full = C.phi35_vision_config() if full is None else full
    cfg = dataclasses.replace(full, decoder=dataclasses.replace(full.decoder, num_layers=2),
                              vision=dataclasses.replace(full.vision, num_layers=2),
                              num_crops=4)
    rcfg = C.RewardConfig(is_general_preference=True, value_head_dim=2,
                          add_cross_attention=True, layer_id=cfg.decoder.num_layers)
    return cfg, rcfg


def entry(device: str = "cuda", full=None, dtype: torch.dtype = torch.bfloat16):
    """``(fn, example_args)`` (``__graft_entry__.py:56-93``): ``fn(params,
    batch)`` is the phi3v reward forward at inference; ``params`` the
    backbone and head trees from generators seeded 0 and 1, in ``dtype`` on
    ``device`` (``"meta"`` gives the shapes alone), and ``batch`` one row of
    seq 512 from ``tiny_image_batch``. ``full`` is the config to cut."""
    dev = resolve_device(device)
    cfg, rcfg = entry_config(full)
    gen_dev = dev if dev.type == "cuda" else "cpu"
    g_backbone, g_head = (torch.Generator(device=gen_dev).manual_seed(s) for s in (0, 1))
    params = {"backbone": phi3v.init_params(cfg, g_backbone, dtype, dev),
              "head": init_head_params(cfg, rcfg, g_head, dtype, dev)}
    batch = to_reward_batch(tiny_image_batch(cfg, np.random.default_rng(0), 1, 512), dev)

    def fn(params, batch):
        return reward_forward(params, cfg, rcfg, batch, training=False).reward

    return fn, (params, batch)


def run_entry(device: str = "cuda", tiny: bool = False) -> float:
    """``fn(*example_args)`` once; prints the reward and the launches."""
    dev = resolve_device(device)
    fn, args = entry(device, C.phi3v_tiny_config() if tiny else None)
    before = kernel_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        reward = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    values = reward.float().cpu().flatten().tolist()
    finite = all(math.isfinite(v) for v in values)
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    print(f"entry: reward {values}, finite {finite}, {secs:.3f} s on {dev}", flush=True)
    print("kernel launches " + json.dumps(launches), flush=True)
    if not finite:
        raise SystemExit("entry: the reward is not finite")
    missing = [k for k in ENTRY_KERNELS if not launches[k]]
    if dev.type == "cuda" and missing:
        raise SystemExit(f"entry: {missing} did not launch on the card")
    return values[0]


def _local_shapes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_local_shapes(v, f"{path}/{k}" if path else k))
        return out
    if isinstance(tree, Sharded):
        return {path: tuple(tree.local.shape)}
    return {path: tuple(tree.shape)} if isinstance(tree, torch.Tensor) else {}


def _from_spec(spec_path: str, device: str):
    """Join the process group; -> (device, spec, family, cfg, rcfg, mesh)."""
    dev = resolve_device(device)
    setup_distributed(device=dev.type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    spec = torch.load(spec_path, map_location=dev, weights_only=True)
    family = spec["family"]
    if "pretrain" in spec:
        cfg = get_family(family).config_from_pretrain(spec["pretrain"])
    else:
        cfg = FAMILIES[family][0](**spec["cfg"])
    mesh = mesh_from_args(argparse.Namespace(**spec["mesh"]))
    return dev, spec, family, cfg, C.RewardConfig(**spec["rcfg"]), mesh


def step(spec_path: str, out_path: str, device: str = "cuda") -> dict:
    """The steps ``spec_path`` describes, on this process group; writes
    ``out_path.<rank>``."""
    dev, spec, family, cfg, rcfg, mesh = _from_spec(spec_path, device)
    tx = make_optimizer(**spec["optim"])
    state, metrics, times = _one_step(
        mesh, cfg, rcfg, spec["frozen"], spec["trainable"], to_reward_batch(spec["chosen"], dev),
        to_reward_batch(spec["rejected"], dev), margin=spec.get("margin"), tx=tx,
        loss_kw=spec.get("loss", {}), projector_path=PROJECTOR_PATHS[family],
        steps=spec.get("steps", 1))
    out = {"rank": mesh.rank, "mesh": mesh.shape, "metrics": metrics, "step_s": times,
           "launches": kernel_launches(), "plain_calls": plain_calls(),
           "shapes": kernel_shapes(), "local_shapes": _local_shapes(state.trainable),
           "trainable": tree_map(lambda t: t.detach().cpu(), gather_tree(state.trainable))}
    torch.save(out, f"{out_path}.{mesh.rank}")
    return out


@torch.no_grad()
def score(spec_path: str, out_path: str, device: str = "cuda") -> dict:
    """The rewards of ``spec_path``'s batches on this process group; writes
    ``out_path.<rank>``."""
    dev, spec, _, cfg, rcfg, mesh = _from_spec(spec_path, device)
    params = gather_unstacked(shard_params(spec["params"], mesh, cfg))
    batches = [shard_batch(to_reward_batch(b, dev), mesh) for b in spec["batches"]]
    group = mesh.group(DATA) if mesh.ways(DATA) > 1 else None
    tp = tensor_parallel(mesh, cfg)
    rewards = {impl: [reward_forward(params, cfg, rcfg, b, attn_impl=impl, data_group=group,
                                     tp=tp).reward.float().cpu() for b in batches]
               for impl in spec.get("impls", ("auto",))}
    out = {"rank": mesh.rank, "mesh": mesh.shape, "data_index": mesh.index(DATA),
           "rewards": rewards, "launches": kernel_launches(), "plain_calls": plain_calls(),
           "shapes": kernel_shapes()}
    torch.save(out, f"{out_path}.{mesh.rank}")
    return out


def main(argv=None) -> None:
    import torch.distributed as dist

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("entry")
    e.add_argument("--tiny", action="store_true",
                   help="the tiny phi3v config with the same cuts (a quick check on the CPU)")
    m = sub.add_parser("multichip")
    m.add_argument("n", type=int)
    subs = [e, m]
    for name in ("step", "score"):
        s = sub.add_parser(name)
        s.add_argument("spec")
        s.add_argument("out")
        subs.append(s)
    for q in subs:
        q.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    try:
        if args.cmd == "entry":
            run_entry(args.device, args.tiny)
        elif args.cmd == "multichip":
            multichip(args.n, args.device)
        else:
            {"step": step, "score": score}[args.cmd](args.spec, args.out, args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
