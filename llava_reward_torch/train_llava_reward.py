"""Train command line (the port's twin of the top-level
``train_llava_reward.py``), flag-compatible with the reference CLI
(train_llava_reward.py:12-227), on one process or on N, one card each:

  python -m llava_reward_torch.train_llava_reward --pretrain <hf_dir> \\
      --dataset <json> --is_general_preference --value_head_dim 2 \\
      --add_cross_attention --lora_rank 128 --lora_alpha 256 --bf16 \\
      --gradient_checkpointing [--device cuda|cpu] ...

  torchrun --nproc_per_node N -m llava_reward_torch.train_llava_reward ...

More than one process (torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``, or the JAX package's
``LRT_COORDINATOR`` / ``LRT_NUM_PROCESSES`` / ``LRT_PROCESS_ID``): the
mesh comes from ``--zero_stage`` / ``--zpg`` / ``--mesh_dp`` /
``--mesh_fsdp`` / ``--mesh_tp`` (``core/mesh.py``), both trees are sharded
by the JAX rules, and each data rank reads its own rows
(``GroupSampler(num_replicas=dp x fsdp, rank=its data index)``) in batches
of ``--micro_train_batch_size``, its tp peers the same rows: one device a
process, so the global batch is dp x fsdp x micro, as in the JAX CLI. Under
``--mesh_tp`` the backbone runs split over the tp ranks
(``parallel/tensor.py``); tp must divide the heads, kv heads and MLP widths
(and, over a 4-bit decoder, leave whole NF4 blocks or packed bytes in each
rank's rows of a row-split projection), which is checked before any
process group starts.

Orchestration (the reference's train(): model -> tokenizer -> optimizer ->
data -> scheduler -> trainer.fit): load the backbone (or, without
``--pretrain``, a tiny random config with a word-hash tokenizer: smoke
mode) -> processor -> trainable tree (heads, LoRA or the whole backbone
when ``--lora_rank 0``, the projector under ``--ft_projector``) -> blended
datasets -> ``GroupSampler`` + ``PrefetchLoader`` -> AdamW ->
``RewardTrainer.fit``. Pointwise rows (or ``--cls_based``) train the
classification objective. Ends with a ``kernel launches`` line (each
hand-written kernel's launches in the run), a ``kernel shapes`` line (the
W8A8 kernels' launches by width and weight shape) and a ``train summary`` line
(this rank's mesh, backend, rows, each logged step's loss, grad_norm and
seconds, bytes of the decoder's stacked layers it holds and of their
quantized codes among them, peak card memory).

``--load_in_8bit`` (W8A8: the codes stay int8 in the matmul) and
``--load_in_4bit`` (``--quant_scheme`` nf4 or absmax) train LoRA over a
quantized frozen decoder (train_llava_reward.py:131-153): the decoder's
stacked layers are quantized one layer at a time on their way to the
device. Both need LoRA and exclude each other. On a tp mesh each rank then
keeps its block of every split quantized leaf (``shard_params``).
"""

from __future__ import annotations

import json
import os
import zlib


def smoke_tokenizer(dec):
    """The JAX train CLI's smoke tokenizer (``train_llava_reward.py:87-125``):
    ``zlib.crc32`` of each word (the same ids in every process), image tags
    to the decoder's image token."""

    class _Tok:
        eos_token = "</s>"
        pad_token_id = dec.pad_token_id

        def __call__(self, text):
            ids = []
            for t in text.split():
                if t in ("<|image_1|>", "<img>", "<image>") and hasattr(dec, "image_token_id"):
                    ids.append(dec.image_token_id)
                else:
                    ids.append(zlib.crc32(t.encode()) % 500 + 3)
            return {"input_ids": ids}

        def apply_chat_template(self, msgs, tokenize=False, add_generation_prompt=True):
            def flat(c):
                if isinstance(c, str):
                    return c
                return " ".join(("<img>" if p.get("type") == "image" else p.get("text", ""))
                                for p in c)

            return ("x" * 58 + " " + " ".join(flat(m["content"]) for m in msgs) + " "
                    + "x" * 22)

    return _Tok()


def _refuse(args) -> None:
    if args.lora_rank == 0 and (args.load_in_4bit or args.load_in_8bit):
        raise ValueError("--load_in_4bit/--load_in_8bit require LoRA (frozen backbone)")
    if args.load_in_4bit and args.load_in_8bit:
        raise ValueError("--load_in_4bit and --load_in_8bit are exclusive")


def _code_bytes(tree) -> int:
    """Bytes of the quantized codes in ``tree`` (a ``Sharded`` block's own)."""
    if not isinstance(tree, dict):
        return 0
    return sum(getattr(v, "local", v).numel() * getattr(v, "local", v).element_size()
               if k.startswith("qvalues") else _code_bytes(v) for k, v in tree.items())


def train(args):
    import torch

    from .core.config import RewardConfig
    from .core.device import resolve_device
    from .core.logging import init_logger
    from .core.mesh import backend, is_rank_0, mesh_from_args, setup_distributed
    from .core.registry import get_family
    from .data.datasets import blending_datasets, is_pairwise
    from .data.loader import PrefetchLoader
    from .data.sampler import GroupSampler
    from .io.torch_io import load_torch_state_dict
    from .lora.lora import init_lora, init_vision_lora
    from .parallel.sharding import DATA, shard_params
    from .parallel.tensor import check_tp
    from .reward.model import init_head_params, num_layers_of
    from .train.optim import make_optimizer, tree_leaves, tree_map
    from .train.train_step import make_cls_loss_fn, make_pairwise_loss_fn
    from .train.trainer import RewardTrainer
    from .utils.quantize import quantize_stacked_layers

    logger = init_logger(__name__)
    _refuse(args)
    family = get_family(args.model_type)
    from_dir = bool(args.pretrain) and os.path.isdir(args.pretrain)
    cfg = family.config_from_pretrain(args.pretrain) if from_dir else family.tiny_config()
    # QLoRA-style training over a quantized frozen decoder
    # (rw_model_general_preference.py:166-175): W8A8 keeps the codes int8 in
    # the matmul (B6 + the int8 GEMM forward, a bf16 tensor-core product
    # backward); nf4 / absmax int4 are dequantized a layer at a time
    scheme = ("w8a8" if args.load_in_8bit else args.quant_scheme) if (
        args.load_in_8bit or args.load_in_4bit) else None
    if args.mesh_tp > 1:  # before any process group starts
        check_tp(cfg, args.mesh_tp, {"absmax": "int4"}.get(scheme, scheme))
    dev = resolve_device(args.device)
    setup_distributed(device=dev.type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_from_args(args)
    logger.info("mesh %s, rank %d, backend %s", mesh.shape, mesh.rank, backend())
    world, rank = mesh.size, mesh.rank
    data_ways, data_rank = mesh.ways(DATA), mesh.index(DATA)

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    rcfg = RewardConfig(
        is_general_preference=args.is_general_preference,
        add_cross_attention=args.add_cross_attention,
        value_head_dim=args.value_head_dim,
        general_preference_tau=args.general_preference_tau,
        add_prompt_head=args.add_prompt_head,
        mean_hidden_state=args.mean_hidden_state,
        layer_id=args.layer_id,
    )

    # ---- model
    param_dtype = torch.bfloat16 if args.bf16 else torch.float32

    def quantized(backbone, device=None, dtype=None):
        """The decoder's stacked layers quantized a layer at a time on their
        way to ``device`` (the float decoder never sits there beside its
        codes), the rest moved whole."""
        dec = "decoder" if "decoder" in backbone else "text"
        rest = {k: v for k, v in backbone[dec].items() if k != "layers"}
        out = tree_map(lambda t: t.to(device=device, dtype=dtype), {**backbone, dec: rest})
        out[dec]["layers"] = quantize_stacked_layers(backbone[dec]["layers"], bits=4,
                                                     scheme=scheme, device=device, dtype=dtype)
        logger.info("frozen decoder weights quantized (%s)", scheme)
        return out

    if from_dir:
        sd = load_torch_state_dict(args.pretrain)
        backbone = family.params_from_sd(sd, cfg, dtype=torch.float32)
        del sd
        backbone = (quantized(backbone, dev, param_dtype) if scheme else
                    tree_map(lambda t: t.to(device=dev, dtype=param_dtype), backbone))
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(
            args.pretrain, use_fast=not args.disable_fast_tokenizer,
            trust_remote_code=True, cache_dir=args.cache_dir)
        family.tokenizer_setup(tokenizer)
    else:
        logger.warning("no --pretrain dir; using tiny random config (smoke mode)")
        rcfg.layer_id = num_layers_of(cfg)
        backbone = family.init_params(cfg, generator(args.seed), param_dtype, dev)
        if scheme:
            backbone = quantized(backbone)
        tokenizer = smoke_tokenizer(family.decoder_cfg(cfg))

    processor = family.make_processor(tokenizer, cfg)
    # lora_rank == 0 means full fine-tuning in the reference (consumed by the
    # _ft_phi eval harness): the whole backbone becomes trainable
    full_finetune = args.lora_rank == 0
    if full_finetune:
        logger.info("lora_rank=0 -> full fine-tuning (backbone trainable)")
        frozen = {"backbone": {k: backbone[k] for k in ("lm_head",) if k in backbone}}
        train_backbone = {k: v for k, v in backbone.items() if k != "lm_head"}
    else:
        frozen, train_backbone = {"backbone": backbone}, None
    targets = tuple(args.target_modules) if args.target_modules else family.lora_targets
    trainable = {
        "backbone": train_backbone,
        "head": init_head_params(cfg, rcfg, generator(1), torch.float32, dev),
        "lora": (init_lora(family.decoder_cfg(cfg), args.lora_rank, args.lora_alpha,
                           generator(2), targets=targets, device=dev)
                 if args.lora_rank > 0 else None),
        "projector": (tree_map(lambda t: t.detach().float().clone(),
                               family.get_projector(backbone))
                      if args.ft_projector else None),
        "vision_lora": (init_vision_lora(cfg.vision, args.lora_rank, args.lora_alpha,
                                         generator(3), device=dev)
                        if args.train_vision and args.lora_rank > 0
                        and args.model_type == "phi3v" else None),
    }

    # ---- shard over the mesh (each leaf whole where fsdp and tp are 1)
    frozen, trainable = shard_params(frozen, mesh, cfg), shard_params(trainable, mesh, cfg)
    del backbone, train_backbone

    # ---- data
    train_rows, eval_rows = blending_datasets(
        args.dataset, args.dataset_probs, seed=args.seed, max_count=args.max_samples,
        train_split_ratio=args.train_split_ratio)
    cls_based = args.cls_based or not is_pairwise(train_rows)
    ds_cls = family.pointwise_dataset if cls_based else family.pairwise_dataset
    train_ds = ds_cls(train_rows, processor, tokenizer, args.image_root)
    eval_ds = ds_cls(eval_rows, processor, tokenizer, args.image_root) if eval_rows else None
    pad_id = family.decoder_cfg(cfg).pad_token_id
    # every data rank reads its own rows (the reference's per-rank sampler),
    # its tp peers the same; one device a process, so the local batch is the
    # micro batch
    sampler = GroupSampler(len(train_ds), num_replicas=data_ways, rank=data_rank, shuffle=True,
                           seed=args.seed, group_size=args.group_size)
    train_loader = PrefetchLoader(
        train_ds, sampler, args.micro_train_batch_size,
        collate_fn=lambda items: train_ds.collate(items, args.seq_len, pad_id),
        num_workers=args.num_workers)
    train_loader.sampler = sampler
    eval_loader = None
    if eval_ds is not None:
        eval_loader = PrefetchLoader(
            eval_ds, GroupSampler(len(eval_ds), num_replicas=data_ways, rank=data_rank,
                                  shuffle=False),
            args.micro_train_batch_size,
            collate_fn=lambda items: eval_ds.collate(items, args.seq_len, pad_id),
            num_workers=args.num_workers, drop_last=False)

    # ---- optimizer / loss
    steps_per_epoch = max(1, len(train_loader))
    total_steps = steps_per_epoch * args.max_epochs // max(1, args.accumulated_gradient)
    tx = make_optimizer(args.learning_rate, total_steps, weight_decay=args.l2,
                        max_norm=args.max_norm, accumulation_steps=args.accumulated_gradient)
    common = dict(compute_fp32_loss=args.compute_fp32_loss, attn_impl=args.attn_impl,
                  remat=args.gradient_checkpointing, projector_path=family.projector_path,
                  mesh=mesh)
    if cls_based:
        loss_fn = make_cls_loss_fn(cfg, rcfg, **common)
    else:
        loss_fn = make_pairwise_loss_fn(
            cfg, rcfg, add_pretrain_loss=args.add_pretrain_loss,
            ptx_loss_coef=args.ptx_loss_coef, reward_scaler_beta=args.reward_scaler_beta,
            add_img_eos=args.add_img_eos, **common)

    wandb_logger = None
    if args.use_wandb and is_rank_0():
        try:
            import wandb

            wandb.init(entity=args.wandb_org, project=args.wandb_project,
                       group=args.wandb_group, name=args.wandb_run_name, config=vars(args))
            wandb_logger = wandb
        except Exception as e:
            logger.warning("wandb unavailable: %s", e)

    trainer = RewardTrainer(
        cfg=cfg, rcfg=rcfg, frozen=frozen, trainable=trainable, tx=tx, loss_fn=loss_fn,
        train_loader=train_loader, eval_loader=eval_loader, cls_based=cls_based,
        margin_loss=args.margin_loss, max_epochs=args.max_epochs, save_path=args.save_path,
        save_steps=args.save_steps, eval_steps=args.eval_steps,
        logging_steps=args.logging_steps, max_ckpt_num=args.max_ckpt_num,
        lora_rank=args.lora_rank, lora_alpha=args.lora_alpha, lora_dropout=args.lora_dropout,
        save_best_model=bool(args.save_best_model), model_type=args.model_type,
        lora_targets=targets, ckpt_path=args.ckpt_path, ckpt_steps=args.ckpt_steps,
        wandb_logger=wandb_logger, device=dev, mesh=mesh,
    )
    if args.load_checkpoint and os.path.exists(os.path.join(args.ckpt_path, "train_state.pt")):
        trainer.load_train_ckpt(args.ckpt_path)
    trainer.fit()
    trainer.save_train_ckpt(args.ckpt_path)
    from .utils.profiling import kernel_launches, kernel_shapes

    print("kernel launches " + json.dumps(kernel_launches()))
    print("kernel shapes " + json.dumps(kernel_shapes()))
    sampler.set_epoch(0)
    bb = trainer.state.trainable.get("backbone") or trainer.frozen["backbone"]
    dec = bb.get("decoder") or bb.get("text") or {}
    print("train summary " + json.dumps({
        "rank": rank, "world": world, "backend": backend(), "mesh": mesh.shape,
        "steps": int(trainer.state.step),
        "losses": [x["preference_loss"] for x in trainer.train_logs],
        "grad_norms": [x["grad_norm"] for x in trainer.train_logs],
        "step_times_s": [x["step_time_s"] for x in trainer.train_logs],
        "rows": [int(i) for i in sampler],
        "layer_bytes": sum(t.numel() * t.element_size()
                           for t in tree_leaves(dec.get("layers"))),
        "code_bytes": _code_bytes(dec.get("layers")),
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                     if dev.type == "cuda" else None)}), flush=True)
    return trainer


def build_parser():
    from .core.args import build_train_parser

    p = build_train_parser()
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    import torch.distributed as dist

    try:
        return train(build_parser().parse_args(argv))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
