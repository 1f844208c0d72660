"""Train-CLI argument surface (the port's own copy of
``llava_reward_tpu/core/args.py``): the reference's flag names
(train_llava_reward.py:148-227), so launch scripts carry over, plus the JAX
package's own flags, with the same defaults.

DeepSpeed-only flags are accepted and mapped or ignored:
  --zero_stage/--zpg     -> parameter sharding axes (kept for script compat)
  --flash_attn           -> the attention kernels (on by default on the card)
  --adam_offload         -> host optimizer-state offload
  --load_in_4bit         -> int4 weight-only quantization (utils/quantize)
  --local_rank           -> ignored
"""

from __future__ import annotations

import argparse


def build_train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LLaVA-Reward training (PyTorch port)")
    # model / data
    p.add_argument("--pretrain", type=str, default=None)
    p.add_argument("--model_type", type=str, default="phi3v",
                   choices=["phi3v", "qwen", "llava"])
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--dataset_probs", type=str, default=None)
    p.add_argument("--image_root", type=str, default=None)
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--max_samples", type=int, default=1000000)
    p.add_argument("--is_custom_dataset", action="store_true", default=False)
    p.add_argument("--train_split_ratio", type=float, default=1.0)
    # save / ckpt
    p.add_argument("--save_path", type=str, default="./ckpt")
    p.add_argument("--save_steps", type=int, default=-1)
    p.add_argument("--logging_steps", type=int, default=1)
    p.add_argument("--eval_steps", type=int, default=-1)
    p.add_argument("--ckpt_path", type=str, default="./ckpt/checkpoints_rm")
    p.add_argument("--ckpt_steps", type=int, default=-1,
                   help="save the resumable train state every N "
                   "steps for preemption safety; -1 = only at end of fit")
    p.add_argument("--max_ckpt_num", type=int, default=3)
    p.add_argument("--max_ckpt_mem", type=float, default=1000)
    p.add_argument("--load_checkpoint", action="store_true", default=False)
    p.add_argument("--save_best_model", type=int, default=None)
    # schedule / batch
    p.add_argument("--max_epochs", type=int, default=1)
    p.add_argument("--micro_train_batch_size", type=int, default=1)
    p.add_argument("--train_batch_size", type=int, default=None,
                   help="global batch; default micro*accum*data_parallel")
    p.add_argument("--accumulated_gradient", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--max_norm", type=float, default=1.0)
    p.add_argument("--l2", type=float, default=0.0)
    p.add_argument("--max_len", type=int, default=2048)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--group_size", type=int, default=1)
    # model knobs
    p.add_argument("--layer_id", type=int, default=32)
    p.add_argument("--gradient_checkpointing", action="store_true", default=False)
    p.add_argument("--gradient_checkpointing_use_reentrant", action="store_true")
    p.add_argument("--bf16", action="store_true", default=False)
    p.add_argument("--freeze_vision_model", action="store_true", default=True)
    p.add_argument("--train_vision", action="store_true", default=False,
                   help="LoRA over the CLIP tower (the reference's unfrozen-"
                        "vision mode, utils/utils.py:205-222)")
    p.add_argument("--ft_projector", action="store_true", default=False)
    p.add_argument("--add_unpaired_head", action="store_true", default=False)
    p.add_argument("--flash_attn", action="store_true", default=False)
    p.add_argument("--compute_fp32_loss", action="store_true", default=False)
    p.add_argument("--margin_loss", action="store_true", default=False)
    p.add_argument("--input_template", type=str, default="User: {}\nAssistant: ")
    p.add_argument("--disable_fast_tokenizer", action="store_true", default=False)
    p.add_argument("--is_pretrained_pm", action="store_true", default=False)
    # lora
    p.add_argument("--lora_rank", type=int, default=0)
    p.add_argument("--lora_alpha", type=int, default=16)
    p.add_argument("--lora_dropout", type=float, default=0.05)
    p.add_argument("--target_modules", type=str, nargs="*", default=None)
    # reward head
    p.add_argument("--is_general_preference", action="store_true", default=False)
    p.add_argument("--add_img_eos", action="store_true", default=False)
    p.add_argument("--cls_based", action="store_true", default=False)
    p.add_argument("--add_cross_attention", action="store_true", default=False)
    p.add_argument("--mean_hidden_state", action="store_true", default=False)
    p.add_argument("--general_preference_tau", type=float, default=0.1)
    p.add_argument("--value_head_dim", type=int, default=2)
    p.add_argument("--add_prompt_head", action="store_true", default=False)
    p.add_argument("--return_prompt_length", action="store_true", default=False)
    # aux losses
    p.add_argument("--add_pretrain_loss", action="store_true", default=False)
    p.add_argument("--ptx_loss_coef", type=float, default=0.1)
    p.add_argument("--reward_scaler_beta", type=float, default=2.0)
    p.add_argument("--reward_margin", type=float, default=1.0)
    p.add_argument("--regression_target_margin", type=float, default=10.0)
    # distributed (DeepSpeed-compat, remapped)
    p.add_argument("--local_rank", type=int, default=-1, help="ignored")
    p.add_argument("--zero_stage", type=int, default=2,
                   help="any stage>0 maps to FSDP param sharding")
    p.add_argument("--zpg", type=int, default=1,
                   help="ZeRO++ hpZ analogue: fsdp-within-slice size")
    p.add_argument("--adam_offload", action="store_true", default=False)
    p.add_argument("--grad_accum_dtype", type=str, default=None)
    p.add_argument("--disable_trace_cache", action="store_true", default=False)
    p.add_argument(
        "--load_in_4bit", action="store_true", default=False,
        help="weight-only 4-bit backbone (default nf4: bitsandbytes NormalFloat4 "
        "grid + per-64-block absmax, matching the reference's bnb numerics)",
    )
    p.add_argument(
        "--quant_scheme", default="nf4", choices=["nf4", "absmax"],
        help="4-bit grid: nf4 (bnb-compatible) or absmax symmetric int4",
    )
    p.add_argument(
        "--load_in_8bit", action="store_true", default=False,
        help="W8A8 int8 frozen decoder for QLoRA-style training: weights stay "
        "int8 in the matmul, halving the frozen weights' memory against bf16",
    )
    # the JAX package's own flags
    p.add_argument("--mesh_dp", type=int, default=1)
    p.add_argument("--mesh_fsdp", type=int, default=-1)
    p.add_argument("--mesh_tp", type=int, default=1)
    p.add_argument("--seq_len", type=int, default=2944,
                   help="static sequence bucket (image budget + text)")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--attn_impl", type=str, default="auto",
                   choices=["auto", "pallas", "xla"])
    # wandb
    p.add_argument("--use_wandb", type=str, default=None)
    p.add_argument("--wandb_org", type=str, default=None)
    p.add_argument("--wandb_group", type=str, default=None)
    p.add_argument("--wandb_project", type=str, default="llava_reward_tpu")
    p.add_argument("--wandb_run_name", type=str, default=None)
    return p
