"""Batch eval command line (the port's twin of the top-level
``eval_batch_inference.py``; the reference's eval/batch_inference_rm_*.py):

    python -m llava_reward_torch.eval_batch_inference --pretrain <hf_dir> \\
        --pm_path <artifact> --dataset data/pairwise.json [--image_root DIR] \\
        [--max_samples N] [--device cuda|cpu]

Pairwise or pointwise is sniffed from the rows; prints the reference's
metrics (accuracy / tie-excluded accuracy / mean prob, or acc / F1 / recall)
and the mean forward time as one JSON object, after a ``kernel launches``
line (each hand-written kernel's launches in the run). A checkpoint directory
without tokenizer files (or a machine without ``transformers``) gets the
train CLI's smoke tokenizer, a word hash.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--pretrain", default=None,
                   help="base checkpoint dir; defaults to --pm_path (full-FT mode)")
    p.add_argument("--pm_path", required=True)
    p.add_argument("--model_type", default="phi3v", choices=["phi3v", "qwen", "llava"])
    p.add_argument("--dataset", required=True)
    p.add_argument("--dataset_probs", default=None)
    p.add_argument("--image_root", default=None)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--micro_batch_size", type=int, default=8)
    p.add_argument("--seq_len", "--max_len", type=int, default=2944)
    p.add_argument("--num_workers", type=int, default=8)
    # the reference loads the projector conditionally
    # (reward_adaptor_loader.py:98-104): --no-ft_projector skips it
    p.add_argument("--ft_projector", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--attn_impl", default="auto", choices=["auto", "pallas", "plain", "xla"])
    p.add_argument("--load_in_8bit", action="store_true", default=False,
                   help="W8A8 decoder: the card's int8 GEMM and quantizing epilogues; "
                   "LoRA is merged before quantization")
    p.add_argument("--load_in_4bit", action="store_true", default=False,
                   help="weight-only nf4 decoder (the reference's --load_in_4bit; "
                   "memory, not speed)")
    # the reference's ft-phi harness (batch_inference_rm_ft_phi.py:28-55):
    # full-FT checkpoints load straight from pm_path, and the reward config
    # may be given here instead of reward_config.yaml
    p.add_argument("--full_ft", action="store_true",
                   help="load a full-finetune checkpoint from pm_path (no lora/)")
    p.add_argument("--cls_based", action="store_true",
                   help="force the pointwise classification path")
    p.add_argument("--is_general_preference", action="store_true", default=None)
    p.add_argument("--add_cross_attention", action="store_true", default=None)
    p.add_argument("--value_head_dim", type=int, default=None)
    p.add_argument("--general_preference_tau", type=float, default=None)
    p.add_argument("--is_custom_dataset", action="store_true",
                   help="accepted for the reference CLI's sake (the format is sniffed)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def hash_tokenizer(dec):
    """The smoke tokenizer of the JAX eval CLI (``eval_batch_inference.py:
    86-112``): ``hash()`` of each word, so ids differ between processes
    (PYTHONHASHSEED); only one process's runs compare."""

    class _Tok:
        eos_token = "</s>"
        pad_token_id = dec.pad_token_id

        def __call__(self, text):
            return {"input_ids": [hash(t) % 500 + 3 for t in text.split()]}

        def apply_chat_template(self, msgs, tokenize=False, add_generation_prompt=True):
            def flat(c):
                if isinstance(c, str):
                    return c
                return " ".join(("<img>" if p.get("type") == "image" else p.get("text", ""))
                                for p in c)

            return ("x" * 58 + " " + " ".join(flat(m["content"]) for m in msgs) + " "
                    + "x" * 22)

    return _Tok()


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.pretrain is None:
        args.pretrain = args.pm_path  # full-FT layout: base + head in one dir

    import torch

    from .core.registry import get_family
    from .data.datasets import blending_datasets
    from .evalx.adaptor import load_reward_adaptor
    from .evalx.batch_inference import batch_rm_inference

    family = get_family(args.model_type)
    quant = "w8a8" if args.load_in_8bit else ("nf4" if args.load_in_4bit else None)
    adaptor = load_reward_adaptor(
        args.pretrain, args.pm_path, model_type=args.model_type,
        ft_projector=args.ft_projector and not args.full_ft,
        compute_dtype=torch.bfloat16, quantize=quant, device=args.device,
    )
    # reward-config overrides (the reference passes these for ft checkpoints)
    for name in ("is_general_preference", "add_cross_attention", "value_head_dim",
                 "general_preference_tau"):
        if getattr(args, name) is not None:
            setattr(adaptor.rcfg, name, getattr(args, name))
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.pretrain, trust_remote_code=True)
        family.tokenizer_setup(tokenizer)
    except (ImportError, OSError, ValueError):
        # a checkpoint dir without tokenizer files (e.g. a bare full-FT save),
        # or no transformers: the train CLI's smoke fallback
        print(f"no tokenizer for {args.pretrain}; using the hash tokenizer (smoke)")
        tokenizer = hash_tokenizer(family.decoder_cfg(adaptor.cfg))
    processor = family.make_processor(tokenizer, adaptor.cfg)

    rows, _ = blending_datasets(args.dataset, args.dataset_probs, return_eval=False,
                                max_count=args.max_samples or 2_000_000)
    metrics = batch_rm_inference(
        adaptor, rows, tokenizer, processor,
        batch_size=args.micro_batch_size, seq_len=args.seq_len,
        max_samples=args.max_samples, num_workers=args.num_workers,
        image_root=args.image_root, attn_impl=args.attn_impl,
        profile_dir=args.profile_dir, cls_based=args.cls_based,
    )
    from .utils.profiling import kernel_launches

    print("kernel launches " + json.dumps(kernel_launches()))
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
