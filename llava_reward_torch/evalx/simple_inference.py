"""Quick start: score images for one prompt (``llava_reward_tpu/evalx/
simple_inference.py``; the reference's README example / eval/simple_inference.py).

    python -m llava_reward_torch.evalx.simple_inference \\
        --pretrain <hf_phi35v_dir> --pm_path <reward_artifact_dir> \\
        --caption "a photo of an astronaut riding a horse" \\
        --images img1.jpg img2.jpg [--device cuda]
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--pretrain", required=True)
    p.add_argument("--pm_path", required=True)
    p.add_argument("--caption", required=True)
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--seq_len", type=int, default=2944)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch
    from transformers import AutoTokenizer

    from ..preprocess.phi3v_processor import Phi3VProcessor
    from ..reward.preference import preference_prob
    from .adaptor import load_reward_adaptor
    from .batch_inference import score_user_input

    adaptor = load_reward_adaptor(args.pretrain, args.pm_path, compute_dtype=torch.bfloat16,
                                  device=args.device)
    tokenizer = AutoTokenizer.from_pretrained(args.pretrain, trust_remote_code=True)
    tokenizer.padding_side = "left"
    processor = Phi3VProcessor(tokenizer, num_crops=adaptor.cfg.num_crops)

    rewards = score_user_input(adaptor, tokenizer, processor, args.caption, args.images,
                               seq_len=args.seq_len)
    print("rewards:", rewards)
    if len(args.images) == 2:
        r = torch.from_numpy(rewards)
        prob = preference_prob(r[:1], r[1:2], is_general_preference=adaptor.rcfg.is_general_preference,
                               value_head_dim=adaptor.rcfg.value_head_dim,
                               tau=adaptor.rcfg.general_preference_tau)
        print(f"P(image1 preferred over image2) = {float(prob[0]):.4f}")


if __name__ == "__main__":
    main()
