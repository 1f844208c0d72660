#!/usr/bin/env bash
# LLaVA-v1.6 batch eval with the PyTorch port (H100): the twin of
# scripts/batch_inference_rm_llava.sh (its sample config is the non-pairwise
# dataset; the harness sniffs the format and switches to pointwise metrics).
# PYTHON picks the interpreter.
set -e
"${PYTHON:-python}" -m llava_reward_torch.eval_batch_inference \
  --model_type llava \
  --pretrain "${PRETRAIN:-llava-hf/llava-v1.6-vicuna-13b-hf}" \
  --pm_path "${PM_PATH:?set PM_PATH to a reward artifact dir}" \
  --dataset "${DATASET:-data/sample_test/non_pairwise_sample.json}" \
  --image_root . --max_samples 500000 --micro_batch_size 1 "$@"
