#!/usr/bin/env bash
# Qwen2.5-VL pairwise batch eval with the PyTorch port (H100): the twin of
# scripts/batch_inference_rm_qwen.sh (add --cls_based for non-pairwise
# classification datasets). PYTHON picks the interpreter.
set -e
"${PYTHON:-python}" -m llava_reward_torch.eval_batch_inference \
  --model_type qwen \
  --pretrain "${PRETRAIN:-Qwen/Qwen2.5-VL-7B-Instruct}" \
  --pm_path "${PM_PATH:?set PM_PATH to a reward artifact dir}" \
  --dataset "${DATASET:-data/sample_test/pairwise_sample.json}" \
  --image_root . --max_samples 500000 --micro_batch_size 1 "$@"
