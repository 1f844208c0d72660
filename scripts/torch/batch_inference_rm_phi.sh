#!/usr/bin/env bash
# Pairwise batch eval on the bundled sample data with the PyTorch port (H100):
# the twin of scripts/batch_inference_rm_phi.sh. PYTHON picks the interpreter.
set -e
"${PYTHON:-python}" -m llava_reward_torch.eval_batch_inference \
  --model_type phi3v \
  --pretrain "${PRETRAIN:-microsoft/Phi-3.5-vision-instruct}" \
  --pm_path "${PM_PATH:?set PM_PATH to a reward artifact dir}" \
  --dataset data/sample_test/pairwise_sample.json \
  --image_root . --micro_batch_size 4 "$@"
