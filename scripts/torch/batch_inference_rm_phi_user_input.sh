#!/usr/bin/env bash
# "Try with your few samples" (reference README.md:64) with the PyTorch port
# (H100): score 2 images; the twin of scripts/batch_inference_rm_phi_user_input.sh.
# PYTHON picks the interpreter.
set -e
"${PYTHON:-python}" -m llava_reward_torch.evalx.simple_inference \
  --pretrain "${PRETRAIN:-microsoft/Phi-3.5-vision-instruct}" \
  --pm_path "${PM_PATH:?set PM_PATH}" \
  --caption "${CAPTION:-a curious cat exploring a haunted mansion}" \
  --images data/sample_test/sample_img/0_good.png data/sample_test/sample_img/0_bad.png "$@"
