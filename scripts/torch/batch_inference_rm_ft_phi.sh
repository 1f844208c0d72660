#!/usr/bin/env bash
# Full-finetune Phi-3.5-V eval (MJ-Bench config) with the PyTorch port (H100):
# the twin of scripts/batch_inference_rm_ft_phi.sh. Loads a full-FT checkpoint
# directly from --pm_path (no LoRA adaptor), GPM dim-2 + SkipCA, tau 0.1.
# PYTHON picks the interpreter.
set -e
"${PYTHON:-python}" -m llava_reward_torch.eval_batch_inference \
  --model_type phi3v --full_ft \
  --pm_path "${PM_PATH:?set PM_PATH to a full-FT checkpoint dir}" \
  --dataset "${DATASET:-data/MJBench/mjbench_quality.json}" \
  --image_root . --max_samples 1000000 --micro_batch_size 1 \
  --is_general_preference --value_head_dim 2 --add_cross_attention \
  --general_preference_tau 0.1 "$@"
