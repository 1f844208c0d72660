#!/usr/bin/env bash
# Phi-3.5-V GPM LoRA reward training on the PyTorch port (H100): the twin of
# scripts/run_train_rm_single_lora_phi.sh, with its flags and defaults
# (LoRA r=128 a=256, SkipCA, GPM dim-2, bf16, grad ckpt, cosine+3% warmup).
# Runs NPROC processes on this host through torchrun (default 1);
# --zero_stage 3 puts them on the fsdp axis. PYTHON picks the interpreter.
#
# CLS=1 selects the pointwise safety-classifier variant (the reference's
# commented config, run_train_rm_single_lora_phi.sh:63-92): it drops
# --is_general_preference and uses value_head_dim 1 + --cls_based.
set -e
PRETRAIN=${PRETRAIN:-microsoft/Phi-3.5-vision-instruct}
DATASET=${DATASET:-data/imagereward_train.json}
if [ "${CLS:-0}" = "1" ]; then
  HEAD_FLAGS=(--cls_based --value_head_dim 1)
else
  HEAD_FLAGS=(--is_general_preference --value_head_dim 2 --general_preference_tau 0.1)
fi
"${PYTHON:-python}" -m torch.distributed.run --standalone --nproc_per_node "${NPROC:-1}" \
  -m llava_reward_torch.train_llava_reward \
  --model_type phi3v \
  --pretrain "$PRETRAIN" \
  --dataset "$DATASET" \
  --image_root "${IMAGE_ROOT:-.}" \
  "${HEAD_FLAGS[@]}" \
  --add_cross_attention --ft_projector \
  --lora_rank 128 --lora_alpha 256 --lora_dropout 0.05 \
  --bf16 --gradient_checkpointing --flash_attn \
  --micro_train_batch_size 4 --accumulated_gradient 4 \
  --learning_rate 2e-4 --max_norm 1.0 --max_epochs 2 \
  --zero_stage 3 --seq_len 2944 \
  --save_path ./ckpt/phi35v_rm --ckpt_path ./ckpt/phi35v_rm/resume \
  --logging_steps 10 --save_steps 500 "$@"

# CLS example — synthetic UnsafeBench-schema data ships at data/Unsafebench/:
#   CLS=1 DATASET=data/Unsafebench/Unsafebench_cap_train.json IMAGE_ROOT=data \
#     scripts/torch/run_train_rm_single_lora_phi.sh
