#!/usr/bin/env bash
# Phi-3.5-V FULL-FINETUNE GPM reward training (no LoRA: --lora_rank 0) on the
# PyTorch port (H100): the twin of scripts/run_train_rm_single_lora_ft.sh,
# with its flags and defaults. Runs NPROC processes on this host through
# torchrun (default 1). PYTHON picks the interpreter.
set -e
"${PYTHON:-python}" -m torch.distributed.run --standalone --nproc_per_node "${NPROC:-1}" \
  -m llava_reward_torch.train_llava_reward \
  --model_type phi3v \
  --pretrain "${PRETRAIN:-microsoft/Phi-3.5-vision-instruct}" \
  --dataset "${DATASET:-data/imagereward_train.json}" \
  --image_root "${IMAGE_ROOT:-.}" \
  --is_general_preference --value_head_dim 2 --general_preference_tau 0.1 \
  --add_cross_attention --freeze_vision_model \
  --lora_rank 0 --lora_alpha 0 --lora_dropout 0 \
  --bf16 --gradient_checkpointing --flash_attn \
  --micro_train_batch_size 8 --accumulated_gradient 4 \
  --learning_rate 5e-7 --max_epochs 1 --max_len 2048 \
  --zero_stage 2 --group_size 1 --train_split_ratio 1 \
  --save_best_model 2 --save_steps 500 --logging_steps 1 \
  --save_path ./ckpt/phi35v_rm_ft --ckpt_path ./ckpt/phi35v_rm_ft/resume "$@"
