#!/usr/bin/env bash
# Qwen2.5-VL-7B GPM LoRA reward training on the PyTorch port (H100): the twin
# of scripts/run_train_rm_single_lora_qwen.sh, with its flags and defaults.
# Runs NPROC processes on this host through torchrun (default 1);
# --zero_stage 3 puts them on the fsdp axis. PYTHON picks the interpreter.
set -e
"${PYTHON:-python}" -m torch.distributed.run --standalone --nproc_per_node "${NPROC:-1}" \
  -m llava_reward_torch.train_llava_reward \
  --model_type qwen \
  --pretrain "${PRETRAIN:-Qwen/Qwen2.5-VL-7B-Instruct}" \
  --dataset "${DATASET:-data/imagereward_train.json}" \
  --image_root "${IMAGE_ROOT:-.}" \
  --is_general_preference --value_head_dim 2 --general_preference_tau 0.1 \
  --add_cross_attention \
  --lora_rank 128 --lora_alpha 256 \
  --bf16 --gradient_checkpointing --flash_attn \
  --micro_train_batch_size 2 --accumulated_gradient 8 \
  --learning_rate 2e-4 --max_epochs 2 --zero_stage 3 \
  --seq_len 1792 \
  --save_path ./ckpt/qwen25vl_rm --ckpt_path ./ckpt/qwen25vl_rm/resume "$@"
