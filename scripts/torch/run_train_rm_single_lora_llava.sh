#!/usr/bin/env bash
# LLaVA-v1.6-vicuna-13B LoRA reward training on the PyTorch port (H100): the
# twin of scripts/run_train_rm_single_lora_llava.sh (its GPM config), with its
# flags and defaults. Runs NPROC processes on this host through torchrun
# (default 1). PYTHON picks the interpreter.
set -e
"${PYTHON:-python}" -m torch.distributed.run --standalone --nproc_per_node "${NPROC:-1}" \
  -m llava_reward_torch.train_llava_reward \
  --model_type llava \
  --pretrain "${PRETRAIN:-llava-hf/llava-v1.6-vicuna-13b-hf}" \
  --dataset "${DATASET:-data/imagereward_train.json}" \
  --image_root "${IMAGE_ROOT:-.}" \
  --is_general_preference --value_head_dim 2 --general_preference_tau 0.1 \
  --freeze_vision_model --ft_projector \
  --lora_rank 128 --lora_alpha 256 --lora_dropout 0.05 \
  --bf16 --gradient_checkpointing --flash_attn \
  --micro_train_batch_size 1 --accumulated_gradient 1 \
  --learning_rate 2e-4 --max_epochs 1 --max_len 2048 \
  --zero_stage 2 --group_size 1 --train_split_ratio 1 \
  --save_best_model 2 --save_steps 500 --logging_steps 1 \
  --save_path ./ckpt/llava16_rm --ckpt_path ./ckpt/llava16_rm/resume "$@"
