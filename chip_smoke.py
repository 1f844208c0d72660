#!/usr/bin/env python3
"""Drive the PyTorch port's reward scoring and training paths on one CUDA card.

Phases, each printing its own lines; any failure exits non-zero:
  1. the card: nvidia-smi name and power limit, torch / CUDA versions;
  2. build the hand-written CUDA kernels from llava_reward_torch/csrc/ and
     print each kernel's registers and spills as ptxas reports them;
  3. hold each kernel against its plain PyTorch version on the card, in
     bf16, at the serving path's shapes (with left-padded rows), and time
     kernel, plain version and one library call beside the card's bound;
     The W8A8 kernels (B4-B7) are checked the same way at the W8A8 path's
     B=8 shapes (M = 20480 rows); the LayerNorm quantizing epilogue (B9) and
     the GEMM at the CLIP tower's shapes (87040 and 21760 rows of 1024 / 4096);
     B4 and B9 timed two ways (CUDA events over 100 launches, the profiler's
     device time), beside the replaced kernels' times and torch's rms_norm /
     layer_norm alone; the norm kernel (the norm mode of the same template,
     every bf16 RMSNorm / LayerNorm on the card) at the CLIP, Phi-3, Qwen
     tower and LLaVA shapes against the plain code, with its bound, its
     device time and torch's fused norm beside;
     the GEMM on K-major weights, as every W8A8 leaf is laid out, with
     torch._int_mm on the same weights plus the scale epilogue as its library
     call; the B3 and GEMM rows print the replaced kernels' times beside theirs;
     the backward (B8) in its segment and key-mask modes at the Qwen2.5-VL
     vision tower's full blocks (2, 16, 1280, 80; 272 pad patches in one row,
     g kept on the pad queries) and in left-pad mode at its decoder's GQA
     shape (2, 28/4, 1792, 128); B8 also runs twice on the same inputs (its
     fp32 sums take the order blocks finish: the largest difference is
     printed) and its three launches are timed apart with torch.profiler;
     B1, B3 and B8 also give a scale-bias reading r, the projection of the
     kernel's error on the direction a 1 % softmax-scale change moves the
     plain version's output, held to SCALE_BIAS_TOL; last, the kernels at
     the LLaVA-NeXT-13B decoder's shapes (B1 and B8 at 40 heads x 128 MHA,
     RoPE, causal, seq 2976, B1's shared memory at head_dim 128 held to the
     card's limit, B1 timed at B=8 too; B4, B5 and the GEMM at 8 x 2976 rows
     of 5120 / 13824); and at this slice's new callers' shapes: B3's segment
     mode over a video's four temporal slices (2, 16, 5120, 80), the
     dynamic GEMM at the W8A8 LoRA steps' rows (qwen 2 x 1792, LLaVA
     2 x 2976), and _Int8LinearCore there (forward through B6 + the GEMM,
     backward on the tensor cores against the fp32 product); B5 in its
     tensor-parallel modes at a tp-2 rank's shapes of a B=8 request (qwen's
     MLP I 9472), and the two ranks' codes together against the kernel's
     own whole-row codes, bit for bit, for B5 and for B6 (LLaVA down_proj
     K 6912, qwen o_proj K 1792); and, first of the phase, B6 in each of its
     three modes (whole rows, the raw absmax, the codes on a given amax) at
     every shape the main paths give it (row_quant_shapes: the W8A8
     decoders' o_proj, the W8A8 CLIP tower's out and fc2, LoRA over a W8A8
     decoder, a tp-2 rank's o and down blocks), bit for bit against its
     plain versions, timed by
     CUDA events, by the profiler's device time, by the wrapper's host
     microseconds a call, beside the bound, the plain version and (absmax)
     vector_norm;
  [entry] the single-chip compile check as a user calls it:
     llava_reward_torch.dryrun.entry() on the card (Phi-3.5-vision at full
     width cut to 2 decoder and 2 CLIP layers, 4 crops, bf16 weights from
     seeds 0 and 1, one row of seq 512), fn(*example_args) once: a finite
     reward, and the launches counted from zero, B1 in the active CLIP
     layers, B2 x3 and B3 in each decoder layer; beside it, python -m
     llava_reward_torch.dryrun entry as a subprocess, exit 0 with a finite
     reward and the same launches;
  4. serve requests at full Phi-3.5-vision width (random bf16 weights from a
     fixed seed, GPM dim 2 + SkipCA) through RewardAdaptor.make_score_fn():
     one pair at B=2 (one side left-padded: B2 + B3 in the decoder) and four
     pairs at B=8, seq 2560, 16+1 crops (B1 in the decoder); B1 runs in the
     CLIP tower for both. The launch counters must show every kernel on
     that path, and the B=2 rewards must match the same forward through the
     plain versions; a value head on the requests' two principal
     directions, and every pair's decision the same on the kernels, the
     plain versions and the reference attention (and, in phase 5, in bf16,
     the decoder W8A8 and the tower W8A8 too);
  5. the same requests with the decoder quantized W8A8 on the card
     (--load_in_8bit; CLIP stays bf16): B4 x2, B5, B6 and four int8 GEMMs per
     decoder layer, counted and checked the same way; then with the CLIP
     tower quantized W8A8 as well (quantize_stacked_layers on clip["layers"]):
     per request B9 x2, two pre-quantized GEMMs (one fused qkv, fc1) and two
     dynamic ones (out, fc2: B6 + GEMM) in each of the 23 active layers, B1
     as before; and the tower alone from one input through the kernels
     against the plain versions, worst crop;
  [data] the data/sample_test pairs from their PNG files through the port's
     Phi3VProcessor(num_crops=16) (the smoke's own tokenizer), collate_samples
     and to_reward_batch, scored through phase 4's tree in the three pixel
     modes (host f32 bank; u8 crops, normalised and globally resized on the
     card; decoded u8 originals, resized on the card too): hd_resize_u8_bank
     on the card against the host's crops byte for byte, prepare_pixel_bank
     against the host f32 bank within BANK_TOL, the modes' rewards against
     each other; the same device checks on seeded synthetic geometries, and a
     16x1 panorama with a two-image prompt scored on the host-bank fallback.
     Host preparation, device pixel (CUDA events) and score times printed;
  [http] phase 4's tree behind the port's HTTP server (RewardService,
     max_batch 8, seq 2560, 10 ms batch window, ThreadingHTTPServer on
     127.0.0.1): /healthz, /score_pair on two sample PNG paths, /score on two
     base64 images, four /score_pair requests queued behind a one-image
     request that holds the card (one B=8 device call), four more at once
     free-running; every answer's rewards bit-equal to make_score_fn on the
     same collated samples, the decisions the same across call shapes;
  [load] a 2-layer full-width Phi-3.5-vision base checkpoint (HF keys, the
     published config.json at 2 layers) and a reward artifact (LoRA r=128,
     heads, projector) written to a temporary directory, read back through
     load_reward_adaptor in bf16 and W8A8: the tree leaf for leaf against the
     written one after the merge, the sample pairs' rewards against the same
     tree built in memory, B4-B7 launched by the W8A8 load; the same for
     Qwen2.5-VL-7B with 2 decoder layers and the whole tower, bf16. Load time
     and bytes read printed;
  [eval] batch_rm_inference on the sample rows (4 pairs, one stacked B=8
     call; 8 pointwise rows) on phase 4's tree, rewards against [data]'s u8
     request; the pairwise run again with a torch.profiler trace, its device
     time summed by kernel; then the command lines as subprocesses: python -m
     llava_reward_torch.eval_batch_inference over [load]'s phi3v checkpoint in
     bf16 and with --load_in_8bit, python -m llava_reward_torch.train_llava_reward
     in its smoke mode on the card (--bf16: the tiny config's head_dim 16
     and 8 run B3 / B8 zero-padded to 64), the eval CLI on the artifact it
     wrote, and the train CLI over [load]'s checkpoint (a word tokenizer
     written beside it) with --load_in_8bit --bf16 --gradient_checkpointing;
     the port's launch scripts over [load]'s checkpoint:
     scripts/torch/batch_inference_rm_phi.sh (its metrics, the pairwise
     decisions among them, against the bf16 eval CLI's, both tokenizing with
     one PYTHONHASHSEED) and scripts/torch/batch_inference_rm_phi_user_input.sh
     (two finite rewards); each command line's own kernel launches, as it
     prints them;
  [dist] the train CLI on more than one process, as subprocesses over
     [load]'s checkpoint (bf16 LoRA, SkipCA, the projector, remat; eight
     sample pairs in two steps of four, two held out): (a) one rank over
     NCCL, micro batch 4; (b) two ranks sharing this card over gloo
     (--mesh_fsdp 2, card tensors staged through host memory), micro batch
     2 each; (a') the CLI with no distributed environment. (a')'s first loss
     equals (a)'s bit for bit (the control); (b)'s ranks agree exactly, their
     rows partition the train rows, each step's loss and grad_norm are
     (a)'s within one bf16 step, each rank holds half of the decoder's
     sharded layer bytes, rank 0 alone writes the artifact, whose heads and
     LoRA are (a)'s within two AdamW steps' reach; each process's own
     launches of B1, B2, B3 and B8 checked exactly; backends, s/step and
     peak memory beside the card's name and power limit;
  [tp] tensor parallelism over the mesh's tp axis on two ranks sharing this
     card over gloo (a correctness check: every tp all-reduce is staged
     through host memory, so the times are no scaling figure): (i) the train
     CLI with --mesh_tp 2 on [dist] (a)'s rows and micro batch, the ranks
     agreeing exactly, each step's loss and grad_norm against (a)'s under
     [dist]'s bounds, each rank reading every row and holding half of the
     decoder's split layer bytes, its launches of B1, B2, B3 and B8 checked
     exactly against the head-group rule on its local heads; (ii) python -m
     llava_reward_torch.dryrun score of [load]'s tree (the LoRA merged, a
     principal-direction head) on two tp ranks at B=2 and B=8, rewards
     against one rank's under phase 4's bound with every decision the same;
     (iii) python -m llava_reward_torch.dryrun step of a Qwen2.5-VL-7B and a
     LLaVA-NeXT-13B LoRA step at full width (2 decoder layers, 2 vision
     blocks) on two tp ranks: the loss against one rank's, grad_norm
     against the same step in fp32, launches by the local-head rule; (iv)
     the train CLI with --mesh_tp 2 --load_in_8bit on (i)'s rows against one
     rank's --load_in_8bit run (the loss under [dist]'s bound, grad_norm
     under TP_W8A8_NORM_TOL), the ranks agreeing exactly, each rank holding
     half of the decoder's W8A8 code bytes, its
     launches of B6 (the row-split projections' inputs in the absmax and
     given-amax modes at K / 2) and of the GEMM counted and shaped (K / 2,
     N / 2) by the rule; (v) python -m llava_reward_torch.dryrun score of
     (ii)'s tree with the decoder W8A8 on two tp ranks at B=2 against one
     rank's W8A8 rewards under phase 4's bound, every decision the same, B4,
     B5 and B6 (in their tp modes) and the GEMM launched and shaped by the
     rule;
  5q. Qwen2.5-VL-7B at full width and depth (vision 32 x 1280, text 28 x
     3584; random bf16 weights built on the card from seed 0, the decoder's
     projections fused as the adaptor leaves them, GPM dim 2 + SkipCA)
     through RewardAdaptor(model_type="qwen").make_score_fn(): uint8 patches
     (normalised on the card) in the real window layout and M-RoPE
     positions, seq 1792, one 1280-patch image per sequence; one pair at
     B=2 (the rejected image 28 x 36 patches, so 272 pad slots among its
     1280, and its tokens left-padded by 40) and four pairs at B=8. Per
     request: B2 x3 + B3 in each decoder layer, B3's segment mode in the
     four full-attention vision blocks. The B=2 rewards against the plain
     route, beside the reference attention's drift from it. Then the
     decoder W8A8 (B4 x2, B5, o_proj's B6 + GEMM, four GEMMs per layer).
     From one input, the vision tower and decoder layer 0 (bf16, W8A8)
     through the kernels against the plain versions; a B=8 request's time
     split between the vision tower and the decoder layers. Then [video]:
     four pairs of seeded u8 videos (16 frames of 360 x 480 at video_fps 4:
     8 frames, grid (4, 26, 34), 884 video tokens) through
     Qwen25VLProcessor(videos=...), B=2 and B=8 on both trees, B3's segment
     mode over four ids in the full blocks, a value head on the video rows'
     principal directions, every decision the same across routes and trees;
  6. LoRA training at full width and depth (random bf16 backbone, fp32 heads
     and LoRA r=128, alpha=256 on qkv/o/gate_up/down, AdamW 2e-4 cosine with
     3 % warmup over 100 steps, remat on): one step through the kernels and
     the same step through the plain versions from one state (the loss, and
     the gradient of every trainable leaf and of every layer slice of the
     LoRA factors compared, beside the drift of the reference attention from
     the plain route; each route's one-number LoRA scale gradients held to
     dscale = <g_b, b> / scale on its own gradients), one decoder layer's
     gradients through the kernels against the plain versions (the
     reference attention's beside), five
     make_train_step steps on one
     pair (B=2, seq 2560, the rejected side left-padded; counted: B1 in CLIP,
     B2/B3 forward and remat recompute, B2 + B8 in every layer's backward),
     one 4-pair step (B=8, seq 2944: B1 in the decoder), one --train_vision
     step (CLIP LoRA: B3 + B8 in the tower; 4 decoder layers), and a
     RewardTrainer.fit of two steps whose artifact is read back; between
     them, the same LoRA over the decoder quantized W8A8 and NF4 on the card
     (a layer at a time): decoder layer 0's gradients through the kernels
     against the plain versions, the loss against the plain route, two
     steps with their launches (W8A8: B6 + the GEMM a projection, forward
     and remat recompute), s/step and peak beside bf16;
  6q. Qwen2.5-VL-7B training on the separate q/k/v, gate/up layout (LoRA rides
     there). LoRA at full width and depth: fp32 heads, LoRA r=128 on
     QWEN_TARGETS and the merger as --ft_projector's projector, remat on; the
     phase 5q pair (B=2, seq 1792, the rejected side left-padded by 40, 272 pad
     slots among its patches). One step through the kernels, the plain versions
     and the reference attention from one state; decoder layer 0 and one full
     vision block alone (gradients of the input and of the layer's own
     trainable leaves, kernels against plain versions); five make_train_step
     steps (counted: B3 in the four full vision blocks, B3 forward and remat
     recompute and B8 in left-pad mode at GQA 28/4 in each of the 28 layers, no
     B2: the separate layout ropes in torch); four more steps with the
     allocator's state after each and one under torch.profiler (the device's
     busy share, the kernels by device time); the same LoRA over the decoder
     W8A8 (seven projections a layer); one B=8 step; a two-step
     RewardTrainer.fit(model_type="qwen") whose artifact (heads, merger,
     QWEN_TARGETS adapters) is read back, merged, fused and scored through
     phase 5q's route. Then full fine-tuning through the vision tower: no LoRA,
     the whole backbone trainable, the decoder cut to 4 layers (the 7.8 B model
     with AdamW's moments does not fit one card), the tower at its 32 blocks
     and every width: B8's segment mode in the four full blocks, compared with
     the plain route the same way, then one make_train_step step;
  [llava] LLaVA-NeXT-13B at full width and depth (the configuration parsed
     from tools/manifests/llava_v16_vicuna_13b/config.json, random bf16
     weights; 4 pairs of seeded 672 x 672 images through LlavaNextProcessor,
     2928 image tokens a row, seq 2976; a value head on the top two
     principal directions of the rows' readout states): scoring on the fused
     layout in bf16 and with the decoder W8A8, B=2 (one side left-padded) and
     B=8, against the plain route at B=2, W8A8 against bf16 (rewards and
     every decision); decoder layer 0 through the kernels against the
     plain versions (bf16, W8A8); one decoder layer's LoRA gradients (B3 /
     B8 at 40 x 128 MHA); LoRA steps at B=2 (r=128, alpha 256 on
     QWEN_TARGETS, fp32 heads and LoRA, remat), with launch counts, s/step
     and the peak GiB, then the same over the decoder in W8A8 (the bf16
     layers released once quantized);
  7. one JSON line listing every kernel, then the result line.

Depths and repetitions are as in the earlier slices; the script's time has
room for the added phases (see PERF.md for the measured total).

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import base64
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib
from http.server import ThreadingHTTPServer

import numpy as np
import torch
from PIL import Image

from llava_reward_torch import dryrun
from llava_reward_torch.core.config import (LlavaNextConfig, RewardConfig, phi35_vision_config,
                                            phi3v_tiny_config, qwen25_vl_7b_config)
from llava_reward_torch.evalx import batch_inference
from llava_reward_torch.evalx.adaptor import (RewardAdaptor, cast_params, llava_config_from_pretrain,
                                              qwen_config_from_pretrain,
                                              load_reward_adaptor, merge_for_scoring)
from llava_reward_torch.evalx.server import RewardService, _load_image, make_handler
from llava_reward_torch.io import artifact, hf_phi3v, hf_qwen
from llava_reward_torch.io.torch_io import save_torch_state_dict
from llava_reward_torch.lora.lora import (DEFAULT_TARGETS, QWEN_TARGETS, init_lora,
                                          init_vision_lora, peft_adapter_config,
                                          peft_state_to_stacked, stacked_to_peft_state)
from llava_reward_torch.models import clip_vit, llava_next, phi3, phi3v, qwen25_vl
from llava_reward_torch.models.clip_vit import layer_slice
from llava_reward_torch.ops import cuda_lib
from llava_reward_torch.ops import flash_attention as fa
from llava_reward_torch.ops import int8_matmul as im
from llava_reward_torch.ops import norms
from llava_reward_torch.ops import quant_epilogue as qe
from llava_reward_torch.ops.pixels import hd_resize_u8_bank, prepare_pixel_bank
from llava_reward_torch.ops.rope import rope_cos_sin_for_config
from llava_reward_torch.parallel.sharding import create_mesh
from llava_reward_torch.preprocess import native
from llava_reward_torch.preprocess.collate import (collate_qwen_samples, collate_samples,
                                                   to_reward_batch)
from llava_reward_torch.preprocess.llava_processor import (LlavaNextProcessor,
                                                           apply_llava_chat_template)
from llava_reward_torch.preprocess.phi3v_processor import (Phi3VProcessor,
                                                           apply_phi3v_chat_template,
                                                           build_img_gather_idx,
                                                           host_bank_from_u8)
from llava_reward_torch.preprocess.qwen_vision import (Qwen25VLProcessor,
                                                       apply_qwen_chat_template,
                                                       sample_from_patches, windowize)
from llava_reward_torch.reward import heads
from llava_reward_torch.reward.model import RewardBatch, init_head_params, reward_forward
from llava_reward_torch.reward.preference import preference_prob
from llava_reward_torch.train.optim import make_optimizer, tree_leaves, tree_map
from llava_reward_torch.train.train_step import (PROJECTOR_PATHS, assemble_params,
                                                 init_train_state, make_pairwise_loss_fn,
                                                 make_train_step)
from llava_reward_torch.train.trainer import RewardTrainer
from llava_reward_torch.utils.profiling import kernel_launches as launches
from llava_reward_torch.utils.quantize import (W8A8_KEY, int8_linear, quantize_array_w8a8,
                                               quantize_stacked_layers)

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores (data sheet)
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# attention: |kernel - plain| <= ATTN_ATOL + ATTN_RTOL * |plain| on valid rows,
# about one bf16 ulp (2^-7 relative): the two round the probabilities at
# different points (online vs full-row softmax), and the output to bf16
ATTN_ATOL, ATTN_RTOL = 8e-3, 2 ** -7
ATTN_TOL_TEXT = f"{ATTN_ATOL:g} + {ATTN_RTOL:g}*|plain|"
PREP_TOL = 0.0  # rope in fp32 with one rounding on both sides: bit-exact
REWARD_TOL = 5e-3  # bf16 forward through 55 attention layers, |reward| ~ 2e-2
# Qwen2.5-VL-7B: 32 vision blocks and 28 decoder layers in bf16; the printed
# drift floor (the reference attention against the plain route) sits below
# it. With the decoder W8A8 every layer requantizes its activations four
# times: where the two routes' bf16 values differ by an ulp next to a code
# boundary, a code flips (amax/127 on a row) and the next layers carry it.
# The reference attention stood 4.6e-03 from the plain route there, the
# kernels 8.7e-03, on rewards of ~1-2e-02, all with the same decision; the
# end-to-end bound is set at the rewards' own size, and the sharp checks are
# the vision tower and decoder layer 0 at full width from one input (the
# worst batch row's relative L2 error of the output, or of the layer's
# update): bf16 1.7e-02 and 6.3e-03, with the reference attention at
# 1.7e-02 and 7.8e-03; W8A8 3.3e-02, the reference 3.7e-02 (its code flips).
# A run with B3's mask row dropped put the vision tower's padded row at 0.106
# from the plain route; with the left pad dropped, layer 0's padded row at
# 0.539.
QWEN_REWARD_TOL, QWEN_W8A8_REWARD_TOL = 5e-3, 2e-2
QWEN_PART_TOL, QWEN_W8A8_PART_TOL = 5e-2, 0.1
QWEN_GRIDS = ((1, 32, 40), (1, 28, 36))  # 1280 and 1008 patches in a 1280-patch budget
QWEN_SEQ, QWEN_PATCHES, QWEN_UNITS = 1792, 1280, 320
# B4 sums x^2 in another order than its plain version: a value at a rounding
# boundary may take the neighbouring code. B5: the JAX package's rule for
# sigmoid's rounding (tests/test_quant_epilogue.py). B6 and B7 are exact.
# B9 sums x and xc^2 in another order, like B4.
CODE_SHARE = {"rms_quant": 1e-3, "silu_mul_quant": 0.02, "row_quant": 0.0, "ln_quant": 1e-3,
              "row_quant_given": 0.0, "silu_mul_quant_given": 0.02}
# Phi-3.5-vision with the CLIP tower W8A8 too: 23 more layers requantize their
# activations four times each, and a flipped code in the tower moves an image
# feature that every decoder layer then reads. The end-to-end bound is set at
# the rewards' own size (~2e-2), as for Qwen's W8A8 decoder; the drift floor
# is printed beside the gap, and the sharp check is the tower alone from one
# input (worst crop's relative L2 error of the patch features).
TOWER_REWARD_TOL, TOWER_PART_TOL = 2e-2, 0.1
# a trained Qwen artifact read back, merged into the bf16 weights, fused and
# scored through the serving route (B2 x3 + B3, rope in the kernel, bf16 heads)
# against the trained tree's inline adapters on the training layout (rope in
# torch, fp32 heads): two bf16 routes through 60 layers, so the bound is the
# rewards' own size; the merge itself is held to 2e-5 in fp32 on the CPU
# (tests/test_torch_lora.py)
ARTIFACT_SCORE_TOL = 2e-2
# B8: |kernel - plain| <= BWD_RTOL*|plain| + BWD_ATOL_SHARE*max|plain| per gradient
# (dq on live rows): one bf16 ulp of the output, plus the rare bf16 rounding
# of p or ds that the two take on either side of a boundary
BWD_RTOL, BWD_ATOL_SHARE = 2 ** -7, 2 ** -8
BWD_TOL_TEXT = f"{BWD_RTOL:g}*|plain| + {BWD_ATOL_SHARE:g}*max|plain|"
# one training step through the kernels against the same step through the
# plain versions: |loss gap|, each trainable leaf's relative L2 gradient
# error, and the same error per layer slice of the stacked LoRA a / b leaves.
# Through 32 random bf16 layers any two attention routes drift apart, and
# every gradient inherits the drift: the reference attention (attn_impl=
# "xla", no kernel and no plain version) stands 0.1-0.2 from the plain
# route on every leaf and every layer slice; the step prints that floor
# beside the kernels' error. The slice bound sits above the floor and below
# 1, the error of a layer whose attention gradient is cut. The sharp check
# is one decoder layer at full width, same input and upstream gradient: the
# gradients of its input and LoRA leaves through B2/B3/B8 against the plain
# versions (bf16 noise: ~5e-3 on the tensors).
# A layer's LoRA scale leaf is ONE number, <g_b, b> / scale in exact
# arithmetic for any route (LoRA applies x @ a @ b * scale): a sum with
# cancellation, whose relative error between two routes is noise (on an H100
# the reference attention read 0-0.57 on it over four seeds). So no route is
# held to another on it. Each route's scale gradient is held to that
# identity on its own b gradient instead, in fp64 (_scale_identity): within
# SCALE_IDENTITY_TOL x ||g_b,l|| ||b_l|| / |scale_l| per layer, which a cut
# or mis-wired scale gradient fails and cancellation cannot. The kernels'
# accuracy is carried by the tensor leaves (a, b, the inputs) against the
# plain route, and a wrong softmax scale by phase 3's scale-bias reading.
# The relative error and the conditioned error of the scale leaves
# (_scale_leaf_errors) are printed, for information.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_SLICE_TOL, LAYER_GRAD_TOL = 5e-3, 0.25, 0.3, 5e-2
# the identity's bound: on an H100 (tools/scale_leaf_readings.py --controls,
# seeds 0-3) every route read 2.8e-6-4.8e-5; a cut scale gradient read
# 9.9e-4-5.5e-3 in the one-layer check and 3.4e-3-1.1e-2 in the full-depth
# steps, a gradient taken from the next layer 5.6e-3-6.9e-2; 2e-4 sits 4.2x
# above the first and 4.9x below the least cut reading (PERF.md §6)
SCALE_IDENTITY_TOL = 2e-4
FLOOR_FACTOR = 1.5  # phase 6q: a leaf's bound is at least this times its own drift floor
# phase 3's scale-bias reading of B1, B3 and B8: with p(s) the plain version at
# the launch's softmax scale s and d = q(SCALE_STEP s) - q(s) on valid rows,
# r = <kernel - p(s), d> / <d, d> (fp64; B8 over dq, dk and dv together). q is
# the plain version on the same inputs widened to fp32 (B1, B3), so that d
# carries no bf16 rounding of the output; B8's outputs are fp32 already, and
# there q = p. A kernel whose scale is off by a factor (1 + e) reads about
# e / (SCALE_STEP - 1); rounding noise projects onto d to near 0 over millions
# of elements. With d taken from the bf16 outputs p instead, the sound B1
# and B3 read +0.016 to +0.037 at every seed: p's own output rounding sits in
# both kernel - p and d. Against an fp64 softmax kernel and plain version
# each read |r| <= 0.0016 (tools/scale_leaf_readings.py --fp64, PERF.md §6).
# On an H100 (--controls, seeds 0-3, every shape of phase 3) a planted x1.003
# read 0.303-0.315, x1.01 0.963-1.000, q/k in fp8 -0.12 to -0.18, B8 sound
# |r| < 1e-4. The bound sits 6.4x below x1.01; x1.003 reads 2x over it.
SCALE_STEP = 1.01
SCALE_BIAS_TOL = 0.15
LORA_R, LORA_ALPHA, LR, TOTAL_STEPS = 128, 256, 2e-4, 100
# LLaVA-NeXT-13B: 23 CLIP and 40 decoder layers; rewards of ~0.3 from the
# principal-direction head (_principal_head): bf16 kernels against the plain
# route held as the other families' are, the W8A8 decoder as qwen's, and W8A8
# against bf16 to LLAVA_W8A8_VS_BF16_TOL, each well below the rewards' size
LLAVA_REWARD_TOL = REWARD_TOL
LLAVA_W8A8_VS_BF16_TOL = 4e-2

KERNELS = {
    "fa_direct": dict(
        route="cuda", source="llava_reward_torch/csrc/flash_attention.cu",
        replaces="llava_reward_tpu/ops/flash_attention.py:975"),
    "prep": dict(
        route="cuda", source="llava_reward_torch/csrc/rope_transpose.cu",
        replaces="llava_reward_tpu/ops/flash_attention.py:849"),
    "fa_hm": dict(
        route="cuda", source="llava_reward_torch/csrc/flash_attention.cu",
        replaces="llava_reward_tpu/ops/flash_attention.py:45"),
    "rms_quant": dict(
        route="cuda", source="llava_reward_torch/csrc/quant_epilogue.cu",
        replaces="llava_reward_tpu/ops/quant_epilogue.py:46"),
    "silu_mul_quant": dict(
        route="cuda", source="llava_reward_torch/csrc/quant_epilogue.cu",
        replaces="llava_reward_tpu/ops/quant_epilogue.py:126"),
    "row_quant": dict(
        route="cuda", source="llava_reward_torch/csrc/quant_epilogue.cu",
        replaces="llava_reward_tpu/ops/quant_epilogue.py:183"),
    "int8_matmul": dict(
        route="cuda", source="llava_reward_torch/csrc/int8_matmul.cu",
        replaces="llava_reward_tpu/ops/int8_matmul.py:55"),
    "fa_bwd": dict(
        route="cuda", source="llava_reward_torch/csrc/flash_attention_bwd.cu",
        replaces="llava_reward_tpu/ops/flash_attention.py:375"),
    "ln_quant": dict(
        route="cuda", source="llava_reward_torch/csrc/quant_epilogue.cu",
        replaces="llava_reward_tpu/ops/quant_epilogue.py:32"),
    # B6's and B5's modes for a row split over tp ranks (the same kernels)
    "row_absmax": dict(
        route="cuda", source="llava_reward_torch/csrc/quant_epilogue.cu",
        replaces="llava_reward_tpu/ops/quant_epilogue.py:183"),
    "row_quant_given": dict(
        route="cuda", source="llava_reward_torch/csrc/quant_epilogue.cu",
        replaces="llava_reward_tpu/ops/quant_epilogue.py:183"),
    "silu_mul_absmax": dict(
        route="cuda", source="llava_reward_torch/csrc/quant_epilogue.cu",
        replaces="llava_reward_tpu/ops/quant_epilogue.py:126"),
    "silu_mul_quant_given": dict(
        route="cuda", source="llava_reward_torch/csrc/quant_epilogue.cu",
        replaces="llava_reward_tpu/ops/quant_epilogue.py:126"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def reset_counters() -> None:
    for mod in (fa, qe, im, norms):
        mod.reset_counters()


# the norm kernel's entries in launches() (ops/norms: every bf16 RMSNorm and
# LayerNorm on the card)
NORM_KERNELS = tuple(norms.LAUNCHES)


def _but_norms(counts):
    """``counts`` without the norm kernel's entries. The norm kernel runs on
    every route of a model, the plain and the reference attention's too, so
    a model's kernels-against-plain comparison holds it on both sides;
    check_norms (phase 3) alone holds it against the plain code."""
    return {k: v for k, v in counts.items() if k not in NORM_KERNELS}


def _norm_launches(cfg, w8a8=False, tower_w8a8=False, skipca=True, forwards=1):
    """The norm kernel's launches in ``forwards`` inference forwards of bf16
    weights (phi3v, Qwen2.5-VL or LLaVA-NeXT): CLIP's LayerNorms
    (pre_layernorm, and ln1 / ln2 of each active layer, which a W8A8 tower
    sends to B9), Qwen2.5-VL's tower RMSNorms (norm1 / norm2 a block, the
    merger's ln_q), the decoder's two a layer (B4's under W8A8) and its final
    norm, and SkipCA's (``skipca``: a bf16 head with add_cross_attention on a
    family that wires it)."""
    dec = cfg.decoder if hasattr(cfg, "decoder") else cfg.text
    rms, ln = (0 if w8a8 else 2 * dec.num_layers) + 1 + int(skipca), 0
    if hasattr(cfg.vision, "depth"):
        rms += 2 * cfg.vision.depth + 1
    else:
        ln = 1 + (0 if tower_w8a8 else 2 * cfg.vision.num_active_layers)
    return {"rms_norm": forwards * rms, "layer_norm": forwards * ln}


def _step_norms(cfg, steps=1, projector=False, vision_lora=False):
    """The norm kernel's launches in ``steps`` LoRA steps under remat, fp32
    heads and adapters over a frozen bf16 backbone. The frozen tower runs
    once a step with no gradient, so each of its norms takes the kernel
    (the merger's ln_q too, unless it is the trainable fp32 projector).
    Decoder layer 0's input norm reads the embeddings, which carry no
    gradient unless a trainable projector (``projector``) feeds them: it
    takes the kernel in the forward and again in the remat recompute; every
    norm after an adapter, and SkipCA's (an fp32 head), keeps the plain code.
    Under vision LoRA (``vision_lora``) only the tower's pre_layernorm and
    layer 0's ln1 (forward and recompute) read no gradient."""
    out = {"rms_norm": 0, "layer_norm": 0}
    if hasattr(cfg.vision, "depth"):
        out["rms_norm"] = 2 * cfg.vision.depth + (0 if projector else 1)
    else:
        out["layer_norm"] = 3 if vision_lora else 1 + 2 * cfg.vision.num_active_layers
    if not (projector or vision_lora):
        out["rms_norm"] += 2
    return {k: steps * v for k, v in out.items()}


def _cli_norms(cfg, steps, sides, projector):
    """The norm kernel's launches of a train CLI process: ``steps`` LoRA steps
    (``_step_norms``), then ``sides`` held-out forwards under no_grad with
    the adapters inline (a decoder's LoRA layers keep their norms off B4, so
    they take the norm kernel under W8A8 too) and the fp32 head (SkipCA's
    norm plain)."""
    st, ev = _step_norms(cfg, projector=projector), _norm_launches(cfg, skipca=False)
    return {k: steps * st[k] + sides * ev[k] for k in st}


# ------------------------------------------------------------------ phase 1


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ------------------------------------------------------------------ phase 2


def phase_build() -> None:
    t0 = time.perf_counter()
    cuda_lib.load()
    say("build", f"kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda_lib.build_seconds if cuda_lib.build_seconds is not None else 'cached'})")
    spilled = []
    for line in _ptxas_lines(cuda_lib.build_logs()):
        say("ptxas", line)
        if "error" not in line and " 0 bytes spill stores" not in line:
            spilled.append(line.split(":")[0])
    say("ptxas", f"kernels that spill: {', '.join(spilled) or 'none'}")


def _template_args(rest: str):
    """The template arguments at the head of ``rest`` (``I...E`` in the
    Itanium mangling): a type name, ``float`` or an integer literal each."""
    out, i = [], 1
    if not rest.startswith("I"):
        return out
    while i < len(rest) and rest[i] != "E":
        lit = re.match(r"L[a-z]+(n?\d+)E", rest[i:])
        num = re.match(r"\d+", rest[i:])
        if lit:
            out.append(lit.group(1).replace("n", "-"))
            i += lit.end()
        elif num:
            n = int(num.group(0))
            out.append(rest[i + num.end():i + num.end() + n])
            i += num.end() + n
        elif rest[i] == "f":
            out.append("float")
            i += 1
        else:
            break
    return out


def _kernel_name(mangled: str) -> str:
    """``norm_quant_kernel<__nv_bfloat16,1,4>`` from an Itanium-mangled kernel name."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group(0))):  # the run may end a previous name
            n = int(m.group(0)[i:])
            ident, rest = mangled[m.end():m.end() + n], mangled[m.end() + n:]
            if ident.endswith("_kernel") and len(ident) == n:
                targs = _template_args(rest)
                return ident + (f"<{','.join(targs)}>" if targs else "")
    return mangled


def _ptxas_lines(log: str):
    """One line per kernel from ptxas -v: its name, registers, barriers and
    shared memory, then its stack frame and spill stores / loads."""
    name, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = _kernel_name(m.group(1)), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            yield f"{name}: {line.split(':', 1)[1].strip()}; {spill}"
            name = None
        elif "error" in line:
            yield line.strip()


# ------------------------------------------------------------------ phase 3


def _pairs_allowed(S, kv_start, q_len, causal):
    """(query, key) pairs the masks leave open, summed over the batch."""
    n = 0
    for s0 in kv_start:
        if causal:
            m = min(S, q_len) - s0
            n += m * (m + 1) // 2
        else:
            n += S * (q_len - s0)
    return n


def _leftpad_rows(kv_start, S, device):
    rows = torch.arange(S, device=device)[None, :]
    return rows >= torch.as_tensor(kv_start, device=device)[:, None]


def _cos_sin(cfg, kv_start, S, device):
    mask = _leftpad_rows(kv_start, S, device).to(torch.int32)
    pos = torch.cumsum(mask, -1) - 1
    pos = torch.where(mask == 0, torch.ones_like(pos), pos)
    if hasattr(cfg, "text"):  # LLaVA-NeXT's vicuna rope: a degenerate M-RoPE
        return qwen25_vl._mrope_cos_sin(pos[None].expand(3, *pos.shape), cfg.text,
                                        torch.bfloat16)
    return rope_cos_sin_for_config(pos, cfg.decoder, dtype=torch.bfloat16)


def _sdpa_mask(kv_start, S, q_len, causal, device):
    k = torch.arange(S, device=device)
    ok = (k[None, :] < q_len) & (k[None, :] >= torch.as_tensor(kv_start, device=device)[:, None])
    ok = ok[:, None, None, :]
    if causal:
        ok = ok & (k[None, :] <= k[:, None])[None, None]
    return ok


def check_direct(name, gen, B, S, H, D, causal, rope, kv_start, q_len, cfg):
    dev = "cuda"
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device=dev, dtype=torch.bfloat16)
    cos = sin = None
    if rope:
        cos, sin = _cos_sin(cfg, kv_start, S, dev)
    kv = torch.tensor(kv_start, dtype=torch.int32, device=dev)
    kw = dict(n_heads=H, head_dim=D, causal=causal, sliding_window=None, scale=D ** -0.5,
              valid_len=q_len if q_len != S else None)
    run = lambda: fa._fused_qkv_attention_direct(qkv, cos, sin, kv, **kw)  # noqa: E731
    out = run()
    ref = fa.fa_direct_plain(qkv, cos, sin, kv, **kw)
    q32 = [fa.fa_direct_plain(qkv.float(), cos, sin, kv, **{**kw, "scale": kw["scale"] * f})
           for f in (1, SCALE_STEP)]
    torch.cuda.synchronize()
    valid = _leftpad_rows(kv_start, S, dev) & (torch.arange(S, device=dev) < q_len)[None]
    err, within = _attn_err(out[valid], ref[valid])
    r = _scale_bias([(out[valid], ref[valid], *(t[valid] for t in q32))])
    del q32
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(run)
    plain_ms = time_ms(lambda: fa.fa_direct_plain(qkv, cos, sin, kv, **kw), iters=2, warmup=1)
    # library yardstick: SDPA on the same roped q/k and v, same masks
    q = qkv[..., : H * D].reshape(B, S, H, D)
    k = qkv[..., H * D : 2 * H * D].reshape(B, S, H, D)
    v = qkv[..., 2 * H * D :].reshape(B, S, H, D)
    if rope:
        q, k = fa._rope_plain(q, cos, sin), fa._rope_plain(k, cos, sin)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    mask = _sdpa_mask(kv_start, S, q_len, causal, dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=D ** -0.5))
    flops = 4 * D * H * _pairs_allowed(S, kv_start, q_len, causal)
    nbytes = 2 * B * S * 3 * H * D + 2 * B * S * H * D + (4 * B * S * D if rope else 0)
    b_ms, b_by = bound_ms(flops, nbytes)
    return _report(name, "fa_direct", err, ATTN_TOL_TEXT, within, finite, ms, plain_ms, lib_ms, b_ms, b_by,
                   f"qkv {tuple(qkv.shape)} H={H} D={D} causal={causal} rope={rope} "
                   f"kv_start={kv_start if len(set(kv_start)) > 1 else f'[{kv_start[0]}]*{B}'} "
                   f"q_len={q_len}", r=r)


def check_prep_and_hm(gen, cfg):
    dev = "cuda"
    B, S, H, D = 2, 2560, 32, 96
    kv_start = [0, 300]
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device=dev, dtype=torch.bfloat16)
    cos, sin = _cos_sin(cfg, kv_start, S, dev)
    kw = dict(col_offset=0, n_heads=H, head_dim=D)
    q = fa.rope_transpose(qkv, cos, sin, **kw)
    k = fa.rope_transpose(qkv, cos, sin, col_offset=H * D, n_heads=H, head_dim=D)
    v = fa.rope_transpose(qkv, None, None, col_offset=2 * H * D, n_heads=H, head_dim=D)
    errs = [
        (q.float() - fa.rope_transpose_plain(qkv, cos, sin, **kw).float()).abs().max().item(),
        (k.float() - fa.rope_transpose_plain(qkv, cos, sin, col_offset=H * D, n_heads=H,
                                             head_dim=D).float()).abs().max().item(),
        (v.float() - fa.rope_transpose_plain(qkv, None, None, col_offset=2 * H * D,
                                             n_heads=H, head_dim=D).float()).abs().max().item(),
    ]
    finite = bool(torch.isfinite(q).all() and torch.isfinite(k).all() and torch.isfinite(v).all())
    ms = time_ms(lambda: fa.rope_transpose(qkv, cos, sin, **kw))
    plain_ms = time_ms(lambda: fa.rope_transpose_plain(qkv, cos, sin, **kw), iters=5)
    # one roped call: read the q columns and cos/sin, write head-major q
    nbytes = 2 * B * S * H * D + 4 * B * S * D + 2 * B * S * H * D
    b_ms, b_by = bound_ms(6 * B * S * H * D, nbytes)
    rows = [_report("B2 prep (2,2560,9216) -> 3 x (2,32,2560,96)", "prep", max(errs), "0 (exact)",
                    max(errs) <= PREP_TOL, finite, ms, plain_ms, None, b_ms, b_by, "q/k roped, v not; timed: q call")]

    kv = torch.tensor(kv_start, dtype=torch.int32, device=dev)
    args = (kv, None, True, None, D ** -0.5)
    run = lambda: fa._flash_fwd_hm(q, k, v, *args, q_len=S)  # noqa: E731
    out = run()
    ref, *q32 = (fa.flash_fwd_hm_plain(*(t.to(dt) for t in (q, k, v)), kv, causal=True,
                                       sliding_window=None, scale=D ** -0.5 * f, q_len=S)
                 for dt, f in ((q.dtype, 1), (torch.float32, 1), (torch.float32, SCALE_STEP)))
    torch.cuda.synchronize()
    valid = _leftpad_rows(kv_start, S, dev)  # (B, S) query rows
    err, within = _attn_err(out.transpose(1, 2)[valid], ref.transpose(1, 2)[valid])
    r = _scale_bias([tuple(t.transpose(1, 2)[valid] for t in (out, ref, *q32))])
    del q32
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(run)
    plain_ms = time_ms(lambda: fa.flash_fwd_hm_plain(
        q, k, v, kv, causal=True, sliding_window=None, scale=D ** -0.5, q_len=S), iters=2,
        warmup=1)
    mask = _sdpa_mask(kv_start, S, S, True, dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=D ** -0.5))
    flops = 4 * D * H * _pairs_allowed(S, kv_start, S, True)
    b_ms, b_by = bound_ms(flops, 2 * 4 * B * H * S * D)
    rows.append(_report("B3 fa_hm q/k/v (2,32,2560,96)", "fa_hm", err, ATTN_TOL_TEXT, within,
                        finite, ms, plain_ms, lib_ms, b_ms, b_by,
                        f"causal kv_start={kv_start}; {_earlier(ms, B3_EARLIER_MS['phi3v'])}",
                        r=r))
    return rows


def check_qwen_prep(gen, qcfg):
    """B2 at the Qwen2.5-VL decoder's B=8 shape: q (28 x 128), k and v (4 x
    128) out of the fused (8, 1792, 4608) projection, M-RoPE tables."""
    dev, tc = "cuda", qcfg.text
    B, S, D, H, Hk = 8, QWEN_SEQ, tc.head_dim, tc.num_heads, tc.num_kv_heads
    qkv = torch.randn(B, S, tc.q_size + 2 * tc.kv_size, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    pos = torch.arange(S, device=dev)[None, None].expand(3, B, S)
    cos, sin = qwen25_vl._mrope_cos_sin(pos, tc, torch.bfloat16)
    parts = ((0, H, True), (H * D, Hk, True), ((H + Hk) * D, Hk, False))
    errs = []
    for off, n, rope in parts:
        c, s_ = (cos, sin) if rope else (None, None)
        got = fa.rope_transpose(qkv, c, s_, col_offset=off, n_heads=n, head_dim=D)
        ref = fa.rope_transpose_plain(qkv, c, s_, col_offset=off, n_heads=n, head_dim=D)
        errs.append((got.float() - ref.float()).abs().max().item())
    kw = dict(col_offset=0, n_heads=H, head_dim=D)
    ms = time_ms(lambda: fa.rope_transpose(qkv, cos, sin, **kw))
    plain_ms = time_ms(lambda: fa.rope_transpose_plain(qkv, cos, sin, **kw), iters=5)
    nbytes = 2 * B * S * H * D + 4 * B * S * D + 2 * B * S * H * D
    b_ms, b_by = bound_ms(6 * B * S * H * D, nbytes)
    return _report(f"B2 prep qwen ({B},{S},{qkv.shape[-1]}) -> q (8,28,{S},128), k/v "
                   f"(8,4,{S},128)", "prep", max(errs), "0 (exact)", max(errs) <= PREP_TOL, True,
                   ms, plain_ms, None, b_ms, b_by, "M-RoPE q/k, v not; timed: q call")


def _segment_pairs(seg):
    """Query x key pairs that segment ids leave open: sum of n^2 per id."""
    n = 0
    for row in seg.cpu().numpy():
        ids, counts = np.unique(row[row != 0], return_counts=True)
        n += int((counts.astype(np.int64) ** 2).sum())
    return n


def check_hm_segments(gen, rows=None, what="qwen vision"):
    """B3's segment mode at the Qwen2.5-VL vision tower's full-attention
    blocks, B=8: 16 heads x 80 over 1280 patches, one row with 272 pad slots
    among them (a 28 x 36 image windowized), non-causal; or over the segment
    id ``rows`` given (a video's: one id per temporal slice)."""
    dev = "cuda"
    if rows is None:
        rows = [windowize(QWEN_GRIDS[0])[1]] * 7 + [windowize(QWEN_GRIDS[1])[1]]
    seg = torch.from_numpy(np.stack(rows).astype(np.int32)).to(dev)
    (B, S), H, D = seg.shape, 16, 80
    q, k, v = (torch.randn(B, H, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    kv0 = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(causal=False, sliding_window=None, scale=D ** -0.5, q_len=S)
    run = lambda: fa._flash_fwd_hm(q, k, v, kv0, seg, segments=True, **kw)  # noqa: E731
    out = run()
    ref, *q32 = (fa.flash_fwd_hm_plain(*(t.to(dt) for t in (q, k, v)), kv0, key_mask=seg,
                                       segments=True, **{**kw, "scale": kw["scale"] * f})
                 for dt, f in ((q.dtype, 1), (torch.float32, 1), (torch.float32, SCALE_STEP)))
    torch.cuda.synchronize()
    valid = seg != 0  # a pad patch's query has no key; its row must be finite
    err, within = _attn_err(out.transpose(1, 2)[valid], ref.transpose(1, 2)[valid])
    r = _scale_bias([tuple(t.transpose(1, 2)[valid] for t in (out, ref, *q32))])
    del q32
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(run)
    plain_ms = time_ms(lambda: fa.flash_fwd_hm_plain(q, k, v, kv0, key_mask=seg, segments=True,
                                                     **kw), iters=2, warmup=1)
    mask = ((seg[:, None, :] != 0) & (seg[:, None, :] == seg[:, :, None]))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=D ** -0.5))
    b_ms, b_by = bound_ms(4 * D * H * _segment_pairs(seg), 2 * 4 * B * H * S * D + 4 * B * S)
    ids = sorted(set(seg[-1].unique().tolist()) - {0})
    return _report(f"B3 fa_hm segments {what} ({B},{H},{S},{D})", "fa_hm", err,
                   ATTN_TOL_TEXT, within, finite, ms, plain_ms, lib_ms, b_ms, b_by,
                   f"non-causal, segment ids {ids}, row {B - 1}: {int(valid[-1].sum())} valid "
                   f"of {S}; pad rows finite {finite}; library: SDPA, boolean mask; "
                   f"{_earlier(ms, B3_EARLIER_MS['segments'] if what == 'qwen vision' else None)}",
                   r=r)


def check_hm_gqa(gen, qcfg):
    """B3 at the Qwen2.5-VL decoder's B=8 shape: GQA 28 / 4 heads x 128,
    causal, one row left-padded by 40."""
    dev, tc = "cuda", qcfg.text
    B, H, Hk, S, D = 8, tc.num_heads, tc.num_kv_heads, QWEN_SEQ, tc.head_dim
    kv_start = [0, 40, 0, 0, 0, 0, 0, 0]
    q = torch.randn(B, H, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn(B, Hk, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    kv = torch.tensor(kv_start, dtype=torch.int32, device=dev)
    kw = dict(causal=True, sliding_window=None, scale=D ** -0.5, q_len=S)
    run = lambda: fa._flash_fwd_hm(q, k, v, kv, None, **kw)  # noqa: E731
    out = run()
    ref, *q32 = (fa.flash_fwd_hm_plain(*(t.to(dt) for t in (q, k, v)), kv,
                                       **{**kw, "scale": kw["scale"] * f})
                 for dt, f in ((q.dtype, 1), (torch.float32, 1), (torch.float32, SCALE_STEP)))
    torch.cuda.synchronize()
    valid = _leftpad_rows(kv_start, S, dev)
    err, within = _attn_err(out.transpose(1, 2)[valid], ref.transpose(1, 2)[valid])
    r = _scale_bias([tuple(t.transpose(1, 2)[valid] for t in (out, ref, *q32))])
    del q32
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(run)
    plain_ms = time_ms(lambda: fa.flash_fwd_hm_plain(q, k, v, kv, **kw), iters=2, warmup=1)
    mask = _sdpa_mask(kv_start, S, S, True, dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=D ** -0.5, enable_gqa=True))
    flops = 4 * D * H * _pairs_allowed(S, kv_start, S, True)
    b_ms, b_by = bound_ms(flops, 2 * (2 * B * H * S * D + 2 * B * Hk * S * D))
    return _report(f"B3 fa_hm GQA qwen decoder ({B},{H}/{Hk},{S},{D})", "fa_hm", err,
                   ATTN_TOL_TEXT, within, finite, ms, plain_ms, lib_ms, b_ms, b_by,
                   f"causal kv_start={kv_start}; library: SDPA enable_gqa, boolean mask; "
                   f"{_earlier(ms, B3_EARLIER_MS['gqa'])}", r=r)


def _attn_err(out, ref):
    """Max abs error on valid rows, and whether every element is within
    ATTN_ATOL + ATTN_RTOL * |ref|."""
    diff = (out.float() - ref.float()).abs()
    within = bool((diff <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()).all())
    return diff.max().item(), within


def _scale_bias(items):
    """The scale-bias reading r over (kernel, p(s), p(SCALE_STEP s)) triples,
    or (kernel, p(s), q(s), q(SCALE_STEP s)) with d taken from q, already
    cut to their valid rows, accumulated in fp64."""
    num = den = 0.0
    for k, p, *qs in items:
        lo, hi = (p, qs[0]) if len(qs) == 1 else qs
        d = hi.double() - lo.double()
        num += float(((k.double() - p.double()) * d).sum())
        den += float((d * d).sum())
    return num / den


def _report(title, name, err, tol_text, within, finite, ms, plain_ms, lib_ms, b_ms, b_by, detail,
            r=None):
    ok = within and finite
    bias = "" if r is None else (f"; scale bias r {r:+.3e} (tol {SCALE_BIAS_TOL:g}, a x(1+e) "
                                 f"scale reads ~e/{SCALE_STEP - 1:g})")
    say("kernel", f"{title}: {detail}; max_abs_err {err:.3e} (tol {tol_text}) finite "
        f"{finite}{bias}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {b_ms:.4f} ms ({b_by}) "
        f"-> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{title} disagrees with its plain version")
    if r is not None and not abs(r) <= SCALE_BIAS_TOL:
        fail(f"{title}: scale bias r {r:+.3e} beyond {SCALE_BIAS_TOL:g}")
    return dict(name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, scale_bias=r)


W8A8_M = 8 * 2560  # decoder rows of a phi3v B=8 request
QWEN_M = 8 * QWEN_SEQ  # ... and of a qwen one
CLIP_M8, CLIP_M2 = 136 * 640, 34 * 640  # CLIP rows (crops x padded tokens) at B=8 and B=2


def _zero_rows(x):
    x[:: x.shape[0] // 4] = 0  # amax := 1 on these rows
    return x


def _codes_report(title, name, got, ref, ms, plain_ms, nbytes, nops, detail):
    """Codes and amax of an epilogue kernel against its plain version."""
    (c, a), (rc, ra) = got, ref
    d = (c.int() - rc.int()).abs()
    dmax, share = d.max().item(), (d > 0).float().mean().item()
    amax_rel = ((a - ra).abs() / ra).max().item()
    rule = CODE_SHARE[name]
    if rule == 0:
        within, tol_text = share == 0 and amax_rel == 0, "0 (exact)"
    else:
        within = dmax <= 1 and share < rule and amax_rel <= 2 ** -7
        tol_text = f"|code diff| <= 1 on < {rule:g} of codes, amax within 2^-7"
    b_ms, b_by = bound_ms(nops, nbytes, PEAK_FP32_FLOPS)
    return _report(title, name, float(dmax), tol_text, within, bool(torch.isfinite(a).all()),
                   ms, plain_ms, None, b_ms, b_by,
                   f"{detail}; differing codes {share:.3e}, amax rel err {amax_rel:.3e}")


def _norm_quant_times(name, run, yardstick, M, H):
    """B4 / B9 timed two ways, CUDA events over 100 launches and the
    profiler's device time a launch, with the earlier kernel's time and the
    norm alone in torch (less work: no codes; a yardstick, not the library
    column) beside. Returns the event time and the text."""
    ms = time_ms(run, iters=100)
    dev = _device_split(run, ["norm_quant"], reps=20)["norm_quant"]
    lib = time_ms(yardstick, iters=100)
    pace = (" (events above the device time by more than 10 %: the wrapper sets the pace)"
            if ms > 1.1 * dev else "")
    norm = "rms_norm" if name == "rms_quant" else "layer_norm"
    return ms, (f"events {ms:.4f} ms over 100 launches, profiler {dev:.4f} ms device time a "
                f"launch{pace}; {_earlier(ms, NORM_QUANT_EARLIER_MS.get((name, M, H)))}; "
                f"torch {norm} alone {lib:.4f} ms")


def check_quant_epilogues(gen, dcfg, M):
    H, I, eps = dcfg.hidden_size, dcfg.intermediate_size, dcfg.rms_norm_eps
    bf = torch.bfloat16
    x = _zero_rows(torch.randn(M, H, generator=gen, device="cuda", dtype=bf))
    w = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(bf)
    run = lambda: qe.rms_quant(x, w, eps)  # noqa: E731
    ms, times = _norm_quant_times("rms_quant", run,
                                  lambda: torch.nn.functional.rms_norm(x, (H,), w, eps), M, H)
    # timed twice more (100 launches each) to show the spread of one run
    spread = [time_ms(run, iters=100) for _ in range(2)]
    rows = [_codes_report(
        f"B4 rms_quant ({M},{H}) bf16", "rms_quant", run(), qe.rms_quant_plain(x, w, eps), ms,
        time_ms(lambda: qe.rms_quant_plain(x, w, eps), iters=3, warmup=1),
        M * H * 2 + H * 2 + M * H + M * 4, 8 * M * H,
        f"zero rows every {M // 4}; {times}; 100-launch repeats {spread[0]:.4f} / "
        f"{spread[1]:.4f} ms")]
    gu = _zero_rows(torch.randn(M, 2 * I, generator=gen, device="cuda", dtype=bf).mul_(2))
    rows.append(_codes_report(
        f"B5 silu_mul_quant ({M},{2 * I}) bf16", "silu_mul_quant", qe.silu_mul_quant(gu),
        qe.silu_mul_quant_plain(gu), time_ms(lambda: qe.silu_mul_quant(gu)),
        time_ms(lambda: qe.silu_mul_quant_plain(gu), iters=3, warmup=1),
        M * 2 * I * 2 + M * I + M * 4, 10 * M * I, "-> codes (M, I)"))
    return rows


def check_ln_quant(gen, vcfg, M):
    """B9 at a CLIP tower shape: crops x 640 padded tokens."""
    H, eps, bf = vcfg.hidden_size, vcfg.layer_norm_eps, torch.bfloat16
    x = _zero_rows(torch.randn(M, H, generator=gen, device="cuda", dtype=bf).mul_(2))
    w = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(bf)
    b = (0.1 * torch.randn(H, generator=gen, device="cuda")).to(bf)
    run = lambda: qe.ln_quant(x, w, b, eps)  # noqa: E731
    ms, times = _norm_quant_times(
        "ln_quant", run, lambda: torch.nn.functional.layer_norm(x, (H,), w, b, eps), M, H)
    return _codes_report(
        f"B9 ln_quant ({M},{H}) bf16", "ln_quant", run(), qe.ln_quant_plain(x, w, b, eps), ms,
        time_ms(lambda: qe.ln_quant_plain(x, w, b, eps), iters=3, warmup=1),
        M * H * 2 + 2 * H * 2 + M * H + M * 4, 12 * M * H,
        f"zero rows every {M // 4} (LayerNorm of a zero row is the bias); {times}")


# The norm kernel's main-path shapes (ops/norms.py): the CLIP tower's
# LayerNorm at B=8 (136 crops x 640 tokens), the Phi-3 decoder's RMSNorm at
# 8 rows x 2944, the Qwen2.5-VL tower's at a call's 43008 patches, LLaVA-NeXT's
# decoder at 8 x 2976.
NORM_SHAPES = (("CLIP layer_norm", True, CLIP_M8, 1024), ("Phi-3 rms_norm", False, 23552, 3072),
               ("Qwen tower rms_norm", False, 43008, 1280),
               ("LLaVA rms_norm", False, 8 * 2976, 5120))


def _bf16_ulps(a, b):
    """Distance of two bf16 tensors in ulps (values in order, +0 == -0)."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _norm_rule(got, ref, ln, b):
    """Whether the norm kernel is within its rule of the plain code
    (tests/test_torch_norm_kernel.py): RMSNorm 2 bf16 ulps (its first rounding
    may flip where the row's fp32 sums, taken in another order, move by an
    ulp); LayerNorm one ulp, plus 2^-20 of its terms where x - mean times the
    weight cancels the bias."""
    g, r = got.float(), ref.float()
    e = torch.frexp(torch.maximum(g.abs(), r.abs()).clamp_min(2.0 ** -126))[1]
    ulp = torch.ldexp(torch.ones_like(g), e - 8)
    tol = ulp + 2.0 ** -20 * ((r - b.float()).abs() + b.float().abs()) if ln else 2 * ulp
    return not bool(((g - r).abs() > tol).any())


def check_norms(gen):
    """The norm kernel (norm mode of norm_quant_kernel) against the plain
    code at the main paths' shapes, by its rule (``_norm_rule``), with its ulp
    distances and bit-equal share; the kernel's time by CUDA events over 100
    launches and its device time, the plain code's, torch's fused norm as the
    library yardstick, and the bound: 4 bytes an element (bf16 read and
    written) plus the weights at 3.35 TB/s."""
    for title, ln, M, H in NORM_SHAPES:
        x = _zero_rows(torch.randn(M, H, generator=gen, device="cuda", dtype=torch.bfloat16)
                       .mul_(2))
        w = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(torch.bfloat16)
        b = (0.1 * torch.randn(H, generator=gen, device="cuda")).to(torch.bfloat16)
        if ln:
            run = lambda: norms.layer_norm(x, w, b, 1e-5)  # noqa: E731
            plain = lambda: norms.layer_norm_plain(x, w, b, 1e-5)  # noqa: E731
            lib = lambda: torch.nn.functional.layer_norm(x, (H,), w, b, 1e-5)  # noqa: E731
        else:
            run = lambda: norms.rms_norm(x, w, 1e-5)  # noqa: E731
            plain = lambda: norms.rms_norm_plain(x, w, 1e-5)  # noqa: E731
            lib = lambda: torch.nn.functional.rms_norm(x, (H,), w, 1e-5)  # noqa: E731
        name = "layer_norm" if ln else "rms_norm"
        norms.reset_counters()
        got, ref = run(), plain()
        if norms.LAUNCHES[name] != 1:
            fail(f"norm {title}: the kernel did not launch ({norms.LAUNCHES})")
        d = _bf16_ulps(got, ref)
        ms = time_ms(run, iters=100)
        dev = _device_split(run, ["norm_quant"], reps=20)["norm_quant"]
        b_ms, b_by = bound_ms((7 if ln else 4) * M * H, 4 * M * H + H * 2 * (2 if ln else 1),
                              PEAK_FP32_FLOPS)
        _report(
            f"norm {title} ({M},{H}) bf16", name, float(d.max()),
            "1 bf16 ulp + 2^-20 of the terms" if ln else "2 bf16 ulps",
            _norm_rule(got, ref, ln, b), bool(torch.isfinite(got).all()), ms,
            time_ms(plain, iters=5, warmup=1), time_ms(lib, iters=100), b_ms, b_by,
            f"bit-equal {float((d == 0).float().mean()):.6f}, 1 ulp on "
            f"{float((d == 1).float().mean()):.3e}, 2 on {float((d == 2).float().mean()):.3e}, "
            f"more on {float((d > 2).float().mean()):.3e}; events over 100 launches, profiler "
            f"{dev:.4f} ms device time a launch, {100 * b_ms / dev if dev else 0:.1f} % of the "
            "bound")
        del x, got, ref


def _int_mm_scaled(codes, amax, wq, ws):
    """The library yardstick: cuBLASLt's s8 x s8 -> s32 on the same K-major
    weights the kernel reads, plus the epilogue."""
    return (torch._int_mm(codes, wq).float() * (amax / 127.0) * ws).to(torch.bfloat16)


# The times of the WMMA kernels that B3 and B7 replaced, ms per launch on an
# "NVIDIA H100 80GB HBM3, 700.00 W", as PERF.md's table keeps them: printed
# beside the new kernels' times.
B3_EARLIER_MS = {"phi3v": 1.5826, "gqa": 5.4916, "segments": 1.2491}
B7_EARLIER_MS = {  # (dynamic, M, K, N)
    (False, 20480, 3072, 9216): 5.4063, (False, 20480, 3072, 3072): 1.7751,
    (False, 20480, 8192, 3072): 4.7091, (False, 20480, 3072, 16384): 9.8538,
    (False, 14336, 3584, 4608): 2.1530, (False, 14336, 3584, 3584): 1.6809,
    (False, 14336, 18944, 3584): 8.7828, (False, 14336, 3584, 37888): 18.1428,
    (True, 14336, 3584, 4608): 2.2124,
    (False, 87040, 1024, 3072): 2.6806, (False, 87040, 1024, 4096): 3.5178,
    (False, 87040, 1024, 1024): 0.9128, (False, 87040, 4096, 1024): 3.2794,
    (False, 21760, 1024, 3072): 0.6726, (True, 21760, 4096, 1024): 0.9847,
}


# The times of the row-per-block kernels that the streaming B4 and B9
# replaced, ms per launch on an "NVIDIA H100 80GB HBM3, 700.00 W", as PERF.md's
# table keeps them, keyed (name, M, H): printed beside the new kernels' times.
NORM_QUANT_EARLIER_MS = {("rms_quant", W8A8_M, 3072): 0.1015, ("rms_quant", QWEN_M, 3584): 0.0930,
                         ("ln_quant", CLIP_M8, 1024): 0.2837}


def _earlier(ms, earlier):
    if earlier is None:
        return "earlier kernel: not measured"
    return f"earlier kernel {earlier:.4f} ms, now {ms / earlier:.3f} of it"


def check_int8_matmul(gen, dcfg, M):
    H, I, qkv = dcfg.hidden_size, dcfg.intermediate_size, dcfg.q_size + 2 * dcfg.kv_size
    return _check_gemm_shapes(gen, M, (H, qkv), (("qkv", H, qkv), ("o", H, H), ("down", I, H),
                                                 ("gate_up", H, 2 * I)))


def check_int8_matmul_clip(gen, vcfg, M8, M2):
    """The GEMM at the W8A8 CLIP tower's shapes, B=8 (87040 rows) and the two
    extreme shapes at B=2 (21760 rows), bit-exact before the request runs."""
    H, I = vcfg.hidden_size, vcfg.intermediate_size
    rows = _check_gemm_shapes(gen, M8, None, (("clip qkv", H, 3 * H), ("clip fc1", H, I),
                                              ("clip out", H, H), ("clip fc2", I, H)))
    return rows + _check_gemm_shapes(gen, M2, (I, H), (("clip qkv", H, 3 * H),))


def _check_gemm_shapes(gen, M, dynamic, shapes):
    """The dynamic form (B6, then the GEMM) at ``dynamic`` = (K, N) if given,
    then the pre-quantized form at each (tag, K, N) of ``shapes``."""
    bf = torch.bfloat16
    rows = []

    def weights(K, N):
        # (K, N) with strides (1, K), as every W8A8 leaf is laid out
        # (utils/quantize.k_major): the layout the kernel and _int_mm both read
        wq = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8).mT
        return wq, torch.rand(1, N, generator=gen, device="cuda") * 1e-3 + 1e-4

    if dynamic is not None:
        K, N = dynamic
        wq, ws = weights(K, N)
        x = _zero_rows(torch.randn(M, K, generator=gen, device="cuda", dtype=bf))
        out, ref = im.w8a8_matmul(x, wq, ws), im.w8a8_matmul_plain(x, wq, ws)
        codes, amax = qe.row_quant_plain(x)
        rows.append(_gemm_report(f"B7 dynamic ({M},{K})x({K},{N})", out, ref,
                                 lambda: im.w8a8_matmul(x, wq, ws),
                                 lambda: im.w8a8_matmul_plain(x, wq, ws),
                                 lambda: _int_mm_scaled(codes, amax, wq, ws), M, K, N, 2,
                                 "x bf16 -> B6 codes -> GEMM; library: _int_mm on the codes",
                                 B7_EARLIER_MS.get((True, M, K, N))))
        del x, out, ref, codes, amax
    # the pre-quantized form at each shape (the last one is the row the
    # kernels line reports)
    for tag, K, N in shapes:
        wq, ws = weights(K, N)
        codes = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                              dtype=torch.int8)
        amax = torch.rand(M, 1, generator=gen, device="cuda") * 4 + 0.1
        out = im.int8_matmul_pre(codes, amax, wq, ws)
        ref = im.int8_matmul_pre_plain(codes, amax, wq, ws, bf)
        # cuBLASLt's s32 product alone, for information
        mm_ms = time_ms(lambda: torch._int_mm(codes, wq))
        rows.append(_gemm_report(
            f"B7 {tag} ({M},{K})x({K},{N})", out, ref,
            lambda: im.int8_matmul_pre(codes, amax, wq, ws),
            lambda: im.int8_matmul_pre_plain(codes, amax, wq, ws, bf),
            lambda: _int_mm_scaled(codes, amax, wq, ws), M, K, N, 1,
            f"pre-quantized codes; _int_mm alone {mm_ms:.4f} ms",
            B7_EARLIER_MS.get((False, M, K, N))))
        del out, ref
        torch.cuda.empty_cache()
    return rows


def _gemm_report(title, out, ref, run, plain, lib, M, K, N, x_bytes, detail, earlier):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    exact = torch.equal(out, ref)
    ms = time_ms(run)
    plain_ms = time_ms(plain, iters=2, warmup=1)
    lib_ms = time_ms(lib)
    b_ms, b_by = bound_ms(2 * M * K * N, M * K * x_bytes + K * N + M * 4 + N * 4 + M * N * 2,
                          PEAK_INT8_OPS)
    return _report(title, "int8_matmul", err, "0 (exact)", exact, bool(torch.isfinite(out).all()),
                   ms, plain_ms, lib_ms, b_ms, b_by,
                   f"{detail}; {2 * M * K * N / ms / 1e9:.1f} TOPS; {_earlier(ms, earlier)}; "
                   f"library/kernel {lib_ms / ms:.3f}")


def check_bwd(title, gen, B, H, S, D, causal, kv_start, Hk=None, mask=None, segments=False):
    """B8 against its plain version at a path shape. Left-pad mode: g zeroed
    on the fully masked (left-pad) query rows as on the training path. Mask
    modes (``mask`` (B, S): a key mask, or segment ids with ``segments``;
    non-causal): g is KEPT on the pad queries, whose uniform p reaches dk and
    dv of every key; dq is compared on the queries that have a key, dk and dv
    on every valid key."""
    dev = "cuda"
    Hk = Hk or H
    q, g = (torch.randn(B, H, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    k, v = (torch.randn(B, Hk, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    kv = torch.tensor(kv_start, dtype=torch.int32, device=dev)
    if mask is None:
        live = _leftpad_rows(kv_start, S, dev) if causal else torch.ones(
            B, S, dtype=torch.bool, device=dev)
        keys = torch.ones(B, S, dtype=torch.bool, device=dev)
        g = g * live[:, None, :, None].to(g.dtype)
        pairs = _pairs_allowed(S, kv_start, S, causal)
        sdpa_mask = _sdpa_mask(kv_start, S, S, causal, dev) if causal else None
    else:
        ok = (mask[:, None, :] != 0).expand(B, S, S)  # (b, query, key)
        if segments:
            ok = ok & (mask[:, None, :] == mask[:, :, None])
        live, keys, pairs = ok.any(-1), mask != 0, int(ok.sum())
        # the library call's rows need a key: a pad query sees itself there
        sdpa_mask = (ok | (torch.eye(S, dtype=torch.bool, device=dev) & ~live[:, :, None]))[:, None]
        del ok
    kw = dict(causal=causal, sliding_window=None, scale=D ** -0.5, q_len=S, key_mask=mask,
              segments=segments)
    run = lambda: fa.flash_bwd(q, k, v, g, kv, **kw)  # noqa: E731
    out = run()
    # dq (and, with GQA, dk/dv) sum in fp32 with atomics: a second launch may
    # round a gradient differently by one bf16 step
    again = run()
    repeat = [(a - b).float().abs().max().item() for a, b in zip(out, again)]
    del again
    ref = fa.flash_bwd_plain(q, k, v, g, kv, **kw)
    ref2 = fa.flash_bwd_plain(q, k, v, g, kv, **{**kw, "scale": kw["scale"] * SCALE_STEP})
    torch.cuda.synchronize()
    errs, within, rel, triples = [], True, [], []
    for name, o, r, r2 in zip(("dq", "dk", "dv"), out, ref, ref2):
        rows = live if name == "dq" else keys  # a keyless row's dq depends on the keys visited
        o, r, r2 = (t.transpose(1, 2)[rows] for t in (o, r, r2))
        triples.append((o, r, r2))
        o, r = o.float(), r.float()
        d = (o - r).abs()
        errs.append(d.max().item())
        rel.append(((o - r).norm() / r.norm()).item())
        within &= bool((d <= BWD_RTOL * r.abs() + BWD_ATOL_SHARE * r.abs().max()).all())
    bias = _scale_bias(triples)
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    del out, ref, ref2, triples
    ms = time_ms(run)
    plain_ms = time_ms(lambda: fa.flash_bwd_plain(q, k, v, g, kv, **kw), iters=2, warmup=1)
    # library yardstick: SDPA's backward through autograd on the same inputs
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=sdpa_mask, scale=D ** -0.5, enable_gqa=Hk != H)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (qs, ks, vs), g, retain_graph=True))
    del o
    split = _launch_split(run, ("fa_bwd_stats", "fa_bwd_main", "fa_bwd_finish"))
    flops = 10 * D * H * pairs  # five products
    # q g read, dq written at H heads; k v read, dk dv written at Hk; the mask row
    nbytes = 2 * B * S * D * (3 * H + 4 * Hk) + (4 * B * S if mask is not None else 0)
    b_ms, b_by = bound_ms(flops, nbytes)
    mode = "left pad" if mask is None else ("segment ids" if segments else "key mask")
    pads = "" if mask is None else (f", valid keys per row {keys.sum(1).tolist()}, "
                                    f"g kept on {int((~live).sum())} keyless queries")
    return _report(title, "fa_bwd", max(errs), BWD_TOL_TEXT, within, finite, ms, plain_ms,
                   lib_ms, b_ms, b_by,
                   f"{mode}, causal={causal} "
                   f"kv_start={kv_start if B < 4 else f'[{kv_start[0]}]*{B}'}{pads}; "
                   f"dq/dk/dv rel L2 {rel[0]:.2e}/{rel[1]:.2e}/{rel[2]:.2e}; two runs differ by "
                   f"max |dq1-dq2| {repeat[0]:.3e}, dk {repeat[1]:.3e}, dv {repeat[2]:.3e}; "
                   f"ms per launch (profiler) {split}; "
                   f"library: SDPA backward{', enable_gqa' if Hk != H else ''}"
                   f"{', boolean mask' if sdpa_mask is not None else ''}", r=bias)


def _device_split(fn, names, reps=3):
    """Device ms per call of each kernel whose name holds one of ``names``
    (the rest summed as "other"), from torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = dict.fromkeys((*names, "other"), 0.0)
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if us and ev.key not in ("cudaDeviceSynchronize", "cudaLaunchKernel"):
            split[next((n for n in names if n in ev.key), "other")] += us / 1e3 / reps
    return split


def _launch_split(fn, names, reps=3):
    return ", ".join(f"{n} {ms:.4f}" for n, ms in _device_split(fn, names, reps).items())


def phase_kernels(cfg, qcfg):
    gen = torch.Generator(device="cuda").manual_seed(1)
    # B6 first: its host and event readings are taken before any profiler
    # session of the process (after one, CUDA calls cost the host more and a
    # session may hold another's kernels: seen on an H100)
    rows = check_row_quant(gen, row_quant_shapes(cfg, qcfg, LlavaNextConfig()))
    torch.cuda.empty_cache()
    rows += [
        check_direct("B1 fa_direct CLIP", gen, 136, 640, 16, 64, False, False, [0] * 136, 577,
                     cfg),
        check_direct("B1 fa_direct decoder", gen, 8, 2560, 32, 96, True, True,
                     [0, 300, 0, 1000, 0, 7, 0, 64], 2560, cfg),
    ]
    rows += check_prep_and_hm(gen, cfg)
    torch.cuda.empty_cache()
    # B8 at the training paths' shapes (the phi3v decoder's last: the kernels
    # line reports it): the Qwen2.5-VL vision tower's full blocks in segment
    # and key-mask mode (B=2, the second image 28 x 36 patches: 272 pad slots),
    # its decoder's GQA shape in left-pad mode, then phi3v's
    seg = torch.from_numpy(np.stack([windowize(g)[1] for g in QWEN_GRIDS]).astype(np.int32)).cuda()
    tc = qcfg.text
    rows.append(check_bwd(f"B8 fa_bwd segments qwen vision (2,16,{QWEN_PATCHES},80)", gen, 2, 16,
                          QWEN_PATCHES, 80, False, [0, 0], mask=seg, segments=True))
    rows.append(check_bwd(f"B8 fa_bwd key mask (2,16,{QWEN_PATCHES},80)", gen, 2, 16,
                          QWEN_PATCHES, 80, False, [0, 0], mask=(seg != 0).to(torch.int32)))
    rows.append(check_bwd(f"B8 fa_bwd GQA qwen decoder (2,{tc.num_heads}/{tc.num_kv_heads},"
                          f"{QWEN_SEQ},{tc.head_dim})", gen, 2, tc.num_heads, QWEN_SEQ,
                          tc.head_dim, True, [0, 40], Hk=tc.num_kv_heads))
    torch.cuda.empty_cache()
    rows.append(check_bwd("B8 fa_bwd CLIP (34,16,577,64)", gen, 34, 16, 577, 64, False,
                          [0] * 34))
    rows.append(check_bwd("B8 fa_bwd decoder (2,32,2560,96)", gen, 2, 32, 2560, 96, True,
                          [0, 40]))
    torch.cuda.empty_cache()
    # the W8A8 CLIP tower's shapes first (the kernels line reports the GEMM
    # at the decoders' shapes, which come after; B9 at B=8, its last)
    rows.append(check_ln_quant(gen, cfg.vision, CLIP_M2))
    rows.append(check_ln_quant(gen, cfg.vision, CLIP_M8))
    rows += check_int8_matmul_clip(gen, cfg.vision, CLIP_M8, CLIP_M2)
    torch.cuda.empty_cache()
    rows += check_quant_epilogues(gen, cfg.decoder, W8A8_M)
    torch.cuda.empty_cache()
    rows += check_int8_matmul(gen, cfg.decoder, W8A8_M)
    torch.cuda.empty_cache()
    # the Qwen2.5-VL path's shapes (their rows come last: the kernels line
    # reports them, B3's segment mode for fa_hm)
    rows.append(check_qwen_prep(gen, qcfg))
    rows.append(check_hm_gqa(gen, qcfg))
    rows.append(check_hm_segments(gen))
    torch.cuda.empty_cache()
    rows += check_quant_epilogues(gen, qcfg.text, QWEN_M)
    torch.cuda.empty_cache()
    rows += check_int8_matmul(gen, qcfg.text, QWEN_M)
    torch.cuda.empty_cache()
    # the LLaVA-NeXT-13B decoder's shapes: printed, held like the others, and
    # left out of the kernels line, whose rows keep the shapes of the runs
    # before LLaVA came, so that each kernel's series reads on
    check_llava_kernels(gen, LlavaNextConfig())
    check_norms(gen)  # printed, left out of the kernels line, as LLaVA's
    torch.cuda.empty_cache()
    check_new_callers(gen, qcfg, LlavaNextConfig())
    rows += check_tp_modes(gen, qcfg, LlavaNextConfig())
    return rows


def check_new_callers(gen, qcfg, lcfg):
    """The shapes at which this slice's paths call the kernels anew, held
    like the rest of phase 3 and left out of the kernels line: B3's segment
    mode over a video's four temporal slices ([video]: 2 x 5120 patch slots,
    3536 valid a row); and, under autograd in the W8A8 LoRA steps, B6 and the
    dynamic GEMM at the training rows (B=2: qwen 2 x 1792, LLaVA 2 x 2976) of
    the q projection, with _Int8LinearCore's forward and backward there (B6
    alone at those rows: check_row_quant)."""
    from llava_reward_torch.preprocess.qwen_video import windowize_video

    seg = windowize_video(VIDEO_GRID, qcfg.vision.window_size)[1]
    check_hm_segments(gen, [seg, seg], "qwen video")
    torch.cuda.empty_cache()
    for name, dcfg, M in (("qwen", qcfg.text, 2 * QWEN_SEQ), ("LLaVA", lcfg.text, 2 * LLAVA_SEQ)):
        H = dcfg.hidden_size
        _check_gemm_shapes(gen, M, (H, dcfg.q_size), ())
        _check_int8_core(gen, name, M, H, dcfg.q_size)
        torch.cuda.empty_cache()


def check_tp_modes(gen, qcfg, lcfg, tp=2):
    """B6 and B5 in their tensor-parallel modes at a tp-2 rank's shapes of a
    B=8 request (LLaVA-NeXT's down_proj, K 13824 / 2; qwen's o_proj, K 3584 /
    2, and its MLP, I 18944 / 2: the kernels line takes each mode's last row,
    at qwen's shapes)."""
    rows = []
    for name, what, M, K in (
            ("row_quant", "LLaVA down_proj", 8 * LLAVA_SEQ, lcfg.text.intermediate_size),
            ("row_quant", "qwen o_proj", QWEN_M, qcfg.text.q_size),
            ("silu_mul_quant", "qwen down_proj", QWEN_M, qcfg.text.intermediate_size)):
        rows += _check_tp_mode(gen, name, what, M, K, tp)
        torch.cuda.empty_cache()
    return rows


def _check_tp_mode(gen, name, what, M, K, tp):
    """A row of width K (B5: the fused 2K gate_up) split over ``tp`` ranks:
    each rank's raw absmax (the absmax mode) against its plain version (B6
    exact, B5 within 2^-7), the MAX over ranks, each rank's codes on it (the
    given-amax mode) against the plain version on the same amax (B6 bit for
    bit, B5 under CODE_SHARE), and the ranks' codes together against the
    kernel's own codes of the whole row, bit for bit (both). Rank 0's launch
    timed, CUDA events over 100 launches."""
    silu = name == "silu_mul_quant"
    bf = torch.bfloat16
    x = _zero_rows(torch.randn(M, 2 * K if silu else K, generator=gen, device="cuda", dtype=bf))
    x[1, :K // tp] = 0  # zero on rank 0's columns: its raw absmax is 0
    if silu:
        x[1, K:K + K // tp] = 0
        blocks = [torch.cat([p.chunk(tp, -1)[r] for p in x.chunk(2, -1)], -1).contiguous()
                  for r in range(tp)]
        absmax, quant = qe.silu_mul_absmax, qe.silu_mul_quant
        absmax_plain, quant_plain = qe.silu_mul_absmax_plain, qe.silu_mul_quant_plain
    else:
        blocks = [b.contiguous() for b in x.chunk(tp, -1)]
        absmax, quant, absmax_plain, quant_plain = (qe.row_absmax, qe.row_quant,
                                                    qe.row_absmax_plain, qe.row_quant_plain)
    whole = quant(x)
    local = [absmax(b) for b in blocks]
    amax = torch.stack(local).amax(0)
    codes = [quant(b, amax) for b in blocks]
    same = torch.equal(torch.cat([c for c, _ in codes], -1), whole[0]) and all(
        torch.equal(a, whole[1]) for _, a in codes)
    stem, b, n = name[:-len("_quant")], blocks[0], K // tp
    tag = f"{'B5' if silu else 'B6'} {stem}"
    if not same or float(local[0][1]) != 0.0:
        fail(f"{tag} {what}: the ranks' codes on the MAX-reduced amax are not the whole row's")
    if not silu:  # B6's modes are held and timed at every shape by check_row_quant
        say("kernel", f"{tag} {what} tp {tp} ({M},{K}): the ranks' codes on the MAX of their raw "
            f"absmax equal the kernel's whole-row codes bit for bit -> ok")
        return []
    ra, got = absmax_plain(b), absmax(b)
    err = (got - ra).abs().max().item()
    within = torch.allclose(got, ra, rtol=2 ** -7, atol=0) if silu else torch.equal(got, ra)
    read = M * b.shape[-1] * 2
    lib = None if silu else time_ms(
        lambda: torch.linalg.vector_norm(b, float("inf"), dim=-1), iters=100)
    b_ms, b_by = bound_ms((10 if silu else 2) * M * n, read + M * 4, PEAK_FP32_FLOPS)
    rows = [_report(f"{tag}_absmax {what} tp rank ({M},{b.shape[-1]}) bf16", f"{stem}_absmax",
                    err, "2^-7 relative" if silu else "0 (exact)", within,
                    bool(torch.isfinite(got).all()), time_ms(lambda: absmax(b), iters=100),
                    time_ms(lambda: absmax_plain(b), iters=3, warmup=1), lib, b_ms, b_by,
                    f"the raw absmax of rank 0's {b.shape[-1]} columns of {tp}")]
    rows.append(_codes_report(
        f"{tag}_quant_given {what} tp rank ({M},{b.shape[-1]}) bf16", f"{name}_given",
        quant(b, amax), quant_plain(b, amax), time_ms(lambda: quant(b, amax), iters=100),
        time_ms(lambda: quant_plain(b, amax), iters=3, warmup=1), read + M * 4 + M * n + M * 4,
        (8 if silu else 2) * M * n,
        f"codes on the MAX over {tp} ranks' absmax; the ranks' codes together equal the "
        f"kernel's whole-row codes ({M},{2 * K if silu else K}) bit for bit"))
    return rows


# B6's whole-row times before its redesign, ms per launch (CUDA events, 10
# launches) on an "NVIDIA H100 80GB HBM3, 700.00 W", as PERF.md's table keeps
# them, keyed (M, H): printed beside the new kernel's
B6_EARLIER_MS = {(W8A8_M, 3072): 0.0730, (QWEN_M, 3584): 0.0655, (8 * 2976, 5120): 0.1349}
B6_MODES = {"whole": "row_quant", "absmax": "row_absmax", "given": "row_quant_given"}
# the rows of the kernels line: the qwen decoder's o_proj input at B=8, and a
# tp-2 rank's share of it for the two tp modes
B6_LINE = {"whole": "qwen o_proj B=8", "absmax": "qwen tp-2 o_proj B=8",
           "given": "qwen tp-2 o_proj B=8"}


def row_quant_shapes(cfg, qcfg, lcfg):
    """(what, M, H) of every B6 call on the main paths: the W8A8 decoders'
    o_proj input at a B=8 request's rows (phi3v 8 x 2560, qwen 8 x 1792,
    LLaVA 8 x 2976); the W8A8 CLIP tower's out and fc2 inputs at B=8 and B=2
    (136 and 34 crops of 640 tokens); LoRA over a W8A8 decoder at a B=2
    step's rows, every projection's input (the hidden width, which q's
    output width equals in all three, and down's); a tp-2 rank's row-split
    blocks at B=8 (o and down, each on its absmax then given-amax)."""
    fams = (("phi3v", cfg.decoder, W8A8_M, 2 * 2560), ("qwen", qcfg.text, QWEN_M, 2 * QWEN_SEQ),
            ("LLaVA", lcfg.text, 8 * LLAVA_SEQ, 2 * LLAVA_SEQ))
    v = cfg.vision
    out = [(f"{n} o_proj B=8", m8, c.q_size) for n, c, m8, _ in fams]
    for b, m in (("B=8", CLIP_M8), ("B=2", CLIP_M2)):
        out += [(f"CLIP out {b}", m, v.hidden_size), (f"CLIP fc2 {b}", m, v.intermediate_size)]
    for n, c, _, m2 in fams:
        assert c.q_size == c.hidden_size  # o_proj's input is as wide as the others'
        out += [(f"{n} LoRA hidden", m2, c.hidden_size), (f"{n} LoRA down", m2,
                                                          c.intermediate_size)]
    for n, c, m8, _ in fams:
        out += [(f"{n} tp-2 o_proj B=8", m8, c.q_size // 2),
                (f"{n} tp-2 down B=8", m8, c.intermediate_size // 2)]
    return out


def _b6_call(mode, x, amax):
    if mode == "whole":
        return lambda: qe.row_quant(x)
    if mode == "absmax":
        return lambda: qe.row_absmax(x)
    return lambda: qe.row_quant(x, amax)


def device_ms_each(runs, reps=20, key=None, tries=3):
    """Device ms a call of each of ``runs``: a torch.profiler session a run of
    ``reps`` calls, its kernels' device time over the calls. With ``key``, a
    call is one kernel whose name holds it, and a session must hold exactly
    ``reps`` of them (else a whole number of kernels a call); one that does
    not is run again, ``tries`` times at most, then read None: in a process
    that has profiled before, a session may hold another's kernels or miss
    its own (seen on an H100)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = []
    for run in runs:
        run()
        ms = None
        for _ in range(tries):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    run()
                torch.cuda.synchronize()
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA and (key is None or key in e.name)]
            if us and (len(us) == reps if key else len(us) % reps == 0):
                ms = sum(us) / reps / 1e3
                break
        out.append(ms)
    return out


def host_us(run, calls=200, sleep_cycles=50_000_000):
    """Host microseconds a call of ``run`` over ``calls`` calls, taken while
    the card is busy ahead of the host (a spin of ``sleep_cycles`` queued
    first), so that no call waits for the card: the wrapper's own cost.
    Returns (us, whether the card was still busy when the last call
    returned)."""
    run()
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    busy = torch.cuda.Event()
    busy.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        run()
    us = (time.perf_counter() - t0) / calls * 1e6
    held = not busy.query()
    torch.cuda.synchronize()
    return us, held


def _b6_bytes_ops(mode, M, H):
    """B6's bytes (x read once; codes and amax written; a given amax read)
    and operations (|x| and max; q * x and the round)."""
    read, codes = M * H * 2 + (4 * M if mode == "given" else 0), M * H + 4 * M
    return ((read + 4 * M, 2 * M * H) if mode == "absmax" else
            (read + codes, (2 if mode == "given" else 4) * M * H))


def check_row_quant(gen, shapes, modes=tuple(B6_MODES)):
    """B6 in each mode at each (what, M, H) of ``shapes`` (bf16 rows, zero
    rows every M / 4): bit for bit against its plain version (whole rows:
    codes and amax; absmax: the raw max, 0 on a zero row; given: the codes on
    each row's absmax times a factor in [1, 2), as another rank's columns may
    raise it, 0 on the zero rows). Timed four ways: CUDA events over 100
    back-to-back launches; the profiler's device time a launch (a session a
    case, 20 launches, device_ms_each); the wrapper's host microseconds a
    call while the card is busy; the plain version (3 calls); and, absmax,
    torch.linalg.vector_norm(x, inf) (the library call; events and device
    time). Prints one line a
    case and whether the expectations of PERF.md held (device time at least
    half the bound; absmax no slower than vector_norm; whole rows at the B=8
    decoder shapes no slower than the kernel they replaced). Returns the
    kernels line's rows (B6_LINE)."""
    cases = []
    for what, M, H in shapes:
        x = _zero_rows(torch.randn(M, H, generator=gen, device="cuda", dtype=torch.bfloat16))
        raw = qe.row_absmax_plain(x)
        given = raw * (1 + torch.rand(M, 1, generator=gen, device="cuda"))
        for mode in modes:
            run = _b6_call(mode, x, given)
            if mode == "whole":
                got, ref = qe.row_quant(x), qe.row_quant_plain(x)
            elif mode == "absmax":
                got, ref = qe.row_absmax(x), raw
            else:
                got, ref = qe.row_quant(x, given), qe.row_quant_plain(x, given)
            torch.cuda.synchronize()
            if mode == "absmax":
                err = (got - ref).abs().max().item()
                exact = torch.equal(got, ref) and not bool(got[0].any())
            else:
                err = float((got[0].int() - ref[0].int()).abs().max().item())
                exact = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            finite = bool(torch.isfinite(got if mode == "absmax" else got[1]).all())
            del got, ref
            plain = {"whole": lambda: qe.row_quant_plain(x),
                     "absmax": lambda: qe.row_absmax_plain(x),
                     "given": lambda: qe.row_quant_plain(x, given)}[mode]
            lib = time_ms(lambda: torch.linalg.vector_norm(x, float("inf"), dim=-1),
                          iters=100) if mode == "absmax" else None
            cases.append(dict(what=what, M=M, H=H, mode=mode, run=run, err=err, exact=exact,
                              finite=finite, ms=time_ms(run, iters=100),
                              plain_ms=time_ms(plain, iters=3, warmup=1), lib=lib,
                              lib_run=lambda x=x: torch.linalg.vector_norm(x, float("inf"),
                                                                           dim=-1),
                              host=host_us(run)))
    for c, dev in zip(cases, device_ms_each([c["run"] for c in cases], key="quant_kernel")):
        c["dev"] = dev
    libs = [c for c in cases if c["mode"] == "absmax"]
    for c, dev in zip(libs, device_ms_each([c["lib_run"] for c in libs])):
        c["lib_dev"] = dev
    line, held = {}, {"device >= half the bound": [], "absmax <= vector_norm": [],
                      "whole B=8 <= earlier": []}
    for c in cases:
        M, H, mode = c["M"], c["H"], c["mode"]
        nbytes, nops = _b6_bytes_ops(mode, M, H)
        b_ms, b_by = bound_ms(nops, nbytes, PEAK_FP32_FLOPS)
        plan = qe.row_plan(H, 2, mode)
        form = (f"warp form, {plan.rows} rows a tile, {plan.nv} chunks a lane" if plan.form == 0
                else "block form, a block a row")
        dev = c["dev"]
        host, busy = c["host"]
        share = "not measured" if dev is None else f"{b_ms / dev:.0%}"
        if dev is not None:
            held["device >= half the bound"].append(b_ms / dev >= 0.5)
        notes = [f"{form}; events {c['ms']:.4f} ms over 100 launches ({b_ms / c['ms']:.0%} of "
                 f"the bound), profiler {'not measured' if dev is None else f'{dev:.4f}'} ms "
                 f"device time a launch ({share} of the bound), wrapper {host:.1f} us a call "
                 f"on the host{'' if busy else ' (the card went idle before the last call)'}"]
        if mode == "absmax":
            held["absmax <= vector_norm"].append(c["ms"] <= c["lib"])
            ld = c["lib_dev"]
            notes.append(f"vector_norm(x, inf) {c['lib']:.4f} ms (profiler "
                         f"{'not measured' if ld is None else f'{ld:.4f}'} ms)")
        earlier = B6_EARLIER_MS.get((M, H)) if mode == "whole" else None
        if earlier is not None:
            held["whole B=8 <= earlier"].append(c["ms"] <= earlier)
            notes.append(_earlier(c["ms"], earlier))
        name = B6_MODES[mode]
        row = _report(f"B6 {name} {c['what']} ({M},{H}) bf16", name, c["err"], "0 (exact)",
                      c["exact"], c["finite"], c["ms"], c["plain_ms"], c["lib"], b_ms, b_by,
                      "; ".join(notes))
        if B6_LINE.get(mode) == c["what"]:
            line[mode] = row
    say("kernel", "B6 expectations (PERF.md): " + "; ".join(
        f"{k}: {sum(v)} of {len(v)}" for k, v in held.items()))
    return [line[m] for m in modes if m in line]


def _check_int8_core(gen, name, M, K, N):
    """_Int8LinearCore (utils/quantize.int8_linear) at a training shape: the
    forward through B6 + the GEMM equal to the plain versions', and the
    backward dx = (dy * scale) @ w^T, bf16 operands with an fp32 result on the
    tensor cores, against the fp32 product of the same bf16 operands rounded
    to bf16: each element within one bf16 ulp plus 2^-16 of the sum of its
    terms' magnitudes (two fp32 summation orders differ by about
    sqrt(K) 2^-24 of that sum; a split-K reduction through bf16 partial sums
    would read some 2^-9 of it). Both timed."""
    qd = quantize_array_w8a8(torch.randn(K, N, generator=gen, device="cuda") * 0.02)
    x = torch.randn(M, K, generator=gen, device="cuda", dtype=torch.bfloat16)
    dy = torch.randn(M, N, generator=gen, device="cuda", dtype=torch.bfloat16)
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    reset_counters()
    yk, yp = int8_linear(xk, qd), int8_linear(xp, qd, plain=True)
    ran = {k: v for k, v in launches().items() if v}
    (dxk,) = torch.autograd.grad(yk, [xk], dy)
    (dxp,) = torch.autograd.grad(yp, [xp], dy)
    dys = (dy.float() * qd["scale"]).to(torch.bfloat16).float()
    wf = qd[W8A8_KEY].float()
    ref = (dys @ wf.t()).to(torch.bfloat16)
    torch.cuda.synchronize()
    diff = (dxk.float() - ref.float()).abs()
    terms = dys.abs() @ wf.abs().t()
    within = bool((diff <= ref.float().abs() * 2.0 ** -7 + terms * 2.0 ** -16).all())
    share = (diff > 0).float().mean().item()
    worst = (diff / terms.clamp_min(1e-30)).max().item()
    ok = (torch.equal(yk, yp) and torch.equal(dxk, dxp) and within
          and ran == {"row_quant": 1, "int8_matmul": 1})

    def bwd():
        return torch.autograd.grad(int8_linear(xk, qd), [xk], dy)

    bwd_ms = time_ms(bwd, iters=5) - time_ms(lambda: int8_linear(x, qd), iters=5)
    f32_ms = time_ms(lambda: dys @ wf.t(), iters=5)
    say("kernel", f"_Int8LinearCore {name} training ({M},{K})x({K},{N}): forward through "
        f"{ran} equal to the plain versions {torch.equal(yk, yp)}; backward bf16 x bf16 -> "
        f"fp32 against the fp32 product rounded to bf16: max |diff| {diff.max().item():.3e}, "
        f"{share:.2e} of elements differ, at most {worst:.2e} of the sum of their terms' "
        f"magnitudes; each within one bf16 ulp + 2^-16 of that sum {within}; backward "
        f"{bwd_ms:.4f} ms beside the fp32 product's {f32_ms:.4f} ms ("
        f"{2 * M * K * N / max(bwd_ms, 1e-9) / 1e9:.1f} TFLOP/s; fp32 peak 67) -> "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"_Int8LinearCore {name}: forward or backward disagrees ({ran})")


def check_llava_kernels(gen, lcfg):
    """The kernels at the LLaVA-NeXT-13B decoder's shapes (40 heads x 128,
    MHA, RoPE, causal; 5120 wide, I = 13824): B1 at the B=2 request's (seq
    2976 padded to 3072, valid_len 2976, one row left-padded) against its
    plain version and timed at B=8 beside SDPA; B8 at the LoRA step's (2, 40,
    2976, 128); B4-B6 and the GEMM at the W8A8 B=8 request's rows (8 x 2976).
    B1's shared memory a block at head_dim 128 with RoPE is held to the
    card's limit."""
    tc = lcfg.text
    s_pad = fa._fused_s_pad(LLAVA_SEQ)
    smem = _direct_smem_bytes(tc.head_dim, True)
    optin = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin",
                    227 * 1024)
    if smem > optin:
        fail(f"llava: B1's shared memory at head_dim {tc.head_dim} with RoPE, {smem} bytes, "
             f"exceeds the card's {optin} a block")
    rows = [check_direct("B1 LLaVA decoder (B=2 request)", gen, 2, s_pad, tc.num_heads,
                         tc.head_dim, True, True, [0, LLAVA_PAD], LLAVA_SEQ, lcfg)]
    say("llava", f"B1 at head_dim {tc.head_dim} with RoPE: seq {LLAVA_SEQ} padded to {s_pad} "
        f"(valid_len {LLAVA_SEQ}); shared memory a block {smem / 1024:.1f} KiB "
        f"(Smem<{tc.head_dim}, true>::bytes) of the card's {optin / 1024:.1f} KiB")
    qkv = torch.randn(8, s_pad, 3 * tc.q_size, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    kv8 = [0] * 4 + [LLAVA_PAD] * 4
    cos, sin = _cos_sin(lcfg, kv8, s_pad, "cuda")
    kv = torch.tensor(kv8, dtype=torch.int32, device="cuda")
    kw = dict(n_heads=tc.num_heads, head_dim=tc.head_dim, causal=True, sliding_window=None,
              scale=tc.head_dim ** -0.5, valid_len=LLAVA_SEQ)
    ms8 = time_ms(lambda: fa._fused_qkv_attention_direct(qkv, cos, sin, kv, **kw))
    q, k, v = (fa._rope_plain(t, cos, sin) if i < 2 else t for i, t in enumerate(
        qkv.view(8, s_pad, 3, tc.num_heads, tc.head_dim).unbind(2)))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    mask = _sdpa_mask(kv8, s_pad, LLAVA_SEQ, True, "cuda")
    lib8 = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=tc.head_dim ** -0.5))
    flops = 4 * tc.head_dim * tc.num_heads * _pairs_allowed(s_pad, kv8, LLAVA_SEQ, True)
    nbytes = 2 * 8 * s_pad * 3 * tc.q_size + 2 * 8 * s_pad * tc.q_size + 4 * 8 * s_pad * \
        tc.head_dim
    b8, b8_by = bound_ms(flops, nbytes)
    say("kernel", f"B1 LLaVA decoder (B=8 request): qkv {tuple(qkv.shape)} H={tc.num_heads} "
        f"D={tc.head_dim} causal rope kv_start=[0]*4+[{LLAVA_PAD}]*4 q_len={LLAVA_SEQ}; kernel "
        f"{ms8:.4f} ms, library (SDPA, boolean mask) {lib8:.4f} ms, bound {b8:.4f} ms ({b8_by})")
    del qkv, q, k, v, mask, cos, sin
    rows.append(check_bwd("B8 LLaVA decoder (LoRA step, B=2)", gen, 2, tc.num_heads, LLAVA_SEQ,
                          tc.head_dim, True, [0, LLAVA_PAD]))
    torch.cuda.empty_cache()
    rows += check_quant_epilogues(gen, tc, 8 * LLAVA_SEQ)
    torch.cuda.empty_cache()
    rows += check_int8_matmul(gen, tc, 8 * LLAVA_SEQ)
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ [entry]

ENTRY_TIMEOUT_S = 300


def phase_entry():
    """``dryrun.entry()`` on the card: ``fn(*example_args)`` once, counted
    from zero, then once more for a warm time; ``python -m
    llava_reward_torch.dryrun entry`` runs beside it as a subprocess."""
    t_phase = time.perf_counter()
    cmd = subprocess.Popen([sys.executable, "-m", "llava_reward_torch.dryrun", "entry"],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        fn, args = dryrun.entry("cuda")
        cfg = dryrun.entry_config()[0]
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t_phase
        with torch.no_grad():
            reset_counters()  # the main path's run starts here
            t0 = time.perf_counter()
            reward = fn(*args)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            got = launches()  # ... and ends here
            warm_ms = time_ms(lambda: fn(*args), iters=3, warmup=1)
        out, _ = cmd.communicate(timeout=ENTRY_TIMEOUT_S)
    finally:
        if cmd.poll() is None:
            cmd.kill()
            cmd.wait()
    r = reward.float().cpu()
    n_dec = cfg.decoder.num_layers
    want = {"fa_direct": cfg.vision.num_active_layers, "prep": 3 * n_dec, "fa_hm": n_dec,
            **_norm_launches(cfg)}
    if tuple(r.shape) != (1, 2) or not torch.isfinite(r).all():
        fail(f"entry: reward {r.tolist()}")
    if got != {k: want.get(k, 0) for k in got}:
        fail(f"entry: launches {got} != {want}")
    found = re.findall(r"^kernel launches (\{.*\})$", out, re.M)
    line = re.findall(r"^entry: reward .*$", out, re.M)
    if cmd.returncode != 0 or len(found) != 1 or len(line) != 1 or "finite True" not in line[0]:
        fail(f"entry: python -m llava_reward_torch.dryrun entry exit {cmd.returncode}\n"
             f"{out[-3000:]}")
    cmd_got = json.loads(found[0])
    if cmd_got != got:
        fail(f"entry: the command line launched {cmd_got}, the call {got}")
    say("entry", f"dryrun.entry() (Phi-3.5-vision full width, {n_dec} decoder and "
        f"{cfg.vision.num_layers} CLIP layers, {cfg.num_crops} crops, bf16, one row of seq "
        f"512): reward {r.numpy().round(6).tolist()}, finite; trees and batch built in "
        f"{build_s:.2f} s; the first call {first_s:.3f} s, warm {warm_ms:.2f} ms; launches "
        f"{ {k: v for k, v in got.items() if v} }")
    say("entry", f"python -m llava_reward_torch.dryrun entry: exit 0, {line[0]}; launches "
        f"the same; phase {time.perf_counter() - t_phase:.1f} s")
    del fn, args, reward
    torch.cuda.empty_cache()
    return got


# ------------------------------------------------------------------ phase 4


def make_request(cfg, gen, pairs, seq, left_pad, device="cuda"):
    """bench.py:219-250's geometry: 16+1 crops (4x4 grid), image tokens
    spliced after position 1. ``left_pad[i]`` pad tokens lead row i."""
    B = 2 * pairs
    nc = cfg.num_crops
    hc = wc = min(4, int(math.isqrt(nc)))
    n_img = (hc * wc + 1) * 144 + 1 + (hc + 1) * 12
    gidx = build_img_gather_idx(hc, wc, nc, budget=n_img)
    mask = np.ones((B, seq), np.int32)
    splice = np.full((B, seq), -1, np.int32)
    for i in range(B):
        p = left_pad.get(i, 0)
        mask[i, :p] = 0
        splice[i, p + 1 : p + 1 + n_img] = np.arange(n_img)
    ids = torch.randint(2, cfg.decoder.vocab_size - 2, (B, seq), generator=gen, device=device)
    mask_t = torch.from_numpy(mask).to(device)
    ids = torch.where(mask_t == 0, cfg.decoder.pad_token_id, ids).to(torch.int32)
    crop = cfg.vision.image_size
    pix = torch.rand(B, nc + 1, crop, crop, 3, generator=gen, device=device) - 0.5
    return RewardBatch(
        input_ids=ids, attention_mask=mask_t, pixel_values=pix,
        img_gather_idx=torch.from_numpy(np.tile(gidx[None], (B, 1))).to(device),
        splice_idx=torch.from_numpy(splice).to(device),
        num_img_tokens=torch.full((B,), n_img, dtype=torch.int32, device=device),
    )


def _serve(score, params, batch, reps):
    out = score(params, batch)  # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = score(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def _prob(r, pairs, rcfg):
    return preference_prob(r[:pairs].float(), r[pairs:].float(), is_general_preference=True,
                           value_head_dim=2, tau=rcfg.general_preference_tau)


def serve_and_check(tag, cfg, rcfg, params, req2, req8, per2, per8, reps, model_type="phi3v",
                    tol=REWARD_TOL):
    """Serve ``req2`` then ``req8`` (one warm + ``reps`` timed calls each)
    through make_score_fn(); the launch counters must equal ``per2`` /
    ``per8`` launches per request for every kernel; the B=2 rewards must
    match the same forward through the plain versions within ``tol``, with
    the same decision; the reference attention's gap from the plain route
    (the drift floor of any two attention routes) is printed beside it."""
    adaptor = RewardAdaptor(cfg, rcfg, params, model_type=model_type, device="cuda")
    score = adaptor.make_score_fn()
    if adaptor.make_score_fn() is not score:
        fail("make_score_fn is not memoised")
    calls = reps + 1

    reset_counters()  # the main path's run starts here
    r2, t2 = _serve(score, params, req2, reps)
    after2 = launches()
    r8, t8 = _serve(score, params, req8, reps)
    total = launches()  # ... and ends here
    say(tag, f"launches after B=2: {after2}; after B=8: {total}")
    want2 = {k: calls * per2.get(k, 0) for k in total}
    if after2 != want2:
        fail(f"{tag} B=2 launches {after2} != {want2}")
    d8 = {k: total[k] - after2[k] for k in total}
    want8 = {k: calls * per8.get(k, 0) for k in total}
    if d8 != want8:
        fail(f"{tag} B=8 launches {d8} != {want8}")

    timing = {}
    for name, r, t, pairs in (("B=2", r2, t2, 1), ("B=8", r8, t8, 4)):
        if r.shape != (2 * pairs, 2) or not bool(torch.isfinite(r).all()):
            fail(f"{tag} {name} rewards not finite / wrong shape: {r}")
        med = float(np.median(t))
        timing[name] = med
        say(tag, f"{name}: rewards {r.float().cpu().numpy().round(6).tolist()} "
            f"preference_prob {_prob(r, pairs, rcfg).cpu().numpy().round(6).tolist()}; "
            f"{med:.4f} s/request (median of {t}), {pairs / med:.3f} pairs/s")

    # the same B=2 forward through the kernels' plain versions, and through
    # the reference attention (neither kernel nor plain version)
    before = _but_norms(launches())
    rp = adaptor.make_score_fn(attn_impl="plain")(params, req2)
    torch.cuda.synchronize()
    if _but_norms(launches()) != before:
        fail(f"{tag}: the plain forward launched a kernel other than the norm kernel")
    # the reference route changes the attention only: on the card a W8A8
    # decoder keeps its epilogue and GEMM kernels there, as in the JAX package
    rx = adaptor.make_score_fn(attn_impl="xla")(params, req2)
    torch.cuda.synchronize()
    if any(launches()[k] != before[k] for k in fa.LAUNCHES):
        fail(f"{tag}: the reference forward launched an attention kernel")
    gap = (r2.float() - rp.float()).abs().max().item()
    floor = (rx.float() - rp.float()).abs().max().item()
    p_k, p_p, p_x = _prob(r2, 1, rcfg), _prob(rp, 1, rcfg), _prob(rx, 1, rcfg)
    same = bool(((p_k > 0.5) == (p_p > 0.5)).all())
    say(tag, f"B=2 kernels vs plain versions: rewards {r2.float().cpu().numpy().tolist()} vs "
        f"{rp.float().cpu().numpy().tolist()}; max gap {gap:.3e} (tol {tol:g}); "
        f"prob {p_k.item():.6f} vs {p_p.item():.6f}; same decision {same}")
    say(tag, f"drift floor, reference attention (attn_impl='xla') vs plain versions: rewards "
        f"{rx.float().cpu().numpy().tolist()}; max gap {floor:.3e}; prob {p_x.item():.6f}; "
        f"same decision {bool(((p_x > 0.5) == (p_p > 0.5)).all())}")
    if gap > tol or not same:
        fail(f"{tag}: B=2 rewards through the kernels disagree with the plain versions")
    _same_decisions(tag, {"kernels": r2, "plain": rp, "reference": rx}, 1, rcfg)
    return total, (r2, r8), timing


def phase_serve(cfg, rcfg, reps=3):
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = {
        "backbone": phi3v.init_params(cfg, gen, torch.bfloat16, "cuda"),
        "head": init_head_params(cfg, rcfg, gen, torch.bfloat16, "cuda"),
    }
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    say("serve", f"random bf16 params: {n_params / 1e9:.3f} B in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    seq = 2560
    req2 = make_request(cfg, gen, 1, seq, {1: 40})
    req8 = make_request(cfg, gen, 4, seq, {})
    params["head"], spread = _principal_head(cfg, rcfg, params, [req2, req8])
    _say_head("serve", "the B=2 and B=8 requests'", spread)
    n_clip = cfg.vision.num_active_layers
    n_dec = cfg.decoder.num_layers
    # per request: B1 in CLIP; B2 x3 + B3 (B=2) or B1 (B=8) in the decoder
    attn2 = {"fa_direct": n_clip, "prep": 3 * n_dec, "fa_hm": n_dec}
    attn8 = {"fa_direct": n_clip + n_dec}
    # and the norm kernel at every norm of the forward (CLIP's LayerNorms,
    # the decoder's RMSNorms and SkipCA's)
    nrm = _norm_launches(cfg)
    bf16_launches, bf16_r, bf16_t = serve_and_check(
        "serve", cfg, rcfg, params, req2, req8, {**attn2, **nrm}, {**attn8, **nrm}, reps)

    # --load_in_8bit: the decoder's projections W8A8, quantized on the card;
    # CLIP and the head stay bf16 (bench.py:209-216)
    t0 = time.perf_counter()
    dec = params["backbone"]["decoder"]
    qparams = {**params, "backbone": {**params["backbone"], "decoder": {
        **dec, "layers": quantize_stacked_layers(dec["layers"], scheme="w8a8")}}}
    torch.cuda.synchronize()
    quantized = [k for k, v in qparams["backbone"]["decoder"]["layers"].items()
                 if isinstance(v, dict)]
    say("w8a8", f"decoder quantized in {time.perf_counter() - t0:.1f} s: {quantized}")
    # per decoder layer: B4 x2 (in place of its two norms), B6, B5 and the
    # four GEMMs
    w8 = {"rms_quant": 2 * n_dec, "silu_mul_quant": n_dec, "row_quant": n_dec,
          "int8_matmul": 4 * n_dec, **_norm_launches(cfg, w8a8=True)}
    w8_launches, w8_r, w8_t = serve_and_check(
        "w8a8", cfg, rcfg, qparams, req2, req8, {**attn2, **w8}, {**attn8, **w8}, reps)
    for name, rb, rq in (("B=2", bf16_r[0], w8_r[0]), ("B=8", bf16_r[1], w8_r[1])):
        say("w8a8", f"{name} rewards W8A8 {rq.float().cpu().numpy().round(6).tolist()} beside "
            f"bf16 {rb.float().cpu().numpy().round(6).tolist()} (same weights; for information)")
    for name in ("B=2", "B=8"):
        say("w8a8", f"{name}: W8A8 {w8_t[name]:.4f} s/request beside bf16 {bf16_t[name]:.4f}")

    # the CLIP tower W8A8 as well, as the JAX package's tests build it: no
    # adaptor option quantizes the tower
    t0 = time.perf_counter()
    clip = qparams["backbone"]["vision"]["clip"]
    qclip = {**clip, "layers": quantize_stacked_layers(clip["layers"], scheme="w8a8")}
    tparams = {**qparams, "backbone": {**qparams["backbone"], "vision": {
        **qparams["backbone"]["vision"], "clip": qclip}}}
    torch.cuda.synchronize()
    quantized = sorted(n for g in ("attn", "mlp") for n, v in qclip["layers"][g].items()
                       if isinstance(v["kernel"], dict))
    say("w8a8-tower", f"CLIP tower quantized in {time.perf_counter() - t0:.1f} s: {quantized}")
    # per active CLIP layer: B9 x2, one fused qkv GEMM and fc1 on its codes,
    # out and fc2 on the dynamic form (B6 + GEMM)
    tw = {**w8, "ln_quant": 2 * n_clip, "row_quant": n_dec + 2 * n_clip,
          "int8_matmul": 4 * n_dec + 4 * n_clip,
          **_norm_launches(cfg, w8a8=True, tower_w8a8=True)}
    tw_launches, tw_r, tw_t = serve_and_check(
        "w8a8-tower", cfg, rcfg, tparams, req2, req8, {**attn2, **tw}, {**attn8, **tw}, reps,
        tol=TOWER_REWARD_TOL)
    for name, rq, rt in (("B=2", w8_r[0], tw_r[0]), ("B=8", w8_r[1], tw_r[1])):
        say("w8a8-tower", f"{name} rewards tower+decoder W8A8 "
            f"{rt.float().cpu().numpy().round(6).tolist()} beside decoder W8A8 "
            f"{rq.float().cpu().numpy().round(6).tolist()} (same weights; for information); "
            f"{tw_t[name]:.4f} s/request beside {w8_t[name]:.4f} and bf16 {bf16_t[name]:.4f}")
    for i, (name, pairs) in enumerate((("B=2", 1), ("B=8", 4))):
        _same_decisions("w8a8-tower", {"bf16": bf16_r[i], "decoder W8A8": w8_r[i],
                                       "tower + decoder W8A8": tw_r[i]}, pairs, rcfg)
    _clip_tower_check(cfg, clip, qclip, req2, req8)
    del qparams, tparams, qclip
    torch.cuda.empty_cache()
    return {k: bf16_launches[k] + w8_launches[k] + tw_launches[k] for k in bf16_launches}, params


@torch.inference_mode()
def _clip_tower_check(cfg, clip, qclip, req2, req8):
    """The W8A8 CLIP tower alone from the B=2 request's 34 crops: its patch
    features through the kernels (B9, B6, the GEMM, B1) against the plain
    versions, as the worst crop's relative L2 error, beside the reference
    attention's; and the B=8 tower's time, W8A8 beside bf16."""
    vc = cfg.vision
    pix = req2.pixel_values.reshape(-1, *req2.pixel_values.shape[2:]).to(torch.bfloat16)
    outs = {i: clip_vit.extract_patch_features(qclip, vc, pix, attn_impl=i)
            for i in ("auto", "plain", "xla")}
    err, floor = (max(_rel_err(a, b) for a, b in zip(outs[i], outs["plain"]))
                  for i in ("auto", "xla"))
    finite = bool(torch.isfinite(outs["auto"]).all())
    say("w8a8-tower", f"CLIP tower W8A8 {tuple(pix.shape)} -> {tuple(outs['auto'].shape)}, "
        f"kernels vs plain versions: worst crop's relative L2 error {err:.3e} (tol "
        f"{TOWER_PART_TOL:g}); reference attention vs plain {floor:.3e}; finite {finite}")
    if err > TOWER_PART_TOL or not finite:
        fail("w8a8-tower: the CLIP tower through the kernels disagrees with the plain versions")
    del outs
    pix8 = req8.pixel_values.reshape(-1, *req8.pixel_values.shape[2:]).to(torch.bfloat16)
    ms = {tag: time_ms(lambda: clip_vit.extract_patch_features(tree, vc, pix8), iters=3, warmup=1)
          for tag, tree in (("bf16", clip), ("W8A8", qclip))}
    say("w8a8-tower", f"B=8 CLIP tower alone (136 crops): W8A8 {ms['W8A8']:.2f} ms beside bf16 "
        f"{ms['bf16']:.2f} ms")


# ------------------------------------------------------------------ [data]

SAMPLE_PAIRS = "data/sample_test/pairwise_sample.json"
DATA_SEQ = 2560
BANK_TOL = 1e-5  # the device bank against the host f32 bank (tests/test_torch_pixels.py)
TAB_KEYS = ("hidx", "hw", "vidx", "vw", "vbias", "col_start", "slot_perm", "tflag")
PEAK_FP64_FLOPS = 67e12  # H100 SXM fp64 tensor cores (data sheet): prepare_pixel_bank's products
# rewards of the u8 pixel modes against the host f32 bank's on the card: the
# banks differ by float rounding (<= BANK_TOL, the sharp check), which bf16
# turns into one-ulp flips of a few pixels that 55 bf16 attention layers then
# carry, as any two attention routes drift (REWARD_TOL); the CPU test holds the
# same comparison to 1e-4 in f32 (tests/test_torch_sample_e2e.py)
DATA_REWARD_TOL = REWARD_TOL
PARITY_BAR = 2.03e-05  # PARITY.md: max reward gap of two f32 routes


class SmokeTok:
    """A word tokenizer of the smoke's own: crc32 of each word into the
    vocabulary, ``<|image_pad|>`` (Qwen2.5-VL) and ``<image>`` (LLaVA-NeXT)
    the image id, ``<|video_pad|>`` Qwen2.5-VL's video id, and chat
    templates of the lengths the dataset layer slices (Phi-3's 22-character
    assistant cue; Qwen2.5-VL's 58-character system preamble and 23-character
    cue)."""

    eos_token = "<|endoftext|>"

    def __init__(self, vocab_size, image_token_id=-1):
        self.vocab_size, self.image_token_id = vocab_size, image_token_id

    def __call__(self, text):
        return {"input_ids": [self.image_token_id if w in ("<|image_pad|>", "<image>") else
                              Qwen25VLProcessor.VIDEO_TOKEN_ID if w == "<|video_pad|>" else
                              3 + zlib.crc32(w.encode()) % (self.vocab_size - 16)
                              for w in text.split()]}

    def apply_chat_template(self, msgs, tokenize=False, add_generation_prompt=True):
        content = msgs[0]["content"]
        if isinstance(content, list):
            body = " ".join("<|image_pad|>" if c["type"] == "image" else c["text"]
                            for c in content)
            return ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
                    f"<|im_start|>user\n{body}<|im_end|>\n<|im_start|>assistant\n")
        return f"<|user|>\n{content}<|end|>\n<|assistant|>\n"


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _synthetic(w, h, seed):
    """A seeded RGB image: blocky noise, upsampled, with fine noise on top."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (max(h // 8, 1), max(w // 8, 1), 3), dtype=np.uint8)
    img = Image.fromarray(base).resize((w, h), Image.BILINEAR)
    return Image.fromarray(np.asarray(img) ^ rng.integers(0, 32, (h, w, 3), dtype=np.uint8))


def _sample_rows():
    with open(SAMPLE_PAIRS) as f:
        return json.load(f)


def _host_batch(proc, prompts, images, seq=None):
    """Every (prompt, images) processed and collated on the host: the batch,
    its seconds, and the sequence length (``seq``, or the longest sample's
    rounded up to 256)."""
    t0 = time.perf_counter()
    samples = [proc(p, im) for p, im in zip(prompts, images)]
    longest = max(len(s.input_ids) for s in samples)
    if seq is None:
        seq = -(-longest // 256) * 256
    elif longest > seq:
        fail(f"data: a sample of {longest} tokens exceeds the sequence length {seq}")
    batch = collate_samples(samples, seq, 0)
    return batch, time.perf_counter() - t0, seq


def _bank_checks(tag, banks):
    """The device pixel ops on the card against the host: the u8-source
    batch resized on the card equals the host's u8 crops byte for byte, and
    the u8 crops prepared on the card stand within BANK_TOL of the host's f32
    bank of the same crops (``host_bank_from_u8``: real crops and the global
    view). The f32 mode's own bank is printed beside: where the native library
    built, its resampler is not PIL's and the two banks differ by about one
    u8 step."""
    src, u8, f32 = (banks[m] for m in ("u8src", "u8", "f32"))
    grid = u8["crop_grid"]
    if not np.array_equal(src["crop_grid"], grid):
        fail(f"{tag}: device-resize grids {src['crop_grid'].tolist()} != {grid.tolist()}")
    t = {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in src["resize_tabs"].items()}
    bank = hd_resize_u8_bank(torch.from_numpy(src["pixel_values"]).cuda(),
                             *(t[k] for k in TAB_KEYS)).cpu().numpy()
    dev = prepare_pixel_bank(torch.from_numpy(u8["pixel_values"]).cuda(),
                             torch.from_numpy(grid).cuda()).cpu().numpy()
    if bank.shape != u8["pixel_values"].shape or dev.shape[1] != f32["pixel_values"].shape[1]:
        fail(f"{tag}: bank shapes {bank.shape} / {dev.shape} against the host's")
    differ = err = f32_gap = 0
    for b, (hc, wc) in enumerate(grid):
        n = hc * wc
        differ += int((bank[b, :n] != u8["pixel_values"][b, :n]).sum())
        host = host_bank_from_u8(u8["pixel_values"][b, :n], (hc, wc))
        err = max(err, float(np.abs(dev[b, : n + 1] - host).max()))
        f32_gap = max(f32_gap, float(np.abs(dev[b, : n + 1] - f32["pixel_values"][b, : n + 1])
                                     .max()))
    say(tag, f"grids {grid.tolist()}: hd_resize_u8_bank on the card vs the host's crops: "
        f"{differ} differing bytes (want 0); prepare_pixel_bank vs the host f32 bank of the same "
        f"crops: max abs {err:.3e} (tol {BANK_TOL:g}); vs the f32 mode's bank {f32_gap:.3e} (for "
        f"information)")
    if differ or not err <= BANK_TOL:
        fail(f"{tag}: the device pixel ops disagree with the host")


def _pixel_times(rb):
    """CUDA-event times of the device pixel ops on a batch, each with its
    byte bound (inputs read once, output written once)."""
    out = {}
    x = rb.pixel_values
    if rb.resize_tabs is not None:
        t = [rb.resize_tabs[k] for k in TAB_KEYS]
        ms = time_ms(lambda: hd_resize_u8_bank(x, *t))
        crops = hd_resize_u8_bank(x, *t)
        nbytes = x.numel() + sum(v.numel() * v.element_size() for v in t) + crops.numel()
        out["hd_resize_u8_bank"] = (ms, nbytes / PEAK_BYTES * 1e3, tuple(x.shape),
                                    tuple(crops.shape))
        x = crops
    B, nc = x.shape[:2]
    ms = time_ms(lambda: prepare_pixel_bank(x, rb.crop_grid))
    nbytes = x.numel() + rb.crop_grid.numel() * 4 + B * (nc + 1) * 336 * 336 * 3 * 4
    flops = 2 * B * nc * 336 * 336 * 1008 * 2  # the two fp64 products
    out["prepare_pixel_bank"] = (ms, nbytes / PEAK_BYTES * 1e3, tuple(x.shape),
                                 (B, nc + 1, 336, 336, 3), flops / PEAK_FP64_FLOPS * 1e3)
    return out


def phase_data(cfg, rcfg, params, reps=3):
    """Score the data/sample_test pairs from their image files through the
    port's processor, collator and device pixel path, in the three pixel
    modes; check the device pixel ops against the host's; then the seeded
    synthetic geometries' banks, and a batch that falls back to the host f32
    bank (a 16x1 panorama, a two-image prompt)."""
    t_phase = time.perf_counter()
    tok = SmokeTok(cfg.decoder.vocab_size)
    rows = _sample_rows()
    pairs = len(rows)
    prompts = [apply_phi3v_chat_template(tok, r["prompt"]) for r in rows] * 2
    images = ([[_read(r["chosen_path"])] for r in rows]
              + [[_read(r["reject_path"])] for r in rows])
    adaptor = RewardAdaptor(cfg, rcfg, params, device="cuda")
    score = adaptor.make_score_fn()
    n_clip, n_dec = cfg.vision.num_active_layers, cfg.decoder.num_layers
    # B = 8: B1 in CLIP and in the decoder; the norm kernel at every norm
    per = {"fa_direct": n_clip + n_dec, **_norm_launches(cfg)}
    say("data", f"native image library: {'built' if native.native_available() else 'absent'}"
        f"{'' if native.native_available() else f' ({native.build_error})'}; "
        f"{pairs} pairs of {SAMPLE_PAIRS}, Phi3VProcessor(num_crops={cfg.num_crops}), "
        f"the smoke's own tokenizer")
    counts = dict.fromkeys(launches(), 0)
    banks, rewards, batches = {}, {}, {}
    for mode in ("f32", "u8", "u8src"):
        proc = Phi3VProcessor(tok, num_crops=cfg.num_crops, device_preproc=mode != "f32",
                              device_resize=mode == "u8src")
        calls = dict(native.CALLS)
        batch, host_s, _ = _host_batch(proc, prompts, images, seq=DATA_SEQ)
        ran = {k: native.CALLS[k] - calls[k] for k in calls if native.CALLS[k] != calls[k]}
        t0 = time.perf_counter()
        rb = to_reward_batch(batch, device="cuda")
        torch.cuda.synchronize()
        put_s = time.perf_counter() - t0
        reset_counters()  # the main path's run starts here
        r, times = _serve(score, params, rb, reps)
        got = launches()  # ... and ends here
        want = {k: (reps + 1) * per.get(k, 0) for k in got}
        if got != want:
            fail(f"data {mode}: launches {got} != {want}")
        counts = {k: counts[k] + got[k] for k in counts}
        if r.shape != (2 * pairs, 2) or not bool(torch.isfinite(r).all()):
            fail(f"data {mode}: rewards not finite / wrong shape: {r}")
        pix = _pixel_times(rb) if mode != "f32" else {}
        crops = {"f32": rb.pixel_values.shape[1],
                 "u8": rb.pixel_values.shape[1] + 1,
                 "u8src": (rb.resize_tabs or {"vidx": rb.pixel_values})["vidx"].shape[1] + 1}
        say("data", f"{mode}: host preparation {host_s:.4f} s for the B={2 * pairs} request "
            f"({host_s / pairs:.4f} s a pair; native calls {ran or 'none: the Python path'}), "
            f"to the card {put_s:.4f} s; pixel_values {tuple(rb.pixel_values.shape)} "
            f"{rb.pixel_values.dtype}, grids "
            f"{batch['crop_grid'].tolist() if 'crop_grid' in batch else 'host'}; device pixel "
            + (", ".join(f"{k} {v[0]:.4f} ms {v[2]} -> {v[3]} (byte bound {v[1]:.4f} ms"
                         + (f", fp64 products {v[4]:.4f} ms" if len(v) > 4 else "") + ")"
                         for k, v in pix.items()) or "none (host bank)")
            + f"; score {float(np.median(times)):.4f} s/request (median of {times}); B1 "
            f"{got['fa_direct'] // (reps + 1)} launches a request, CLIP on "
            f"{rb.input_ids.shape[0]} x {crops[mode]} crops (the bucket); rewards "
            f"{r.float().cpu().numpy().round(6).tolist()}")
        banks[mode], rewards[mode], batches[mode] = batch, r.float(), rb
    _bank_checks("data", banks)
    gap_src = (rewards["u8src"] - rewards["u8"]).abs().max().item()
    gap_f32 = (rewards["u8"] - rewards["f32"]).abs().max().item()
    dec = {m: (_prob(r, pairs, rcfg) > 0.5).cpu() for m, r in rewards.items()}
    same = bool((dec["u8"] == dec["f32"]).all() and (dec["u8src"] == dec["u8"]).all())
    say("data", f"rewards, u8 sources vs u8 crops (equal banks): max gap {gap_src:.3e} (want 0); "
        f"u8 crops vs host f32: max gap {gap_f32:.3e} (tol {DATA_REWARD_TOL:g}); same decisions "
        f"{same}")
    if gap_src != 0 or not gap_f32 <= DATA_REWARD_TOL or not same:
        fail("data: the three pixel modes' rewards disagree")

    # seeded geometries: a 4x4 grid, a portrait, a wide one (banks only)
    geo = [_synthetic(340, 330, 2), _synthetic(150, 420, 3), _synthetic(500, 180, 5)]
    gbanks = {}
    for mode in ("f32", "u8", "u8src"):
        proc = Phi3VProcessor(tok, num_crops=cfg.num_crops, device_preproc=mode != "f32",
                              device_resize=mode == "u8src")
        gbanks[mode] = _host_batch(proc, prompts[:3], [[g] for g in geo], seq=DATA_SEQ)[0]
    _bank_checks("data-geometries", gbanks)

    # the host f32 fallback: a 16x1 panorama (over MAX_GRID) and a two-image
    # prompt, from a device-preprocessing processor, scored once (B=2)
    proc = Phi3VProcessor(tok, num_crops=cfg.num_crops, device_preproc=True)
    two = "<|user|>\n<|image_1|>\nfirst <|image_2|>\nsecond, which is better?" + tok.eos_token
    fb, fb_s, fb_seq = _host_batch(
        proc, [prompts[0], two],
        [[_synthetic(1700, 100, 4)], [_synthetic(300, 200, 6), images[0][0]]])
    if fb["pixel_values"].dtype != np.float32 or "crop_grid" in fb:
        fail("data: the fallback batch is not the host f32 bank")
    rb = to_reward_batch(fb, device="cuda")
    reset_counters()  # the main path's run starts here
    r = score(params, rb)
    torch.cuda.synchronize()
    got = launches()  # ... and ends here
    want = {"fa_direct": n_clip, "prep": 3 * n_dec, "fa_hm": n_dec,  # B=2
            **_norm_launches(cfg)}
    if got != {k: want.get(k, 0) for k in got} or not bool(torch.isfinite(r).all()):
        fail(f"data: fallback batch launches {got} != {want} or rewards {r}")
    counts = {k: counts[k] + got[k] for k in counts}
    say("data", f"host f32 fallback (a 16x1 panorama; two images in one prompt): pixel_values "
        f"{tuple(rb.pixel_values.shape)}, seq {fb_seq}, host {fb_s:.4f} s, rewards "
        f"{r.float().cpu().numpy().round(6).tolist()}; phase {time.perf_counter() - t_phase:.1f} s")
    return counts, batches["u8"], rewards["u8"]


# ------------------------------------------------------------------ [load]


def _manifest_config(name, layers):
    with open(os.path.join("tools", "manifests", name, "config.json")) as f:
        cj = json.load(f)
    cj["num_hidden_layers"] = layers
    return cj


def _dir_bytes(*dirs):
    return sum(os.path.getsize(os.path.join(d, f)) for root in dirs
               for d, _, files in os.walk(root) for f in files)


def _bf16_lora(lora):
    """The adapters as the artifact stores them (bf16), widened back."""
    return tree_map(lambda t: t.to(torch.bfloat16).float(), lora)


def _assert_tree_equal(tag, got, want, path=""):
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            fail(f"{tag}: tree keys differ at {path or '/'}: {sorted(got)} vs {sorted(want)}")
        for k in want:
            _assert_tree_equal(tag, got[k], want[k], f"{path}/{k}")
        return
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        d = (got.float() - want.float()).abs().max().item() if got.shape == want.shape else "n/a"
        fail(f"{tag}: loaded leaf {path} {got.dtype} {tuple(got.shape)} differs from the written "
             f"one {want.dtype} {tuple(want.shape)} (max abs {d})")


def _write_artifact(pm, rcfg, head, projector, lora, dcfg, targets, model_type):
    artifact.save_reward_artifact(
        pm, rcfg, head, projector_params=projector,
        lora_state=stacked_to_peft_state(lora, dcfg),
        lora_config=peft_adapter_config(LORA_R, LORA_ALPHA, 0.05, targets=targets),
        model_type=model_type)


def _load_and_score(tag, base, pm, model_type, want, batch, per, quantize=None):
    """``load_reward_adaptor`` on the card (read in f32, the LoRA merged,
    cast to bf16): its tree leaf for leaf against ``want``, the rewards on
    ``batch`` against the same tree built in memory, its launches per
    request (``per``). Returns (launches, rewards, load seconds, gap)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adaptor = load_reward_adaptor(base, pm, model_type=model_type, compute_dtype=torch.bfloat16,
                                  quantize=quantize, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    _assert_tree_equal(tag, adaptor.params["backbone"], want["backbone"])
    _assert_tree_equal(tag, adaptor.params["head"], want["head"])
    reset_counters()  # the main path's run starts here
    r = adaptor.make_score_fn()(adaptor.params, batch)
    torch.cuda.synchronize()
    got = launches()  # ... and ends here
    if got != {k: per.get(k, 0) for k in got}:
        fail(f"{tag}: launches {got} != {per}")
    ref = RewardAdaptor(adaptor.cfg, adaptor.rcfg, want, model_type=model_type,
                        device="cuda").make_score_fn()(want, batch)
    gap = (r.float() - ref.float()).abs().max().item()
    if not bool(torch.isfinite(r).all()) or not gap <= PARITY_BAR:
        fail(f"{tag}: rewards {r} against the in-memory tree's {ref} (gap {gap:.3e})")
    return got, r, load_s, gap


def _qwen_sample_batch(qcfg):
    """The data/sample_test pairs through the port's Qwen2.5-VL processor
    (u8 patches), collated on the host, on the card."""
    tok = SmokeTok(qcfg.text.vocab_size, qcfg.text.image_token_id)
    vc = qcfg.vision
    proc = Qwen25VLProcessor(tok, patch_size=vc.patch_size,
                             temporal_patch_size=vc.temporal_patch_size,
                             merge_size=vc.spatial_merge_size, window_size=vc.window_size,
                             min_pixels=qcfg.min_pixels, max_pixels=qcfg.max_pixels,
                             image_token_id=qcfg.text.image_token_id, device_preproc=True)
    rows = _sample_rows()
    samples = [proc(apply_qwen_chat_template(tok, r["prompt"]),
                    [Image.open(r[k]).convert("RGB")])
               for k in ("chosen_path", "reject_path") for r in rows]
    seq = -(-max(len(s.input_ids) for s in samples) // 128) * 128
    patches = -(-max(s.patches.shape[0] for s in samples) // 64) * 64
    units = max(s.unit_gather.shape[0] for s in samples)
    batch = collate_qwen_samples(samples, seq, qcfg.text.pad_token_id, patches, units)
    return to_reward_batch(batch, device="cuda"), (seq, patches)


def phase_load(cfg, rcfg, params, qcfg, data_batch, tmp):
    """Write a 2-layer, full-width Phi-3.5-vision base checkpoint (HF keys,
    the published config.json at 2 layers) and a reward artifact (LoRA r=128
    on DEFAULT_TARGETS, heads, projector), load them through
    load_reward_adaptor in bf16 and W8A8 and score the sample pairs; then
    Qwen2.5-VL-7B with 2 decoder layers and the whole 32-block tower, bf16.
    The files go to ``tmp`` (a temporary directory under build/); the
    phi3v pair stays there for [eval], the qwen one is removed. Returns the
    launches and the phi3v (base, artifact) directories."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    counts = dict.fromkeys(launches(), 0)
    # --- phi3v: phase 4's tree cut to 2 decoder layers
    base, pm = os.path.join(tmp, "phi3v_base"), os.path.join(tmp, "phi3v_pm")
    os.makedirs(base)
    with open(os.path.join(base, "config.json"), "w") as f:
        json.dump(_manifest_config("phi35_vision_instruct", 2), f)
    cfg2 = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_layers=2))
    bb = params["backbone"]
    tree = {**bb, "decoder": {**bb["decoder"], "layers": tree_map(
        lambda t: t[:2], bb["decoder"]["layers"])}}
    lora = init_lora(cfg2.decoder, LORA_R, LORA_ALPHA, gen, device="cuda")
    for t in lora.values():
        t["b"].normal_(0.0, 1e-3, generator=gen)
    proj = tree_map(lambda t: (t.float() * 1.5).to(t.dtype), bb["vision"]["img_projection"])
    t0 = time.perf_counter()
    save_torch_state_dict(hf_phi3v.hf_state_dict_from_params(tree, cfg2),
                          os.path.join(base, "pytorch_model.bin"))
    _write_artifact(pm, rcfg, params["head"], proj, lora, cfg2.decoder, DEFAULT_TARGETS,
                    "phi3v")
    write_s, nbytes = time.perf_counter() - t0, _dir_bytes(base, pm)
    # the same tree in memory: f32, the stored adapters and projector merged
    merged = merge_for_scoring(tree_map(lambda t: t.float(), tree), "phi3v",
                               lora=_bf16_lora(lora),
                               projector=tree_map(lambda t: t.float(), proj))
    n_clip = cfg.vision.num_active_layers
    got, r, load_s, gap = _load_and_score(
        "load", base, pm, "phi3v",
        {"backbone": cast_params(merged, torch.bfloat16), "head": params["head"]},
        data_batch, {"fa_direct": n_clip + 2, **_norm_launches(cfg2)})
    counts = {k: counts[k] + got[k] for k in counts}
    say("load", f"phi3v: wrote {nbytes / 1e9:.3f} GB (base: 2 decoder layers, every width "
        f"and the CLIP tower; artifact: LoRA r={LORA_R} on {list(DEFAULT_TARGETS)}, heads, "
        f"projector) in {write_s:.2f} s; load_reward_adaptor bf16 read {nbytes / 1e9:.3f} GB "
        f"in {load_s:.2f} s; the tree equals the written one leaf for leaf after the merge; "
        f"sample-pair rewards {r.float().cpu().numpy().round(6).tolist()}, against the "
        f"in-memory tree's: max gap {gap:.3e} (tol {PARITY_BAR:g}); launches {got}")
    # W8A8: the merged f32 decoder quantized, then the rest cast
    qdec = {**merged["decoder"], "layers": quantize_stacked_layers(
        merged["decoder"]["layers"], scheme="w8a8")}
    want = {"backbone": cast_params({**merged, "decoder": qdec}, torch.bfloat16),
            "head": params["head"]}
    w8 = {"rms_quant": 4, "silu_mul_quant": 2, "row_quant": 2, "int8_matmul": 8}
    got, rq, load_q, gapq = _load_and_score("load-w8a8", base, pm, "phi3v", want,
                                            data_batch, {"fa_direct": n_clip + 2, **w8,
                                                         **_norm_launches(cfg2, w8a8=True)},
                                            quantize="w8a8")
    counts = {k: counts[k] + got[k] for k in counts}
    say("load", f"phi3v W8A8: load_reward_adaptor(quantize='w8a8') in {load_q:.2f} s; codes "
        f"and scales equal to quantizing the merged tree; rewards "
        f"{rq.float().cpu().numpy().round(6).tolist()} (the bf16 load's beside, for "
        f"information: {r.float().cpu().numpy().round(6).tolist()}), against the in-memory "
        f"W8A8 tree's: max gap {gapq:.3e}; launches {got}")
    del merged, qdec, want, tree, lora, proj
    phi3v_dirs = (base, pm)
    torch.cuda.empty_cache()

    # --- qwen: 2 decoder layers, the whole tower
    qcfg2 = dataclasses.replace(qcfg, text=dataclasses.replace(qcfg.text, num_layers=2))
    qrcfg = RewardConfig(is_general_preference=True, value_head_dim=2,
                         add_cross_attention=True, layer_id=2)
    qtree = qwen25_vl.init_params(qcfg2, gen, torch.bfloat16, "cuda")
    qhead = init_head_params(qcfg2, qrcfg, gen, torch.bfloat16, "cuda")
    qlora = init_lora(qcfg2.text, LORA_R, LORA_ALPHA, gen, targets=QWEN_TARGETS,
                      device="cuda")
    for t in qlora.values():
        t["b"].normal_(0.0, 1e-3, generator=gen)
    merger = tree_map(lambda t: (t.float() * 1.25).to(t.dtype), qtree["visual"]["merger"])
    base, pm = os.path.join(tmp, "qwen_base"), os.path.join(tmp, "qwen_pm")
    os.makedirs(base)
    with open(os.path.join(base, "config.json"), "w") as f:
        json.dump(_manifest_config("qwen25_vl_7b_instruct", 2), f)
    t0 = time.perf_counter()
    save_torch_state_dict(hf_qwen.hf_state_dict_from_params(qtree, qcfg2),
                          os.path.join(base, "pytorch_model.bin"))
    _write_artifact(pm, qrcfg, qhead, merger, qlora, qcfg2.text, QWEN_TARGETS, "qwen")
    write_s, nbytes = time.perf_counter() - t0, _dir_bytes(base, pm)
    merged = merge_for_scoring(tree_map(lambda t: t.float(), qtree), "qwen",
                               lora=_bf16_lora(qlora),
                               projector=tree_map(lambda t: t.float(), merger))
    want = {"backbone": cast_params(merged, torch.bfloat16), "head": qhead}
    del merged, qtree
    batch, (qseq, qpatches) = _qwen_sample_batch(qcfg2)
    n_full = len(qcfg.vision.fullatt_block_indexes)
    got, r, load_s, gap = _load_and_score("load-qwen", base, pm, "qwen", want, batch,
                                          {"prep": 3 * 2, "fa_hm": 2 + n_full,
                                           **_norm_launches(qcfg2)})
    counts = {k: counts[k] + got[k] for k in counts}
    say("load", f"qwen: wrote {nbytes / 1e9:.3f} GB (base: the {qcfg.vision.depth}-block "
        f"tower and 2 decoder layers at every width; artifact: LoRA r={LORA_R} on "
        f"{list(QWEN_TARGETS)}, heads, merger) in {write_s:.2f} s; load_reward_adaptor bf16 "
        f"read {nbytes / 1e9:.3f} GB in {load_s:.2f} s; the tree equals the written one "
        f"leaf for leaf after the merge and fusion; sample pairs (u8 patches, seq {qseq}, "
        f"{qpatches} patches): rewards {r.float().cpu().numpy().round(6).tolist()}, against "
        f"the in-memory tree's: max gap {gap:.3e} (tol {PARITY_BAR:g}); launches {got}")
    del want
    shutil.rmtree(base)
    shutil.rmtree(pm)
    torch.cuda.empty_cache()
    say("load", f"phase {time.perf_counter() - t_phase:.1f} s")
    return counts, phi3v_dirs


def qwen_request(qcfg, rng, grids, left_pad):
    """One Qwen2.5-VL request: per row a uint8 image of ``grids[i]`` patches
    (raw pixels, normalised on the card) spliced after 2 text tokens, random
    text to QWEN_SEQ tokens less ``left_pad[i]``, collated to the static
    (1792 tokens, 1280 patches, 320 units) budget on the card."""
    tc, vc = qcfg.text, qcfg.vision
    samples = []
    for i, grid in enumerate(grids):
        n_units = (grid[1] // 2) * (grid[2] // 2)
        n_text = QWEN_SEQ - left_pad.get(i, 0) - n_units + 1  # + the placeholder
        ids = rng.integers(2, 150000, n_text).astype(np.int32)
        ids[2] = tc.image_token_id  # the placeholder sample_from_patches expands
        patches = rng.integers(0, 256, (grid[1] * grid[2], vc.patch_dim)).astype(np.uint8)
        samples.append(sample_from_patches(ids, patches, grid, tc.image_token_id,
                                           vc.window_size, vc.patch_size,
                                           vc.spatial_merge_size))
    return to_reward_batch(collate_qwen_samples(samples, QWEN_SEQ, tc.pad_token_id,
                                                QWEN_PATCHES, QWEN_UNITS), device="cuda")


def phase_serve_qwen(qcfg, reps=3):
    """Qwen2.5-VL-7B scoring at full width and depth, bf16 then W8A8."""
    torch.cuda.empty_cache()
    tc, vc = qcfg.text, qcfg.vision
    rcfg = RewardConfig(is_general_preference=True, value_head_dim=2, add_cross_attention=True,
                        layer_id=tc.num_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    backbone = qwen25_vl.init_params(qcfg, gen, torch.bfloat16, "cuda")
    # the inference layout the adaptor loads (fused qkv and gate_up)
    backbone["text"]["layers"] = qwen25_vl.fuse_decoder_projections(backbone["text"]["layers"])
    params = {"backbone": backbone, "head": init_head_params(qcfg, rcfg, gen, torch.bfloat16,
                                                             "cuda")}
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    say("qwen", f"Qwen2.5-VL-7B random bf16 params (decoder fused): {n_params / 1e9:.3f} B in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(0)
    req2 = qwen_request(qcfg, rng, QWEN_GRIDS, {1: 40})
    req8 = qwen_request(qcfg, rng, [QWEN_GRIDS[0]] * 8, {})
    say("qwen", f"requests: seq {QWEN_SEQ}, u8 patches {tuple(req8.pixel_values.shape)}, "
        f"B=2 valid patches {req2.patch_valid.ne(0).sum(1).tolist()}, units "
        f"{req2.num_img_tokens.tolist()}, left pad {(1 - req2.attention_mask).sum(1).tolist()}")
    params["head"], spread = _principal_head(qcfg, rcfg, params, [req2, req8])
    _say_head("qwen", "the B=2 and B=8 requests'", spread)
    n_dec, n_full = tc.num_layers, len(vc.fullatt_block_indexes)
    # per request: B2 x3 + B3 in each decoder layer, B3 (segments) in each
    # full-attention vision block; the 64-patch windows stay on the reference
    # and the norm kernel at every norm: the tower's and the merger's, the
    # decoder's and SkipCA's
    attn = {"prep": 3 * n_dec, "fa_hm": n_dec + n_full, **_norm_launches(qcfg)}
    torch.cuda.reset_peak_memory_stats()
    bf16_launches, bf16_r, bf16_t = serve_and_check(
        "qwen", qcfg, rcfg, params, req2, req8, attn, attn, reps, "qwen", QWEN_REWARD_TOL)
    say("qwen", f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (bf16 serving)")

    # --load_in_8bit: the decoder's projections W8A8, quantized on the card;
    # the vision tower and the head stay bf16. Quantizing the fused leaves
    # gives the codes of quantizing q/k/v (gate/up) and fusing after: the
    # scales are per output column.
    t0 = time.perf_counter()
    text = params["backbone"]["text"]
    qparams = {**params, "backbone": {**params["backbone"], "text": {
        **text, "layers": quantize_stacked_layers(text["layers"], scheme="w8a8")}}}
    torch.cuda.synchronize()
    quantized = [k for k, v in qparams["backbone"]["text"]["layers"].items()
                 if isinstance(v, dict) and isinstance(v.get("kernel"), dict)]
    say("qwen-w8a8", f"decoder quantized in {time.perf_counter() - t0:.1f} s: {quantized}")
    w8 = {"rms_quant": 2 * n_dec, "silu_mul_quant": n_dec, "row_quant": n_dec,
          "int8_matmul": 4 * n_dec, **_norm_launches(qcfg, w8a8=True)}
    torch.cuda.reset_peak_memory_stats()
    w8_launches, w8_r, w8_t = serve_and_check(
        "qwen-w8a8", qcfg, rcfg, qparams, req2, req8, {**attn, **w8}, {**attn, **w8}, reps,
        "qwen", QWEN_W8A8_REWARD_TOL)
    say("qwen-w8a8", f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (bf16 and "
        f"W8A8 trees both held)")
    for name, rb, rq in (("B=2", bf16_r[0], w8_r[0]), ("B=8", bf16_r[1], w8_r[1])):
        say("qwen-w8a8", f"{name} rewards W8A8 {rq.float().cpu().numpy().round(6).tolist()} "
            f"beside bf16 {rb.float().cpu().numpy().round(6).tolist()} (same weights; for "
            f"information)")
    for name in ("B=2", "B=8"):
        say("qwen-w8a8", f"{name}: W8A8 {w8_t[name]:.4f} s/request beside bf16 "
            f"{bf16_t[name]:.4f}")
    for i, (name, pairs) in enumerate((("B=2", 1), ("B=8", 4))):
        _same_decisions("qwen-w8a8", {"bf16": bf16_r[i], "W8A8": w8_r[i]}, pairs, rcfg)
    _qwen_part_checks(qcfg, params, qparams, req2)
    _qwen_time_split(qcfg, params, qparams, req8, bf16_t["B=8"], w8_t["B=8"])
    video = phase_video(qcfg, rcfg, params, qparams, reps)
    return {k: bf16_launches[k] + w8_launches[k] + video[k] for k in bf16_launches}


VIDEO_SHAPE = (16, 360, 480)  # frames, height, width of each seeded u8 video
VIDEO_FPS = 4.0
VIDEO_GRID = (4, 26, 34)  # 8 frames sampled, resized to 364 x 476
VIDEO_PATCHES, VIDEO_UNITS = 4 * 20 * 64, 4 * 13 * 17  # 20 windows a slice; 884 video tokens


def _video_requests(qcfg):
    """Four pairs of seeded u8 videos (16 frames of 360 x 480 at video_fps 4:
    8 frames sampled, each resized to 364 x 476, grid (4, 26, 34), 884 video
    tokens, 20 windows of 64 patch slots in each temporal slice, padded)
    through Qwen25VLProcessor(videos=...) at seq 1792, the rejected rows
    left-padded by 40. Returns the B=2 request (the first pair), the B=8 one
    (c0..c3, r0..r3) and the host seconds a video took."""
    tc, vc = qcfg.text, qcfg.vision
    proc = Qwen25VLProcessor(SmokeTok(tc.vocab_size, tc.image_token_id),
                             window_size=vc.window_size, image_token_id=tc.image_token_id)
    rng = np.random.default_rng(7)
    vids = [rng.integers(0, 256, (*VIDEO_SHAPE, 3), dtype=np.uint8) for _ in range(8)]
    t0 = time.perf_counter()
    samples = []
    for j, v in enumerate(vids):
        fill = QWEN_SEQ - (40 if j >= 4 else 0) - VIDEO_UNITS
        text = " ".join(["<|video_pad|>"] + [f"w{i}" for i in range(fill)])
        samples.append(proc(text, videos=[{"video": v, "video_fps": VIDEO_FPS}]))
    host_s = (time.perf_counter() - t0) / len(vids)
    for smp in samples:
        ids = sorted(np.unique(smp.patch_valid).tolist())
        if (smp.grid_thw != VIDEO_GRID or smp.num_img_tokens != VIDEO_UNITS
                or smp.patches.shape[0] != VIDEO_PATCHES or ids != [0, 1, 2, 3, 4]):
            fail(f"video: sample grid {smp.grid_thw}, {smp.num_img_tokens} tokens, "
                 f"{smp.patches.shape[0]} patch slots, segment ids {ids}")
    pad = tc.pad_token_id

    def batch(rows):
        return to_reward_batch(collate_qwen_samples(rows, QWEN_SEQ, pad, VIDEO_PATCHES,
                                                    VIDEO_UNITS), device="cuda")

    return batch([samples[0], samples[4]]), batch(samples), host_s


def phase_video(qcfg, rcfg, params, qparams, reps=3):
    """[video]: Qwen2.5-VL-7B scoring videos on phase 5q's trees (bf16, and
    the decoder W8A8), B=2 and B=8 on the kernel route, the B=2 rewards
    against the plain route and the reference attention; a value head on the
    video rows' principal directions; every pair's decision the same across
    the routes and the two trees. Per request: B2 x3 + B3 in each decoder
    layer, B3 in segment mode (four nonzero ids, one a temporal slice) in
    the four full-attention vision blocks; W8A8 adds B4 x2, B5, B6 and four
    GEMMs a layer."""
    t_phase = time.perf_counter()
    tc, vc = qcfg.text, qcfg.vision
    n_dec, n_full = tc.num_layers, len(vc.fullatt_block_indexes)
    v2, v8, host_s = _video_requests(qcfg)
    say("video", f"requests: 8 seeded u8 videos of {VIDEO_SHAPE[0]} frames {VIDEO_SHAPE[1]} x "
        f"{VIDEO_SHAPE[2]} at video_fps {VIDEO_FPS:g} through Qwen25VLProcessor(videos=...): "
        f"{host_s:.3f} s of host preparation a video (frame sampling, bicubic resize, patches, "
        f"windows); grid {VIDEO_GRID}, {VIDEO_UNITS} video tokens, f32 patches "
        f"{tuple(v8.pixel_values.shape)}, segment ids {sorted(v8.patch_valid.unique().tolist())}, "
        f"{int(v2.patch_valid[0].ne(0).sum())} valid of {VIDEO_PATCHES} slots a row, left pad "
        f"B=2 {(1 - v2.attention_mask).sum(1).tolist()}")
    head, spread = _principal_head(qcfg, rcfg, params, [v2, v8])
    _say_head("video", "the video rows'", spread)
    vp, vq = {**params, "head": head}, {**qparams, "head": head}
    attn = {"prep": 3 * n_dec, "fa_hm": n_dec + n_full, **_norm_launches(qcfg)}
    w8 = {"rms_quant": 2 * n_dec, "silu_mul_quant": n_dec, "row_quant": n_dec,
          "int8_matmul": 4 * n_dec, **_norm_launches(qcfg, w8a8=True)}
    torch.cuda.reset_peak_memory_stats()
    bf16_launches, bf16_r, bf16_t = serve_and_check(
        "video", qcfg, rcfg, vp, v2, v8, attn, attn, reps, "qwen", QWEN_REWARD_TOL)
    w8_launches, w8_r, w8_t = serve_and_check(
        "video-w8a8", qcfg, rcfg, vq, v2, v8, {**attn, **w8}, {**attn, **w8}, reps, "qwen",
        QWEN_W8A8_REWARD_TOL)
    for i, (name, pairs) in enumerate((("B=2", 1), ("B=8", 4))):
        _same_decisions("video-w8a8", {"bf16": bf16_r[i], "W8A8": w8_r[i]}, pairs, rcfg)
        say("video", f"{name}: bf16 {bf16_t[name]:.4f} s/request ({pairs / bf16_t[name]:.3f} "
            f"pairs/s), W8A8 {w8_t[name]:.4f} s/request; host preparation "
            f"{2 * pairs * host_s:.3f} s for the request's videos")
    say("video", f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (bf16 and W8A8 trees "
        f"held); phase {time.perf_counter() - t_phase:.1f} s")
    return {k: bf16_launches[k] + w8_launches[k] for k in bf16_launches}


@torch.inference_mode()
def _qwen_time_split(qcfg, params, qparams, req, bf16_s, w8_s):
    """Where a B=8 request's time goes: the vision tower, and decoder layer 0
    (bf16, W8A8) times the depth, each timed alone through the kernels."""
    tc, vc = qcfg.text, qcfg.vision
    vin = (req.pixel_values, req.patch_valid, req.rot_pos, req.unit_gather, req.num_img_tokens)
    vis = params["backbone"]["visual"]
    vis_ms = time_ms(lambda: qwen25_vl.vision_forward(vis, vc, *vin), iters=3, warmup=1)
    # one window block and one full block on the same hidden state
    x = torch.randn(*req.patch_valid.shape, vc.hidden_size, device="cuda", dtype=torch.bfloat16)
    vcos, vsin = qwen25_vl._vision_rope(req.rot_pos, vc.head_dim)
    n_full = len(vc.fullatt_block_indexes)
    block_ms = {full: time_ms(lambda: qwen25_vl._vision_block(
        x, layer_slice(vis["blocks"], i), vc, vcos, vsin, req.patch_valid, full, "auto"),
        iters=3, warmup=1) for full, i in ((False, 0), (True, vc.fullatt_block_indexes[0]))}
    blocks = block_ms[False] * (vc.depth - n_full) + block_ms[True] * n_full
    say("qwen-split", f"B=8 vision tower {vis_ms:.2f} ms: window block {block_ms[False]:.2f} ms "
        f"x {vc.depth - n_full}, full block (B3 segments) {block_ms[True]:.2f} ms x {n_full} = "
        f"{blocks:.2f} ms; the rest (u8 normalise, patch embed, rotary tables, merger, "
        f"gather) {vis_ms - blocks:.2f} ms")
    h = params["backbone"]["text"]["embed_tokens"][req.input_ids.long()]
    cos, sin = qwen25_vl._mrope_cos_sin(req.position_ids, tc, h.dtype)
    for tag, tree, served in (("bf16", params, bf16_s), ("W8A8", qparams, w8_s)):
        lp = layer_slice(tree["backbone"]["text"]["layers"], 0)
        layer_ms = time_ms(lambda: qwen25_vl._decoder_layer(h, lp, tc, cos, sin,
                                                            req.attention_mask, "auto"),
                           iters=3, warmup=1)
        dec_ms = layer_ms * tc.num_layers
        say("qwen-split", f"B=8 {tag}: vision tower {vis_ms:.2f} ms, decoder layer "
            f"{layer_ms:.2f} ms x {tc.num_layers} = {dec_ms:.2f} ms; sum {vis_ms + dec_ms:.2f} "
            f"ms of the served {served * 1e3:.2f} ms/request (rest: embedding, splice, "
            f"final norm, SkipCA, head, host)")


@torch.inference_mode()
def _qwen_part_checks(qcfg, params, qparams, req):
    """From one input at full width: the vision tower (B3's segment mode in
    its four full blocks) and decoder layer 0 (B2 x3 + B3; W8A8: + B4 x2, B5,
    B6 and four GEMMs) through the kernels against the plain versions, as
    the worst batch row's relative L2 error (of the layer's update, out - h,
    on valid tokens: the padded row shows a mask fault undiluted), beside
    the reference attention's error against the plain versions."""
    tc, vc = qcfg.text, qcfg.vision
    vis = params["backbone"]["visual"]
    vin = (req.pixel_values, req.patch_valid, req.rot_pos, req.unit_gather, req.num_img_tokens)
    outs = {i: qwen25_vl.vision_forward(vis, vc, *vin, attn_impl=i)
            for i in ("auto", "plain", "xla")}
    checks = [("vision tower (2, 1280 patches) -> (2, 320, 3584)", outs, QWEN_PART_TOL)]
    h = params["backbone"]["text"]["embed_tokens"][req.input_ids.long()]
    cos, sin = qwen25_vl._mrope_cos_sin(req.position_ids, tc, h.dtype)
    valid = req.attention_mask[..., None].to(h.dtype)
    for tag, tree in (("bf16", params), ("W8A8", qparams)):
        lp = layer_slice(tree["backbone"]["text"]["layers"], 0)
        outs = {i: (qwen25_vl._decoder_layer(h, lp, tc, cos, sin, req.attention_mask, i)
                    - h) * valid for i in ("auto", "plain", "xla")}
        checks.append((f"decoder layer 0 {tag} (2, {QWEN_SEQ}, {tc.hidden_size})", outs,
                       QWEN_W8A8_PART_TOL if tag == "W8A8" else QWEN_PART_TOL))
    for title, o, tol in checks:
        err, floor = (max(_rel_err(a, b) for a, b in zip(o[i], o["plain"]))
                      for i in ("auto", "xla"))
        finite = bool(torch.isfinite(o["auto"]).all())
        say("qwen", f"{title}, kernels vs plain versions: relative L2 error {err:.3e} (tol "
            f"{tol:g}); reference attention vs plain {floor:.3e}; finite {finite}")
        if err > tol or not finite:
            fail(f"qwen: the {title} through the kernels disagrees with the plain versions")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------------ phase 6


def _halves(batch, pairs):
    """A stacked request as its chosen and rejected halves (qwen's M-RoPE
    position_ids carry the batch on axis 1)."""
    def cut(name, t, sl):
        if t is None:
            return None
        return t[:, sl] if name == "position_ids" else t[sl]

    return tuple(RewardBatch(*[cut(n, t, sl) for n, t in zip(RewardBatch._fields, batch)])
                 for sl in (slice(None, pairs), slice(pairs, None)))


def _trainable(cfg, rcfg, gen, vision=False):
    """fp32 heads and LoRA r=128; b is drawn small and nonzero (b = 0 would
    make a's gradient exactly zero, and the parity check blind to it)."""
    tr = {"head": init_head_params(cfg, rcfg, gen, torch.float32, "cuda"),
          "lora": init_lora(cfg.decoder, LORA_R, LORA_ALPHA, gen, device="cuda")}
    if vision:
        tr["vision_lora"] = init_vision_lora(cfg.vision, LORA_R, LORA_ALPHA, gen, device="cuda")
    for key in ("lora", "vision_lora"):
        for t in tr.get(key, {}).values():
            t["b"].normal_(0.0, 1e-3, generator=gen)
    return tr


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _rel_err(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _lora_factor(name):
    return name.startswith("lora/") and name.endswith(("/a", "/b"))


def _grad_errors(names, got, ref, stacked=_lora_factor):
    """Relative L2 errors of ``got`` against ``ref``, per leaf and per layer
    slice of the leaves that ``stacked(name)`` picks (by default the stacked
    LoRA ``a`` / ``b`` leaves; a ``scale`` slice is one number). Returns
    (worst leaf, {leaf: error}), (worst slice, {slice: error})."""
    leaves, slices = {}, {}
    for n, a, b in zip(names, got, ref):
        leaves[n] = _rel_err(a, b)
        if stacked(n):
            slices.update({f"{n}[{i}]": _rel_err(a[i], b[i]) for i in range(a.shape[0])})
    return (max(leaves, key=leaves.get), leaves), (max(slices, key=slices.get), slices)


def _scale_leaf_errors(names, got, ref, values):
    """The conditioned error of each one-number LoRA scale leaf (``.../scale``
    beside its ``a`` and ``b``): for layer l, |got_l - ref_l| / (||g_b,l||
    ||b_l|| / |scale_l|), g_b the b leaf's gradient in ``ref``, b and scale
    the leaves' values in ``values`` (name -> tensor), the worst over layers.
    In exact arithmetic dscale = <g_b, b> / scale, so the denominator bounds
    |dscale| (Cauchy-Schwarz): a sum that cancels reads small, and a fault
    that moves g_b by a relative e reads e at most, along b, but about
    e / sqrt(N) in a direction of its own over the N terms. Printed beside
    the scale leaves' relative error, for information (PERF.md §6)."""
    at = {n: i for i, n in enumerate(names)}
    out = {}
    for n in names:
        stem = n[: -len("scale")]
        if not (n.endswith("/scale") and stem + "a" in at and stem + "b" in at):
            continue
        scale = values[n].detach().float().reshape(-1)
        L = scale.numel()
        gb = ref[at[stem + "b"]].float().reshape(L, -1).norm(dim=1)
        b = values[stem + "b"].detach().float().reshape(L, -1).norm(dim=1)
        d = (got[at[n]].float() - ref[at[n]].float()).reshape(-1).abs()
        out[n] = (d / (gb * b / scale.abs()).clamp_min(1e-30)).max().item()
    return out


def _scale_identity(names, grads, values):
    """Each LoRA scale leaf's gradient held to the identity dscale_l =
    <g_b,l, b_l> / scale_l on the same route's own b gradient, in fp64: for
    layer l, |dscale_l - <g_b,l, b_l> / scale_l| / (||g_b,l|| ||b_l|| /
    |scale_l|), the worst over layers. Exact in exact arithmetic for every
    route; rounding reads far below SCALE_IDENTITY_TOL, a cut or mis-wired
    scale gradient reads ~1 times the leaf's own conditioning."""
    at = {n: i for i, n in enumerate(names)}
    out = {}
    for n in names:
        stem = n[: -len("scale")]
        if not (n.endswith("/scale") and stem + "a" in at and stem + "b" in at):
            continue
        scale = values[n].detach().double().reshape(-1)
        L = scale.numel()
        gb = grads[at[stem + "b"]].double().reshape(L, -1)
        b = values[stem + "b"].detach().double().reshape(L, -1)
        want = (gb * b).sum(1) / scale
        bound = gb.norm(dim=1) * b.norm(dim=1) / scale.abs()
        got = grads[at[n]].double().reshape(-1)
        out[n] = ((got - want).abs() / bound.clamp_min(1e-300)).max().item()
    return out


def _check_identity(tag, names, routes, values):
    """``_scale_identity`` on every route (name -> gradients); fails beyond
    SCALE_IDENTITY_TOL."""
    reads = {r: _scale_identity(names, g, values) for r, g in routes.items()}
    worst = {r: max(v.items(), key=lambda kv: kv[1]) for r, v in reads.items() if v}
    if not worst:
        return
    say(tag, "scale leaves, |dscale - <g_b, b> / scale| / (||g_b|| ||b|| / |scale|) on each "
        f"route's own gradients (tol {SCALE_IDENTITY_TOL:g}), worst leaf: "
        + ", ".join(f"{r} {v:.3e} at {k}" for r, (k, v) in worst.items()))
    bad = [f"{r} {v:.3e} at {k}" for r, (k, v) in worst.items() if not v <= SCALE_IDENTITY_TOL]
    if bad:
        fail(f"{tag}: a scale gradient breaks dscale = <g_b, b> / scale: {', '.join(bad)}")


def _tensor_leaves(errs):
    return {k: v for k, v in errs.items() if not k.endswith("/scale")}


def _over(errs, floor, tol, factor):
    """The readings above max(tol, factor x their own drift floor)."""
    return {k: v for k, v in errs.items() if v > max(tol, factor * floor.get(k, 0.0))}


def _loss_and_grads(loss_fn, trainable, frozen, chosen, rejected, probs=None):
    """The loss and the gradients of every trainable leaf; the preference
    probability is appended to ``probs`` where one is given."""
    leaves = [t.requires_grad_() for t in tree_leaves(trainable)]
    loss, m = loss_fn(trainable, frozen, chosen, rejected)
    if probs is not None:
        probs.append(m["prob"].detach().float().reshape(-1))
    return loss.detach().float(), torch.autograd.grad(loss, leaves)


def _layer_parity(cfg, frozen, trainable, batch, gen, label="bf16"):
    """Decoder layer 0 at full width, B=2, seq 2560, one row left-padded:
    the gradients of its input and its LoRA leaves through the kernels and
    through the plain versions, from one input and one upstream gradient,
    with the reference attention's distance from the plain versions beside
    (``label``: the frozen weights' form, bf16 or a quantized one)."""
    dcfg = cfg.decoder
    mask = torch.ones(2, batch.input_ids.shape[1], dtype=torch.int32, device="cuda")
    mask[1, :40] = 0
    pos = torch.cumsum(mask, -1) - 1
    pos = torch.where(mask == 0, torch.ones_like(pos), pos)
    cos, sin = rope_cos_sin_for_config(pos, dcfg, dtype=torch.bfloat16)
    h = torch.randn(2, mask.shape[1], dcfg.hidden_size, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    # the upstream gradient is zero on left-pad rows, as on the path (no valid
    # row attends to them); there a row's attention output is the mean of the
    # keys the kernel visits, not of all keys, so their values differ by design
    w = torch.randn(h.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    w = w * mask[:, :, None].to(w.dtype)
    lp = layer_slice(frozen["backbone"]["decoder"]["layers"], 0)
    grads = {}
    for impl in ("auto", "plain", "xla"):
        x = h.clone().requires_grad_()
        lora = tree_map(lambda t: t[0].detach().requires_grad_(), trainable["lora"])
        out = phi3.decoder_layer(x, lp, dcfg, cos, sin, mask, impl, lora)
        leaves = [x] + tree_leaves(lora)
        grads[impl] = torch.autograd.grad((out.float() * w.float()).sum(), leaves)
    names = ["h"] + [n for n, _ in _named_leaves(trainable["lora"])]
    rels = {n: _rel_err(a, b) for n, a, b in zip(names, grads["auto"], grads["plain"])}
    floor = {n: _rel_err(a, b) for n, a, b in zip(names, grads["xla"], grads["plain"])}
    tensors = _tensor_leaves(rels)
    worst = max(tensors, key=tensors.get)
    say("train", f"one decoder layer {label} {tuple(h.shape)}, kernels vs plain versions: "
        f"worst relative L2 gradient error {rels[worst]:.3e} at {worst} (tol "
        f"{LAYER_GRAD_TOL:g}, tensor leaves; the scale leaves for information); kernels "
        f"(reference attention): "
        + ", ".join(f"{k} {v:.2e} ({floor[k]:.2e})" for k, v in rels.items()))
    values = dict(_named_leaves(lora))
    cond = [_scale_leaf_errors(names, grads[r], grads["plain"], values) for r in ("auto", "xla")]
    say("train", f"one decoder layer {label}, the scale leaves' conditioned error (for "
        "information), kernels (reference attention): "
        + ", ".join(f"{k} {v:.2e} ({cond[1][k]:.2e})" for k, v in cond[0].items()))
    _check_identity("train", names, {"kernels": grads["auto"], "plain": grads["plain"],
                                     "reference": grads["xla"]}, values)
    if rels[worst] > LAYER_GRAD_TOL or not all(bool(torch.isfinite(g).all())
                                               for g in grads["auto"]):
        fail("train: one layer's gradients through the kernels disagree with the plain versions")


def _timed_steps(step, state, frozen, chosen, rejected, n, mallocs=None):
    """``n`` steps: their losses, grad norms and seconds; with ``mallocs`` a
    list, each step's cudaMalloc calls by the caching allocator are added."""
    losses, norms, times = [], [], []
    for _ in range(n):
        before = torch.cuda.memory_stats().get("num_device_alloc", 0)
        t0 = time.perf_counter()
        state, m = step(state, frozen, chosen, rejected)
        loss, gn = m["preference_loss"].item(), m["grad_norm"].item()  # waits for the card
        times.append(time.perf_counter() - t0)
        if mallocs is not None:
            mallocs.append(torch.cuda.memory_stats().get("num_device_alloc", 0) - before)
        losses.append(loss)
        norms.append(gn)
        if not (math.isfinite(loss) and math.isfinite(gn)):
            fail(f"non-finite training step: loss {loss} grad_norm {gn}")
    return state, losses, norms, times


def _expect(tag, got, want):
    say("train", f"{tag} launches {got} (expected {want})")
    if got != {k: want.get(k, 0) for k in got}:
        fail(f"{tag}: launches {got} != {want}")


QUANT_SCHEMES = {"W8A8": dict(scheme="w8a8"), "NF4": dict(bits=4, scheme="nf4")}


def _quant_lora_steps(tag, scheme, frozen, dec, trainable, make_loss, chosen, rejected, per,
                      n_proj, n_dec, layer_check, bf16, release=False):
    """LoRA over the frozen decoder quantized ``scheme`` on the card, one
    layer at a time (the train CLI's --load_in_8bit / --load_in_4bit): decoder
    layer 0's gradients through the kernels against the plain versions
    (``layer_check``, the bf16 one-layer bounds and the scale identity), the
    loss of one pair through the kernels against the plain route, then two
    make_train_step steps, counted: ``per`` attention launches a step, and
    under W8A8 each of the ``n_proj`` projections of a layer through B6 + the
    GEMM in the forward and again in the remat recompute. ``bf16``: the bf16
    steps' loss, s/step and peak, printed beside. ``release``: the float
    layers leave ``frozen`` once quantized (the caller needs them no more)."""
    t0 = time.perf_counter()
    bb = frozen["backbone"]
    layers = quantize_stacked_layers(bb[dec]["layers"], **QUANT_SCHEMES[scheme])
    qfrozen = {"backbone": {**bb, dec: {**bb[dec], "layers": layers}}}
    if release:
        bb[dec]["layers"] = layers
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(layers))
    say(tag, f"{scheme}: decoder layers quantized on the card one layer at a time in {q_s:.1f} "
        f"s, {nbytes / 1e9:.3f} GB of codes and scales; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    layer_check(qfrozen)
    with torch.no_grad():
        lk = make_loss("auto")(trainable, qfrozen, chosen, rejected)[0].float().item()
        before = _but_norms(launches())
        lp = make_loss("plain")(trainable, qfrozen, chosen, rejected)[0].float().item()
        torch.cuda.synchronize()
        if _but_norms(launches()) != before:
            fail(f"{tag} {scheme}: the plain route launched a kernel other than the norm "
                 "kernel")
    tx = make_optimizer(LR, TOTAL_STEPS)
    step = make_train_step(make_loss("auto"), tx)
    state = init_train_state(trainable, tx)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()  # the quantized training path's run starts here
    state, losses, norms, times = _timed_steps(step, state, qfrozen, chosen, rejected, 2)
    counts = launches()  # ... and ends here
    want = {k: 2 * v for k, v in per.items()}
    if scheme == "W8A8":
        want.update(row_quant=2 * 2 * n_proj * n_dec, int8_matmul=2 * 2 * n_proj * n_dec)
    _expect(f"{tag} 2 LoRA steps B=2 over the {scheme} decoder", counts, want)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(tag, f"{scheme} LoRA B=2: one pair's loss through the kernels {lk:.6f} vs the plain "
        f"route {lp:.6f} (gap {abs(lk - lp):.3e}, tol {TRAIN_LOSS_TOL:g}); steps' loss "
        f"{[round(x, 6) for x in losses]} grad_norm {[round(x, 4) for x in norms]} beside bf16 "
        f"{[round(x, 6) for x in bf16['loss'][:2]]}; {times[1]:.4f} s/step (second step; first "
        f"{times[0]:.4f}) beside bf16 {bf16['s']:.4f}; peak {peak:.2f} GiB beside bf16 "
        f"{bf16['peak']:.2f}; launches B6 {counts['row_quant']}, B7 {counts['int8_matmul']}, "
        f"B8 {counts['fa_bwd']}")
    if abs(lk - lp) > TRAIN_LOSS_TOL or not math.isfinite(lk):
        fail(f"{tag} {scheme}: the loss through the kernels disagrees with the plain route")
    del state, step, qfrozen, layers
    torch.cuda.empty_cache()
    return counts


def phase_train(cfg, rcfg, steps=5):
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    frozen = {"backbone": phi3v.init_params(cfg, gen, torch.bfloat16, "cuda")}
    trainable = _trainable(cfg, rcfg, gen)
    n_lora = sum(t.numel() for t in tree_leaves(trainable["lora"]))
    say("train", f"random bf16 backbone + fp32 head and LoRA r={LORA_R} ({n_lora / 1e6:.1f} M "
        f"LoRA params), {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    n_clip, n_dec = cfg.vision.num_active_layers, cfg.decoder.num_layers
    req2 = make_request(cfg, gen, 1, 2560, {1: 40})
    req8 = make_request(cfg, gen, 4, 2944, {7: 40})
    chosen, rejected = _halves(req2, 1)
    c8, r8 = _halves(req8, 4)
    params, lora, _ = assemble_params(frozen, trainable)
    trainable["head"], spread = _principal_head(cfg, rcfg, params, [req2, req8], lora=lora)
    _say_head("train", "the B=2 and B=8 steps'", spread, True)
    del params, lora, req8

    # one step's loss and gradients through the kernels, through the plain
    # versions and through the reference attention, from the same state
    _route_parity("train", lambda impl: make_pairwise_loss_fn(cfg, rcfg, attn_impl=impl,
                                                              remat=True),
                  trainable, frozen, chosen, rejected, _lora_factor, "LoRA layer slices", 0.0)
    kern_fn = make_pairwise_loss_fn(cfg, rcfg, attn_impl="auto", remat=True)
    torch.cuda.empty_cache()
    _layer_parity(cfg, frozen, trainable, chosen, gen)

    # the main path: make_train_step, one pair per step
    tx = make_optimizer(LR, TOTAL_STEPS)
    state = init_train_state(trainable, tx)
    step = make_train_step(kern_fn, tx)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()  # the training path's run starts here
    state, losses, norms, times = _timed_steps(step, state, frozen, chosen, rejected, steps)
    counts = launches()  # ... and ends here
    per = {"fa_direct": n_clip, "prep": 3 * n_dec * 3, "fa_hm": 2 * n_dec, "fa_bwd": n_dec,
           **_step_norms(cfg)}
    _expect(f"{steps} steps B=2", counts, {k: steps * v for k, v in per.items()})
    med = float(np.median(times[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    say("train", f"B=2 seq 2560: loss per step {[round(x, 6) for x in losses]}, grad_norm "
        f"{[round(x, 4) for x in norms]}; {med:.4f} s/step (median after one warm step, "
        f"{[round(t, 4) for t in times]}), {1 / med:.3f} pairs/s; peak {peak:.2f} GiB")
    # the same LoRA over the decoder in W8A8 and in NF4 (--load_in_8bit,
    # --load_in_4bit): the four projections a layer
    bf16 = {"loss": losses, "s": med, "peak": peak}
    del state
    for scheme in QUANT_SCHEMES:
        got = _quant_lora_steps(
            "train", scheme, frozen, "decoder", trainable,
            lambda impl: make_pairwise_loss_fn(cfg, rcfg, attn_impl=impl, remat=True), chosen,
            rejected, per, 4, n_dec,
            lambda qf, scheme=scheme: _layer_parity(cfg, qf, trainable, chosen, gen, scheme),
            bf16)
        counts = {k: counts[k] + got[k] for k in counts}
    state = init_train_state(trainable, tx)

    # the published micro-batch: 4 pairs (B=8) at seq 2944, B1 in the decoder
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    state, l8, n8, t8 = _timed_steps(step, state, frozen, c8, r8, 1)
    _expect("B=8 step", launches(), {"fa_direct": n_clip + 2 * n_dec, "prep": 3 * n_dec,
                                     "fa_bwd": n_dec, **_step_norms(cfg)})
    say("train", f"B=8 seq 2944: loss {l8[0]:.6f} grad_norm {n8[0]:.4f}; {t8[0]:.4f} s/step "
        f"(first call), {4 / t8[0]:.3f} pairs/s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del c8, r8, state
    torch.cuda.empty_cache()

    # --train_vision: CLIP LoRA through mha -> B3 / B8, 4 decoder layers
    cfg4 = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_layers=4))
    bb = frozen["backbone"]
    dec = bb["decoder"]
    frozen4 = {"backbone": {**bb, "decoder": {
        **dec, "layers": tree_map(lambda t: t[:4], dec["layers"])}}}
    rcfg4 = dataclasses.replace(rcfg, layer_id=4)
    tv = _trainable(cfg4, rcfg4, gen, vision=True)
    tx4 = make_optimizer(LR, TOTAL_STEPS)
    step4 = make_train_step(make_pairwise_loss_fn(cfg4, rcfg4, remat=True), tx4)
    reset_counters()
    _, lv, nv, tv_t = _timed_steps(step4, init_train_state(tv, tx4), frozen4, chosen, rejected, 1)
    _expect("vision-LoRA step", launches(), {"fa_hm": 2 * n_clip + 2 * 4, "fa_bwd": n_clip + 4,
                                             "prep": 3 * 4 * 3,
                                             **_step_norms(cfg4, vision_lora=True)})
    say("train", f"--train_vision (CLIP LoRA r={LORA_R}, 4 decoder layers): loss {lv[0]:.6f} "
        f"grad_norm {nv[0]:.4f}; {tv_t[0]:.4f} s/step (first call)")
    del tv, step4, frozen4
    torch.cuda.empty_cache()

    # RewardTrainer.fit over two host batches; the port reads its artifact back
    host = lambda b: {k: (None if v is None else v.cpu().numpy())  # noqa: E731
                      for k, v in b._asdict().items()}
    loader = [(host(chosen), host(rejected), np.array([1.0]), np.array([0.0]))] * 2
    with tempfile.TemporaryDirectory() as tmp:
        trainer = RewardTrainer(
            cfg=cfg, rcfg=rcfg, frozen=frozen, trainable=_trainable(cfg, rcfg, gen),
            tx=make_optimizer(LR, TOTAL_STEPS), loss_fn=kern_fn, train_loader=loader,
            save_path=tmp, lora_rank=LORA_R, lora_alpha=LORA_ALPHA, device="cuda")
        t0 = time.perf_counter()
        st = trainer.fit()
        dt = time.perf_counter() - t0
        path = os.path.join(tmp, "epoch_0")
        head = artifact.load_head_params(path, rcfg, device="cuda")
        sd = torch.load(os.path.join(path, "lora", "adapter_model.bin"), weights_only=True)
        lora = peft_state_to_stacked(sd, cfg.decoder, LORA_ALPHA, LORA_R, device="cuda")
        bf = lambda t: t.detach().to(torch.bfloat16).float()  # noqa: E731
        same = (torch.equal(head["value_head"]["kernel"], bf(st.trainable["head"]["value_head"]
                                                            ["kernel"]))
                and all(torch.equal(lora[n]["a"], bf(st.trainable["lora"][n]["a"]))
                        and torch.equal(lora[n]["b"], bf(st.trainable["lora"][n]["b"]))
                        for n in lora)
                and artifact.load_reward_config(path).to_contract_dict()
                == rcfg.to_contract_dict()
                and artifact.check_artifact_keys(path) == [])
        files = sorted(os.path.relpath(os.path.join(r, f), path)
                       for r, _, fs in os.walk(path) for f in fs)
    say("train", f"RewardTrainer.fit: {st.step} steps in {dt:.2f} s, logs "
        f"{trainer.last_train_logs}; artifact {files} read back equal: {same}")
    if st.step != 2 or not same:
        fail("train: the trainer's artifact does not read back equal")
    return counts


# ------------------------------------------------------------------ phase 6q


def _route_parity(tag, make_loss, trainable, frozen, chosen, rejected, stacked, what,
                  floor_factor=FLOOR_FACTOR):
    """One step's loss and gradients through the kernels, through the plain
    versions and through the reference attention, from one state. Each
    tensor leaf and each slice is held to the larger of phase 6's bound and
    ``floor_factor`` times its own drift floor (phase 6 itself passes 0: the
    bound alone); through Qwen's 60 random bf16 layers the floor differs from
    leaf to leaf. The one-number LoRA scale leaves are held to their identity
    on every route (``_check_identity``); their errors against the plain
    route are printed."""
    probs = []
    lk, gk = _loss_and_grads(make_loss("auto"), trainable, frozen, chosen, rejected, probs)
    before = _but_norms(launches())
    lp, gp = _loss_and_grads(make_loss("plain"), trainable, frozen, chosen, rejected, probs)
    lx, gx = _loss_and_grads(make_loss("xla"), trainable, frozen, chosen, rejected, probs)
    torch.cuda.synchronize()
    if _but_norms(launches()) != before:
        fail(f"{tag}: the plain-route or reference step launched a kernel other than the norm "
             "kernel")
    decided = [bool((p > 0.5).all()) for p in probs]
    say(tag, f"preference probability per pair, kernels / plain / reference: "
        f"{[p.cpu().numpy().round(6).tolist() for p in probs]}; every pair's decision the "
        f"same on the three routes: {len(set(decided)) == 1}")
    if any(not torch.equal(p > 0.5, probs[0] > 0.5) for p in probs):
        fail(f"{tag}: a pair's decision differs between the kernels, the plain versions and "
             "the reference attention")
    names = [n for n, _ in _named_leaves(trainable)]
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    (_, errs), (piece, slice_errs) = _grad_errors(names, gk, gp, stacked)
    (_, floor), (fpiece, floor_slices) = _grad_errors(names, gx, gp, stacked)
    tensors, ftensors = _tensor_leaves(errs), _tensor_leaves(floor)
    leaf, fleaf = max(tensors, key=tensors.get), max(ftensors, key=ftensors.get)
    gap = abs(lk.item() - lp.item())
    say(tag, f"kernels vs plain versions, one step: loss {lk.item():.6f} vs {lp.item():.6f} "
        f"(gap {gap:.3e}, tol {TRAIN_LOSS_TOL:g}); worst relative L2 gradient error "
        f"{errs[leaf]:.3e} at {leaf} (tol {TRAIN_GRAD_TOL:g} or {floor_factor:g} x its floor) "
        f"over {len(tensors)} tensor leaves, {slice_errs[piece]:.3e} at {piece} (tol "
        f"{TRAIN_SLICE_TOL:g} or {floor_factor:g} x its floor) over {len(slice_errs)} {what}; "
        f"grads finite {finite}")
    say(tag, f"drift floor, reference attention (attn_impl='xla') vs plain versions, the "
        f"same step: loss gap {abs(lx.item() - lp.item()):.3e}; worst {floor[fleaf]:.3e} at "
        f"{fleaf}, {floor_slices[fpiece]:.3e} at {fpiece}")
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:12]
    say(tag, "relative L2 gradient error per leaf, kernels (reference), the 12 largest (the "
        "scale leaves for information): "
        + ", ".join(f"{k} {v:.2e} ({floor[k]:.2e})" for k, v in worst))
    values = dict(_named_leaves(trainable))
    cond = [_scale_leaf_errors(names, g, gp, values) for g in (gk, gx)]
    if cond[0]:
        say(tag, "the scale leaves' conditioned error (for information), kernels (reference): "
            + ", ".join(f"{k} {v:.2e} ({cond[1][k]:.2e})" for k, v in cond[0].items()))
    _check_identity(tag, names, {"kernels": gk, "plain": gp, "reference": gx}, values)
    over = [f"{k} {v:.3e} (floor {fl[k]:.3e})" for d, fl, tol in
            ((tensors, floor, TRAIN_GRAD_TOL), (slice_errs, floor_slices, TRAIN_SLICE_TOL))
            for k, v in _over(d, fl, tol, floor_factor).items()]
    if gap > TRAIN_LOSS_TOL or over or not finite:
        fail(f"{tag}: the kernel route's loss or gradients disagree with the plain versions"
             f"{': ' + ', '.join(over[:8]) if over else ''}")
    return slice_errs, floor_slices


def _qwen_layer_parity(qcfg, frozen, trainable, req, gen, vision=True, label="bf16"):
    """At full width from one input and one upstream gradient, kernels
    against plain versions: decoder layer 0 on the separate layout with its
    LoRA slice (B3 / B8 in left-pad mode at GQA 28/4; the upstream gradient
    zero on left-pad rows, as on the path), and the first full-attention
    vision block with its own weights trainable (B3 / B8 in segment mode; the
    upstream gradient KEPT on the 272 pad patches)."""
    tc, vc = qcfg.text, qcfg.vision
    mask = req.attention_mask
    cos, sin = qwen25_vl._mrope_cos_sin(req.position_ids, tc, torch.bfloat16)
    h = torch.randn(2, QWEN_SEQ, tc.hidden_size, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    w = torch.randn(h.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    w = w * mask[:, :, None].to(w.dtype)
    lp = layer_slice(frozen["backbone"]["text"]["layers"], 0)
    grads = []
    for impl in ("auto", "plain"):
        x = h.clone().requires_grad_()
        lora = tree_map(lambda t: t[0].detach().requires_grad_(), trainable["lora"])
        reset_counters()
        out = qwen25_vl._decoder_layer(x, lp, tc, cos, sin, mask, impl, lora)
        grads.append(torch.autograd.grad((out.float() * w.float()).sum(),
                                         [x] + tree_leaves(lora)))
        if impl == "auto" and (fa.LAUNCHES["fa_hm"], fa.LAUNCHES["fa_bwd"]) != (1, 1):
            fail(f"train-qwen: decoder layer launches {fa.LAUNCHES}")
    names = ["h"] + [n for n, _ in _named_leaves(trainable["lora"])]
    checks = [(f"decoder layer 0 {label} {tuple(h.shape)}, LoRA on {len(trainable['lora'])} "
               f"targets", names, grads, dict(_named_leaves(lora)))]
    if not vision:
        return _layer_checks(checks)

    i_full = vc.fullatt_block_indexes[0]
    vcos, vsin = qwen25_vl._vision_rope(req.rot_pos, vc.head_dim)
    hv = torch.randn(2, QWEN_PATCHES, vc.hidden_size, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    wv = torch.randn(hv.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    block = layer_slice(frozen["backbone"]["visual"]["blocks"], i_full)
    grads = []
    for impl in ("auto", "plain"):
        x = hv.clone().requires_grad_()
        bp = tree_map(lambda t: t.detach().clone().requires_grad_(), block)
        reset_counters()
        out = qwen25_vl._vision_block(x, bp, vc, vcos, vsin, req.patch_valid, True, impl)
        grads.append(torch.autograd.grad((out.float() * wv.float()).sum(),
                                         [x] + tree_leaves(bp)))
        if impl == "auto" and (fa.LAUNCHES["fa_hm"], fa.LAUNCHES["fa_bwd"]) != (1, 1):
            fail(f"train-qwen: vision block launches {fa.LAUNCHES}")
    checks.append((f"full vision block {i_full} {tuple(hv.shape)}, segment ids, "
                   f"{int((req.patch_valid == 0).sum())} pad patches with a gradient",
                   ["h"] + [n for n, _ in _named_leaves(block)], grads, {}))
    _layer_checks(checks)


def _layer_checks(checks):
    """Each (title, leaf names, (kernel grads, plain grads), scale values):
    the worst tensor leaf within LAYER_GRAD_TOL, the scale identity held."""
    for title, names, (gk, gp), values in checks:
        rels = {n: _rel_err(a, b) for n, a, b in zip(names, gk, gp)}
        tensors = _tensor_leaves(rels)
        worst = max(tensors, key=tensors.get)
        say("train-qwen", f"{title}, kernels vs plain versions: worst relative L2 gradient "
            f"error {rels[worst]:.3e} at {worst} (tol {LAYER_GRAD_TOL:g}, tensor leaves; the "
            f"scale leaves for information); " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
            + "".join(f"; {k} conditioned {v:.2e} (for information)"
                      for k, v in _scale_leaf_errors(names, gk, gp, values).items()))
        _check_identity("train-qwen", names, {"kernels": gk, "plain": gp}, values)
        if rels[worst] > LAYER_GRAD_TOL or not all(bool(torch.isfinite(g).all()) for g in gk):
            fail(f"train-qwen: the {title.split(',')[0]}'s gradients through the kernels "
                 "disagree with the plain versions")


def _profile_steps(tag, step, state, frozen, chosen, rejected, n=4):
    """Where a training step's time goes: ``n`` more steps with the memory
    the caching allocator holds after each (a leak grows it step by step),
    its cudaMalloc calls and the retries it made after freeing its cache
    (each retry synchronises the card, a slow step's mark), then one step
    under ``utils/profiling.trace``: the device's busy time against the
    step's span, and the kernels by device time."""
    from llava_reward_torch.utils.profiling import trace

    rows = []
    for _ in range(n):
        before = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, frozen, chosen, rejected)
        m["preference_loss"].item()
        dt = time.perf_counter() - t0
        after = torch.cuda.memory_stats()
        rows.append((round(dt, 4), round(torch.cuda.memory_allocated() / 2**30, 3),
                     after.get("num_device_alloc", 0) - before.get("num_device_alloc", 0),
                     after["num_alloc_retries"] - before["num_alloc_retries"]))
    say(tag, f"{n} more steps, each (s, GiB allocated after it, cudaMalloc calls, allocator "
        f"retries): {rows}; reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with trace(tmp):
            state, m = step(state, frozen, chosen, rejected)
            m["preference_loss"].item()
        dt = time.perf_counter() - t0
        top, busy, span, n_ev = _device_top(os.path.join(tmp, "trace.json"), n=12)
    say(tag, f"profile of one step (torch.profiler, CUDA activity; {dt:.4f} s with the "
        f"profiler on): {n_ev} device events, device busy {busy:.2f} ms in a span of "
        f"{span:.2f} ms (idle share {1 - busy / span:.3f}); the largest by device time: "
        + "; ".join(f"{name[:70]} {ms:.2f} ms ({ms / busy:.1%})" for name, ms in top))
    return state


def _qwen_trainable(qcfg, rcfg, gen, backbone):
    """fp32 heads, LoRA r=128 on QWEN_TARGETS (b small and nonzero, as in
    phase 6) and the merger in fp32 as --ft_projector's projector."""
    tr = {"head": init_head_params(qcfg, rcfg, gen, torch.float32, "cuda"),
          "lora": init_lora(qcfg.text, LORA_R, LORA_ALPHA, gen, targets=QWEN_TARGETS,
                            device="cuda"),
          "projector": tree_map(lambda t: t.float().clone(), backbone["visual"]["merger"])}
    for t in tr["lora"].values():
        t["b"].normal_(0.0, 1e-3, generator=gen)
    return tr


def phase_train_qwen(qcfg, steps=5):
    torch.cuda.empty_cache()
    tc, vc = qcfg.text, qcfg.vision
    n_dec, n_full = tc.num_layers, len(vc.fullatt_block_indexes)
    rcfg = RewardConfig(is_general_preference=True, value_head_dim=2, add_cross_attention=True,
                        layer_id=n_dec)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the training layout: q/k/v and gate/up separate (LoRA rides on them)
    frozen = {"backbone": qwen25_vl.init_params(qcfg, gen, torch.bfloat16, "cuda")}
    trainable = _qwen_trainable(qcfg, rcfg, gen, frozen["backbone"])
    n_tr = {k: sum(t.numel() for t in tree_leaves(v)) for k, v in trainable.items()}
    say("train-qwen", f"Qwen2.5-VL-7B random bf16 backbone (separate projections) + fp32 "
        f"trainables {({k: round(v / 1e6, 1) for k, v in n_tr.items()})} M params (LoRA "
        f"r={LORA_R} on {list(QWEN_TARGETS)}), {torch.cuda.memory_allocated() / 2**30:.2f} GiB; "
        f"reckoned before the run: 15.6 GB of bf16 weights, 1.5 GB of fp32 trainables and as "
        f"much again for each of gradients, two moments and, inside the update, their "
        f"successors (about 9 GB), remat inputs 26 MB per layer")
    rng = np.random.default_rng(0)
    req2 = qwen_request(qcfg, rng, QWEN_GRIDS, {1: 40})
    req8 = qwen_request(qcfg, rng, [QWEN_GRIDS[0]] * 7 + [QWEN_GRIDS[1]], {7: 40})
    chosen, rejected = _halves(req2, 1)
    c8, r8 = _halves(req8, 4)
    path = PROJECTOR_PATHS["qwen"]
    params, lora, _ = assemble_params(frozen, trainable, path)
    trainable["head"], spread = _principal_head(qcfg, rcfg, params, [req2, req8], lora=lora)
    _say_head("train-qwen", "the B=2 and B=8 steps'", spread, True)
    del params, lora

    def make_loss(impl):
        return make_pairwise_loss_fn(qcfg, rcfg, attn_impl=impl, remat=True,
                                     projector_path=path)

    _route_parity("train-qwen", make_loss, trainable, frozen, chosen, rejected, _lora_factor,
                  "LoRA layer slices")
    torch.cuda.empty_cache()
    _qwen_layer_parity(qcfg, frozen, trainable, req2, gen)
    torch.cuda.empty_cache()

    # the main path: make_train_step, one pair per step
    kern_fn = make_loss("auto")
    tx = make_optimizer(LR, TOTAL_STEPS)
    state = init_train_state(trainable, tx)
    step = make_train_step(kern_fn, tx)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()  # the Qwen training path's run starts here
    mallocs = []
    state, losses, norms, times = _timed_steps(step, state, frozen, chosen, rejected, steps,
                                               mallocs)
    counts = launches()  # ... and ends here
    # the frozen tower is not recomputed; each decoder layer runs B3 forward
    # and again under remat, and B8 once; the separate layout ropes in torch
    per = {"fa_hm": n_full + 2 * n_dec, "fa_bwd": n_dec, **_step_norms(qcfg, projector=True)}
    _expect(f"{steps} qwen LoRA steps B=2", counts, {k: steps * v for k, v in per.items()})
    med = float(np.median(times[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    say("train-qwen", f"LoRA B=2 seq {QWEN_SEQ}: loss per step {[round(x, 6) for x in losses]}, "
        f"grad_norm {[round(x, 4) for x in norms]}; {med:.4f} s/step (median after one warm "
        f"step, {[round(t, 4) for t in times]}; cudaMalloc calls a step {mallocs}), "
        f"{1 / med:.3f} pairs/s; peak {peak:.2f} GiB")
    state = _profile_steps("train-qwen", step, state, frozen, chosen, rejected)
    # the same LoRA over the decoder in W8A8 (--load_in_8bit): q, k, v, o,
    # gate, up and down a layer, each B6 + the GEMM
    got = _quant_lora_steps(
        "train-qwen", "W8A8", frozen, "text", trainable, make_loss, chosen, rejected, per, 7,
        n_dec, lambda qf: _qwen_layer_parity(qcfg, qf, trainable, req2,
                                             torch.Generator(device="cuda").manual_seed(1),
                                             vision=False, label="W8A8"),
        {"loss": losses, "s": med, "peak": peak})
    counts = {k: counts[k] + got[k] for k in counts}

    # four pairs (B=8) at the same geometry, as phase 6 does for phi3v
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    state, l8, n8, t8 = _timed_steps(step, state, frozen, c8, r8, 1)
    _expect("qwen LoRA B=8 step", launches(), per)
    say("train-qwen", f"LoRA B=8 seq {QWEN_SEQ}: loss {l8[0]:.6f} grad_norm {n8[0]:.4f}; "
        f"{t8[0]:.4f} s/step (first call), {4 / t8[0]:.3f} pairs/s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del c8, r8, state, step
    torch.cuda.empty_cache()

    # RewardTrainer.fit over two host batches; the artifact is read back,
    # merged, fused and scored through phase 5q's route
    host = lambda b: {k: (None if v is None else v.cpu().numpy())  # noqa: E731
                      for k, v in b._asdict().items()}
    loader = [(host(chosen), host(rejected), np.array([1.0]), np.array([0.0]))] * 2
    with tempfile.TemporaryDirectory() as tmp:
        trainer = RewardTrainer(
            cfg=qcfg, rcfg=rcfg, frozen=frozen,
            trainable=_qwen_trainable(qcfg, rcfg, gen, frozen["backbone"]),
            tx=make_optimizer(LR, TOTAL_STEPS), loss_fn=kern_fn, train_loader=loader,
            save_path=tmp, lora_rank=LORA_R, lora_alpha=LORA_ALPHA, model_type="qwen",
            device="cuda")
        t0 = time.perf_counter()
        st = trainer.fit()
        dt = time.perf_counter() - t0
        out = os.path.join(tmp, "epoch_0")
        head = artifact.load_head_params(out, rcfg, dtype=torch.bfloat16, device="cuda")
        merger = artifact.load_qwen_merger_params(out, device="cuda")
        sd = torch.load(os.path.join(out, "lora", "adapter_model.bin"), weights_only=True)
        lora = peft_state_to_stacked(sd, tc, LORA_ALPHA, LORA_R, targets=QWEN_TARGETS,
                                     device="cuda")
        with open(os.path.join(out, "lora", "adapter_config.json")) as f:
            targets = json.load(f)["target_modules"]
        bf = lambda t: t.detach().to(torch.bfloat16).float()  # noqa: E731
        got = st.trainable
        same = (torch.equal(head["value_head"]["kernel"].float(),
                            bf(got["head"]["value_head"]["kernel"]))
                and all(torch.equal(lora[n][f], bf(got["lora"][n][f]))
                        for n in lora for f in ("a", "b"))
                and set(lora) == set(QWEN_TARGETS) and targets == list(QWEN_TARGETS)
                and torch.equal(merger["ln_q"], bf(got["projector"]["ln_q"]))
                and all(torch.equal(merger[fc][f], bf(got["projector"][fc][f]))
                        for fc in ("fc1", "fc2") for f in ("kernel", "bias"))
                and artifact.load_reward_config(out).to_contract_dict()
                == rcfg.to_contract_dict()
                and artifact.check_artifact_keys(out) == [])
        files = sorted(os.path.relpath(os.path.join(r, f), out)
                       for r, _, fs in os.walk(out) for f in fs)
    say("train-qwen", f"RewardTrainer.fit(model_type='qwen'): {st.step} steps in {dt:.2f} s, "
        f"logs {trainer.last_train_logs}; artifact {files} read back equal: {same}")
    if st.step != 2 or not same:
        fail("train-qwen: the trainer's artifact does not read back equal")
    # scoring what was trained: inline adapters on the training layout against
    # the artifact merged into bf16 weights and fused (the merge rounds each
    # weight to bf16 once more, so the two differ by bf16 noise)
    adaptor = RewardAdaptor(qcfg, rcfg, frozen, model_type="qwen", device="cuda")
    scored = {"backbone": merge_for_scoring(frozen["backbone"], "qwen", lora=lora,
                                            projector=merger), "head": head}
    del lora, sd, trainer
    reset_counters()
    r_art = adaptor.make_score_fn()(scored, req2)
    torch.cuda.synchronize()
    art_counts = launches()
    del scored
    torch.cuda.empty_cache()
    with torch.inference_mode():
        params, inline, _ = assemble_params(frozen, got, path)
        r_inl = reward_forward(params, qcfg, rcfg, req2, lora=inline).reward
    gap = (r_art.float() - r_inl.float()).abs().max().item()
    say("train-qwen", f"the artifact merged and fused, scored through the serving route "
        f"(launches {({k: v for k, v in art_counts.items() if v})}): rewards "
        f"{r_art.float().cpu().numpy().round(6).tolist()} beside the trained tree's inline "
        f"adapters {r_inl.float().cpu().numpy().round(6).tolist()}; max gap {gap:.3e} (tol "
        f"{ARTIFACT_SCORE_TOL:g})")
    if art_counts["prep"] != 3 * n_dec or gap > ARTIFACT_SCORE_TOL or not bool(
            torch.isfinite(r_art).all()):
        fail("train-qwen: the read-back artifact does not score like the trained tree")
    del params, inline, got, st, trainable, adaptor
    torch.cuda.empty_cache()

    # full fine-tuning through the vision tower: the decoder cut to 4 layers,
    # the tower whole
    cut = 4
    cfg4 = dataclasses.replace(qcfg, text=dataclasses.replace(tc, num_layers=cut))
    rcfg4 = dataclasses.replace(rcfg, layer_id=cut)
    bb = frozen["backbone"]
    backbone4 = {"visual": tree_map(lambda t: t.clone(), bb["visual"]),
                 "text": {**{k: v.clone() for k, v in bb["text"].items() if k != "layers"},
                          "layers": tree_map(lambda t: t[:cut].clone(), bb["text"]["layers"])}}
    del frozen, bb
    torch.cuda.empty_cache()
    full = {"head": init_head_params(cfg4, rcfg4, gen, torch.float32, "cuda"),
            "backbone": backbone4}
    full["head"], spread = _principal_head(cfg4, rcfg4, full, [req2, req8])
    del req8
    n_full_params = sum(t.numel() for t in tree_leaves(backbone4))
    say("train-qwen", f"full fine-tuning: the whole backbone trainable in bf16, no LoRA; cut: "
        f"decoder {n_dec} -> {cut} layers (the 7.8 B model with AdamW's fp32 moments does not "
        f"fit one card), vision tower {vc.depth} blocks and every width kept: "
        f"{n_full_params / 1e9:.3f} B trainable params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; value head on the cut model's "
        f"principal directions (singular values {spread[:3]} ...)")

    def make_loss4(impl):
        return make_pairwise_loss_fn(cfg4, rcfg4, attn_impl=impl, remat=True,
                                     projector_path=path)

    per_layer = lambda n: "/blocks/" in n or "/layers/" in n  # noqa: E731
    slice_errs, floor_slices = _route_parity("train-qwen-full", make_loss4, full, {}, chosen,
                                             rejected, per_layer, "block / layer slices")
    for i in vc.fullatt_block_indexes:  # the blocks whose backward is B8's segment mode
        key = f"backbone/visual/blocks/qkv/kernel[{i}]"
        say("train-qwen-full", f"full vision block {i}: qkv kernel gradient error "
            f"{slice_errs[key]:.3e} (reference attention {floor_slices[key]:.3e})")
    torch.cuda.empty_cache()
    tx4 = make_optimizer(LR, TOTAL_STEPS)
    step4 = make_train_step(make_loss4("auto"), tx4)
    state4 = init_train_state(full, tx4)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()  # the full fine-tuning step's run starts here
    state4, lf, nf, tf = _timed_steps(step4, state4, {}, chosen, rejected, 1)
    full_counts = launches()  # ... and ends here
    # every block and layer is recomputed under remat: the four full vision
    # blocks (segment mode) and the four decoder layers (left pad)
    _expect("qwen full fine-tuning step", full_counts,
            {"fa_hm": 2 * (n_full + cut), "fa_bwd": n_full + cut})
    say("train-qwen-full", f"B=2: loss {lf[0]:.6f} grad_norm {nf[0]:.4f}; {tf[0]:.4f} s/step "
        f"(first call); fa_bwd {full_counts['fa_bwd']} = {n_full} in segment mode at "
        f"(2, {vc.num_heads}, {QWEN_PATCHES}, {vc.head_dim}) + {cut} in left-pad mode at (2, "
        f"{tc.num_heads}/{tc.num_kv_heads}, {QWEN_SEQ}, {tc.head_dim}); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state4, full, backbone4
    torch.cuda.empty_cache()
    return {k: counts[k] + full_counts[k] for k in counts}


# ------------------------------------------------------------------ [http]


HTTP_SEQ = 2560  # phase 4's sequence: 16+1 crops of the sample images fit


def _http(url, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data, {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _pair_request(row):
    return {"prompt": row["prompt"], "chosen": row["chosen_path"],
            "rejected": row["reject_path"]}


def _request_launches(cfg, B):
    """Attention launches of one scoring request of B rows (phi3v or LLaVA):
    B1 in each active CLIP layer; in each decoder layer B1 when the row's
    head groups times B reach 32 (``flash_attention.py:1221-1232``), B2 x3
    + B3 below."""
    dec = cfg.decoder if hasattr(cfg, "decoder") else cfg.text
    n_clip, n_dec = cfg.vision.num_active_layers, dec.num_layers
    groups = dec.num_heads // fa._direct_group(dec.num_heads, dec.head_dim)
    if B * groups >= 32:
        return {"fa_direct": n_clip + n_dec}
    return {"fa_direct": n_clip, "prep": 3 * n_dec, "fa_hm": n_dec}


def _serving_launches(cfg, sizes):
    """Launches of the serving path for device calls of ``sizes`` rows (phi3v:
    the norm kernel at every norm of each call)."""
    want = dict.fromkeys(launches(), 0)
    for b in sizes:
        for k, v in {**_request_launches(cfg, b), **_norm_launches(cfg)}.items():
            want[k] += v
    return want


def phase_http(cfg, rcfg, params, reps=3):
    """Serve phase 4's tree over HTTP: RewardService (max_batch 8, seq 2560,
    10 ms batch window) behind a ThreadingHTTPServer on 127.0.0.1, the
    registry's default processor (u8 crops) and the smoke's own tokenizer.
    /healthz; /score_pair on two sample PNG paths (one warm request, then
    ``reps`` timed); /score on two base64 images; four /score_pair requests
    from four threads that queue while the card is held by a one-image
    request, so that the batcher takes them as one B=8 call; then four more
    from four threads at once, free-running. Every answer's rewards are
    bit-equal to a direct make_score_fn call on the same collated samples
    at the same shape; across shapes (B=8 against B=2) the decisions agree."""
    t_phase = time.perf_counter()
    tok = SmokeTok(cfg.decoder.vocab_size)
    adaptor = RewardAdaptor(cfg, rcfg, params, device="cuda")
    proc = Phi3VProcessor(tok, num_crops=cfg.num_crops, device_preproc=True)
    service = RewardService(adaptor, tok, proc, seq_len=HTTP_SEQ, max_batch=8,
                            batch_window_ms=10)
    calls, service_score = [], service._score

    def counted(p, batch):  # the rows of every device call the service makes
        calls.append(batch.input_ids.shape[0])
        return service_score(p, batch)

    service._score = counted
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_port}"
    rows = _sample_rows()
    score = adaptor.make_score_fn()
    text = lambda row: apply_phi3v_chat_template(tok, row["prompt"])  # noqa: E731

    def direct(samples):
        """make_score_fn on the service's own collation at its shape."""
        batch = to_reward_batch(service._collate_family(list(samples)), "cuda")
        with torch.inference_mode():
            return score(params, batch).float().cpu().numpy()

    def samples_of(row, keys=("chosen_path", "reject_path")):
        return [proc(text(row), [_load_image(row[k])]) for k in keys]

    def pair_rewards(out):
        return np.asarray([out["chosen_reward"], out["rejected_reward"]], np.float32)

    try:
        reset_counters()  # the main path's run starts here
        if _http(url, "/healthz") != {"ok": True}:
            fail("http: /healthz")
        times = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            out = _http(url, "/score_pair", _pair_request(rows[0]))
            times.append(time.perf_counter() - t0)
        got, want = pair_rewards(out), direct(samples_of(rows[0]))
        if not np.array_equal(got, want) or not 0.0 <= out["prob"] <= 1.0:
            fail(f"http: /score_pair rewards {got.tolist()} != direct {want.tolist()}")
        b64 = ["data:image/png;base64," + base64.b64encode(_read(rows[1][k])).decode()
               for k in ("chosen_path", "reject_path")]
        sc = _http(url, "/score", {"caption": rows[1]["prompt"], "images": b64})
        if (not np.array_equal(np.asarray(sc["rewards"], np.float32),
                               direct(samples_of(rows[1])))
                or "prob_first_over_second" not in sc):
            fail(f"http: /score on base64 images {sc}")

        # four pairs queued behind a held card: one B=8 call
        results, order = {}, []
        queue = service._queue
        put0 = queue.unfinished_tasks  # counts puts: the service never calls task_done

        def post(key, path, payload):
            results[key] = _http(url, path, payload)

        held = time.perf_counter()
        service._lock.acquire()
        try:
            blocker = threading.Thread(target=post, args=("one", "/score", {
                "caption": rows[3]["prompt"], "images": [rows[3]["chosen_path"]]}))
            blocker.start()
            while not (queue.unfinished_tasks == put0 + 1 and queue.qsize() == 0):
                time.sleep(0.002)  # queued and taken by the batcher, now waiting for the card
            time.sleep(0.2)  # past its 10 ms window: nothing more joins that call
            threads = []
            t_four = time.perf_counter()
            for i in range(4):  # one at a time into the queue: their order is known
                threads.append(threading.Thread(target=post, args=(i, "/score_pair",
                                                                    _pair_request(rows[i]))))
                threads[-1].start()
                while queue.qsize() < i + 1:
                    time.sleep(0.002)
                order.append(i)
            queued_s = time.perf_counter() - t_four
        finally:
            service._lock.release()
            held_s = time.perf_counter() - held
        for t in threads + [blocker]:
            t.join(timeout=300)
        four_s = time.perf_counter() - t_four
        held_calls = calls[reps + 2:]
        if sorted(results, key=str) != [0, 1, 2, 3, "one"] or held_calls != [1, 8]:
            fail(f"http: the four queued requests were not one B=8 call: {held_calls}")
        coalesced = np.concatenate([pair_rewards(results[i]) for i in order])
        want8 = direct([s for i in order for s in samples_of(rows[i])])
        if not np.array_equal(coalesced, want8):
            fail("http: the B=8 call's rewards differ from the direct call on the same samples")
        b2 = np.concatenate([direct(samples_of(rows[i])) for i in order])

        def decisions(r):
            return [bool(_prob(torch.from_numpy(r[2 * j: 2 * j + 2]), 1, rcfg) > 0.5)
                    for j in range(len(r) // 2)]

        # four more at once, free-running: however the 10 ms window splits them
        n0 = len(calls)
        free = [threading.Thread(target=post, args=(f"free{i}", "/score_pair",
                                                     _pair_request(rows[i])))
                for i in range(4)]
        t0 = time.perf_counter()
        for t in free:
            t.start()
        for t in free:
            t.join(timeout=300)
        free_s = time.perf_counter() - t0
        free_sizes = calls[n0:]
        free_r = np.concatenate([pair_rewards(results[f"free{i}"]) for i in range(4)])
        gaps = {k: float(np.abs(r - b2).max()) for k, r in (("B=8", coalesced), ("free", free_r))}
        if not decisions(coalesced) == decisions(free_r) == decisions(b2):
            fail(f"http: decisions across call shapes differ: B=8 {decisions(coalesced)}, "
                 f"free-running {decisions(free_r)}, B=2 {decisions(b2)}")
        sizes = list(calls)
        got = launches()  # ... and ends here
    finally:
        server.shutdown()
        server.server_close()
    # and the direct calls made for the comparisons: B=2 x2, B=8, B=2 x4
    want = _serving_launches(cfg, sizes + [2, 2, 8] + [2] * 4)
    if got != want:
        fail(f"http: launches {got} != {want} for device calls {sizes}")
    say("http", f"/healthz ok; /score_pair (two sample PNG paths, B=2 call): "
        f"{float(np.median(times[1:])):.4f} s/request (median of {len(times) - 1} after one "
        f"warm: {[round(t, 4) for t in times]}), rewards {pair_rewards(out).round(6).tolist()} "
        f"prob {out['prob']:.6f}, bit-equal to make_score_fn on the same collated samples; "
        f"/score (two base64 images) prob_first_over_second "
        f"{sc['prob_first_over_second']:.6f}, bit-equal too")
    say("http", f"four /score_pair from four threads, queued behind a one-image request "
        f"holding the card: device calls {held_calls} (that request, then the four pairs as "
        f"one B=8 call); queued in {queued_s:.4f} s, answered {four_s:.4f} s after the first "
        f"was sent (the card held back {held_s:.4f} s by the smoke); B=8 rewards bit-equal to "
        f"make_score_fn on the 8 samples; against each pair alone at B=2: max gap "
        f"{gaps['B=8']:.3e}, same decisions")
    say("http", f"four /score_pair from four threads at once, free-running: device calls "
        f"{free_sizes} (the 10 ms window against each request's host preparation), wall "
        f"{free_s:.4f} s; against each pair alone at B=2: max gap {gaps['free']:.3e}, same "
        f"decisions")
    say("http", f"launches {got} over {len(sizes)} service calls {sizes} and 7 direct calls; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return got


# ------------------------------------------------------------------ [eval]


SAMPLE_POINTS = "data/sample_test/non_pairwise_sample.json"
BATCH_EVAL_SCRIPT = "scripts/torch/batch_inference_rm_phi.sh"
# [eval]'s command lines' preference temperature: at the artifact's 0.1 the
# random head's probabilities sit within 2e-5 of 0.5 (GPM skew products of
# ~5e-6), under bf16's step there
EVAL_TAU = "1e-5"
USER_INPUT_SCRIPT = "scripts/torch/batch_inference_rm_phi_user_input.sh"


def _device_top(trace_path, n=8):
    """From a torch.profiler Chrome trace: the device time by kernel name (the
    ``n`` largest), the device's busy time, and the span from the first
    device event to the last."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                                         "gpu_memset")]
    if not dev:
        fail(f"eval: the profile {trace_path} holds no device event")
    by = {}
    for e in dev:
        by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] / 1e3
    span = (max(e["ts"] + e["dur"] for e in dev) - min(e["ts"] for e in dev)) / 1e3
    busy = sum(by.values())
    return sorted(by.items(), key=lambda kv: -kv[1])[:n], busy, span, len(dev)


def _start(logdir, tag, argv, env=None):
    """``argv`` from the checkout's root, started in the background (with
    ``env`` in place of this process's environment when given), its output
    to files under ``logdir``."""
    path = os.path.join(logdir, re.sub(r"[ '()]", "_", tag) + ".out")
    out = open(path, "w")
    proc = subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT, text=True, env=env)
    return proc, out, path, time.perf_counter()


def _cli(logdir, tag, module, *args, env=None):
    """``python -m module args``, as ``_start``."""
    return _start(logdir, tag, [sys.executable, "-m", module, *args], env)


def _cli_results(started, timeout=900):
    """Wait for every command line of ``started`` (tag -> ``_cli``); each must
    exit 0. Returns tag -> (the metrics JSON its output ends with or None,
    its output, its seconds from start to exit)."""
    done, t_end = {}, time.perf_counter() + timeout
    while len(done) < len(started):
        for tag, (proc, out, path, t0) in started.items():
            if tag not in done and proc.poll() is not None:
                done[tag] = time.perf_counter() - t0
                out.close()
        if time.perf_counter() > t_end:
            for proc, *_ in started.values():
                proc.kill()
            fail(f"eval: command lines still running after {timeout} s: "
                 f"{sorted(set(started) - set(done))}")
        time.sleep(0.1)
    res = {}
    for tag, (proc, _, path, _) in started.items():
        with open(path) as f:
            text = f.read()
        if proc.returncode != 0:
            fail(f"{tag}: exit {proc.returncode}\n{text[-4000:]}")
        at = text.rfind("\n{")
        res[tag] = (json.loads(text[at + 1:]) if at >= 0 else None, text, done[tag])
    return res


def phase_eval(cfg, rcfg, params, data_rewards, phi3v_dirs, tmp):
    """batch_rm_inference on the sample rows (pairwise: 4 pairs stacked into
    one B=8 call at seq 2560; pointwise: 8 rows) on phase 4's tree, the
    registry's default processor (u8 crops); the pairwise run once more with
    a profile, whose device time is summed by kernel. Then the command
    lines as a user runs them: the eval CLI over [load]'s 2-layer full-width
    checkpoint in bf16 and with --load_in_8bit, the train CLI in its smoke
    mode on the card, and the eval CLI on the artifact that wrote (over a
    tiny base checkpoint of the smoke config)."""
    t_phase = time.perf_counter()
    tok = SmokeTok(cfg.decoder.vocab_size)
    adaptor = RewardAdaptor(cfg, rcfg, params, device="cuda")
    proc = Phi3VProcessor(tok, num_crops=cfg.num_crops, device_preproc=True)
    rows = _sample_rows()
    with open(SAMPLE_POINTS) as f:
        points = json.load(f)
    n_clip, n_dec = cfg.vision.num_active_layers, cfg.decoder.num_layers
    seen = []
    orig = batch_inference.preference_prob

    def recording(chosen, rejected, **kw):
        # the rewards the stacked call produced, before the probabilities
        # (which batch_rm_inference takes in the rewards' dtype, bf16 here,
        # as the JAX package does)
        seen.append(torch.cat([chosen, rejected]).float())
        return orig(chosen, rejected, **kw)

    kw = dict(batch_size=4, seq_len=DATA_SEQ, num_workers=4, progress=False)
    batch_inference.preference_prob = recording
    try:
        reset_counters()  # the main path's run starts here
        t0 = time.perf_counter()
        pm = batch_inference.batch_rm_inference(adaptor, rows, tok, proc, **kw)
        pair_s = time.perf_counter() - t0
        after_pairs = launches()
        t0 = time.perf_counter()
        pt = batch_inference.batch_rm_inference(adaptor, points, tok, proc, **kw)
        point_s = time.perf_counter() - t0
        got = launches()  # ... and ends here
        prof_dir = os.path.join(tmp, "eval_profile")
        reset_counters()
        t0 = time.perf_counter()
        pm2 = batch_inference.batch_rm_inference(adaptor, rows, tok, proc, profile_dir=prof_dir,
                                                 **kw)
        prof_s = time.perf_counter() - t0
        prof_counts = launches()
    finally:
        batch_inference.preference_prob = orig
    per8 = {"fa_direct": n_clip + n_dec, **_norm_launches(cfg)}  # one B=8 call
    if after_pairs != {k: per8.get(k, 0) for k in after_pairs}:
        fail(f"eval: pairwise launches {after_pairs} != {per8}")
    if got != {k: 3 * per8.get(k, 0) for k in got}:  # the eight rows: two B=4 calls, B1 again
        fail(f"eval: pairwise + pointwise launches {got}")
    got_r = seen[0]
    gap = (got_r - data_rewards.float()).abs().max().item()
    probs = _prob(got_r, 4, rcfg)
    same = bool(((probs > 0.5) == (_prob(data_rewards, 4, rcfg) > 0.5)).all())
    if pm["num_pairs"] != 4 or not same or pt["num_samples"] != len(points):
        fail(f"eval: metrics {pm} / {pt}, decisions against [data]'s u8 request {same}")
    if pm2["num_pairs"] != 4 or prof_counts != after_pairs:
        fail(f"eval: the profiled run {pm2}, launches {prof_counts}")
    top, busy, span, n_ev = _device_top(os.path.join(prof_dir, "trace.json"))
    say("eval", f"batch_rm_inference, {SAMPLE_PAIRS} (4 pairs, one stacked B=8 call, seq "
        f"{DATA_SEQ}): {pm} (its probabilities in bf16, the rewards' dtype); {pair_s:.3f} s in "
        f"all (loader threads, host preparation and the card); rewards against [data]'s u8-crop "
        f"request on the same rows: max gap {gap:.3e}; probabilities in f32 "
        f"{probs.cpu().numpy().round(6).tolist()}, same decisions {same}")
    say("eval", f"batch_rm_inference, {SAMPLE_POINTS} ({len(points)} rows, two B=4 calls): "
        f"{pt}; {point_s:.3f} s; launches of both runs {got}")
    say("eval", f"profile of the pairwise run (torch.profiler, CUDA activity; {prof_s:.3f} s "
        f"with the profiler on): {n_ev} device events, device busy {busy:.2f} ms in a span of "
        f"{span:.2f} ms from the first device event to the last (idle share "
        f"{1 - busy / span:.3f}); the largest by device time: "
        + "; ".join(f"{name[:60]} {ms:.2f} ms ({ms / busy:.1%})" for name, ms in top))

    # the command lines, as subprocesses: bf16 and W8A8 evals over [load]'s
    # checkpoint, the train CLI's smoke mode and the train CLI over [load]'s
    # checkpoint with --load_in_8bit, started together
    base, pm_dir = phi3v_dirs
    tok_base = _with_word_tokenizer(base, os.path.join(tmp, "phi3v_tok"))
    # a sharp preference temperature, so that the pairs' bf16 decisions are
    # not all ties at 0.5
    sharp = ["--general_preference_tau", EVAL_TAU]
    ev = ["--pretrain", base, "--pm_path", pm_dir, "--dataset", SAMPLE_PAIRS,
          "--micro_batch_size", "4", "--seq_len", str(DATA_SEQ), "--num_workers", "4",
          "--device", "cuda", *sharp]
    train_dir = os.path.join(tmp, "train_cli")
    # six processes share the host's cores: two CPU threads each (their
    # work is on the card; oversubscribed threads only slow their start-up).
    # The bf16 eval CLI and the batch eval script tokenize alike: the hash
    # tokenizer (no tokenizer files in [load]'s base) under one PYTHONHASHSEED
    shared = dict(os.environ, OMP_NUM_THREADS="2")
    hashed = dict(shared, PYTHONHASHSEED="0")
    script_env = dict(hashed, PYTHON=sys.executable, PRETRAIN=base, PM_PATH=pm_dir)
    torch.cuda.empty_cache()  # the card's memory to the processes beside this one
    started = {
        "eval-cli bf16": _cli(tmp, "eval-cli bf16", "llava_reward_torch.eval_batch_inference",
                              *ev, env=hashed),
        "eval-cli w8a8": _cli(tmp, "eval-cli w8a8", "llava_reward_torch.eval_batch_inference",
                              *ev, "--load_in_8bit", env=shared),
        "train-cli": _cli(tmp, "train-cli", "llava_reward_torch.train_llava_reward",
                          "--dataset", SAMPLE_PAIRS, "--max_epochs", "1",
                          "--micro_train_batch_size", "2", "--seq_len", "1024",
                          "--is_general_preference", "--value_head_dim", "2", "--lora_rank", "4",
                          "--lora_alpha", "8", "--ft_projector", "--bf16", "--save_path",
                          os.path.join(train_dir, "save"), "--ckpt_path",
                          os.path.join(train_dir, "ckpt"), "--num_workers", "2",
                          "--device", "cuda", env=shared),
        "train-cli w8a8": _cli(tmp, "train-cli w8a8", "llava_reward_torch.train_llava_reward",
                               "--pretrain", tok_base, "--load_in_8bit", "--bf16",
                               "--gradient_checkpointing", "--dataset", SAMPLE_PAIRS,
                               "--max_epochs", "1", "--micro_train_batch_size", "2",
                               "--seq_len", str(DATA_SEQ), "--is_general_preference",
                               "--value_head_dim", "2", "--lora_rank", "4", "--lora_alpha", "8",
                               "--save_path", os.path.join(train_dir, "w8a8_save"),
                               "--ckpt_path", os.path.join(train_dir, "w8a8_ckpt"),
                               "--num_workers", "2", "--device", "cuda", env=shared),
        # the port's launch scripts, as a user runs them; the user-input one
        # over the word tokenizer (simple_inference loads the tokenizer)
        "script batch eval": _start(tmp, "script batch eval", [
            "bash", BATCH_EVAL_SCRIPT, "--seq_len", str(DATA_SEQ), "--num_workers", "4",
            "--device", "cuda", *sharp], script_env),
        "script user input": _start(tmp, "script user input", [
            "bash", USER_INPUT_SCRIPT, "--device", "cuda"], dict(script_env, PRETRAIN=tok_base)),
    }
    # a base checkpoint of the smoke config for the train CLI's artifact
    tiny = phi3v_tiny_config(num_crops=4)
    tiny_base = os.path.join(tmp, "tiny_base")
    os.makedirs(tiny_base)
    tree = phi3v.init_params(tiny, torch.Generator(device="cuda").manual_seed(5),
                             torch.float32, "cuda")
    save_torch_state_dict(hf_phi3v.hf_state_dict_from_params(tree, tiny),
                          os.path.join(tiny_base, "pytorch_model.bin"))
    d = tiny.decoder
    with open(os.path.join(tiny_base, "config.json"), "w") as f:
        json.dump({"model_type": "phi3_v", "vocab_size": d.vocab_size,
                   "hidden_size": d.hidden_size, "intermediate_size": d.intermediate_size,
                   "num_hidden_layers": d.num_layers, "num_attention_heads": d.num_heads,
                   "num_key_value_heads": d.num_kv_heads, "pad_token_id": d.pad_token_id,
                   "eos_token_id": d.eos_token_id}, f)
    res = _cli_results(started)
    artifact_dir = os.path.join(train_dir, "save", "epoch_0")
    files = sorted(os.path.relpath(os.path.join(r, f), artifact_dir)
                   for r, _, fs in os.walk(artifact_dir) for f in fs)
    tag = "eval-cli on the train CLI's artifact"
    res.update(_cli_results({tag: _cli(tmp, tag, "llava_reward_torch.eval_batch_inference",
                                       "--pretrain", tiny_base, "--pm_path", artifact_dir,
                                       "--dataset", SAMPLE_PAIRS, "--micro_batch_size", "4",
                                       "--num_workers", "4", "--device", "cuda")}))
    for tag in ("eval-cli bf16", "eval-cli w8a8", "eval-cli on the train CLI's artifact",
                "script batch eval"):
        m = res[tag][0]
        if not m or m.get("num_pairs") != 4 or not 0.0 <= m["mean_prob"] <= 1.0:
            fail(f"eval: {tag} printed {m}")
    # the batch eval script against the bf16 eval CLI: the same decisions
    # (accuracy and its tie-excluded form over the four pairs), the mean
    # probability within phase 4's bound; the CLI prints no reward a row
    m_s, m_c = res["script batch eval"][0], res["eval-cli bf16"][0]
    script_gap = abs(m_s["mean_prob"] - m_c["mean_prob"])
    if ((m_s["accuracy"], m_s["accuracy_wo_tie"]) != (m_c["accuracy"], m_c["accuracy_wo_tie"])
            or script_gap > REWARD_TOL):
        fail(f"eval: {BATCH_EVAL_SCRIPT} printed {m_s}, the eval CLI {m_c}")
    _, user_text, user_s = res.pop("script user input")
    user = re.search(r"^rewards: (.*?)^P\(image1 preferred over image2\) = ([0-9.]+)$",
                     user_text, re.M | re.S)
    user_rewards = [float(v) for v in re.findall(r"-?\d+\.\d*(?:e[-+]?\d+)?",
                                                 user.group(1))] if user else []
    if (len(user_rewards) != 2 * rcfg.value_head_dim
            or not all(math.isfinite(v) for v in user_rewards)
            or not 0.0 <= float(user.group(2)) <= 1.0):
        fail(f"eval: {USER_INPUT_SCRIPT} printed\n{user_text[-3000:]}")
    # each command line's own launches: one stacked B=8 call for the evals
    # (B1 in CLIP and the 2 decoder layers; W8A8 adds the 2 layers' B4 x2,
    # B5, B6 and four GEMMs); the tiny config's head_dim 16 and 8 run B3
    # (and B8 in training) zero-padded to 64
    w8 = {"rms_quant": 4, "silu_mul_quant": 2, "row_quant": 2, "int8_matmul": 8}
    tiny_hm = {"fa_hm": tiny.vision.num_active_layers + d.num_layers}
    # the W8A8 train CLI: 3 sample pairs train, 1 evaluates (the smoke mode's
    # split); one step of 2 pairs (B=4 rows: B1 in the 2 decoder layers, and
    # again under remat; the backward's B2 x3 + B8), each of the 4 projections
    # of a layer through B6 + the GEMM in the forward and the recompute; then
    # the held-out pair scored a side at a time (B=1: B2 x3 + B3 a layer, B6 +
    # GEMM a projection); B1 in CLIP for every forward
    want_train8 = {"fa_direct": 3 * n_clip + 2 * 2, "prep": 3 * 2 + 2 * 3 * 2, "fa_hm": 2 * 2,
                   "fa_bwd": 2, "row_quant": 2 * 4 * 2 + 2 * 4 * 2,
                   "int8_matmul": 2 * 4 * 2 + 2 * 4 * 2}
    # the norm kernel: every norm of the evals' call ([load]'s artifact has
    # SkipCA, the train CLI's has none); the train CLIs as _cli_norms has
    # them (the smoke one with --ft_projector, the W8A8 one without)
    cfg2 = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_layers=2))
    want_train8.update(_cli_norms(cfg2, steps=1, sides=2, projector=False))
    want = {"eval-cli bf16": {"fa_direct": n_clip + 2, **_norm_launches(cfg2)},
            "script batch eval": {"fa_direct": n_clip + 2, **_norm_launches(cfg2)},
            "eval-cli w8a8": {"fa_direct": n_clip + 2, **w8, **_norm_launches(cfg2, w8a8=True)},
            "eval-cli on the train CLI's artifact": {**tiny_hm,
                                                     **_norm_launches(tiny, skipca=False)},
            "train-cli w8a8": want_train8}
    smoke_norms = _cli_norms(tiny, steps=1, sides=2, projector=True)
    cli_launches = {}
    for tag, (_, text, _) in res.items():
        found = re.findall(r"^kernel launches (\{.*\})$", text, re.M)
        if len(found) != 1:
            fail(f"eval: {tag} printed {len(found)} kernel launches lines")
        got_cli = cli_launches[tag] = json.loads(found[0])
        ran = {k for k, v in got_cli.items() if v}
        if tag == "train-cli":
            ok = (ran == {"fa_hm", "fa_bwd", *NORM_KERNELS}
                  and all(got_cli[k] == v for k, v in smoke_norms.items()))
        else:
            ok = got_cli == {k: want[tag].get(k, 0) for k in got_cli}
        if not ok:
            fail(f"eval: {tag} launched {got_cli} (expected "
                 f"{want.get(tag, f'B3, B8 and the norm kernel {smoke_norms} only')})")
    fallback = {t: "hash tokenizer" in r[1] for t, r in res.items() if t.startswith("eval")}
    train_log = [ln for ln in res["train-cli"][1].splitlines() if ln.strip()][-3:]
    say("eval", "python -m llava_reward_torch.eval_batch_inference over [load]'s 2-layer "
        f"full-width checkpoint: bf16 {res['eval-cli bf16'][0]} in {res['eval-cli bf16'][2]:.1f} "
        f"s; --load_in_8bit {res['eval-cli w8a8'][0]} in {res['eval-cli w8a8'][2]:.1f} s "
        f"(six command lines started together); the hash-tokenizer fallback: {fallback}")
    on_artifact = res["eval-cli on the train CLI's artifact"][0]
    say("eval", f"the command lines' kernel launches: {cli_launches}")
    say("eval", f"python -m llava_reward_torch.train_llava_reward (smoke mode: tiny config, "
        f"--bf16, one epoch on the sample pairs, --device cuda): exit 0 in {res['train-cli'][2]:.1f} s, "
        f"artifact {files}; its last log lines {train_log}; the eval CLI on that artifact over "
        f"a tiny base checkpoint: {on_artifact}")
    w8_dir = os.path.join(train_dir, "w8a8_save", "epoch_0")
    w8_files = sorted(os.listdir(w8_dir)) if os.path.isdir(w8_dir) else []
    w8_log = [ln for ln in res["train-cli w8a8"][1].splitlines()
              if "step 1 " in ln or "eval step" in ln]
    say("eval", f"python -m llava_reward_torch.train_llava_reward --pretrain [load]'s 2-layer "
        f"full-width checkpoint (with a word tokenizer written beside it) --load_in_8bit --bf16 "
        f"--gradient_checkpointing, LoRA r=4: exit 0 in {res['train-cli w8a8'][2]:.1f} s, "
        f"artifact {w8_files}; log {w8_log}")
    if "pytorch_model.bin" not in w8_files:
        fail(f"eval: the W8A8 train CLI wrote {w8_files}")
    say("eval", f"{BATCH_EVAL_SCRIPT} (PRETRAIN and PM_PATH: [load]'s checkpoint; --seq_len "
        f"{DATA_SEQ} --num_workers 4 --device cuda --general_preference_tau {EVAL_TAU} through "
        f"\"$@\", as the eval CLIs): exit 0 in "
        f"{res['script batch eval'][2]:.1f} s, {m_s}; against the bf16 eval CLI: the same "
        f"decisions, mean_prob gap {script_gap:.3e}; {USER_INPUT_SCRIPT} (PRETRAIN with the word "
        f"tokenizer): exit 0 in {user_s:.1f} s, rewards {user_rewards}, "
        f"P(image1 preferred) {float(user.group(2))}")
    say("eval", f"phase {time.perf_counter() - t_phase:.1f} s")
    return {k: got[k] + prof_counts[k] for k in got}


def _with_word_tokenizer(base, out):
    """``out``: the checkpoint directory ``base`` (its files linked) with a
    word-level tokenizer beside it, which ``AutoTokenizer`` loads: the sample
    prompts' words, the Phi-3 chat markers as special tokens, and Phi-3's
    chat template (its 22-character assistant cue, which the dataset layer
    slices off). A checkpoint made on the card has no tokenizer files, and
    the train CLI, as the JAX one, reads the tokenizer from --pretrain."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    os.makedirs(out)
    for name in os.listdir(base):
        os.symlink(os.path.abspath(os.path.join(base, name)), os.path.join(out, name))
    special = ["<unk>", "</s>", "<|user|>", "<|end|>", "<|assistant|>"]
    words = sorted({w for r in _sample_rows() for k in ("prompt", "chosen", "rejected")
                    for w in re.findall(r"\w+|[^\w\s]", str(r.get(k, "")))} - set(special))
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(special + words)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(special)
    tok.save(os.path.join(out, "tokenizer.json"))
    template = ("{% for m in messages %}<|user|>\n{{ m['content'] }}<|end|>\n{% endfor %}"
                "{% if add_generation_prompt %}<|assistant|>\n{% endif %}")
    with open(os.path.join(out, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "</s>",
                   "unk_token": "<unk>", "chat_template": template}, f)
    return out


# ------------------------------------------------------------------ [dist]

TRAIN_CLI = "llava_reward_torch.train_llava_reward"
# (b) against (a), relative, on each step's loss: one bf16 step (2^-8); on
# grad_norm: four (2^-6). The control, (a') against (a), is one layout run
# twice: the same first loss bit for bit, grad_norm apart by B8's fp32
# atomics only (0 when first read, H100 80GB HBM3 at 700 W). Between (a) and
# (b) the rows of a step and every kernel route are the same (B1 at B=8 and
# at B=4 rows), but each half's backward runs at other GEMM row counts and
# its weight gradients, sums over 10-20 k rows with cancellation, are
# rounded to bf16 apart before the two are summed: the first reading on that
# card was 1.6e-05 on the loss and 6.9e-04 / 3.87e-03 on grad_norm (against
# 2^-8 then). A fault of the data-parallel path moves
# grad_norm by far more: a gradient not averaged over the two ranks doubles
# it, one rank's half lost or a shard's reduce-scatter skipped changes it by
# tens of percent.
DIST_TOL = 2.0 ** -8
DIST_NORM_TOL = 2.0 ** -6
# [tp] (iv): two tp ranks over the decoder in W8A8 against one rank. The
# decoder requantizes every activation, on bf16 values; tp's bf16 partial
# sums (the CLIP tower's, the LoRA deltas') move activations by a bf16 ulp,
# ~0.4 % of a value, which carries a large share of codes across their
# rounding boundary (the codes themselves are the whole row's on both
# layouts). On an H100 80GB HBM3 at 700 W grad_norm read 1.08e-02 at step
# 1 and 2.10e-02 at step 2 (where AdamW's first update has moved each LoRA
# element by +-lr whatever its gradient's size), the loss 1.1e-04, against
# the bf16 runs' 7e-04 / 8.1e-03 ((i)); so grad_norm is held to 2^-5 here,
# the loss to DIST_TOL. A fault of the tp path (a gradient not summed over
# tp, a misplaced block) moves grad_norm by tens of percent.
TP_W8A8_NORM_TOL = 2.0 ** -5


def _dist_env(world, rank, port):
    """torchrun's environment for rank ``rank`` of ``world`` on this host."""
    return dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world))


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _summary(tag, text):
    found = re.findall(r"^train summary (\{.*\})$", text, re.M)
    cl = re.findall(r"^kernel launches (\{.*\})$", text, re.M)
    if len(found) != 1 or len(cl) != 1:
        fail(f"dist: {tag} printed {len(found)} summary and {len(cl)} launches lines")
    return {**json.loads(found[0]), "launches": json.loads(cl[0])}


def _artifact(save):
    d = os.path.join(save, "epoch_0")
    return {**torch.load(os.path.join(d, "pytorch_model.bin"), weights_only=True),
            **torch.load(os.path.join(d, "lora", "adapter_model.bin"), weights_only=True)}


def _dist_args(tmp):
    """The train CLI's flags of [dist] and [tp]: [load]'s checkpoint with its
    word tokenizer, ten sample pairs (eight train, two held out)."""
    data = os.path.join(tmp, "dist_rows.json")
    if not os.path.exists(data):
        rows = _sample_rows()
        with open(data, "w") as f:
            json.dump(rows * 2 + rows[:2], f)
    return ["--pretrain", os.path.join(tmp, "phi3v_tok"), "--bf16",
            "--gradient_checkpointing", "--dataset", data, "--train_split_ratio", "0.8",
            "--max_epochs", "1", "--seq_len", str(DATA_SEQ), "--is_general_preference",
            "--value_head_dim", "2", "--add_cross_attention", "--lora_rank", "4",
            "--lora_alpha", "8", "--ft_projector", "--logging_steps", "1", "--num_workers",
            "2", "--device", "cuda"]


def _dist_run(tmp, tag, micro, *extra):
    return ["--micro_train_batch_size", str(micro), *extra,
            "--save_path", os.path.join(tmp, "dist", tag, "save"),
            "--ckpt_path", os.path.join(tmp, "dist", tag, "ckpt")]


def phase_dist(cfg, tmp):
    """The train CLI on more than one process, over [load]'s 2-layer
    full-width phi3v checkpoint (the word tokenizer [eval] wrote beside it),
    bf16 LoRA with SkipCA and the projector, remat, ten sample pairs (eight
    train, two held out), two steps of four pairs: (a) one rank over NCCL
    (torchrun's environment, WORLD_SIZE=1, --zero_stage 2: fsdp 1), micro
    batch 4; then together (b) two ranks on this one card over gloo
    (--mesh_fsdp 2, collectives staged through host memory), micro batch 2
    each, and (a') the CLI with no distributed environment, micro batch 4.
    (b)'s time is two processes sharing one card (and (a')'s run): no
    multi-card scaling figure. Returns the launches of the four processes and
    (a)'s summary."""
    t_phase = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    common = _dist_args(tmp)

    def run(tag, micro, *extra):
        return _dist_run(tmp, tag, micro, *extra)

    torch.cuda.empty_cache()
    res = _cli_results({"(a)": _cli(tmp, "dist (a)", TRAIN_CLI, *common,
                                    *run("a", 4, "--zero_stage", "2"),
                                    env=_dist_env(1, 0, _free_port()))})
    port = _free_port()
    started = {f"(b) rank {r}": _cli(tmp, f"dist (b) rank {r}", TRAIN_CLI, *common,
                                     *run("b", 2, "--mesh_fsdp", "2"),
                                     env=_dist_env(2, r, port)) for r in range(2)}
    started["(a')"] = _cli(tmp, "dist (a')", TRAIN_CLI, *common, *run("a0", 4))
    res.update(_cli_results(started))
    s = {tag: _summary(tag, text) for tag, (_, text, _) in res.items()}
    a, a0, b0, b1 = s["(a)"], s["(a')"], s["(b) rank 0"], s["(b) rank 1"]

    # launches, each process's own: two steps of B1 in the CLIP tower and in
    # the 2 decoder layers forward and under remat (B=8 and B=4 rows both
    # take B1), B2 x3 + B8 a layer backward; then the held-out pairs a side
    # at a time (B=2 / B=1 rows: B2 x3 + B3 a layer), B1 in CLIP
    n_clip = cfg.vision.num_active_layers
    want = {"fa_direct": 4 * n_clip + 2 * 4, "prep": 2 * 6 + 2 * 6, "fa_hm": 2 * 2,
            "fa_bwd": 2 * 2,
            **_cli_norms(dataclasses.replace(cfg, decoder=dataclasses.replace(
                cfg.decoder, num_layers=2)), steps=2, sides=2, projector=True)}
    for tag, x in s.items():
        if x["launches"] != {k: want.get(k, 0) for k in x["launches"]}:
            fail(f"dist: {tag} launched {x['launches']}, expected {want}")
    backends = {tag: x["backend"] for tag, x in s.items()}
    if backends != {"(a)": "nccl", "(a')": None, "(b) rank 0": "gloo", "(b) rank 1": "gloo"}:
        fail(f"dist: backends {backends}")
    if any(x["steps"] != 2 for x in s.values()):
        fail(f"dist: steps {[x['steps'] for x in s.values()]}")
    # the control: one layout twice
    if a["losses"][0] != a0["losses"][0]:
        fail(f"dist: the first loss over NCCL {a['losses'][0]!r} != without it "
             f"{a0['losses'][0]!r}")
    control = abs(a["grad_norms"][0] - a0["grad_norms"][0]) / a["grad_norms"][0]
    # (b): the ranks agree exactly; their rows partition the train rows; each
    # step's loss and grad_norm as (a)'s within DIST_TOL
    if (b0["losses"], b0["grad_norms"]) != (b1["losses"], b1["grad_norms"]):
        fail(f"dist: the ranks disagree: {b0['losses']} {b0['grad_norms']} / "
             f"{b1['losses']} {b1['grad_norms']}")
    if set(b0["rows"]) & set(b1["rows"]) or sorted(b0["rows"] + b1["rows"]) != list(range(8)) \
            or sorted(a["rows"]) != list(range(8)):
        fail(f"dist: rows (a) {a['rows']}, (b) {b0['rows']} / {b1['rows']}")
    rel = [max(abs(x - y) / abs(y) for x, y in zip(b0[k], a[k])) for k in ("losses",
                                                                          "grad_norms")]
    if rel[0] > DIST_TOL or max(rel[1], control) > DIST_NORM_TOL:
        fail(f"dist: (b) against (a) {rel}, the control {control:.3e} (tol {DIST_TOL:g} "
             f"loss, {DIST_NORM_TOL:g} grad_norm)")
    # each rank holds half of every sharded leaf of the stacked decoder layers;
    # the two RMSNorm weights (L, H) a layer stay whole
    mc = _manifest_config("phi35_vision_instruct", 2)
    norms = 2 * mc["num_hidden_layers"] * mc["hidden_size"] * 2
    if not b0["layer_bytes"] == b1["layer_bytes"] == (a["layer_bytes"] - norms) // 2 + norms:
        fail(f"dist: decoder layer bytes (a) {a['layer_bytes']}, (b) {b0['layer_bytes']} / "
             f"{b1['layer_bytes']}")
    # one artifact, rank 0's; heads and LoRA as (a)'s within what two AdamW
    # steps at lr 2e-4 can move an element (a sign of a near-zero gradient
    # flipped) plus DIST_TOL of the leaf
    writes = [len(re.findall(r"saved reward artifact", res[t][1])) for t in
              ("(b) rank 0", "(b) rank 1")]
    art_a, art_b = _artifact(os.path.join(tmp, "dist", "a", "save")), _artifact(
        os.path.join(tmp, "dist", "b", "save"))
    if writes != [1, 0] or art_a.keys() != art_b.keys():
        fail(f"dist: artifact writes per rank {writes}, keys equal {art_a.keys() == art_b.keys()}")
    worst = max(((art_b[k].float() - art_a[k].float()).abs().max().item()
                 / (4 * 2e-4 * 2 + DIST_TOL * art_a[k].float().abs().max().item()), k)
                for k in art_a)
    if worst[0] > 1:
        fail(f"dist: artifact leaf {worst[1]} apart from (a)'s by {worst[0]:.3f} of its bound")
    for tag in ("(a)", "(a')", "(b) rank 0", "(b) rank 1"):
        x = s[tag]
        say("dist", f"{tag}: backend {x['backend']}, mesh {x['mesh']}, rows {x['rows']}, losses "
            f"{x['losses']}, grad_norms {x['grad_norms']}, s/step {x['step_times_s']} (the "
            f"second is steady), peak {x['peak_gib']:.2f} GiB, decoder layer bytes "
            f"{x['layer_bytes']}, exit 0 in {res[tag][2]:.1f} s; launches {x['launches']}")
    say("dist", f"{card}: (b) against (a), the largest relative gap of the losses "
        f"{rel[0]:.3e} (tol {DIST_TOL:g}) and of grad_norm {rel[1]:.3e} (tol "
        f"{DIST_NORM_TOL:g}); the control (a') against (a): first loss bit-equal, grad_norm "
        f"{control:.3e}; the artifact written "
        f"once (rank 0), its worst leaf {worst[1]} at {worst[0]:.3f} of its bound; (b) shares "
        f"one card between two ranks and (a')'s run, so its time is no scaling figure")
    say("dist", f"phase {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(x["launches"][k] for x in s.values()) for k in a["launches"]}, a


# ------------------------------------------------------------------ [tp]


def _attention_launches(cfg, tp, rows, clip=True):
    """B1 / B2 / B3 launches of one phi3v forward at ``rows`` rows on a rank
    holding 1 / ``tp`` of the heads: B1 in every CLIP layer (its head groups
    on the local heads; ``clip``), and per decoder layer B1 when rows x
    (local heads / head group) >= 32
    (``ops/flash_attention._fused_qkv_attention_fwd_impl``), else B2 x3 + B3."""
    dec = cfg.decoder
    out = dict.fromkeys(("fa_direct", "prep", "fa_hm", "fa_bwd"), 0)
    if clip and fa._direct_group(cfg.vision.num_heads // tp, cfg.vision.head_dim) is not None:
        out["fa_direct"] += cfg.vision.num_active_layers
    nh = dec.num_heads // tp
    g = fa._direct_group(nh, dec.head_dim)
    if g is not None and rows * (nh // g) >= 32:
        out["fa_direct"] += dec.num_layers
    else:
        out["prep"] += 3 * dec.num_layers
        out["fa_hm"] += dec.num_layers
    return out


def _cli_launches(cfg, tp, step_rows, steps, eval_rows):
    """One train CLI process's launches over [dist]'s flags (--ft_projector):
    per step the forward, the decoder's again under remat (the CLIP tower
    holds nothing trainable: once), the backward's B2 x3 (the fused core's
    recompute) and B8 a decoder layer; then each held-out side's forward;
    the norm kernel as ``_cli_norms`` has it."""
    fwd = _attention_launches(cfg, tp, step_rows)
    remat = _attention_launches(cfg, tp, step_rows, clip=False)
    side = _attention_launches(cfg, tp, eval_rows)
    L = cfg.decoder.num_layers
    bwd = {"prep": 3 * L, "fa_bwd": L}
    return {**{k: steps * (fwd[k] + remat[k] + bwd.get(k, 0)) + 2 * side[k] for k in fwd},
            **_cli_norms(cfg, steps, 2, projector=True)}


def phase_tp(cfg, rcfg, tmp, a, phi3v_dirs):
    """Tensor parallelism over tp on two ranks sharing this card over gloo:
    (i) the train CLI with --mesh_tp 2 against [dist] (a), (ii) scoring
    [load]'s tree on two tp ranks against one rank, (iv) and (v) the same
    over the decoder in W8A8 (``_tp_w8a8``), (iii) qwen and LLaVA LoRA steps
    at full width (``_tp_steps``). Returns the launches of the thirteen
    processes."""
    t_phase = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    # --- (ii)'s inputs first (the one-rank rewards in this process), so that
    # the four processes then run together
    base, pm = phi3v_dirs
    adaptor = load_reward_adaptor(base, pm, model_type="phi3v", compute_dtype=torch.bfloat16,
                                  device="cuda")
    params, cfg2 = adaptor.params, adaptor.cfg
    gen = torch.Generator(device="cuda").manual_seed(7)
    reqs = [make_request(cfg2, gen, 1, DATA_SEQ, {1: 40}), make_request(cfg2, gen, 4, DATA_SEQ, {})]
    params["head"], spread = _principal_head(cfg2, rcfg, params, reqs)
    _say_head("tp", "the B=2 and B=8 requests'", spread)
    # (v)'s: the same tree with the decoder W8A8, one rank's B=2 rewards
    dec = params["backbone"]["decoder"]
    qparams = dict(params, backbone=dict(params["backbone"], decoder=dict(
        dec, layers=quantize_stacked_layers(dec["layers"], scheme="w8a8"))))
    with torch.inference_mode():
        one = [reward_forward(params, cfg2, rcfg, r).reward.float().cpu() for r in reqs]
        one_w8 = reward_forward(qparams, cfg2, rcfg, reqs[0]).reward.float().cpu()
    batches = [{k: v.cpu() for k, v in r._asdict().items() if v is not None} for r in reqs]
    spec, qspec = (os.path.join(tmp, f"tp_score{t}.pt") for t in ("", "_w8a8"))
    for path, tree, bs in ((spec, params, batches), (qspec, qparams, batches[:1])):
        torch.save({"family": "phi3v", "pretrain": base, "rcfg": dataclasses.asdict(rcfg),
                    "mesh": {"mesh_tp": 2}, "params": tree_map(lambda t: t.cpu(), tree),
                    "batches": bs}, path)
    del adaptor, params, qparams, dec
    torch.cuda.empty_cache()

    port = [_free_port() for _ in range(2)]
    started = {f"(i) rank {r}": _cli(tmp, f"tp (i) rank {r}", TRAIN_CLI, *_dist_args(tmp),
                                     *_dist_run(tmp, "tp", 4, "--mesh_tp", "2"),
                                     env=_dist_env(2, r, port[0])) for r in range(2)}
    started.update({f"(ii) rank {r}": _cli(tmp, f"tp (ii) rank {r}", "llava_reward_torch.dryrun",
                                           "score", spec, os.path.join(tmp, "tp_score.out"),
                                           env=_dist_env(2, r, port[1])) for r in range(2)})
    # (iv): the train CLI over the decoder in W8A8, on two tp ranks and on one
    port += [_free_port() for _ in range(2)]
    started.update({f"(iv) rank {r}": _cli(
        tmp, f"tp (iv) rank {r}", TRAIN_CLI, *_dist_args(tmp), "--load_in_8bit",
        *_dist_run(tmp, "tp_w8a8", 4, "--mesh_tp", "2"), env=_dist_env(2, r, port[2]))
        for r in range(2)})
    started["(iv) one rank"] = _cli(tmp, "tp (iv) one rank", TRAIN_CLI, *_dist_args(tmp),
                                    "--load_in_8bit", *_dist_run(tmp, "one_w8a8", 4))
    # (v): scoring the W8A8 tree on two tp ranks
    started.update({f"(v) rank {r}": _cli(tmp, f"tp (v) rank {r}", "llava_reward_torch.dryrun",
                                          "score", qspec, os.path.join(tmp, "tp_score_w8a8.out"),
                                          env=_dist_env(2, r, port[3])) for r in range(2)})
    res = _cli_results(started)
    s = {tag: _summary(tag, res[tag][1]) for tag in ("(i) rank 0", "(i) rank 1")}
    t0, t1 = s["(i) rank 0"], s["(i) rank 1"]
    counts = {k: t0["launches"][k] + t1["launches"][k] for k in t0["launches"]}

    # (i): the ranks agree exactly; each reads every train row, as (a) does;
    # each step's loss and grad_norm as (a)'s within [dist]'s bounds
    want = _cli_launches(cfg2, 2, step_rows=8, steps=2, eval_rows=2)
    for tag, x in s.items():
        if x["launches"] != {k: want.get(k, 0) for k in x["launches"]}:
            fail(f"tp: {tag} launched {x['launches']}, expected {want} (local heads)")
        if x["mesh"] != {"dp": 1, "fsdp": 1, "tp": 2} or x["backend"] != "gloo":
            fail(f"tp: {tag} mesh {x['mesh']}, backend {x['backend']}")
    if (t0["losses"], t0["grad_norms"]) != (t1["losses"], t1["grad_norms"]) or t0["steps"] != 2:
        fail(f"tp: the ranks disagree: {t0['losses']} {t0['grad_norms']} / "
             f"{t1['losses']} {t1['grad_norms']}")
    if not t0["rows"] == t1["rows"] == a["rows"]:
        fail(f"tp: rows {t0['rows']} / {t1['rows']}, (a) {a['rows']}")
    rel = [max(abs(x - y) / abs(y) for x, y in zip(t0[k], a[k])) for k in ("losses",
                                                                          "grad_norms")]
    if rel[0] > DIST_TOL or rel[1] > DIST_NORM_TOL:
        fail(f"tp: against (a) {rel} (tol {DIST_TOL:g} loss, {DIST_NORM_TOL:g} grad_norm)")
    mc = _manifest_config("phi35_vision_instruct", 2)
    norms = 2 * mc["num_hidden_layers"] * mc["hidden_size"] * 2
    if not t0["layer_bytes"] == t1["layer_bytes"] == (a["layer_bytes"] - norms) // 2 + norms:
        fail(f"tp: decoder layer bytes (a) {a['layer_bytes']}, tp {t0['layer_bytes']} / "
             f"{t1['layer_bytes']}")
    writes = [len(re.findall(r"saved reward artifact", res[t][1])) for t in
              ("(i) rank 0", "(i) rank 1")]
    if writes != [1, 0]:
        fail(f"tp: artifact writes per rank {writes}")
    for tag, x in s.items():
        say("tp", f"(i) {tag[4:]}: backend {x['backend']}, mesh {x['mesh']}, rows {x['rows']}, "
            f"losses {x['losses']}, grad_norms {x['grad_norms']}, s/step {x['step_times_s']} "
            f"(the second is steady), peak {x['peak_gib']:.2f} GiB, decoder layer bytes "
            f"{x['layer_bytes']} (one rank: {a['layer_bytes']}), exit 0 in "
            f"{res[tag][2]:.1f} s; launches {x['launches']} (the local-head rule: {want})")
    say("tp", f"{card}: (i) against [dist] (a), the largest relative gap of the losses "
        f"{rel[0]:.3e} (tol {DIST_TOL:g}) and of grad_norm {rel[1]:.3e} (tol "
        f"{DIST_NORM_TOL:g}); the artifact written once (rank 0); two ranks share one card "
        f"and stage every tp all-reduce through host memory beside (ii)'s two: no scaling "
        f"figure")

    # (ii): each tp rank's rewards against one rank's, every decision the same
    outs = [torch.load(os.path.join(tmp, f"tp_score.out.{r}"), weights_only=True)
            for r in range(2)]
    per = [_attention_launches(cfg2, 2, 2), _attention_launches(cfg2, 2, 8)]
    want = {**{k: per[0][k] + per[1][k] for k in per[0]}, **_norm_launches(cfg2, forwards=2)}
    for r, o in enumerate(outs):
        got = {k: v for k, v in o["launches"].items() if v}
        if got != {k: v for k, v in want.items() if v}:
            fail(f"tp: (ii) rank {r} launched {o['launches']}, expected {want} (local heads)")
        counts = {k: counts[k] + o["launches"].get(k, 0) for k in counts}
    for i, (name, pairs) in enumerate((("B=2", 1), ("B=8", 4))):
        rt = [o["rewards"]["auto"][i] for o in outs]
        if not torch.equal(rt[0], rt[1]):
            fail(f"tp: (ii) {name} the tp ranks' rewards differ: {rt}")
        gap = (rt[0] - one[i]).abs().max().item()
        say("tp", f"(ii) {name}: rewards on two tp ranks {rt[0].numpy().round(6).tolist()}, "
            f"one rank {one[i].numpy().round(6).tolist()}; max gap {gap:.3e} (tol "
            f"{REWARD_TOL:g})")
        if not bool(torch.isfinite(rt[0]).all()) or gap > REWARD_TOL:
            fail(f"tp: (ii) {name} rewards on tp 2 against one rank: gap {gap:.3e}")
        _same_decisions("tp", {"one rank": one[i], "tp 2": rt[0]}, pairs, rcfg)
    say("tp", f"(ii) each rank's launches over both requests {outs[0]['launches']} (the "
        f"local-head rule: {want}); exit 0 in {res['(ii) rank 0'][2]:.1f} s")
    counts = _tp_w8a8(cfg2, rcfg, tmp, res, one_w8, counts, card)
    counts = _tp_steps(tmp, counts)
    say("tp", f"phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def _w8a8_launches(dec, tp, forwards, fused):
    """The W8A8 launches and their shapes of ``forwards`` decoder forwards on
    a rank holding 1 / ``tp`` of each projection. ``fused`` (scoring, no
    LoRA): B4 into qkv and gate_up, B6's codes for o_proj and B5's for down;
    otherwise (LoRA) B6 on every projection's input, qkv and gate_up on the
    whole row. Under tp the row-split o / down take B6's (B5's) absmax and
    given-amax modes at K / tp."""
    L, H, I, q = dec.num_layers, dec.hidden_size, dec.intermediate_size, dec.q_size
    n = L * forwards
    counts, shapes = {"int8_matmul": 4 * n}, {}

    def add(d, key, v):
        d[key] = d.get(key, 0) + v

    for k, out, split_rows in ((H, q + 2 * dec.kv_size, False), (q, H, True), (H, 2 * I, False),
                               (I, H, True)):
        add(shapes, f"int8_matmul K{k // tp if split_rows else k} N"
                    f"{out if split_rows else out // tp}", n)
    if fused:
        add(counts, "rms_quant", 2 * n)
        rows = (("row", q), ("silu_mul", I))
    else:
        add(counts, "row_quant", 2 * n)
        add(shapes, f"row_quant {H}", 2 * n)
        rows = (("row", q), ("row", I))
    for stem, k in rows:
        modes = (f"{stem}_quant",) if tp == 1 else (f"{stem}_absmax", f"{stem}_quant_given")
        for m in modes:
            add(counts, m, n)
            add(shapes, f"{m} {k // tp}", n)
    return counts, shapes


def _tp_w8a8(cfg, rcfg, tmp, res, one_w8, counts, card):
    """(iv) the train CLI with --load_in_8bit on two tp ranks against one
    rank's --load_in_8bit run on the same rows (the loss under DIST_TOL,
    grad_norm under TP_W8A8_NORM_TOL: the W8A8 codes' flips); each
    rank holding half of the decoder's W8A8 code bytes, its B6 / GEMM
    launches counted and shaped by the rule (the row-split projections'
    codes on the tp-global amax: B6's absmax and given-amax modes at K / 2);
    (v) the W8A8 tree's B=2 rewards on two tp ranks against one rank's under
    phase 4's bound, every decision the same, with B4, B5 and B6 in their tp
    modes and the GEMM on each rank's blocks. Returns ``counts`` with the
    five processes' launches added."""
    dec = cfg.decoder
    s = {tag: {**_summary(tag, res[tag][1]), "shapes": json.loads(re.findall(
        r"^kernel shapes (\{.*\})$", res[tag][1], re.M)[0])}
        for tag in ("(iv) rank 0", "(iv) rank 1", "(iv) one rank")}
    t0, t1, one = s["(iv) rank 0"], s["(iv) rank 1"], s["(iv) one rank"]
    forwards = 2 * 2 + 2  # two steps (forward, remat recompute), two held-out sides
    for tag, x in s.items():
        tp = 2 if "one" not in tag else 1
        want = _cli_launches(cfg, tp, step_rows=8, steps=2, eval_rows=2)
        w8, shapes = _w8a8_launches(dec, tp, forwards, fused=False)
        want.update(w8)
        if x["launches"] != {k: want.get(k, 0) for k in x["launches"]} or x["shapes"] != shapes:
            fail(f"tp: (iv) {tag} launched {x['launches']} {x['shapes']}, expected {want} "
                 f"{shapes}")
        counts = {k: counts[k] + x["launches"].get(k, 0) for k in counts}
    if (t0["losses"], t0["grad_norms"]) != (t1["losses"], t1["grad_norms"]) or t0["steps"] != 2:
        fail(f"tp: (iv) the ranks disagree: {t0['losses']} {t0['grad_norms']} / "
             f"{t1['losses']} {t1['grad_norms']}")
    if not t0["rows"] == t1["rows"] == one["rows"]:
        fail(f"tp: (iv) rows {t0['rows']} / {t1['rows']}, one rank {one['rows']}")
    rel = [max(abs(x - y) / abs(y) for x, y in zip(t0[k], one[k])) for k in ("losses",
                                                                            "grad_norms")]
    H, I, q = dec.hidden_size, dec.intermediate_size, dec.q_size
    codes = dec.num_layers * (H * (q + 2 * dec.kv_size) + q * H + H * 2 * I + I * H)
    for tag, x in s.items():
        say("tp", f"(iv) {tag[5:]}: mesh {x['mesh']}, losses {x['losses']}, grad_norms "
            f"{x['grad_norms']}, s/step {x['step_times_s']}, peak {x['peak_gib']:.2f} GiB, "
            f"decoder W8A8 code bytes {x['code_bytes']} of {codes}, layer bytes "
            f"{x['layer_bytes']}; exit 0 in {res[tag][2]:.1f} s; W8A8 launches by shape "
            f"{x['shapes']}")
    say("tp", f"{card}: (iv) two tp ranks over the W8A8 decoder against one rank, the largest "
        f"relative gap of the losses {rel[0]:.3e} (tol {DIST_TOL:g}) and of grad_norm "
        f"{rel[1]:.3e} (tol {TP_W8A8_NORM_TOL:g}); two ranks share one card: no scaling figure")
    if rel[0] > DIST_TOL or rel[1] > TP_W8A8_NORM_TOL:
        fail(f"tp: (iv) against one rank {rel} (tol {DIST_TOL:g} loss, {TP_W8A8_NORM_TOL:g} "
             f"grad_norm)")
    if not (one["code_bytes"] == codes and t0["code_bytes"] == t1["code_bytes"] == codes // 2):
        fail(f"tp: (iv) W8A8 code bytes one rank {one['code_bytes']}, tp {t0['code_bytes']} / "
             f"{t1['code_bytes']} (the decoder's {codes})")

    outs = [torch.load(os.path.join(tmp, f"tp_score_w8a8.out.{r}"), weights_only=True)
            for r in range(2)]
    want = _attention_launches(cfg, 2, 2)
    w8, shapes = _w8a8_launches(dec, 2, 1, fused=True)
    want.update(w8, **_norm_launches(cfg, w8a8=True))
    for r, o in enumerate(outs):
        got = {k: v for k, v in o["launches"].items() if v}
        if got != {k: v for k, v in want.items() if v} or o["shapes"] != shapes:
            fail(f"tp: (v) rank {r} launched {o['launches']} {o['shapes']}, expected {want} "
                 f"{shapes}")
        counts = {k: counts[k] + o["launches"].get(k, 0) for k in counts}
    rt = [o["rewards"]["auto"][0] for o in outs]
    gap = (rt[0] - one_w8).abs().max().item()
    say("tp", f"(v) W8A8 B=2: rewards on two tp ranks {rt[0].numpy().round(6).tolist()}, one "
        f"rank {one_w8.numpy().round(6).tolist()}; max gap {gap:.3e} (tol {REWARD_TOL:g}); "
        f"each rank's launches {got}, by shape {outs[0]['shapes']}; exit 0 in "
        f"{res['(v) rank 0'][2]:.1f} s")
    if not torch.equal(rt[0], rt[1]) or not bool(torch.isfinite(rt[0]).all()) or \
            gap > REWARD_TOL:
        fail(f"tp: (v) W8A8 rewards on tp 2 {rt} against one rank {one_w8}: gap {gap:.3e}")
    _same_decisions("tp", {"one rank": one_w8, "tp 2": rt[0]}, 1, rcfg)
    return counts


def _cut_config(tmp, family):
    """A config.json directory of the published ``family`` cut to 2 decoder
    layers and 2 vision blocks (qwen: block 1 a full-attention block), every
    width kept. Returns (directory, the parsed config)."""
    d = os.path.join(tmp, f"tp_{family}_cfg")
    os.makedirs(d, exist_ok=True)
    if family == "qwen":
        cj = _manifest_config("qwen25_vl_7b_instruct", 2)
        cj["vision_config"].update(depth=2, fullatt_block_indexes=[1])
        parse = qwen_config_from_pretrain
    else:
        with open(os.path.join(LLAVA_MANIFEST, "config.json")) as f:
            cj = json.load(f)
        cj["text_config"]["num_hidden_layers"] = cj["vision_config"]["num_hidden_layers"] = 2
        parse = llava_config_from_pretrain
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cj, f)
    return d, parse(d)


def _tp_steps(tmp, counts):
    """(iii): Qwen2.5-VL-7B and LLaVA-NeXT-13B at full width, 2 decoder layers
    and 2 vision blocks, random bf16 weights: one bf16 LoRA step (heads and
    LoRA r=4 on QWEN_TARGETS, remat; one left-padded pair) in this process,
    and the same step by ``python -m llava_reward_torch.dryrun step`` on two
    tp ranks sharing the card over gloo. The loss against the one rank's
    under [dist]'s bound. grad_norm, of both bf16 runs, against the same
    step in fp32 through the reference attention (one rank) under [dist]'s
    bound: the two bf16 runs round apart by more than one another's reach
    (LLaVA on an H100 80GB HBM3 at 700 W: one rank 0.78 % under the fp32
    step, two tp ranks 1.36 % over it, 2.2e-02 apart), while a gradient not
    summed over tp moves grad_norm by tens of percent. The ranks exactly
    equal, each rank's launches by the local-head rule (qwen GQA 14/2 a
    rank, n_rep 7; LLaVA 20 of 40 heads, CLIP 8 of 16). Returns ``counts``
    with the four processes' launches added."""
    from llava_reward_torch import dryrun

    dev = torch.device("cuda")
    optim = dict(lr=2e-4, total_steps=10, max_norm=1.0)
    started, checks = {}, {}
    for family, seeds in (("qwen", (21, 22, 23)), ("llava", (24, 25, 26))):
        pretrain, cfg = _cut_config(tmp, family)
        rcfg = RewardConfig(is_general_preference=True, value_head_dim=2,
                            layer_id=cfg.text.num_layers)
        if family == "qwen":
            req = qwen_request(cfg, np.random.default_rng(seeds[0]), QWEN_GRIDS, {1: 40})
        else:
            tok = SmokeTok(cfg.text.vocab_size, cfg.text.image_token_id)
            req = _llava_requests(cfg, tok, LlavaNextProcessor(
                tok, image_token_id=cfg.text.image_token_id,
                grid_pinpoints=cfg.grid_pinpoints))[0]
        chosen, rejected = _halves(req, 1)
        frozen, trainable = dryrun._family_trees(family, cfg, rcfg, dev, torch.bfloat16, seeds)
        spec = os.path.join(tmp, f"tp_{family}_step.pt")
        torch.save({"family": family, "pretrain": pretrain, "rcfg": dataclasses.asdict(rcfg),
                    "mesh": {"mesh_tp": 2}, "optim": optim, "loss": {"remat": True},
                    "frozen": tree_map(lambda t: t.cpu(), frozen),
                    "trainable": tree_map(lambda t: t.cpu(), trainable),
                    **{k: {n: v.cpu() for n, v in b._asdict().items() if v is not None}
                       for k, b in (("chosen", chosen), ("rejected", rejected))}}, spec)
        one, f32 = (dryrun._one_step(
            create_mesh(1, 1, 1, world_size=1, rank=0), cfg, rcfg, tree, trainable, chosen,
            rejected, projector_path=PROJECTOR_PATHS[family], tx=make_optimizer(**optim),
            loss_kw={"remat": True, "attn_impl": impl})[1]
            for tree, impl in ((frozen, "auto"), (tree_map(lambda t: t.float(), frozen), "xla")))
        L = cfg.text.num_layers
        want = {"fa_hm": 2 * L, "fa_bwd": L}  # the decoder's forward, remat, backward
        if family == "qwen":  # B3's segment mode in each full vision block
            want["fa_hm"] += len(cfg.vision.fullatt_block_indexes)
        elif fa._direct_group(cfg.vision.num_heads // 2, cfg.vision.head_dim) is not None:
            want["fa_direct"] = cfg.vision.num_active_layers
        want.update({k: v for k, v in _step_norms(cfg).items() if v})  # the frozen projector
        checks[family] = (cfg, one, f32, want, spec)
        del frozen, trainable, req, chosen, rejected
        torch.cuda.empty_cache()
        port = _free_port()
        started.update({f"(iii) {family} rank {r}": _cli(
            tmp, f"tp (iii) {family} rank {r}", "llava_reward_torch.dryrun", "step", spec,
            spec + ".out", env=_dist_env(2, r, port)) for r in range(2)})
    res = _cli_results(started)
    for family, (cfg, one, f32, want, spec) in checks.items():
        outs = [torch.load(f"{spec}.out.{r}", weights_only=True) for r in range(2)]
        m = outs[0]["metrics"]
        if outs[1]["metrics"] != m:
            fail(f"tp: (iii) {family} the ranks disagree: {m} / {outs[1]['metrics']}")
        for r, o in enumerate(outs):
            got = {k: v for k, v in o["launches"].items() if v}
            if got != want:
                fail(f"tp: (iii) {family} rank {r} launched {got}, expected {want}")
            counts = {k: counts[k] + o["launches"].get(k, 0) for k in counts}
        rel = abs(m["preference_loss"] - one["preference_loss"]) / abs(one["preference_loss"])
        norm = [abs(x["grad_norm"] - f32["grad_norm"]) / f32["grad_norm"] for x in (m, one)]
        tc = cfg.text
        say("tp", f"(iii) {family} ({tc.num_layers} x {tc.hidden_size}, {tc.num_heads} / "
            f"{tc.num_kv_heads} heads, {tc.num_heads // 2} / {tc.num_kv_heads // 2} a rank; "
            f"vision {cfg.vision.hidden_size} wide): loss {m['preference_loss']:.6f} on two tp "
            f"ranks, {one['preference_loss']:.6f} on one (relative gap {rel:.3e}, tol "
            f"{DIST_TOL:g}); grad_norm {m['grad_norm']:.6f} on two tp ranks, "
            f"{one['grad_norm']:.6f} on one, {f32['grad_norm']:.6f} in fp32 through the "
            f"reference attention (relative gaps to it {norm[0]:.3e} / {norm[1]:.3e}, tol "
            f"{DIST_NORM_TOL:g}); each rank's launches {want} (the local-head rule); step "
            f"{outs[0]['step_s'][0]:.2f} s a rank, exit 0 in "
            f"{res[f'(iii) {family} rank 0'][2]:.1f} s")
        if rel > DIST_TOL or max(norm) > DIST_NORM_TOL:
            fail(f"tp: (iii) {family}: loss against one rank {rel:.3e}, grad_norm against fp32 "
                 f"{norm}")
    return counts


# ------------------------------------------------------------------ [llava]


LLAVA_SEQ = 2976  # bench.py:metric_llava_int8: 2928 image tokens and the prompt
LLAVA_MANIFEST = os.path.join("tools", "manifests", "llava_v16_vicuna_13b")
LLAVA_PAD = 32  # left pads of the rejected rows (2928 image tokens + 13 more fill 2941)


def _direct_smem_bytes(D, rope, bq=128, bk=64, stages=3):
    """B1's dynamic shared memory a block: ``Smem<D, ROPE>::bytes`` of
    csrc/flash_attention.cu (its BQ, BK and STAGES): the Q tile, a K and a V
    ring, with RoPE the K tiles' cos / sin rows, and the barriers."""
    return (bq * D * 2 + 2 * stages * bk * D * 2 + (stages * bk * 2 * D * 2 if rope else 0)
            + (2 + 4 * stages) * 8)


def _llava_requests(lcfg, tok, proc):
    """Four pairs of seeded 672 x 672 images (4 + 1 tiles, 2928 image tokens
    each) through LlavaNextProcessor at seq 2976: every chosen row fills the
    sequence, every rejected row is left-padded by LLAVA_PAD. Returns the
    B=2 request (the first pair) and the B=8 one (rows c0..c3, r0..r3), on
    the card, with the host seconds the eight samples took."""
    base = "a photo of a quiet harbour at dusk, which is better".split()
    n_fixed = len(proc(apply_llava_chat_template(tok, " ".join(base)),
                       [_synthetic(672, 672, 0)]).input_ids)
    if n_fixed + LLAVA_PAD > LLAVA_SEQ:
        fail(f"llava: a {n_fixed}-token sample leaves no room for {LLAVA_PAD} pads")
    t0 = time.perf_counter()
    chosen, rejected = [], []
    for j in range(4):
        words_c = base + [f"w{i}" for i in range(LLAVA_SEQ - n_fixed)]
        words_r = base + [f"w{i}" for i in range(LLAVA_SEQ - n_fixed - LLAVA_PAD)]
        chosen.append(proc(apply_llava_chat_template(tok, " ".join(words_c)),
                           [_synthetic(672, 672, 40 + 2 * j)]))
        rejected.append(proc(apply_llava_chat_template(tok, " ".join(words_r)),
                             [_synthetic(672, 672, 41 + 2 * j)]))
    host_s = time.perf_counter() - t0
    if {s.num_img_tokens for s in chosen + rejected} != {2928}:
        fail(f"llava: image tokens {[s.num_img_tokens for s in chosen + rejected]}")
    pad = lcfg.text.pad_token_id
    req2 = to_reward_batch(collate_samples([chosen[0], rejected[0]], LLAVA_SEQ, pad), "cuda")
    req8 = to_reward_batch(collate_samples(chosen + rejected, LLAVA_SEQ, pad), "cuda")
    return req2, req8, host_s


def _skew(r, pairs):
    """The GPM decision's c0 r1 - c1 r0 of each pair of rewards ``r``."""
    c, q = r[:pairs].double(), r[pairs:].double()
    return [float(f"{v:.5g}") for v in (c[:, 0] * q[:, 1] - c[:, 1] * q[:, 0]).tolist()]


def _principal_head(cfg, rcfg, params, reqs, lora=None, match_size=True):
    """A value head that reads the two directions along which the readout
    states of the requests ``reqs`` (what the value head reads, at each row's
    EOS: the final hidden state, after SkipCA where the head has it; bf16,
    the kernels' route; ``lora`` inline as training runs it) vary most: their
    top principal directions, as columns of norm 1/sqrt(H), in the head's
    dtype. A random head (std 1/(H+1)) reads a random plane, where the rows
    differ by about as much as two routes' drift through tens of layers of
    random weights, so their decisions would be the drift's: with this one
    each pair's c0 r1 - c1 r0 is a large part of |c| |r|. With
    ``match_size`` the columns are scaled so that the rows' rewards have the
    RMS of the head in ``params`` on the same states: the reward bounds the
    phases hold were set at that size, and no decision depends on the
    scale. Returns the head and the states' singular values."""
    seen = []
    apply = heads.apply_value_head
    heads.apply_value_head = lambda p, x: seen.append(x) or apply(p, x)
    try:
        with torch.inference_mode():
            for req in reqs:
                reward_forward(params, cfg, rcfg, req, lora=lora)
    finally:
        heads.apply_value_head = apply
    rows = []
    for x, req in zip(seen, reqs):
        idx = heads.eos_index_from_mask(req.attention_mask)
        rows.append(x[torch.arange(idx.shape[0], device=idx.device), idx].float())
    del seen
    x = torch.cat(rows)  # outside inference mode: the head may be a trainable leaf
    _, sv, vt = torch.linalg.svd(x - x.mean(0), full_matrices=False)
    w = vt[:2].T / x.shape[1] ** 0.5
    if match_size:
        old = params["head"]["value_head"]["kernel"].float()
        w = w * ((x @ old).pow(2).mean() / (x @ w).pow(2).mean()).sqrt()
    w = w.to(params["head"]["value_head"]["kernel"].dtype)
    return ({**params["head"], "value_head": {"kernel": w.contiguous()}},
            sv.cpu().numpy().round(3).tolist())


def _say_head(tag, what, spread, trainable=False):
    say(tag, f"value head{' (fp32, trainable)' if trainable else ''}: the two principal "
        f"directions of {what} readout states (after SkipCA), scaled to the random head's "
        f"reward RMS on the same states; their singular values about their mean {spread}")


def _same_decisions(tag, routes, pairs, rcfg):
    """Every pair's GPM decision the same on every route (name -> rewards of
    ``pairs`` chosen rows then as many rejected); prints c0 r1 - c1 r0."""
    decided = {n: (_prob(r, pairs, rcfg) > 0.5).cpu() for n, r in routes.items()}
    first = next(iter(decided.values()))
    same = all(bool(torch.equal(d, first)) for d in decided.values())
    say(tag, f"c0 r1 - c1 r0 per pair: " + "; ".join(f"{n} {_skew(r.float(), pairs)}"
                                                     for n, r in routes.items())
        + f"; every decision the same across {list(routes)}: {same}")
    if not same:
        fail(f"{tag}: a pair's decision differs between {list(routes)}")


def _llava_positions(mask):
    pos = torch.cumsum(mask.to(torch.int32), -1) - 1
    pos = torch.where(mask == 0, torch.ones_like(pos), pos)
    return pos[None].expand(3, *pos.shape)


@torch.inference_mode()
def _llava_layer_checks(lcfg, params, qparams, req):
    """Decoder layer 0 at full width from the B=2 request's embeddings, bf16
    (B1 at head_dim 128, RoPE, causal, the sequence padded 2976 -> 3072 with
    valid_len) and W8A8 (+ B4 x2, B5, B6, four GEMMs), through the kernels
    against the plain versions: the worst row's relative L2 error of the
    layer's update on valid tokens, beside the reference attention's."""
    tc = lcfg.text
    h = params["backbone"]["text"]["embed_tokens"][req.input_ids.long()]
    cos, sin = qwen25_vl._mrope_cos_sin(_llava_positions(req.attention_mask), tc, h.dtype)
    valid = req.attention_mask[..., None].to(h.dtype)
    for tag, tree, tol in (("bf16", params, QWEN_PART_TOL), ("W8A8", qparams,
                                                             QWEN_W8A8_PART_TOL)):
        lp = layer_slice(tree["backbone"]["text"]["layers"], 0)
        outs = {}
        for i in ("auto", "plain", "xla"):
            reset_counters()
            outs[i] = (qwen25_vl._decoder_layer(h, lp, tc, cos, sin, req.attention_mask, i)
                       - h) * valid
            if i == "auto":
                ran = {k: v for k, v in launches().items() if v}
        err, floor = (max(_rel_err(a, b) for a, b in zip(outs[i], outs["plain"]))
                      for i in ("auto", "xla"))
        finite = bool(torch.isfinite(outs["auto"]).all())
        say("llava", f"decoder layer 0 {tag} {tuple(h.shape)}, kernels vs plain versions: "
            f"relative L2 error {err:.3e} (tol {tol:g}); reference attention vs plain "
            f"{floor:.3e}; finite {finite}; launches {ran}")
        if err > tol or not finite or ran.get("fa_direct", 0) + ran.get("fa_hm", 0) != 1:
            fail(f"llava: decoder layer 0 {tag} through the kernels disagrees with the plain "
                 "versions")


def _llava_layer_grads(lcfg, frozen, trainable, req, gen, label="bf16"):
    """Decoder layer 0 on the separate layout with its LoRA slice (B3 forward,
    B8 backward, MHA 40 x 128 in left-pad mode), from one input and one
    upstream gradient (zero on left-pad rows, as on the path): the gradients
    of its input and LoRA leaves through the kernels against the plain
    versions, _qwen_layer_parity's bound, the reference attention beside."""
    tc = lcfg.text
    mask = req.attention_mask
    cos, sin = qwen25_vl._mrope_cos_sin(_llava_positions(mask), tc, torch.bfloat16)
    h = torch.randn(2, LLAVA_SEQ, tc.hidden_size, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    w = torch.randn(h.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    w = w * mask[:, :, None].to(w.dtype)
    lp = layer_slice(frozen["backbone"]["text"]["layers"], 0)
    grads = {}
    for impl in ("auto", "plain", "xla"):
        x = h.clone().requires_grad_()
        lora = tree_map(lambda t: t[0].detach().requires_grad_(), trainable["lora"])
        reset_counters()
        out = qwen25_vl._decoder_layer(x, lp, tc, cos, sin, mask, impl, lora)
        grads[impl] = torch.autograd.grad((out.float() * w.float()).sum(),
                                          [x] + tree_leaves(lora))
        if impl == "auto" and (fa.LAUNCHES["fa_hm"], fa.LAUNCHES["fa_bwd"]) != (1, 1):
            fail(f"llava: decoder layer launches {fa.LAUNCHES}")
    names = ["h"] + [n for n, _ in _named_leaves(trainable["lora"])]
    rels = {n: _rel_err(a, b) for n, a, b in zip(names, grads["auto"], grads["plain"])}
    floor = {n: _rel_err(a, b) for n, a, b in zip(names, grads["xla"], grads["plain"])}
    tensors = _tensor_leaves(rels)
    worst = max(tensors, key=tensors.get)
    say("llava", f"decoder layer 0 {label} {tuple(h.shape)}, LoRA on "
        f"{len(trainable['lora'])} targets, kernels vs plain versions: worst relative L2 "
        f"gradient error {rels[worst]:.3e} at {worst} (tol {LAYER_GRAD_TOL:g}, tensor leaves; "
        f"the scale leaves for information); "
        f"kernels (reference attention): "
        + ", ".join(f"{k} {v:.2e} ({floor[k]:.2e})" for k, v in rels.items()))
    _check_identity("llava", names, {"kernels": grads["auto"], "plain": grads["plain"],
                                     "reference": grads["xla"]}, dict(_named_leaves(lora)))
    if rels[worst] > LAYER_GRAD_TOL or not all(bool(torch.isfinite(g).all())
                                               for g in grads["auto"]):
        fail("llava: the decoder layer's gradients through the kernels disagree with the plain "
             "versions")


def phase_llava(reps=3, steps=3):
    """LLaVA-NeXT-13B at full width and depth (CLIP ViT-L/14-336 with 23
    active layers; vicuna 40 x 5120, 40 heads x 128 MHA, I = 13824), the
    configuration parsed from the published config.json, random bf16
    weights from a seed (the kernels at its decoder's shapes are held in
    phase 3: ``check_llava_kernels``). Scoring through
    RewardAdaptor(model_type="llava") on the fused layout, with a value head
    on the rows' principal directions (``_principal_head``), bf16 and with
    the decoder W8A8, B=2 (one side left-padded) and B=8, W8A8 against bf16;
    decoder layer 0 through the kernels against the plain versions; one
    layer's LoRA gradients; and LoRA steps at B=2 (r=128, alpha 256 on
    QWEN_TARGETS, fp32 heads and LoRA, remat)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    lcfg = LlavaNextConfig()
    parsed = llava_config_from_pretrain(LLAVA_MANIFEST)
    if (parsed.text, parsed.vision, parsed.grid_pinpoints) != (lcfg.text, lcfg.vision,
                                                               lcfg.grid_pinpoints):
        fail(f"llava: the published config.json parses to {parsed}, not {lcfg}")
    tc, vc = lcfg.text, lcfg.vision
    n_clip, n_dec = vc.num_active_layers, tc.num_layers
    gen = torch.Generator(device="cuda").manual_seed(11)

    # the model: the training layout, and the fused scoring layout beside it
    t0 = time.perf_counter()
    rcfg = RewardConfig(is_general_preference=True, value_head_dim=2, layer_id=n_dec)
    backbone = llava_next.init_params(lcfg, gen, torch.bfloat16, "cuda")
    head = init_head_params(lcfg, rcfg, gen, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(backbone))
    n_dec_params = sum(t.numel() for t in _leaves(backbone["text"]["layers"]))
    say("llava", f"LLaVA-NeXT-13B random bf16 params: {n_params / 1e9:.3f} B ({n_dec_params / 1e9:.3f} "
        f"B in the decoder layers) in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; config.json of {LLAVA_MANIFEST} parses "
        f"to the defaults (text {tc.num_layers} x {tc.hidden_size}, {tc.num_heads} x "
        f"{tc.head_dim} MHA, I={tc.intermediate_size}; CLIP {n_clip} active layers)")
    tok = SmokeTok(tc.vocab_size, tc.image_token_id)
    proc = LlavaNextProcessor(tok, image_token_id=tc.image_token_id,
                              grid_pinpoints=lcfg.grid_pinpoints)
    req2, req8, host_s = _llava_requests(lcfg, tok, proc)
    say("llava", f"requests: 8 samples of seeded 672 x 672 images through LlavaNextProcessor in "
        f"{host_s:.3f} s on the host; pixel_values {tuple(req8.pixel_values.shape)} f32, 2928 "
        f"image tokens a row, seq {LLAVA_SEQ}, left pads B=2 "
        f"{(1 - req2.attention_mask).sum(1).tolist()}, B=8 "
        f"{(1 - req8.attention_mask).sum(1).tolist()}")
    params = {"backbone": merge_for_scoring(backbone, "llava"), "head": head}
    params["head"], spread = _principal_head(lcfg, rcfg, params, [req8], match_size=False)
    say("llava", f"value head: the two principal directions of the B=8 request's readout "
        f"states (bf16, the kernels' route), columns of norm 1/sqrt({tc.hidden_size}); the "
        f"states' singular values about their mean {spread}")
    torch.cuda.synchronize()
    # per request: B1 in the 23 CLIP layers and the 40 decoder layers (B x 40
    # head groups >= 32 at B=2 already), no B2 / B3
    attn2, attn8 = _request_launches(lcfg, 2), _request_launches(lcfg, 8)
    # and the norm kernel at every norm (SkipCA is not wired for LLaVA)
    nrm = _norm_launches(lcfg, skipca=False)
    attn2, attn8 = {**attn2, **nrm}, {**attn8, **nrm}
    torch.cuda.reset_peak_memory_stats()
    bf16_launches, bf16_r, bf16_t = serve_and_check(
        "llava", lcfg, rcfg, params, req2, req8, attn2, attn8, reps, "llava", LLAVA_REWARD_TOL)
    say("llava", f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (bf16 serving; the "
        f"training layout held beside the fused one)")

    t0 = time.perf_counter()
    text = params["backbone"]["text"]
    qparams = {**params, "backbone": {**params["backbone"], "text": {
        **text, "layers": quantize_stacked_layers(text["layers"], scheme="w8a8")}}}
    torch.cuda.synchronize()
    quantized = [k for k, v in qparams["backbone"]["text"]["layers"].items()
                 if isinstance(v, dict) and isinstance(v.get("kernel"), dict)]
    say("llava-w8a8", f"decoder quantized in {time.perf_counter() - t0:.1f} s, one layer at a "
        f"time: {quantized}; {torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    w8 = {"rms_quant": 2 * n_dec, "silu_mul_quant": n_dec, "row_quant": n_dec,
          "int8_matmul": 4 * n_dec, **_norm_launches(lcfg, w8a8=True, skipca=False)}
    torch.cuda.reset_peak_memory_stats()
    w8_launches, w8_r, w8_t = serve_and_check(
        "llava-w8a8", lcfg, rcfg, qparams, req2, req8, {**attn2, **w8}, {**attn8, **w8}, reps,
        "llava", QWEN_W8A8_REWARD_TOL)
    say("llava-w8a8", f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # W8A8 against bf16, through the kernels: every pair's decision, and the
    # rewards within LLAVA_W8A8_VS_BF16_TOL
    for name, rb, rq, pairs in (("B=2", bf16_r[0], w8_r[0], 1), ("B=8", bf16_r[1], w8_r[1], 4)):
        rb, rq = rb.float(), rq.float()
        same = bool(((_prob(rb, pairs, rcfg) > 0.5) == (_prob(rq, pairs, rcfg) > 0.5)).all())
        gap = (rb - rq).abs().max().item()
        say("llava-w8a8", f"{name}: W8A8 rewards {rq.cpu().numpy().round(6).tolist()} against "
            f"bf16 {rb.cpu().numpy().round(6).tolist()}: max gap {gap:.3e} (tol "
            f"{LLAVA_W8A8_VS_BF16_TOL:g}, |bf16 reward| up to {rb.abs().max().item():.3e}); "
            f"c0 r1 - c1 r0 per pair W8A8 {_skew(rq, pairs)} bf16 {_skew(rb, pairs)}; same "
            f"decisions {same}; {w8_t[name]:.4f} s/request beside bf16 {bf16_t[name]:.4f}")
        if not same or gap > LLAVA_W8A8_VS_BF16_TOL:
            fail(f"llava: W8A8 and bf16 {name} rewards or decisions differ")
    _llava_layer_checks(lcfg, params, qparams, req2)
    del params, qparams, text
    torch.cuda.empty_cache()

    # LoRA on the training layout
    frozen = {"backbone": backbone}
    trainable = {"head": init_head_params(lcfg, rcfg, gen, torch.float32, "cuda"),
                 "lora": init_lora(tc, LORA_R, LORA_ALPHA, gen, targets=QWEN_TARGETS,
                                   device="cuda")}
    for t in trainable["lora"].values():
        t["b"].normal_(0.0, 1e-3, generator=gen)
    n_lora = sum(t.numel() for t in tree_leaves(trainable["lora"]))
    _llava_layer_grads(lcfg, frozen, trainable, req2, gen)
    chosen, rejected = _halves(req2, 1)
    tx = make_optimizer(LR, TOTAL_STEPS)
    step = make_train_step(make_pairwise_loss_fn(lcfg, rcfg, attn_impl="auto", remat=True,
                                                 projector_path=PROJECTOR_PATHS["llava"]), tx)
    state = init_train_state(trainable, tx)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()  # the training path's run starts here
    state, losses, norms, times = _timed_steps(step, state, frozen, chosen, rejected, steps)
    counts = launches()  # ... and ends here
    # per step: B1 in CLIP (frozen: no backward, no recompute); B3 forward and
    # its remat recompute and B8 in each decoder layer
    _expect(f"llava {steps} LoRA steps B=2", counts,
            {"fa_direct": steps * n_clip, "fa_hm": steps * 2 * n_dec, "fa_bwd": steps * n_dec,
             **_step_norms(lcfg, steps)})
    med = float(np.median(times[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    say("llava", f"LoRA r={LORA_R} alpha {LORA_ALPHA} on {list(QWEN_TARGETS)} ({n_lora / 1e6:.1f} "
        f"M params, fp32, fp32 heads), remat, B=2 seq {LLAVA_SEQ}: loss per step "
        f"{[round(x, 6) for x in losses]}, grad_norm {[round(x, 4) for x in norms]}; "
        f"{med:.4f} s/step (median after one warm step, {[round(t, 4) for t in times]}), "
        f"{1 / med:.3f} pairs/s; peak {peak:.2f} GiB; "
        f"launches {counts}: fa_hm and fa_bwd at (2, {tc.num_heads}, {LLAVA_SEQ}, "
        f"{tc.head_dim}), fa_direct at CLIP's ({chosen.pixel_values.shape[1] * 2}, "
        f"{vc.num_heads}, 640, {vc.head_dim})")
    # the same LoRA over the decoder in W8A8 (--load_in_8bit): the bf16
    # layers leave the card once quantized
    del state
    torch.cuda.empty_cache()
    got = _quant_lora_steps(
        "llava", "W8A8", frozen, "text", trainable,
        lambda impl: make_pairwise_loss_fn(lcfg, rcfg, attn_impl=impl, remat=True,
                                           projector_path=PROJECTOR_PATHS["llava"]),
        chosen, rejected, {"fa_direct": n_clip, "fa_hm": 2 * n_dec, "fa_bwd": n_dec,
                           **_step_norms(lcfg)}, 7, n_dec,
        lambda qf: _llava_layer_grads(lcfg, qf, trainable, req2, gen, "W8A8"),
        {"loss": losses, "s": med, "peak": peak}, release=True)
    counts = {k: counts[k] + got[k] for k in counts}
    del frozen, trainable, backbone
    torch.cuda.empty_cache()
    say("llava", f"phase {time.perf_counter() - t_phase:.1f} s")
    return {k: bf16_launches[k] + w8_launches[k] + counts[k] for k in counts}


# ------------------------------------------------------------------ main


def main() -> int:
    phase_device()
    phase_build()
    cfg = phi35_vision_config()
    rcfg = RewardConfig(is_general_preference=True, value_head_dim=2,
                        add_cross_attention=True, layer_id=cfg.decoder.num_layers)
    qcfg = qwen25_vl_7b_config()
    rows = phase_kernels(cfg, qcfg)
    entry = phase_entry()
    # launches: summed over the main paths' runs, each counted from zero: the
    # single-chip compile check's call; the serving runs (phi3v bf16, decoder
    # W8A8, tower + decoder W8A8; the sample pairs from their image files in
    # three pixel modes and the host-bank fallback; the HTTP server's
    # requests; the loaded checkpoints, bf16 and W8A8, and qwen's; batch
    # evaluation; qwen bf16 and W8A8; LLaVA-NeXT bf16 and W8A8) and the
    # training runs (phi3v's five LoRA steps; qwen's three
    # LoRA steps and its full fine-tuning step; LLaVA-NeXT's LoRA steps; the
    # [dist] train CLI processes' own, as each prints them; [tp]'s thirteen
    # processes' own, B5 / B6's tp modes among them)
    served, params = phase_serve(cfg, rcfg)
    data, data_batch, data_rewards = phase_data(cfg, rcfg, params)
    http = phase_http(cfg, rcfg, params)
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_load_", dir="build") as tmp:
        loaded, phi3v_dirs = phase_load(cfg, rcfg, params, qcfg, data_batch, tmp)
        evaled = phase_eval(cfg, rcfg, params, data_rewards, phi3v_dirs, tmp)
        dist, dist_a = phase_dist(cfg, tmp)
        tp = phase_tp(cfg, rcfg, tmp, dist_a, phi3v_dirs)
    del params, data_batch
    torch.cuda.empty_cache()
    runs = [entry, served, data, http, loaded, evaled, dist, tp, phase_serve_qwen(qcfg),
            phase_train(cfg, rcfg), phase_train_qwen(qcfg)]
    runs.append(phase_llava())
    counts = {k: sum(r[k] for r in runs) for k in runs[0]}
    say("norm", "the norm kernel's launches over the main paths' runs: "
        f"{ {k: counts[k] for k in NORM_KERNELS} }")

    kernels = []
    for name, meta in KERNELS.items():
        # one row per kernel: its last check before LLaVA's (B1 and B8 at the
        # phi3v decoder's shapes, which dominate their time on the path; B2,
        # B4-B7 at the qwen decoder's, the GEMM at gate_up; B3 in its segment
        # mode at the qwen vision tower's; B9 at the CLIP tower's B=8 shape)
        row = [r for r in rows if r["name"] == name][-1]
        kernels.append({"name": name, **meta, "launches": counts[name],
                        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
