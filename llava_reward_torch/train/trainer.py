"""Trainer: epochs over a loader of (chosen, rejected, c_rate, r_rate)
batches, the training step, EMA loss, log / save cadence, per-epoch artifact
export, evaluation, checkpoint rotation and resume, on one device
(``llava_reward_tpu/train/trainer.py:37-528``).

As in the JAX package: evaluation works (the reference's crashes), resume
really resumes (skipping the batches the saved state already consumed), and
the margin is ``c_rate - r_rate`` under ``margin_loss``. The train-state
checkpoint is ``torch.save`` of ``{step, trainable, opt_state}`` (the JAX
package's orbax layout is its own, not the contract). ``wandb_logger``, when
given, receives the train and eval logs (``trainer.py:190-210,299-303``).

Under a ``mesh`` (``parallel/sharding.py``) every data rank steps on its
own rows (its tp peers on the same rows, the backbone split between them);
evaluation all-gathers the probabilities (or rewards and labels) over the
data ranks before the metrics, the samplers' padding duplicates included,
as in the JAX package; saving gathers the sharded leaves on every rank and rank 0
alone writes, then all ranks meet at a barrier. The train-state checkpoint
is the gathered whole state, so it resumes under any mesh, one process
included. Logs and wandb are rank 0's.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Callable, Dict, List, Optional

import torch

from ..core.config import RewardConfig
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..core.logging import init_logger
from ..core.mesh import is_rank_0
from ..evalx.metrics import pairwise_metrics, pointwise_metrics
from ..io.artifact import save_reward_artifact
from ..io.hf_phi3v import hf_state_dict_from_params
from ..io.torch_io import save_torch_state_dict
from ..lora.lora import (DEFAULT_TARGETS, QWEN_TARGETS, peft_adapter_config,
                         stacked_to_peft_state, vision_stacked_to_peft_state)
from ..parallel.collectives import all_gather_list, barrier
from ..parallel.sharding import DATA, gather_tree, reshard_like
from ..parallel.tensor import tensor_parallel
from ..preprocess.collate import to_reward_batch
from ..reward.model import reward_forward
from ..reward.preference import preference_prob
from .optim import tree_map
from .train_step import (PROJECTOR_PATHS, TrainState, assemble_params, init_train_state,
                         make_train_step)

logger = init_logger(__name__)


class RewardTrainer:
    def __init__(
        self,
        *,
        cfg,  # Phi3VConfig, Qwen25VLConfig ("qwen") or LlavaNextConfig ("llava")
        rcfg: RewardConfig,
        frozen: dict,
        trainable: dict,
        tx,
        loss_fn: Callable,
        train_loader,
        eval_loader=None,
        cls_based: bool = False,
        margin_loss: bool = False,
        max_epochs: int = 1,
        save_path: str = "./ckpt",
        save_steps: int = -1,
        eval_steps: int = -1,
        logging_steps: int = 1,
        max_ckpt_num: int = 3,
        lora_rank: int = 0,
        lora_alpha: float = 0.0,
        lora_dropout: float = 0.05,
        save_best_model: bool = False,
        model_type: str = "phi3v",
        lora_targets: Optional[tuple] = None,
        ckpt_path: Optional[str] = None,
        ckpt_steps: int = -1,
        wandb_logger=None,
        device=DEFAULT_DEVICE,
        mesh=None,
    ):
        self.cfg, self.rcfg = cfg, rcfg
        self.device = resolve_device(device)
        self.frozen = frozen
        self.tx = tx
        self.state = init_train_state(trainable, tx)
        self.train_step = make_train_step(loss_fn, tx, mesh)
        # mesh: the trees are sharded over it and each rank's batches are its
        # own rows (no global batch to cut, unlike the JAX trainer's
        # shard_batch_fn)
        self.data_group = (mesh.group(DATA) if mesh is not None and mesh.ways(DATA) > 1
                           else None)
        self.tp = tensor_parallel(mesh, cfg)
        self.train_loader, self.eval_loader = train_loader, eval_loader
        self.cls_based, self.margin_loss = cls_based, margin_loss
        self.max_epochs = max_epochs
        self.save_path, self.save_steps = save_path, save_steps
        self.eval_steps, self.logging_steps = eval_steps, logging_steps
        self.max_ckpt_num = max_ckpt_num
        self.lora_rank, self.lora_alpha, self.lora_dropout = lora_rank, lora_alpha, lora_dropout
        # --save_best_model tracks eval accuracy and keeps <save_path>/best
        self.save_best_model = save_best_model
        self.best_eval_acc = float("-inf")
        if model_type not in PROJECTOR_PATHS:
            raise NotImplementedError(
                f"model_type {model_type!r}: the families are {sorted(PROJECTOR_PATHS)}")
        self.model_type = model_type
        # the trained target list rides into adapter_config.json, so a qwen
        # or llava run never advertises phi3's fused targets (``trainer.py:102-105``)
        self.lora_targets = lora_targets or (
            DEFAULT_TARGETS if model_type == "phi3v" else QWEN_TARGETS)
        self.wandb = wandb_logger
        self.ckpt_path, self.ckpt_steps = ckpt_path, ckpt_steps
        self.last_train_logs: Dict[str, float] = {}
        self.train_logs: List[Dict[str, float]] = []  # every logged step's
        if save_best_model and eval_loader is None and eval_steps == -1:
            logger.warning("--save_best_model is inert: no eval loader and eval_steps=-1 "
                           "means evaluate() never runs, so <save_path>/best never fires")

    # ------------------------------------------------------------ fit

    def _step_args(self, batch):
        if self.cls_based:
            b, labels = batch
            return (to_reward_batch(b, self.device), torch.as_tensor(labels).to(self.device))
        chosen, rejected, c_rate, r_rate = batch
        margin = None
        if self.margin_loss:
            margin = torch.as_tensor(c_rate - r_rate, dtype=torch.float32).to(self.device)
        return (to_reward_batch(chosen, self.device), to_reward_batch(rejected, self.device),
                margin)

    def fit(self) -> TrainState:
        eval_steps = self.eval_steps
        if eval_steps == -1 and self.eval_loader is not None:
            eval_steps = len(self.train_loader)  # once per epoch
        save_steps = self.save_steps if self.save_steps != -1 else float("inf")

        global_step = 1
        loss_mean = 0.0
        # resume: state.step counts the steps already applied; skipping that
        # many batches replays the same data order (deterministic samplers)
        skip = int(self.state.step)
        for epoch in range(self.max_epochs):
            sampler = getattr(self.train_loader, "sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            t_step = time.perf_counter()
            for batch in self.train_loader:
                if skip > 0:
                    skip -= 1
                    global_step += 1
                    continue
                self.state, metrics = self.train_step(self.state, self.frozen,
                                                      *self._step_args(batch))
                loss = float(metrics["preference_loss"])
                loss_mean = loss_mean * 0.9 + 0.1 * loss  # EMA

                if global_step % self.logging_steps == 0:
                    dt = time.perf_counter() - t_step
                    t_step = time.perf_counter()
                    logs = {
                        "preference_loss": loss,
                        "prob": float(metrics["prob"]),
                        "loss_mean": loss_mean,
                        "grad_norm": float(metrics["grad_norm"]),
                        "step_time_s": dt / self.logging_steps,
                    }
                    self.last_train_logs = dict(logs, global_step=global_step)
                    self.train_logs.append(self.last_train_logs)
                    if is_rank_0():
                        logger.info("epoch %d step %d %s", epoch, global_step,
                                    " ".join(f"{k}={v:.4f}" for k, v in logs.items()))
                    if self.wandb is not None:
                        self.wandb.log({f"train/{k}": v for k, v in logs.items()}
                                       | {"train/global_step": global_step})
                if eval_steps and eval_steps > 0 and global_step % eval_steps == 0:
                    self.evaluate(global_step)
                if global_step % save_steps == 0:
                    self.save_artifact(os.path.join(self.save_path, f"global_step{global_step}"))
                    self.clean_old_checkpoints()
                if (self.ckpt_path is not None and self.ckpt_steps > 0
                        and global_step % self.ckpt_steps == 0):
                    self.save_train_ckpt(self.ckpt_path)
                global_step += 1
            self.save_artifact(os.path.join(self.save_path, f"epoch_{epoch}"))
        if self.wandb is not None:
            self.wandb.finish()
        return self.state

    # ------------------------------------------------------------ eval

    def _score(self, params, lora, vision_lora, batch) -> torch.Tensor:
        return reward_forward(params, self.cfg, self.rcfg, to_reward_batch(batch, self.device),
                              training=False, lora=lora, vision_lora=vision_lora,
                              data_group=self.data_group, tp=self.tp).reward

    @torch.no_grad()
    def evaluate(self, global_step: int = 0) -> Dict[str, float]:
        if self.eval_loader is None:
            return {}
        params, lora, vision_lora = assemble_params(
            self.frozen, self.state.trainable, PROJECTOR_PATHS[self.model_type])
        rcfg = self.rcfg
        if self.cls_based:
            rewards, labels = [], []
            for b, y in self.eval_loader:
                # the first reward dimension, as the cls loss and the batch
                # scorer read it (the JAX trainer flattens a GPM head's
                # (B, 2) rewards against B labels: ROADMAP §C)
                r = self._score(params, lora, vision_lora, b)[..., 0]
                rewards.extend(r.float().cpu().tolist())
                labels.extend(torch.as_tensor(y).reshape(-1).tolist())
            if self.data_group is not None:
                rewards = all_gather_list(rewards, self.data_group)
                labels = all_gather_list(labels, self.data_group)
            pm = pointwise_metrics(rewards, labels)
            metrics = {"eval_acc": pm["accuracy"], "eval_f1": pm["f1"],
                       "eval_recall": pm["recall"], "eval_num_samples": pm["num_samples"]}
            return self._finish_eval(global_step, metrics, pm["accuracy"])
        probs = []
        for chosen, rejected, _, _ in self.eval_loader:
            c = self._score(params, lora, vision_lora, chosen)
            r = self._score(params, lora, vision_lora, rejected)
            p = preference_prob(c, r, is_general_preference=rcfg.is_general_preference,
                                value_head_dim=rcfg.value_head_dim,
                                tau=rcfg.general_preference_tau)
            probs.extend(p.float().cpu().tolist())
        if self.data_group is not None:
            probs = all_gather_list(probs, self.data_group)
        pm = pairwise_metrics(probs)
        metrics = {"eval_acc": pm["accuracy"], "eval_acc_wo_tie": pm["accuracy_wo_tie"],
                   "eval_mean_prob": pm["mean_prob"], "eval_num_pairs": pm["num_pairs"]}
        return self._finish_eval(global_step, metrics, pm["accuracy"])

    def _finish_eval(self, global_step, metrics, acc):
        if is_rank_0():
            logger.info("eval step %d %s", global_step, metrics)
        if self.save_best_model and acc > self.best_eval_acc:
            self.best_eval_acc = acc
            self.save_artifact(os.path.join(self.save_path, "best"))
            logger.info("new best eval_acc=%.4f -> saved %s/best", acc, self.save_path)
        if self.wandb is not None:
            self.wandb.log({f"eval/{k}": v for k, v in metrics.items()}
                           | {"eval/global_step": global_step})
        return metrics

    # ------------------------------------------------------------ saving

    def save_artifact(self, path: str) -> None:
        """pytorch_model.bin (heads + projector) + lora/ + reward_config.yaml
        (``trainer.py:331-451``); under full fine-tuning also the whole
        phi3v backbone as an HF-layout checkpoint in ``full_model/`` (a qwen or
        llava backbone is not exported, as in the JAX package). Every rank
        gathers the sharded leaves; rank 0 writes; all meet at a barrier."""
        trainable = gather_tree(self.state.trainable)
        lm_head = None
        if trainable.get("backbone") is not None:
            lm_head = gather_tree(self.frozen.get("backbone", {}).get("lm_head"))
        if not is_rank_0():
            barrier()
            return
        lora_state = lora_config = None
        if trainable.get("lora") is not None and self.lora_rank > 0:
            dec_cfg = self.cfg.decoder if self.model_type == "phi3v" else self.cfg.text
            lora_state = stacked_to_peft_state(trainable["lora"], dec_cfg)
            lora_config = peft_adapter_config(self.lora_rank, self.lora_alpha, self.lora_dropout,
                                              targets=tuple(self.lora_targets))
        if trainable.get("vision_lora") is not None:
            # the CLIP adapters ride in the same PEFT file
            if lora_state is None:
                lora_state = {}
                lora_config = peft_adapter_config(self.lora_rank, self.lora_alpha,
                                                  self.lora_dropout, targets=())
            lora_state.update(vision_stacked_to_peft_state(trainable["vision_lora"],
                                                           self.cfg.vision))
            lora_config["target_modules"] = list(lora_config.get("target_modules", [])) + [
                "q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"]
        save_reward_artifact(path, self.rcfg, trainable["head"],
                             projector_params=trainable.get("projector"),
                             lora_state=lora_state, lora_config=lora_config,
                             model_type=self.model_type)
        if trainable.get("backbone") is not None:
            if self.model_type == "phi3v":
                self._save_full_model(os.path.join(path, "full_model"), trainable["backbone"],
                                      lm_head)
            else:
                logger.warning("full-FT export only implemented for phi3v; backbone not saved")
        logger.info("saved reward artifact to %s", path)
        barrier()

    def _save_full_model(self, path: str, backbone: dict, lm_head) -> None:
        """The fine-tuned backbone (and the frozen lm_head, if any) as an
        HF-layout bf16 ``pytorch_model.bin`` with its ``config.json``, so the
        full-checkpoint loaders read it (save_model, deepspeed.py:277-332)."""
        sd = hf_state_dict_from_params(backbone, self.cfg)
        if lm_head is not None:
            sd["lm_head.weight"] = lm_head.detach().cpu().T.contiguous()
        save_torch_state_dict(sd, os.path.join(path, "pytorch_model.bin"), torch.bfloat16)
        dc = self.cfg.decoder
        cfg_json = {
            "model_type": "phi3_v",
            "vocab_size": dc.vocab_size,
            "hidden_size": dc.hidden_size,
            "intermediate_size": dc.intermediate_size,
            "num_hidden_layers": dc.num_layers,
            "num_attention_heads": dc.num_heads,
            "num_key_value_heads": dc.num_kv_heads,
            "rms_norm_eps": dc.rms_norm_eps,
            "rope_theta": dc.rope_theta,
            "max_position_embeddings": dc.max_position_embeddings,
            "original_max_position_embeddings": dc.original_max_position_embeddings,
            "sliding_window": dc.sliding_window,
            "pad_token_id": dc.pad_token_id,
            "eos_token_id": dc.eos_token_id,
        }
        if dc.rope_scaling is not None:
            cfg_json["rope_scaling"] = {
                "type": dc.rope_scaling.rope_type,
                "short_factor": list(dc.rope_scaling.short_factor),
                "long_factor": list(dc.rope_scaling.long_factor),
            }
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(cfg_json, f, indent=2)
        logger.info("saved full fine-tuned backbone to %s", path)

    def clean_old_checkpoints(self) -> None:
        """Keep the newest ``max_ckpt_num`` global_step dirs
        (``trainer.py:453-475``; the size budget no caller sets is left out),
        on rank 0."""
        if not is_rank_0() or not os.path.isdir(self.save_path):
            return
        dirs = [d for d in os.listdir(self.save_path) if d.startswith("global_step")]
        dirs.sort(key=lambda d: os.path.getmtime(os.path.join(self.save_path, d)))
        for victim in dirs[: max(len(dirs) - self.max_ckpt_num, 0)]:
            shutil.rmtree(os.path.join(self.save_path, victim), ignore_errors=True)
            logger.info("removed old checkpoint %s", victim)

    # ------------------------------------------------------------ resume

    def save_train_ckpt(self, path: str) -> None:
        """The train state, ``torch.save`` of {step, trainable, opt_state},
        whole: every rank gathers its sharded leaves, rank 0 writes."""
        state = gather_tree({"step": self.state.step,
                             "trainable": tree_map(lambda t: t.detach(), self.state.trainable),
                             "opt_state": self.state.opt_state})
        if is_rank_0():
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, "train_state.pt.tmp")
            torch.save(state, tmp)
            os.replace(tmp, os.path.join(path, "train_state.pt"))
        barrier()

    def load_train_ckpt(self, path: str) -> None:
        """Read the whole state and shard it as this trainer's state is
        sharded (orbax's restore onto the target's sharding, ``trainer.py:
        505-528``): a checkpoint from any mesh resumes under any other."""
        state = reshard_like(
            torch.load(os.path.join(path, "train_state.pt"), map_location=self.device,
                       weights_only=True),
            {"step": self.state.step, "trainable": self.state.trainable,
             "opt_state": self.state.opt_state})
        self.state = TrainState(state["step"], state["trainable"], state["opt_state"])
        if is_rank_0():
            logger.info("resumed train state from %s (step %s)", path, state["step"])
