"""The training step (``llava_reward_tpu/train/train_step.py``).

One stacked forward scores the pair (``reward/model.py:paired_forward``),
the loss is taken on it, and autograd differentiates with respect to the
TRAINABLE tree only (LoRA + heads [+ projector], or the whole backbone in
full fine-tuning), so the frozen backbone has no gradient and no optimizer
state. Loss selection follows the reference trainer's tree:
GPM dim 2 -> gpm; GPM dim 1 -> cls; GPM high-dim + prompt head -> moe;
GPM high-dim -> high_dim_gpm; cls_based -> binary_cls; else bt.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..core.config import RewardConfig
from ..models.phi3 import logits as lm_logits
from ..parallel.collectives import all_reduce
from ..parallel.sharding import AXES, DATA, Sharded, gather_unstacked
from ..parallel.tensor import tensor_parallel
from ..reward import losses
from ..reward.heads import eos_index_from_mask, prompt_skew_block_matrices
from ..reward.model import RewardBatch, paired_forward, reward_forward
from .optim import global_norm, tree_leaves, tree_map


class TrainState(NamedTuple):
    step: int
    trainable: Any  # {'head': ..., 'lora': ...|None, 'vision_lora': ..., 'projector': ...}
    opt_state: Any


def select_loss_name(rcfg: RewardConfig, cls_based: bool, add_img_eos: bool = False) -> str:
    """``train_step.py:38-56``; ``add_img_eos`` forces the dim-2 GPM product
    even for high-dim heads."""
    if rcfg.is_general_preference:
        if rcfg.value_head_dim == 2 and not rcfg.add_prompt_head and not add_img_eos:
            return "gpm"
        if rcfg.value_head_dim == 1:
            return "cls"
        if rcfg.value_head_dim % 2:
            raise ValueError("GPM value head dim must be even")
        if rcfg.add_prompt_head:
            return "moe"
        if add_img_eos:
            return "gpm"
        return "high_dim_gpm"
    if cls_based:
        return "binary_cls"
    return "bt"


# where each family's forward reads the projector from the backbone tree
# (``train_step.py:59-66``)
PROJECTOR_PATHS = {
    "phi3v": ("vision", "img_projection"),
    "qwen": ("visual", "merger"),  # ln_q, fc1, fc2
    "llava": ("vision", "projector"),  # multi_modal_projector.linear_{1,2}
}


def assemble_params(frozen: dict, trainable: dict,
                    projector_path: Tuple[str, ...] = PROJECTOR_PATHS["phi3v"]):
    """Merge the trainable leaves back into a full forward tree
    (``train_step.py:69-94``). Returns (params, lora, vision_lora). Full
    fine-tuning keeps the whole backbone under ``trainable['backbone']``.
    Sharded leaves outside the stacked layers are gathered here, under
    autograd, once a forward; the models gather stacked ones a layer at a
    time."""
    backbone = trainable.get("backbone") or frozen["backbone"]
    if trainable.get("projector") is not None:
        backbone = dict(backbone)
        node = backbone
        for key in projector_path[:-1]:
            node[key] = dict(node[key])
            node = node[key]
        node[projector_path[-1]] = trainable["projector"]
    params = gather_unstacked({"backbone": backbone, "head": trainable["head"]})
    return params, trainable.get("lora"), trainable.get("vision_lora")


def make_pairwise_loss_fn(
    cfg,  # Phi3VConfig or Qwen25VLConfig
    rcfg: RewardConfig,
    *,
    cls_based: bool = False,
    compute_fp32_loss: bool = False,
    attn_impl: str = "auto",
    remat: bool = True,
    add_pretrain_loss: bool = False,
    ptx_loss_coef: float = 0.1,
    reward_scaler_beta: float = 2.0,
    add_img_eos: bool = False,
    projector_path: Tuple[str, ...] = PROJECTOR_PATHS["phi3v"],
    mesh=None,
) -> Callable:
    """``train_step.py:97-188``. For Qwen2.5-VL pass
    ``projector_path=PROJECTOR_PATHS["qwen"]`` (the merger is the trainable
    projector) and qwen ``RewardBatch``es. ``add_pretrain_loss`` mixes the SFTSum ptx
    regulariser over the chosen sequence's LM logits: loss = (1 - coef) *
    preference + coef * ptx; the frozen backbone tree must hold 'lm_head'.
    Under a ``mesh`` the batches are this rank's rows and the loss is their
    mean, as every loss here (the ptx term too: a mean over rows of each
    row's token sum) is a mean over rows; ``make_train_step`` averages it
    over the data ranks. A mesh with a tp axis runs the backbone split over
    it (``parallel/tensor.py``), and refuses a tp that does not divide
    ``cfg``'s heads and MLP widths."""
    loss_name = select_loss_name(rcfg, cls_based, add_img_eos)
    tau = rcfg.general_preference_tau
    data_group = _data_group(mesh)
    tp = tensor_parallel(mesh, cfg)

    def loss_fn(trainable: dict, frozen: dict, chosen: RewardBatch, rejected: RewardBatch,
                margin: Optional[torch.Tensor] = None):
        params, lora, vision_lora = assemble_params(frozen, trainable, projector_path)
        prompt_end = None
        if loss_name == "moe":
            # the prompt-conditioned R reads the hidden state at the EOS
            # position, which for reward inputs is the prompt end
            prompt_end = eos_index_from_mask(chosen.attention_mask)
        c_r, r_r, prompt_hidden, chosen_last_hidden = paired_forward(
            params, cfg, rcfg, chosen, rejected, training=True, attn_impl=attn_impl,
            remat=remat, lora=lora, vision_lora=vision_lora, prompt_end_index=prompt_end,
            data_group=data_group, tp=tp,
        )
        if compute_fp32_loss:
            c_r, r_r = c_r.float(), r_r.float()

        if loss_name == "gpm":
            loss, prob = losses.general_preference_loss(c_r, r_r, margin, tau=tau)
        elif loss_name == "cls":
            loss, prob = losses.cls_loss(c_r, r_r, margin)
        elif loss_name == "high_dim_gpm":
            loss, prob = losses.high_dim_general_preference_loss(
                c_r, r_r, margin, tau=tau, value_head_dim=rcfg.value_head_dim)
        elif loss_name == "moe":
            R = prompt_skew_block_matrices(trainable["head"]["prompt_head"],
                                           prompt_hidden.float(), rcfg.value_head_dim)
            loss, prob = losses.high_dim_general_preference_moe_loss(
                c_r, r_r, R, margin, softmax_tau=tau)
        else:  # bt
            loss, prob = losses.pairwise_loss(c_r, r_r, margin, tau=tau)

        metrics = {"preference_loss": loss, "prob": prob}
        if add_pretrain_loss:
            lm_head = params["backbone"].get("lm_head")
            if lm_head is None:
                raise ValueError("--add_pretrain_loss needs lm_head weights")
            logits = lm_logits(params["backbone"], lm_head, chosen_last_hidden)
            # image positions are masked, as the reference's c_mask & (ids != -1)
            m = chosen.attention_mask
            if chosen.splice_idx is not None:
                m = m * (chosen.splice_idx < 0).to(m.dtype)
            ptx = losses.sft_sum_loss(logits.float(), chosen.input_ids, m,
                                      beta=reward_scaler_beta)
            metrics["ptx_loss"] = ptx
            loss = (1 - ptx_loss_coef) * loss + ptx_loss_coef * ptx
            metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_cls_loss_fn(cfg, rcfg: RewardConfig, *, compute_fp32_loss: bool = False,
                     attn_impl: str = "auto", remat: bool = True,
                     projector_path: Tuple[str, ...] = PROJECTOR_PATHS["phi3v"],
                     mesh=None) -> Callable:
    """Pointwise classification objective (``train_step.py:191-215``)."""
    data_group = _data_group(mesh)
    tp = tensor_parallel(mesh, cfg)

    def loss_fn(trainable, frozen, batch: RewardBatch, labels: torch.Tensor):
        params, lora, vision_lora = assemble_params(frozen, trainable, projector_path)
        out = reward_forward(params, cfg, rcfg, batch, training=True, attn_impl=attn_impl,
                             remat=remat, lora=lora, vision_lora=vision_lora,
                             data_group=data_group, tp=tp)
        r = out.reward[..., 0]
        if compute_fp32_loss:
            r = r.float()
        loss, prob = losses.binary_cls_loss(r, labels)
        return loss, {"preference_loss": loss, "prob": prob}

    return loss_fn


def _trainable_leaves(tree) -> None:
    for leaf in tree_leaves(tree):
        if leaf.is_floating_point() and not leaf.requires_grad:
            leaf.requires_grad_(True)


def _data_group(mesh):
    """The data ranks' process group, None for one data rank."""
    return mesh.group(DATA) if mesh is not None and mesh.ways(DATA) > 1 else None


def _mean_over_ranks(grads, metrics: dict, mesh):
    """Each rank's gradients and metrics averaged over the data ranks, and
    the leaves and metrics that the tp peers all hold over tp too: a leaf's
    gradient is summed over every mesh axis it is not split over, except
    fsdp for a ``Sharded`` leaf split over fsdp (its gather's backward took
    that sum), then divided by the data ways, times tp for a leaf not split
    over tp; one bucket per set of axes. The tp peers compute their copies of
    a whole leaf's gradient apart (the CPU's matmuls round by the data's
    alignment), so the average keeps their copies the same bits."""
    n, tp = mesh.ways(DATA), mesh.shape["tp"]
    buckets = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif t is not None:
            split = t.axes if isinstance(t, Sharded) else ()
            axes = tuple(a for a in ("dp", "fsdp", "tp") if a not in split)
            buckets.setdefault(axes, []).append(t.local if isinstance(t, Sharded) else t)

    walk(grads)
    reduced = {}
    for axes in sorted(buckets):  # the same order on every rank
        leaves = buckets[axes]
        flat = torch.cat([g.reshape(-1).float() for g in leaves])
        if mesh.ways(axes) > 1:
            flat = all_reduce(flat, mesh.group(axes))
        flat = flat / (n * (tp if "tp" in axes else 1))
        for g, piece in zip(leaves, flat.split([g.numel() for g in leaves])):
            reduced[id(g)] = piece.view_as(g).to(g.dtype)
    keys = sorted(metrics)
    means = all_reduce(torch.stack([metrics[k].float() for k in keys]),
                       mesh.group(AXES)) / (n * tp)
    return tree_map(lambda g: reduced[id(g)], grads), dict(zip(keys, means.unbind()))


def make_train_step(loss_fn: Callable, tx, mesh=None) -> Callable:
    """``train_step(state, frozen, *loss_args) -> (state, metrics)``
    (``train_step.py:218-238``): loss and grads of the trainable tree, the
    optimizer's update, and ``grad_norm`` = global norm of the raw grads.
    Metrics come back as detached tensors (reading them waits for the card).
    Under a ``mesh`` with more than one data rank, each rank's loss is over
    its own rows; gradients and metrics are their mean over the data ranks,
    the global batch's, and equal on every rank (the tp peers' too)."""
    sync = mesh is not None and mesh.size > 1

    def train_step(state: TrainState, frozen: dict, *loss_args):
        trainable = state.trainable
        _trainable_leaves(trainable)
        loss, metrics = loss_fn(trainable, frozen, *loss_args)
        leaves = tree_leaves(trainable)
        grads_flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(g if g is not None else torch.zeros_like(p)
                  for g, p in zip(grads_flat, leaves))
        grads = tree_map(lambda _: next(it), trainable)
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in metrics.items()}
            if sync:
                grads, metrics = _mean_over_ranks(grads, metrics, mesh)
            updates, opt_state = tx.update(grads, state.opt_state, trainable)
            new_trainable = tree_map(lambda p, u: (p + u.to(p.dtype)).requires_grad_(),
                                     trainable, updates)
            metrics["grad_norm"] = global_norm(grads)
        return TrainState(state.step + 1, new_trainable, opt_state), metrics

    return train_step


def init_train_state(trainable: dict, tx) -> TrainState:
    with torch.no_grad():
        return TrainState(0, trainable, tx.init(trainable))
