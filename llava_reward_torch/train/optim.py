"""Optimizer and LR schedule (``llava_reward_tpu/train/optim.py``): AdamW
with a cosine schedule and warmup, optional global-norm clipping, and
gradient accumulation, with optax's numbers.

The transformations work on trees (nested dicts of tensors, ``None`` for an
absent subtree) and mirror optax's interface: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; ``apply_updates``
adds the updates. States are plain dicts, so ``torch.save`` keeps them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from ..parallel.collectives import all_gather
from ..parallel.sharding import Sharded

Schedule = Callable[[int], float]


# ---------------------------------------------------------------- trees


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; ``None`` subtrees stay ``None``. A ``Sharded`` leaf maps over
    its local block and stays ``Sharded``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree.with_local(fn(tree.local, *(
            r.local if isinstance(r, Sharded) else r for r in rest)))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in order, a ``Sharded`` leaf as its local block."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree.local if isinstance(tree, Sharded) else tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (``optax.global_norm``).
    A ``Sharded`` leaf's squares are summed over the axes it is split over
    (fsdp, tp or both), so every rank gets the norm of the whole tree, each
    replicated leaf counted once."""
    sq, parts, mesh = 0.0, {}, None

    def walk(t):
        nonlocal sq, mesh
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, Sharded):
            parts[t.axes] = parts.get(t.axes, 0.0) + torch.sum(t.local.float() ** 2)
            mesh = t.mesh
        elif t is not None:
            sq = sq + torch.sum(t.float() ** 2)

    walk(tree)
    for axes in sorted(parts):  # the same order on every rank
        # gathered and summed in group order, so every rank gets the same bits
        # (gloo's all-reduce of one element over four ranks need not)
        sq = sq + torch.sum(all_gather(parts[axes][None], 0, mesh.group(axes)))
    return torch.sqrt(torch.as_tensor(sq))


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


# ---------------------------------------------------------------- schedule


def cosine_schedule_with_warmup(lr: float, total_steps: int, warmup_ratio: float = 0.03,
                                min_ratio: float = 0.0) -> Schedule:
    """HF 'cosine' with ceil(ratio * total) warmup steps (``optim.py:20-34``);
    step 0 has lr 0."""
    warmup = math.ceil(total_steps * warmup_ratio)

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup:
            return lr * step / max(warmup, 1)
        progress = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
        return lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * progress)))

    return schedule


# ---------------------------------------------------------------- AdamW


class AdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(...))``: the
    optional clip of the incoming gradients by their global norm, then
    Adam's moments, bias correction ``m / (1 - b1^(n+1))``, the update
    ``m_hat / (sqrt(v_hat) + eps)``, decoupled decay ``+ wd * p`` and the
    step ``-lr(n) *`` it, where n counts the updates applied before."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_norm: Optional[float] = None):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(self, grads, state: dict, params) -> Tuple[object, dict]:
        if self.max_norm is not None:
            g_norm = global_norm(grads)
            if not bool(g_norm < self.max_norm):
                grads = tree_map(lambda g: (g / g_norm.to(g.dtype)) * self.max_norm, grads)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g.float() + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g.float() * g.float()) + b2 * v, grads,
                      state["nu"])
        n = state["count"]
        bc1, bc2 = 1 - b1 ** (n + 1), 1 - b2 ** (n + 1)
        lr = self.schedule(n)
        wd = self.weight_decay

        def step(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if wd:
                u = u + wd * p.float()
            return -lr * u

        updates = tree_map(step, mu, nu, params)
        return updates, {"count": n + 1, "mu": mu, "nu": nu}


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)``: the running mean of
    k gradients (``acc + (g - acc) / (i + 1)``) goes to ``inner`` on every
    k-th call, whose update is returned then; zero updates in between, and
    the inner state (so the schedule) advances only on those calls."""

    def __init__(self, inner, every_k: int):
        self.inner, self.k = inner, every_k

    def init(self, params) -> dict:
        return {"mini_step": 0, "gradient_step": 0, "inner": self.inner.init(params),
                "acc": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(self, grads, state: dict, params) -> Tuple[object, dict]:
        i = state["mini_step"]
        acc = tree_map(lambda g, a: a + (g.float() - a) / (i + 1), grads, state["acc"])
        if i == self.k - 1:
            updates, inner = self.inner.update(acc, state["inner"], params)
            return updates, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                             "inner": inner, "acc": tree_map(torch.zeros_like, acc)}
        return tree_map(torch.zeros_like, acc), {
            "mini_step": i + 1, "gradient_step": state["gradient_step"],
            "inner": state["inner"], "acc": acc}


def make_optimizer(lr: float, total_steps: int, *, betas=(0.9, 0.95), eps: float = 1e-8,
                   weight_decay: float = 0.0, warmup_ratio: float = 0.03,
                   max_norm: Optional[float] = None, accumulation_steps: int = 1):
    """AdamW + cosine/warmup (+ optional clip), wrapped for accumulation
    when ``accumulation_steps > 1`` (``optim.py:37-67``)."""
    tx = AdamW(cosine_schedule_with_warmup(lr, total_steps, warmup_ratio), betas[0], betas[1],
               eps, weight_decay, max_norm)
    return MultiSteps(tx, accumulation_steps) if accumulation_steps > 1 else tx
