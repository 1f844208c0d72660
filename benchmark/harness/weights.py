"""Seeded weights in the tree layout the port reads, made on the device.

Both sides get their weights from here: the port its tree at set-up, the
plain reference the same tree made again from the same seed once the port's
state is freed. Every random leaf of a group is a slice of one buffer that
one ``normal_`` call per 2**30 elements fills, in the dtype the weights are
served in; norms are ones and biases zeros, as the published inits have
them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import family

CHUNK = 1 << 30

# a leaf: (path, shape, kind), kind "randn" (with its std), "ones" or "zeros"
Leaf = Tuple[str, Tuple[int, ...], str, float]


def head_spec(c: dict, H: int, std: float) -> List[Leaf]:
    """The value head (and SkipCA) that every family shares."""
    rw = c["reward"]
    dim = rw["value_head_dim"] if rw["is_general_preference"] else 1
    head = [("value_head/kernel", (H, dim), "randn", std)]
    if rw["add_cross_attention"]:
        head += [(f"skipca/{n}/kernel", (H, H), "randn", std) for n in ("W_q", "W_k", "W_v")]
        head += [("skipca/ca_layernorm/weight", (H,), "ones", 0)]
    return head


def _fill(leaves: List[Leaf], gen: torch.Generator, dtype, device) -> Dict[str, torch.Tensor]:
    n = sum(_numel(s) for _, s, k, _ in leaves if k == "randn")
    buf = torch.empty(n, dtype=dtype, device=device)
    for off in range(0, n, CHUNK):
        buf[off: off + CHUNK].normal_(generator=gen)
    out, pos = {}, 0
    for path, shape, kind, std in leaves:
        if kind == "randn":
            k = _numel(shape)
            out[path] = buf[pos: pos + k].view(shape).mul_(std)
            pos += k
        else:
            out[path] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, dtype=dtype, device=device)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _nest(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parts, last = path.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = t
    return tree


def make_weights(cfg: dict, seed: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """``{'backbone': tree, 'head': tree}`` from ``seed``: the groups in a fixed
    order from one generator, so both sides read the same numbers."""
    spec = family.of(cfg).weight_spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = {}
    for group in ("vision", "layers", "rest"):
        flat.update(_fill(spec[group], gen, dtype, device))
    head = _fill(spec["head"], gen, dtype, device)
    return {"backbone": _nest(flat), "head": _nest(head)}


def param_count(cfg: dict) -> int:
    spec = family.of(cfg).weight_spec(cfg)
    return sum(_numel(s) for g in spec.values() for _, s, _, _ in g)
