"""Weights carried across from the JAX package.

The port consumes the JAX package's param trees as they are: plain nested
dicts with ``(in, out)`` kernels and layers stacked on a leading axis
(backbone: ``models/phi3v.py:36-56``, ``phi3.py:22-32``,
``clip_vit.py:16-28``; head: ``reward/model.py:83-96``). ``to_torch`` turns
such a tree of numpy arrays into the same tree of tensors (same keys,
stacking and dtypes); ``to_numpy`` is its inverse, bit for bit.

bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays; they cross
as their 16-bit patterns, so no value is rounded. W8A8 codes
(``qvalues_w8a8``) keep their shape and values and take the port's K-major
storage (``utils/quantize.k_major``); ``to_numpy`` gives back the numpy form.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from ..utils.quantize import W8A8_KEY, k_major


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def array_to_tensor(a: Any, device: Union[str, torch.device]) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch tensors may be written in place
        a = a.copy()
    if _is_bf16(a):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only the inverse needs a numpy bfloat16

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree: Any, device: Union[str, torch.device] = DEFAULT_DEVICE) -> Any:
    """Numpy (or array-like) param tree -> the same tree of tensors."""
    dev = resolve_device(device)

    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if key == W8A8_KEY:  # laid out on the host; .to keeps the strides
            return k_major(array_to_tensor(x, "cpu")).to(dev)
        return array_to_tensor(x, dev)

    return walk(tree)


def to_numpy(tree: Any) -> Any:
    """Tensor tree -> numpy tree (inverse of ``to_torch``)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tensor_to_array(tree)
