"""Device rule of the port.

Entry points take an explicit ``device`` whose default is ``"cuda"``. Asking
for CUDA where there is none raises: the port never carries on silently on
the CPU. Tests pass ``device="cpu"``.

``on_card`` is the counterpart of the JAX package's ``_on_tpu()`` gates
(``llava_reward_tpu/models/clip_vit.py:219-223``,
``llava_reward_tpu/ops/attention.py:107-118,172-182``): it is decided by
where the tensor lies, so the same shapes take the same route in both
packages (kernel path on the accelerator, reference path on the CPU).
"""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def on_card(x: torch.Tensor) -> bool:
    """True when ``x`` lies on a CUDA device (the kernel path)."""
    return x.is_cuda
