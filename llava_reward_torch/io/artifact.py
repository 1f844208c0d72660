"""The public reward-checkpoint contract (``llava_reward_tpu/io/artifact.py``),
written and read unchanged:

  pm_path/
    pytorch_model.bin      value_head.weight, W_q/W_k/W_v.weight,
                           ca_layernorm.weight, prompt_head.weight and the
                           projector keys (phi3v: model.vision_embed_tokens.
                           img_projection.{0,2}.{weight,bias}; qwen:
                           visual.merger.ln_q.weight and
                           visual.merger.mlp.{0,2}.{weight,bias}; llava:
                           multi_modal_projector.linear_{1,2}.
                           {weight,bias}), bf16
    lora/                  PEFT adapter: adapter_config.json + adapter_model.bin
    reward_config.yaml     {add_cross_attention, general_preference_tau,
                            is_general_preference, value_head_dim}

Linear weights are stored (out, in), the tree's kernels (in, out). The card
has no PyYAML, so the four-key ``reward_config.yaml`` is written and read by
hand in ``yaml.safe_dump``'s format: sorted keys, one ``key: value`` per
line; ``yaml.safe_load`` reads the port's file and the port reads
``safe_dump``'s.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import torch

from ..core.config import RewardConfig
from ..core.device import DEFAULT_DEVICE, resolve_device

# substrings the reference loader re-keys by; any other key in
# pytorch_model.bin would be dropped silently by that loader
_ARTIFACT_KEY_FAMILIES = (
    "value_head", "W_q", "W_k", "W_v", "ca_layernorm", "prompt_head",
    "img_projection", "merger", "multi_modal_projector",
)


# ---------------------------------------------------------------- reward_config.yaml


def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            raise ValueError(f"reward_config.yaml: non-finite value {v}")
        r = repr(v)
        if "." not in r:  # YAML 1.1 floats need a dot: 1e-05 -> 1.0e-05
            mant, _, exp = r.partition("e")
            r = f"{mant}.0" + (f"e{exp}" if exp else "")
        return r
    raise TypeError(f"reward_config.yaml: unsupported value {v!r}")


def _parse_scalar(s: str):
    """The scalars ``safe_dump`` writes for the contract's keys."""
    s = s.strip()
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    raise ValueError(f"reward_config.yaml: cannot read value {s!r}")


def save_reward_config(pm_path: str, rcfg: RewardConfig) -> None:
    os.makedirs(pm_path, exist_ok=True)
    d = rcfg.to_contract_dict()
    with open(os.path.join(pm_path, "reward_config.yaml"), "w") as f:
        f.writelines(f"{k}: {_yaml_scalar(d[k])}\n" for k in sorted(d))


def load_reward_config(pm_path: str) -> RewardConfig:
    d = {}
    with open(os.path.join(pm_path, "reward_config.yaml")) as f:
        for line in f:
            line = line.split("#", 1)[0].rstrip()
            if not line.strip() or line.strip() in ("---", "..."):
                continue
            key, sep, val = line.partition(":")
            if not sep:
                raise ValueError(f"reward_config.yaml: cannot read line {line!r}")
            d[key.strip()] = _parse_scalar(val)
    return RewardConfig.from_contract_dict(d)


# ---------------------------------------------------------------- state dicts


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.detach().cpu().T.contiguous()


def _save_state_dict(sd: Dict[str, torch.Tensor], path: str, dtype) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu().to(dtype).contiguous() for k, v in sd.items()}, path)


def _load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def projector_state_dict(projector_params: dict,
                         model_type: str = "phi3v") -> Dict[str, torch.Tensor]:
    """A trained projector's torch keys per family (``artifact.py:153-180``):
    phi3v's ``img_projection`` MLP, qwen's merger (``ln_q`` + the MLP),
    llava's ``multi_modal_projector.linear_{1,2}``."""
    idx = ("0", "2")
    if model_type == "phi3v":
        pre, sd = "model.vision_embed_tokens.img_projection", {}
    elif model_type == "qwen":
        pre = "visual.merger.mlp"
        sd = {"visual.merger.ln_q.weight": projector_params["ln_q"].detach().cpu()}
    elif model_type == "llava":
        pre, sd, idx = "multi_modal_projector", {}, ("linear_1", "linear_2")
    else:
        raise ValueError(f"unknown model_type {model_type!r}")
    for fc, i in zip(("fc1", "fc2"), idx):
        sd[f"{pre}.{i}.weight"] = _t(projector_params[fc]["kernel"])
        sd[f"{pre}.{i}.bias"] = projector_params[fc]["bias"].detach().cpu()
    return sd


def save_reward_artifact(
    pm_path: str,
    rcfg: RewardConfig,
    head_params: dict,
    projector_params: Optional[dict] = None,
    lora_state: Optional[Dict[str, torch.Tensor]] = None,
    lora_config: Optional[dict] = None,
    torch_dtype=torch.bfloat16,
    model_type: str = "phi3v",
) -> None:
    """Write the artifact the reference loader consumes (``artifact.py:183-223``)."""
    os.makedirs(pm_path, exist_ok=True)
    sd: Dict[str, torch.Tensor] = {"value_head.weight": _t(head_params["value_head"]["kernel"])}
    if "skipca" in head_params:
        sk = head_params["skipca"]
        for name in ("W_q", "W_k", "W_v"):
            sd[f"{name}.weight"] = _t(sk[name]["kernel"])
        sd["ca_layernorm.weight"] = sk["ca_layernorm"]["weight"].detach().cpu()
    if "prompt_head" in head_params:
        sd["prompt_head.weight"] = _t(head_params["prompt_head"]["kernel"])
    if projector_params is not None:
        sd.update(projector_state_dict(projector_params, model_type))
    _save_state_dict(sd, os.path.join(pm_path, "pytorch_model.bin"), torch_dtype)
    save_reward_config(pm_path, rcfg)
    if lora_state is not None:
        lora_dir = os.path.join(pm_path, "lora")
        _save_state_dict(lora_state, os.path.join(lora_dir, "adapter_model.bin"), torch_dtype)
        with open(os.path.join(lora_dir, "adapter_config.json"), "w") as f:
            json.dump(lora_config or {}, f, indent=2)


def check_artifact_keys(pm_path: str, *, strict: bool = True) -> list:
    """pytorch_model.bin keys that no loader family matches (``artifact.py:56-75``)."""
    sd = _load_state_dict(os.path.join(pm_path, "pytorch_model.bin"))
    extra = sorted(k for k in sd if not any(f in k for f in _ARTIFACT_KEY_FAMILIES))
    if not extra:
        return []
    shown = ", ".join(extra[:12]) + (" ..." if len(extra) > 12 else "")
    msg = (f"{len(extra)} unrecognised key(s) in {pm_path}/pytorch_model.bin: [{shown}] — the "
           "adaptor loader would silently drop these weights. Pass strict=False to downgrade "
           "this to a warning.")
    if strict:
        raise ValueError(msg)
    from ..core.logging import init_logger

    init_logger(__name__).warning(msg)
    return extra


def _to(x: torch.Tensor, dtype, dev) -> torch.Tensor:
    return x.to(device=dev, dtype=dtype)


def load_head_params(pm_path: str, rcfg: RewardConfig, dtype=torch.float32,
                     device=DEFAULT_DEVICE) -> dict:
    """pytorch_model.bin -> head tree; keys re-keyed by their last path
    component, as the reference loader does (``artifact.py:78-98``)."""
    dev = resolve_device(device)
    sd = _load_state_dict(os.path.join(pm_path, "pytorch_model.bin"))

    def last(key_sub):
        return {k.split(".")[-1]: v for k, v in sd.items() if key_sub in k}

    def kernel(key_sub):
        return {"kernel": _to(last(key_sub)["weight"].T.contiguous(), dtype, dev)}

    head: dict = {"value_head": kernel("value_head")}
    if rcfg.add_cross_attention:
        head["skipca"] = {
            "W_q": kernel("W_q"), "W_k": kernel("W_k"), "W_v": kernel("W_v"),
            "ca_layernorm": {"weight": _to(last("ca_layernorm")["weight"], dtype, dev)},
        }
    if last("prompt_head"):
        head["prompt_head"] = kernel("prompt_head")
    return head


def _load_mlp(pm_path: str, family: str, dtype, dev, idx=("0", "2")):
    """(keys of ``family`` re-keyed by their last two path parts, the
    ``{fc1, fc2}`` tree of its ``{idx}.{weight,bias}`` entries), or (None, None)."""
    sd = _load_state_dict(os.path.join(pm_path, "pytorch_model.bin"))
    proj = {".".join(k.split(".")[-2:]): v for k, v in sd.items() if family in k}
    if not proj:
        return None, None
    return proj, {
        fc: {"kernel": _to(proj[f"{i}.weight"].T.contiguous(), dtype, dev),
             "bias": _to(proj[f"{i}.bias"], dtype, dev)}
        for fc, i in zip(("fc1", "fc2"), idx)
    }


def load_projector_params(pm_path: str, dtype=torch.float32,
                          device=DEFAULT_DEVICE) -> Optional[dict]:
    """The phi3v ``img_projection`` subtree from the artifact, or None
    (``artifact.py:101-112``)."""
    return _load_mlp(pm_path, "img_projection", dtype, resolve_device(device))[1]


def load_qwen_merger_params(pm_path: str, dtype=torch.float32,
                            device=DEFAULT_DEVICE) -> Optional[dict]:
    """The qwen ``visual.merger`` subtree (``ln_q``, ``fc1``, ``fc2``) from the
    artifact, or None (``artifact.py:115-127``)."""
    dev = resolve_device(device)
    proj, mlp = _load_mlp(pm_path, "merger", dtype, dev)
    if proj is None:
        return None
    return {"ln_q": _to(proj["ln_q.weight"], dtype, dev), **mlp}


def load_llava_projector_params(pm_path: str, dtype=torch.float32,
                                device=DEFAULT_DEVICE) -> Optional[dict]:
    """LLaVA's ``multi_modal_projector`` from the artifact, re-keyed by
    ``linear_{1,2}`` (``artifact.py:130-150``; reward_adaptor_loader.py:143-148),
    or None."""
    return _load_mlp(pm_path, "multi_modal_projector", dtype, resolve_device(device),
                     idx=("linear_1", "linear_2"))[1]
