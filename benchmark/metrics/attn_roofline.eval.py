"""Attention's share of its roofline in batch evaluation: the bound of the traced
calls' attention (each call's operations and bytes at its valid lengths)
over the device time of the kernels under the attention span, which wraps
the attention entries the models call."""


SPANS = {"bench.attn": [
    ("llava_reward_torch.models.phi3", "fused_rope_attention"),
    ("llava_reward_torch.models.clip_vit", "mha"),
    ("llava_reward_torch.ops.flash_attention", "direct_attention"),
    ("llava_reward_torch.models.qwen25_vl", "fused_rope_attention"),
    ("llava_reward_torch.models.qwen25_vl", "mha"),
]}


def count(work):
    """A device call's attention bound: ``max(ops / 989 T, bytes / 3.35 TB/s)``
    per call kind and layer, at the valid lengths (the families' ``attn.*``
    terms)."""
    return work.bound_s("attn")


def read(data):
    if data is None or data.get("role") != "eval":
        return None
    t = data["trace"]["spans"].get("bench.attn", 0.0)
    bound = data.get("count", {}).get("traced", 0.0)
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
