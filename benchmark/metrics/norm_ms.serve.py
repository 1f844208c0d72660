"""Milliseconds of device time a traced call of serving spends in
normalisation: the kernels under the norm span, which wraps every RMSNorm and
LayerNorm entry the models call (not W8A8's quantizing epilogues, whose norm
and codes are one kernel), over the traced calls."""

SPANS = {"bench.norm": [
    ("llava_reward_torch.models.phi3", "rms_norm"),
    ("llava_reward_torch.models.qwen25_vl", "rms_norm"),
    ("llava_reward_torch.reward.skipca", "rms_norm"),
    ("llava_reward_torch.models.clip_vit", "layer_norm"),
]}


def read(data):
    if data is None or data.get("role") != "serve":
        return None
    t = data["trace"]["spans"].get("bench.norm", 0.0)
    calls = sum(1 for traced in data.get("traced") or () if traced)
    if t <= 0 or calls == 0:
        return None
    return 1e3 * t / calls
