"""Milliseconds of device time a traced call of batch evaluation spends in
normalisation: the kernels under the norm span, which wraps every RMSNorm and
LayerNorm entry the models call, over the traced calls. The entries are the
same names whatever carries them, the plain passes or a kernel."""

SPANS = {"bench.norm": [
    ("llava_reward_torch.models.phi3", "rms_norm"),
    ("llava_reward_torch.models.qwen25_vl", "rms_norm"),
    ("llava_reward_torch.reward.skipca", "rms_norm"),
    ("llava_reward_torch.models.clip_vit", "layer_norm"),
]}


def read(data):
    if data is None or data.get("role") != "eval":
        return None
    t = data["trace"]["spans"].get("bench.norm", 0.0)
    calls = sum(1 for traced in data.get("traced") or () if traced)
    if t <= 0 or calls == 0:
        return None
    return 1e3 * t / calls
