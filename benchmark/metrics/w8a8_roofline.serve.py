"""The W8A8 layer's share of its roofline in serving: the bound of the traced
calls' int8 GEMMs (operations at 1979 TOP/s, the weight read once a call)
and of the epilogues that make their codes (bytes at 3.35 TB/s), at the
valid rows, over the device time of the kernels under the W8A8 span."""

SPANS = {"bench.w8a8": [
    ("llava_reward_torch.ops.quant_epilogue", "rms_quant"),
    ("llava_reward_torch.ops.quant_epilogue", "ln_quant"),
    ("llava_reward_torch.ops.quant_epilogue", "silu_mul_quant"),
    ("llava_reward_torch.ops.quant_epilogue", "row_quant"),
    ("llava_reward_torch.ops.int8_matmul", "_launch"),
]}


def count(work):
    """A device call's W8A8 bound (the families' ``w8a8.*`` terms)."""
    return work.bound_s("w8a8")


def read(data):
    if data is None or data.get("role") != "serve":
        return None
    t = data["trace"]["spans"].get("bench.w8a8", 0.0)
    bound = data.get("count", {}).get("traced", 0.0)
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
