"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W), the
denominators of every roofline and utilization share."""

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
