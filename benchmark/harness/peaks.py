"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W); a roofline share is stated against them with the
card's power limit printed beside it."""

TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
# an fp32-accurate product on the tensor cores takes 3 TF32 passes (the
# same rate as 6 passes of bf16 at 989 TFLOP/s)
FP32_ACCURATE_FLOPS = TF32_FLOPS / 3.0
# NVLink 4 of one H100 SXM: 18 links, 900 GB/s in both directions
# together, 450 GB/s out of the card
NVLINK_BYTES_PER_S = 450e9
