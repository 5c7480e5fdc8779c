"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). Every roofline
share and ``mfu`` is stated against these, with the card's power limit
printed beside it."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores: the programs run with TF32 off
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
