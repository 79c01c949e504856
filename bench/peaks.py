"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at its
700 W limit (NVIDIA's data sheet)."""

#: Dense TF32 tensor-core rate. The port's work is float32: no route that
#: keeps float32 inputs' accuracy exceeds it (3xTF32 reaches a third).
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
FP32_SIMT_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
