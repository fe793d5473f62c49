"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates without
sparsity, at its 700 W limit (NVIDIA's data sheet).  Shares are stated
against these, with the card's power limit beside them in each result."""

BF16_FLOPS = 989e12      # bf16 / fp16 tensor cores
TF32_FLOPS = 495e12      # TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12
