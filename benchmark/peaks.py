"""Published peaks of one NVIDIA H100 SXM5 ("NVIDIA H100 80GB HBM3"),
dense, without sparsity, at its 700 W limit (NVIDIA's data sheet and the
Hopper architecture whitepaper)."""

# bf16 Tensor Core peak: the one peak every cell's MFU is read against,
# whatever the cell's precision, so that the numbers stay comparable.
BF16_FLOPS = 989.4e12
# HBM3 bandwidth.
HBM_BYTES_S = 3.35e12
# float32 outside the tensor cores is 67 TFLOP/s, 33.5 T fused multiply-adds
# a second; an add, a min or an integer multiply fills the same dispatch
# slot, so every arithmetic operation of a kernel counts as one.
INSTR_S = 33.5e12
