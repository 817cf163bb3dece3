"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit): the denominators of every roofline and
utilisation share."""

#: HBM3 bandwidth, bytes per second.
HBM_BYTES_PER_S = 3.35e12
#: Dense bfloat16 tensor-core rate, FLOP per second.
BF16_FLOPS = 989e12
#: Dense int8 tensor-core rate, operations per second.
INT8_OPS = 1979e12
