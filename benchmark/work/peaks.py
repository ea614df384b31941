"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the full 700 W power limit)."""

#: bf16 tensor-core FLOP/s
PEAK_BF16_FLOPS = 989e12
#: f32 FLOP/s outside the tensor cores
PEAK_F32_FLOPS = 67e12
#: int8 tensor-core operations/s
PEAK_INT8_OPS = 1979e12
#: HBM3 bytes/s
PEAK_BYTES = 3.35e12
