"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at its
700 W limit), the table every roofline and utilisation of the benchmark
divides by."""

HBM_BYTES_PER_S = 3.35e12     # device memory bandwidth
BF16_TENSOR_FLOPS = 989e12    # bf16 / fp16 on the tensor cores
F32_FLOPS = 67e12             # float32 outside the tensor cores
