"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity; at the full 700 W power limit)."""

H100_SXM = {
    "bf16_flops_per_s": 989e12,
    "fp16_flops_per_s": 989e12,
    "tf32_flops_per_s": 495e12,
    "fp32_flops_per_s": 67e12,       # outside the tensor cores; an FMA counts 2
    "fp8_flops_per_s": 1979e12,
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
}
