"""Published peaks of the card the benchmark runs on (NVIDIA H100 SXM
data sheet, dense rates at the full 700 W power limit).  The program
computes in float32 FFMA with TF32 off, so float32 outside the tensor
cores is the peak its rooflines and its model FLOP share are taken
against."""

H100 = {
    "float32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}
