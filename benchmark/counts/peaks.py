"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).

An operand type maps to the highest rate any product with operands of that
type can run at on the card: bf16 989 TFLOP/s on the tensor cores, and for
float32 operands 495 TFLOP/s, the TF32 tensor-core rate (no product with
float32 operands runs faster). So no implementation, present or later, can
read over 100 % of these peaks.

Origin: ``chip_smoke.bound``'s table, with the float32 peak taken as the
TF32 rate instead of chip_smoke's 165 TFLOP/s (three TF32 products per f32
product, a figure derived from one implementation)."""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES = 3.35e12  # HBM3, bytes/s


def least_seconds(flops: float, n_bytes: float, dtype: str) -> float:
    """The least time the card could take for the work: the larger of the
    operations over the peak of their operand type and the bytes over the
    memory rate."""
    return max(flops / PEAK_FLOPS[dtype], n_bytes / PEAK_BYTES)
