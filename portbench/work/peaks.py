"""Published peaks of the cards the benchmark knows, keyed by
torch.cuda.get_device_name(): dense tensor-core bf16 FLOP/s and memory
bytes/s (NVIDIA's H100 SXM data sheet, at its 700 W limit). A card not in
the table gets no roofline or mfu share."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "bytes": 3.35e12},
}


def least_seconds(flop: float, moved: float, card: str) -> float:
    """The least time the card could take for the work: the larger of the
    operations over the FLOP/s peak and the bytes over the memory rate."""
    p = PEAKS[card]
    return max(flop / p["bf16_flops"], moved / p["bytes"])
