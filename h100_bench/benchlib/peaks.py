"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its full
700 W power limit). A card set below that limit runs slower under load;
the run reports the card's limit beside every share of a peak."""
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "float32": 67e12,      # outside the tensor cores (TF32 off)
    "bfloat16": 989e12,    # tensor cores, dense
}


def flops_per_s(dtype_name: str) -> float:
    return FLOPS_PER_S[dtype_name]
