from repro_torch.kernels.secure_mask.ops import (  # noqa: F401
    masked_encode, ring_size, summed_mask)
