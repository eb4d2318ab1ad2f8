from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.decode import decode_attention  # noqa: F401
