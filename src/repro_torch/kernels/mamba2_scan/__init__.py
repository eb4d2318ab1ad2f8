from repro_torch.kernels.mamba2_scan.ops import mamba2_scan  # noqa: F401
