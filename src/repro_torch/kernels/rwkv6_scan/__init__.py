from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: F401
