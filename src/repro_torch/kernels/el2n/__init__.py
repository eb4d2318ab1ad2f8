from repro_torch.kernels.el2n.ops import el2n_scores  # noqa: F401
