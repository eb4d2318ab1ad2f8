"""SFPrompt in PyTorch: the port of `repro` for NVIDIA Hopper.

It mirrors `repro`'s subpackages and names and never imports JAX or
`repro`. Modules with no JAX in the original (`models/config.py`,
`configs/*`, `serve/workload.py`, `obs/trace.py`, `runtime/meter.py`) are
copies; the rest are ports. Every entry point takes `device=` and defaults
to "cuda"; asking for CUDA where there is none raises. A kernel op runs its
plain PyTorch version on CPU tensors and its hand-written CUDA kernel
(`csrc/`, built at first use) on CUDA tensors.

Ported so far: dense split serving (`serve.ServeEngine`,
`python -m repro_torch.launch.serve`).
"""
