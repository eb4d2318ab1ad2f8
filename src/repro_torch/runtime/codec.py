"""Wire codecs: what a smashed tensor looks like as bytes on the link.

A `WireCodec` maps an activation (or cut-layer gradient) to the payload that
actually crosses the client<->server boundary and back:

    payload = encode(x, u)        # the bytes on the wire
    y       = decode(payload, dt) # what the receiving segment computes on

`payload_nbytes(shape)` is the exact serialized size of that payload — the
TrafficMeter counts it; it is identical to the JAX package's codecs.

`roundtrip(x, u_fwd, u_bwd)` is the autodiff-correct wire crossing: the
forward value goes through encode/decode, and the backward pushes the
gradient through the SAME codec (with independent noise), so training sees
exactly the int8 wire a physical deployment would — quantized activations
forward, quantized gradients backward.

Stochastic rounding noise `u` is uniform in [0, 1); `u = 0.5` degenerates to
round-to-nearest (the deterministic eval/serving mode).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch.kernels.quant.ops import dequantize_int8, quantize_int8

Payload = Any


class WireCodec:
    """Base contract. Codecs are stateless."""

    name: str = "identity"
    stochastic: bool = False   # does encode consume rounding noise?

    def encode(self, x: torch.Tensor, u) -> Payload:
        raise NotImplementedError

    def decode(self, payload: Payload, dtype) -> torch.Tensor:
        raise NotImplementedError

    def payload_nbytes(self, shape: Tuple[int, ...]) -> int:
        """Exact wire bytes for one tensor of `shape`."""
        raise NotImplementedError

    def bytes_per_float(self, shape: Tuple[int, ...]) -> float:
        """Effective bytes per element incl. side-channel (scales) overhead."""
        return self.payload_nbytes(shape) / max(1, math.prod(shape))

    def roundtrip(self, x: torch.Tensor, u_fwd, u_bwd) -> torch.Tensor:
        return _WireRoundtrip.apply(self, x, u_fwd, u_bwd)

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"

    def __hash__(self):
        return hash((type(self), self.name))

    def __eq__(self, other):
        return type(self) is type(other)


class _WireRoundtrip(torch.autograd.Function):
    """The counterpart of the JAX `_wire_roundtrip` custom VJP: forward is
    encode/decode with u_fwd; the gradient crosses the same physical link,
    so backward encodes/decodes it too, with u_bwd. The noise gets no
    gradient."""

    @staticmethod
    def forward(ctx, codec, x, u_fwd, u_bwd):
        ctx.codec = codec
        ctx.u_bwd = u_bwd
        return codec.decode(codec.encode(x, u_fwd), x.dtype)

    @staticmethod
    def backward(ctx, g):
        codec = ctx.codec
        return None, codec.decode(codec.encode(g, ctx.u_bwd), g.dtype), \
            None, None


class Fp32Codec(WireCodec):
    """Raw fp32 on the wire — the paper-naive baseline."""

    name = "fp32"

    def encode(self, x, u):
        return x.float()

    def decode(self, payload, dtype):
        return payload.to(dtype)

    def payload_nbytes(self, shape):
        return 4 * math.prod(shape)


class Bf16Codec(WireCodec):
    """bf16 truncation: 2 bytes/float, exact exponent, 8-bit mantissa."""

    name = "bf16"

    def encode(self, x, u):
        return x.to(torch.bfloat16)

    def decode(self, payload, dtype):
        return payload.to(dtype)

    def payload_nbytes(self, shape):
        return 2 * math.prod(shape)


class Int8Codec(WireCodec):
    """Per-token-row symmetric int8 with stochastic rounding.

    Payload = int8 values (1 B/elem) + one fp32 scale per row of the last
    axis. The quantize/dequantize pair runs as the CUDA kernels of
    kernels/quant/ on a CUDA tensor and as their plain version on the CPU.
    A Python-number `u` (the round-to-nearest 0.5) reaches the kernel by
    value; a tensor `u` through its strides, so a broadcast scalar is
    never an (N, D) tensor.
    """

    name = "int8"
    stochastic = True

    def encode(self, x, u):
        D = x.shape[-1]
        x2 = x.reshape(-1, D)
        if isinstance(u, torch.Tensor):
            u = torch.as_tensor(u, dtype=torch.float32, device=x.device)
            u = u.expand(x.shape).reshape(-1, D)
        values, scales = quantize_int8(x2, u)
        return values.reshape(x.shape), scales.reshape(x.shape[:-1] + (1,))

    def decode(self, payload, dtype):
        values, scales = payload
        D = values.shape[-1]
        out = dequantize_int8(values.reshape(-1, D), scales.reshape(-1, 1),
                              dtype=dtype)
        return out.reshape(values.shape)

    def payload_nbytes(self, shape):
        n_rows = math.prod(shape[:-1]) if len(shape) > 1 else 1
        return math.prod(shape) + 4 * n_rows


class RawCodec(WireCodec):
    """Verbatim 4-byte words on the wire — no cast, no quantization. The
    secure-aggregation path uses it for uint32 ring uploads and seed/pubkey
    exchange, where a float cast would corrupt the payload and the bytes
    must be counted exactly."""

    name = "raw"

    def encode(self, x, u):
        return x

    def decode(self, payload, dtype):
        return payload.to(dtype)

    def payload_nbytes(self, shape):
        return 4 * math.prod(shape)


CODECS = {"fp32": Fp32Codec, "bf16": Bf16Codec, "int8": Int8Codec,
          "raw": RawCodec}


def get_codec(name: str) -> WireCodec:
    if name not in CODECS:
        raise ValueError(f"unknown wire codec {name!r}; have {list(CODECS)}")
    return CODECS[name]()
