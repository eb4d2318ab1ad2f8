"""Transport-aware segment pipeline: the split's wire boundaries.

  codec.py    — WireCodec (fp32 | bf16 | int8-stochastic | raw) + the
                autograd roundtrip that quantizes backward gradients too
  boundary.py — Boundary / WireSpec: the head->body and body->tail links
  meter.py    — TrafficMeter: measured bytes per boundary (a copy of the
                JAX package's, which has no JAX in it)
  hetero.py   — per-client SplitConfig groups (import directly to avoid a
                core<->runtime import cycle at package load)
"""
from repro_torch.runtime.boundary import (BOUNDARY_NAMES, Boundary,  # noqa: F401
                                          WireSpec)
from repro_torch.runtime.codec import (CODECS, Bf16Codec, Fp32Codec,  # noqa: F401
                                       Int8Codec, RawCodec, WireCodec,
                                       get_codec)
from repro_torch.runtime.meter import TrafficMeter  # noqa: F401
