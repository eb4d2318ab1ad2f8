"""The port's CUDA kernels against their plain versions on the card, at
small and odd shapes (chip_smoke.py holds them at the full-width serving
shapes). Marked `cuda`: they skip without a CUDA device and run on the card
with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import torch

torch.set_num_threads(2)

import re  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

pytestmark = pytest.mark.cuda

ATTN_TOL = 2e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (37, 160), (130, 5120),
                                   (2, 300)])
def test_quant_kernels_bit_equal(gen, shape):
    from repro_torch.kernels.quant import ref
    from repro_torch.kernels.quant.ops import dequantize_int8, quantize_int8
    x = torch.randn(shape, generator=gen, device="cuda") * 4.0
    x[0] = 0.0
    for u in (0.5, torch.rand(shape, generator=gen, device="cuda")):
        v, s = quantize_int8(x, u)
        rv, rs = ref.quantize(x, u)
        assert torch.equal(v, rv) and torch.equal(s, rs)
        assert torch.equal(dequantize_int8(v, s), ref.dequantize(v, s))


@pytest.mark.parametrize("layout", ["row", "col", "scalar", "transposed"])
def test_quant_kernels_bit_equal_on_gradient_layouts(gen, layout):
    """The layouts autograd hands the wire's backward crossing: broadcast
    views with a zero stride and a transposed gradient."""
    from repro_torch.kernels.quant import ref
    from repro_torch.kernels.quant.ops import dequantize_int8, quantize_int8
    N, D = 213, 768
    x = {"row": lambda: torch.randn((1, D), generator=gen, device="cuda")
         .expand(N, D),
         "col": lambda: torch.randn((N, 1), generator=gen, device="cuda")
         .expand(N, D),
         "scalar": lambda: torch.randn((), generator=gen, device="cuda")
         .expand(N, D),
         "transposed": lambda: torch.randn((D, N), generator=gen,
                                           device="cuda").t()}[layout]()
    for u in (0.5, torch.rand((N, D), generator=gen, device="cuda")):
        v, s = quantize_int8(x, u)
        rv, rs = ref.quantize(x.contiguous(), u)
        assert torch.equal(v, rv) and torch.equal(s, rs)
        assert torch.equal(dequantize_int8(v, s), ref.dequantize(v, s))


QUANT_D = (100, 768, 2560, 5120, 5124, 18432)
QUANT_N = (1, 8, 16, 132, 3408)
QUANT_DTYPES = ("float32", "bfloat16", "float16")


def _quant_plans(D):
    """None (the plan `quantize_plan` picks), then every layout that holds
    rows of D values: the warp up to 1024, the block up to 8192, and
    clusters of 2, 3, 4 and 8 blocks from ceil(D / 8192) on."""
    plans = [None]
    if D <= 1024:
        plans.append(("warp", 1, 256))
    if D <= 8192:
        plans.append(("block", 1, 256))
    plans += [("cluster", C, 256) for C in (2, 3, 4, 8)
              if C * 8192 >= D]
    return plans


def _quant_us(gen, N, D):
    """u as a float (0.5 and another), as a (0, 0)-strided tensor, and
    dense."""
    return (0.5, float(torch.rand((), generator=gen, device="cuda")),
            torch.rand((), generator=gen, device="cuda").expand(N, D),
            torch.rand((N, D), generator=gen, device="cuda"))


def _quant_check(x, us, plans, dtype):
    """Every (u, plan) against plain: payload and scales, then the payload
    dequantized to f32 and to x's dtype."""
    from repro_torch.kernels.quant import ref
    from repro_torch.kernels.quant.kernel import dequantize_fwd, quantize_fwd
    for u in us:
        rv, rs = ref.quantize(x, u)
        for plan in plans:
            v, s = quantize_fwd(x, u, plan)
            assert torch.equal(v, rv), (plan, int((v != rv).sum()))
            assert torch.equal(s, rs), (plan, int((s != rs).sum()))
    for dt in {torch.float32, dtype}:
        assert torch.equal(dequantize_fwd(rv, rs, dt),
                           ref.dequantize(rv, rs, dt))


@pytest.mark.parametrize("D", QUANT_D)
@pytest.mark.parametrize("dtype", QUANT_DTYPES)
def test_quant_kernel_every_layout_bit_equal(gen, D, dtype):
    """Every layout (warp, block, clusters) that holds the row, at N 1 to
    3408 and u as a float, a (0, 0) tensor and dense, bit-equal to plain at
    f32, bf16 and f16. D 5124 is a multiple of 4 but not of 8 (16-byte
    loads at f32, one value a load at 16 bits), D 100 neither of 8 nor of
    16 (the dequantize tails), 18432 nemotron-4-340b's width (a cluster of
    3 or more)."""
    dtype = getattr(torch, dtype)
    for N in QUANT_N:
        x = _bf16((N, D), gen, scale=3.0, dtype=dtype)
        x[0, :7] = 0.0
        if N > 1:
            x[1] = 0.0                     # an all-zero row: scale 1e-8
        _quant_check(x, _quant_us(gen, N, D), _quant_plans(D), dtype)


@pytest.mark.parametrize("layout", ["offset", "row stride 0", "odd stride",
                                    "u offset", "u rows broadcast",
                                    "u strided"])
@pytest.mark.parametrize("dtype", QUANT_DTYPES)
def test_quant_kernel_unaligned_and_strided_bit_equal(gen, layout, dtype):
    """The scalar path and the strided reads: x one element off 16 bytes,
    x with row stride 0 (the backward's broadcast gradient: 16-byte loads
    still), x rows one element longer than a 16-byte multiple, a dense u
    one element off, u broadcast over rows (strides (0, 1)) and u
    transposed (strides (1, N)); payloads from values one byte off 16
    dequantize the same."""
    from repro_torch.kernels.quant import ref
    from repro_torch.kernels.quant.kernel import dequantize_fwd
    dtype = getattr(torch, dtype)
    for N, D in ((8, 5120), (132, 768), (16, 18432), (3, 100)):
        x = _bf16((N, D), gen, scale=3.0, dtype=dtype)
        us = _quant_us(gen, N, D)
        if layout == "offset":
            x = _bf16((N, D), gen, offset=1, scale=3.0, dtype=dtype)
        elif layout == "row stride 0":
            x = _bf16((1, D), gen, scale=3.0, dtype=dtype).expand(N, D)
        elif layout == "odd stride":
            x = _bf16((N, D + 1), gen, scale=3.0, dtype=dtype)[:, :D]
        elif layout == "u offset":
            us = (torch.rand(N * D + 1, generator=gen, device="cuda")[1:]
                  .view(N, D),)
        elif layout == "u rows broadcast":
            us = (torch.rand((1, D), generator=gen, device="cuda")
                  .expand(N, D),)
        else:
            us = (torch.rand((D, N), generator=gen, device="cuda").t(),)
        _quant_check(x, us, _quant_plans(D), dtype)
        v, s = ref.quantize(x, 0.5)
        v1 = torch.empty(N * D + 1, dtype=torch.int8,
                         device="cuda")[1:].view(N, D)
        v1.copy_(v)
        assert torch.equal(dequantize_fwd(v1, s, dtype),
                           ref.dequantize(v, s, dtype))


def test_dequant_kernel_row_loop_past_65535_rows(gen):
    """More rows than a grid's y dimension holds: the row loop."""
    from repro_torch.kernels.quant import ref
    from repro_torch.kernels.quant.kernel import dequantize_fwd, quantize_fwd
    for N, D in ((70001, 20), (600000, 16)):
        x = torch.randn((N, D), generator=gen, device="cuda")
        v, s = quantize_fwd(x, 0.5)
        assert torch.equal(v, ref.quantize(x, 0.5)[0])
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(dequantize_fwd(v, s, dt),
                               ref.dequantize(v, s, dt))


def test_quant_wrapper_refuses_rows_past_65536_and_bad_plans(gen):
    from repro_torch.kernels.quant.kernel import quantize_fwd
    with pytest.raises(ValueError, match="65536"):
        quantize_fwd(torch.zeros((1, 65537), device="cuda"), 0.5)
    x = torch.zeros((2, 2048), device="cuda")
    with pytest.raises(ValueError, match="1024"):
        quantize_fwd(x, 0.5, ("warp", 1, 256))
    with pytest.raises(ValueError):
        quantize_fwd(x, 0.5, ("cluster", 16, 256))
    with pytest.raises(ValueError, match="u must be"):
        quantize_fwd(x, torch.full((2, 2048), 0.5, dtype=torch.float64,
                                   device="cuda"))


def test_round_to_nearest_crossing_launches_only_the_pair(gen):
    """A round-to-nearest crossing of the int8 wire on the card runs the
    quantize and the dequantize kernel and nothing else: the noise 0.5
    goes to the kernel by value, so no fill kernel makes a tensor of it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.boundary import Boundary
    from repro_torch.runtime.codec import get_codec
    b = Boundary("head_body", get_codec("int8"))
    x = torch.randn((8, 1, 5120), generator=gen, device="cuda")
    b.transmit(x, train=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        b.transmit(x, train=False)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA"
             and not e.name.startswith("aten::")]
    assert len(names) == 2, names
    assert any("quantize_kernel" in n and "dequantize" not in n
               for n in names), names
    assert any("dequantize_kernel" in n for n in names), names


# The wide f32 layout's own cases (head dims 192 and 256): (..., offset,
# Dv, rows, q_layout). Each row count the plan can choose (32, 16) forced
# at both width classes, MLA's 192 / 128 at G 1 with 64 and 128 heads,
# rows that every key masks (a window ending before kv_len: rows from
# kv_len + window - 1 on average every key), q heads-major and from a fused
# qkv tensor, and one value off 16 bytes (4-byte copies, rows wider than
# the block's 128 or 256 threads)
PREFILL_F32_WIDE_CASES = [
    *((1, 100, 8, 2, 192, True, None, None, None, 0, None, r, None)
      for r in (32, 16)),
    *((2, 77, 8, 4, 256, True, 16, 50.0, None, 0, None, r, None)
      for r in (32, 16)),
    *((1, 70, 6, 2, 256, False, None, None, 50, 1, None, r, None)
      for r in (32, 16)),
    *((1, 90, 4, 1, 176, True, 12, None, 60, 1, 128, r, None)
      for r in (32, 16)),
    (1, 132, 64, 64, 192, True, None, None, None, 0, 128, None, None),
    (1, 132, 128, 128, 192, True, None, None, None, 0, 128, None, None),
    (1, 37, 128, 128, 192, True, None, 50.0, None, 0, 128, None, None),
    (1, 100, 4, 2, 256, True, 8, None, 40, 0, None, 32, None),
    (1, 90, 8, 4, 192, True, 8, 30.0, 30, 0, 128, 16, None),
    (1, 129, 6, 3, 256, False, 12, None, 50, 0, None, 16, None),
    (1, 132, 16, 8, 256, True, None, 50.0, None, 0, None, None,
     "transposed"),
    (2, 65, 8, 2, 192, True, 20, None, None, 0, 128, 32, "transposed"),
    (1, 70, 10, 2, 256, True, None, None, 60, 0, None, None, "fused"),
    (1, 70, 10, 2, 192, True, None, None, 60, 1, None, 16, "fused"),
    (2, 77, 24, 2, 192, True, 16, 50.0, None, 1, 128, None, None),
]


# The narrow f32 layout's own cases (head dims up to 160): (..., offset,
# Dv, rows, q_layout, splits, group, Skv). Every row count and every split
# count 1-8 forced over a long key axis (whisper's cross-attention: Sq 1
# and 64, non-causal, kv_len short of Skv), one head a block and the GQA
# group (G 4, 5, 8) at every row count, ragged Sq, rows that every key
# masks (a window ending before kv_len) under a split, q heads-major and
# from a fused qkv tensor, and one value off 16 bytes (4-byte copies).
PREFILL_F32_NARROW_CASES = [
    *((2, 1, 8, 2, 64, False, None, None, 650, 0, None, r, None, n, 4, 700)
      for r in (64, 32, 16) for n in range(1, 9)),
    *((2, 64, 8, 2, 64, False, None, 30.0, 650, 0, None, r, None, n, g, 700)
      for r in (64, 32, 16) for n in (1, 3, 8) for g in (1, 4)),
    *((1, 100, 10, 2, 128, True, None, None, 70, 0, None, r, None, n, g)
      for r in (64, 32, 16) for n in (1, 2) for g in (1, 5)),
    *((2, 77, 16, 2, 128, True, 16, 20.0, None, 0, None, r, None, 3, g)
      for r in (64, 32, 16) for g in (1, 8)),
    *((1, 120, 8, 1, 64, True, 8, None, 40, 0, None, r, None, n, g)
      for r in (64, 32, 16) for n in (1, 8) for g in (1, 8)),
    *((1, 133, 32, 8, 160, True, None, None, None, 0, None, r, None, 1, g)
      for r in (64, 32, 16) for g in (1, 4)),
    *((2, S, 6, 2, 80, True, None, None, None, 0, None, 16, None, 1, 3)
      for S in (1, 17, 33, 65, 129)),
    (1, 90, 8, 2, 80, False, None, None, None, 1, None, 32, None, 4, 4,
     600),
    (2, 50, 6, 2, 40, True, 12, None, None, 1, None, 16, None, 2, 3),
    (2, 65, 8, 2, 64, True, None, None, None, 0, None, 16, "transposed", 2,
     4),
    (1, 70, 10, 2, 160, True, None, None, 60, 0, None, 32, "fused", 1, 5),
    (1, 33, 8, 8, 32, False, None, None, None, 1, None, 64, "fused", 5, 1,
     900),
]


@pytest.mark.parametrize("case", [
    # (B, Sq, Hq, Hkv, Dh, causal, window, softcap, kv_len, offset)
    (2, 5, 4, 4, 32, True, None, None, None, 0),
    (1, 45, 10, 2, 16, True, None, None, None, 0),
    (2, 70, 8, 1, 96, True, 9, None, None, 0),
    (1, 33, 6, 3, 128, True, None, 30.0, 20, 0),
    (1, 64, 10, 2, 64, True, 16, 20.0, 17, 0),
    (2, 21, 4, 2, 16, False, None, None, None, 0),
    (1, 37, 8, 8, 80, True, None, None, None, 0),     # zamba2's head_dim 80
    (16, 213, 12, 12, 64, False, None, None, None, 0),  # ViT-Base scoring
    (1, 1, 4, 2, 64, True, None, None, None, 0),     # Sq ragged over the
    (1, 65, 8, 2, 64, True, 20, None, None, 0),      # 64-row query block
    (2, 129, 4, 1, 32, True, None, 30.0, 100, 0),
    (2, 77, 6, 3, 20, False, None, None, None, 0),   # widths not a multiple
    (1, 200, 4, 4, 40, True, 16, None, 60, 0),       # of 8 (zero-padded)
    (2, 50, 6, 2, 64, True, None, None, None, 1),    # one float off 16-byte
    (1, 90, 4, 4, 40, False, 24, 10.0, None, 1),     # alignment: 4-byte copies
    (1, 100, 10, 2, 128, True, None, None, 70, 0),   # GQA 5, kv_len < Sq
    (8, 100, 40, 8, 128, True, 32, 30.0, 90, 0),     # batched, with every
    (4, 129, 24, 8, 40, True, None, None, 100, 1),   # option at once
    # the wide head dims: gemma2's 256 (G 2, window, softcap 50),
    # stablelm's 160 (G 4), nemotron's 192 (G 12), 176 (an odd number of
    # 16-column pairs), 4-byte copies and a non-causal call at 256
    (1, 70, 16, 8, 256, True, 20, 50.0, None, 0),
    (2, 133, 32, 8, 160, True, None, None, None, 0),
    (1, 100, 24, 2, 192, True, None, None, 80, 0),
    (1, 200, 8, 4, 176, True, 16, None, 60, 0),
    (2, 65, 4, 2, 256, False, None, None, None, 1),
    (1, 90, 12, 1, 192, True, 24, 10.0, None, 1),
    *PREFILL_F32_WIDE_CASES,
    *PREFILL_F32_NARROW_CASES,
])
def test_prefill_kernel_matches_plain(gen, case):
    """One case, (B, Sq, Hq, Hkv, Dh, causal, window, softcap, kv_len,
    offset) and optionally (Dv, rows, q_layout, splits, group, Skv), as
    `_prefill_half`'s: the plan forced to `rows` rows a block (and, narrow
    f32, `splits` key shares and `group` heads a block), q heads-major or
    from a fused qkv tensor, keys Skv long (default Sq)."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.ops import prefill_attention
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, prefill_plan)
    B, S, Hq, Hkv, Dh, causal, window, softcap, kv_len, offset = case[:10]
    Dv, rows, q_layout, splits, group, Skv = \
        tuple(case[10:]) + (None,) * (16 - len(case))
    Dv = Dv or Dh
    Skv = Skv or S

    def randn(shape):               # a view `offset` floats into its storage
        if not offset:
            return torch.randn(shape, generator=gen, device="cuda")
        return torch.randn(int(np.prod(shape)) + offset, generator=gen,
                           device="cuda")[offset:].view(shape)

    if q_layout == "transposed":
        q = randn((B, Hq, S, Dh)).transpose(1, 2)
    elif q_layout == "fused":
        q = randn((B, S, 2 * Hq, Dh))[:, :, Hq:]
    else:
        q = randn((B, S, Hq, Dh))
    if Dv == Dh:
        kv = randn((B, Skv, 2 * Hkv, Dh))
        k, v = kv[:, :, :Hkv], kv[:, :, Hkv:]      # strided views
    else:
        k, v = randn((B, Skv, Hkv, Dh)), randn((B, Skv, Hkv, Dv))
    assert offset == 0 or q.data_ptr() % 16 and k.data_ptr() % 16
    n = flash_attention_fwd.launches
    L = kv_len or Skv
    if rows is None:
        got = prefill_attention(q, k, v, causal=causal,
                                sliding_window=window, softcap=softcap,
                                kv_len=kv_len)
    else:
        plan = prefill_plan(B, S, Hq, Dh, Dv, 4, Hkv=Hkv, kv_len=L)._replace(
            rows=rows, splits=splits or 1, group=group or 1)
        got = flash_attention_fwd(q, k, v, causal=causal,
                                  sliding_window=window, softcap=softcap,
                                  scale=Dh ** -0.5, kv_len=L, plan=plan)
    assert flash_attention_fwd.launches == n + 1
    assert got.shape == (B, S, Hq, Dv)
    want = ref.attention(q, k[:, :L], v[:, :L], causal=causal,
                         sliding_window=window, softcap=softcap)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATTN_TOL


@pytest.mark.parametrize("S", [1, 7, 64])
def test_cross_attention_launches_prefill_kernel(gen, S):
    """Whisper's cross-attention on the card: S queries over 100 encoder
    frames, non-causal (S 1: a decode step), through the layers' dispatch
    (one prefill launch) against its differentiable pass (the plain
    form)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.models import layers as L
    cfg = get_config("whisper-base").reduced(d_model=128, d_ff=256)
    p = L.init_attention(gen, cfg, cross=True, device="cuda")
    p.update(L.init_cross_attention_extra(gen, cfg, device="cuda"))
    x = torch.randn((3, S, 128), generator=gen, device="cuda")
    enc = torch.randn((3, 100, 128), generator=gen, device="cuda")
    pos = torch.zeros((3, S), dtype=torch.int32, device="cuda")
    out = {}
    for differentiable in (False, True):
        n = flash_attention_fwd.launches
        with torch.no_grad():
            out[differentiable] = L.apply_cross_attention(
                p, cfg, x, L.Ctx(mode="decode" if S == 1 else "prefill",
                                 positions=pos, encoder_out=enc,
                                 differentiable=differentiable))
        assert flash_attention_fwd.launches == n + (not differentiable)
    assert torch.isfinite(out[False]).all()
    assert float((out[False] - out[True]).abs().max()) <= ATTN_TOL


def _decode_lens(kind, W):
    if kind == "empty":            # no slot has held a request
        return [0] * 5
    if kind == "seam":             # slot 4's ring wrapped 8 past W
        return [0, 1, 40, W, 8]
    return [0, 1, 40, W, 30]


@pytest.mark.parametrize("G,Dh,window,softcap,kind", [
    pytest.param(1, 32, None, None, "", id="1-32-None-None"),
    pytest.param(5, 128, None, None, "", id="5-128-None-None"),
    pytest.param(8, 16, 7, None, "", id="8-16-7-None"),
    pytest.param(3, 64, None, 25.0, "", id="3-64-None-25.0"),
    pytest.param(5, 128, 64, 50.0, "", id="5-128-64-50.0"),
    pytest.param(1, 80, None, None, "", id="1-80-None-None"),
    pytest.param(5, 128, None, None, "empty", id="all-slots-empty"),
    # a window of 16 keeps slot 4's keys 69..76 and 0..7: both ends of the
    # ring, across its seam
    pytest.param(5, 128, 16, None, "seam", id="window-across-the-seam"),
    pytest.param(1, 80, 16, None, "seam", id="window-across-the-seam-hd80"),
    pytest.param(5, 128, 64, 50.0, "unaligned", id="unaligned-cache"),
    # the wide shapes: head dims 160-256 and groups up to 16
    pytest.param(2, 256, 16, 50.0, "seam", id="gemma2-256-seam-softcap"),
    pytest.param(4, 160, None, None, "", id="stablelm-160"),
    pytest.param(12, 192, None, None, "", id="nemotron-192-G12"),
    pytest.param(12, 192, 16, 50.0, "seam", id="192-G12-seam-softcap"),
    pytest.param(16, 64, None, None, "", id="G16-64"),
    pytest.param(12, 192, 64, 50.0, "unaligned", id="192-G12-unaligned"),
    pytest.param(2, 256, None, None, "empty", id="256-all-slots-empty"),
    # Whisper's 64 (G 1) and Qwen2-VL's 128 at G 8
    pytest.param(1, 64, None, None, "", id="whisper-64"),
    pytest.param(8, 128, None, None, "seam", id="qwen2-vl-G8-128-seam"),
])
def test_decode_kernel_matches_plain(gen, monkeypatch, G, Dh, window,
                                     softcap, kind):
    """At W = 77 (not a multiple of 32), with the wrapper's split count and
    with every split count 1-8 forced: within ATTN_TOL of plain, one
    launch a call."""
    from repro_torch.kernels.flash_attention import decode
    from repro_torch.kernels.flash_attention.decode import (
        decode_attention, decode_attention_fwd, decode_splits,
        grouped_decode, sm_count)
    B, W, Hkv = 5, 77, 2
    q = torch.randn((B, 1, G * Hkv, Dh), generator=gen, device="cuda")
    k = torch.randn((B, W, Hkv, Dh), generator=gen, device="cuda")
    v = torch.randn((B, W, Hkv, Dh), generator=gen, device="cuda")
    if kind == "unaligned":
        k, v = _unaligned(k), _unaligned(v)
        assert k.data_ptr() % 16 and k.stride(2) % 4
    kvp = torch.full((B, W), -1, dtype=torch.int32)
    qp = torch.zeros((B,), dtype=torch.int32)
    for b, n in enumerate(_decode_lens(kind, W)):
        if b == 4:                                  # wrapped ring
            pos = torch.arange(n, n + W, dtype=torch.int32)
            kvp[b, pos % W] = pos
            qp[b] = n + W - 1
        elif n:
            kvp[b, :n] = torch.arange(n, dtype=torch.int32)
            qp[b] = n - 1
    qp, kvp = qp.cuda(), kvp.cuda()
    want = grouped_decode(q, k, v, qp, kvp, scale=Dh ** -0.5,
                          sliding_window=window, softcap=softcap)
    assert decode_splits(B, Hkv, W, sm_count(q.device.index)) == 3
    for S in (None, 1, 2, 3, 4, 5, 6, 7, 8):
        if S is not None:
            monkeypatch.setattr(decode, "decode_splits",
                                lambda *shape, S=S: S)
        n = decode_attention_fwd.launches
        got = decode_attention(q, k, v, q_positions=qp, kv_positions=kvp,
                               sliding_window=window, softcap=softcap)
        torch.cuda.synchronize()
        assert decode_attention_fwd.launches == n + 1
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= ATTN_TOL, S


def test_wrappers_raise_instead_of_falling_back(gen):
    """Wrong inputs raise on CUDA tensors. Multi-query attention with
    positions (the chunked-prefill continuation) is the plain version on
    every device, as in the JAX package: no TPU kernel computes it, so no
    kernel launches for it."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.decode import \
        paged_decode_attention_fwd
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.quant.ops import dequantize_int8
    q = torch.randn((1, 4, 2, 8), device="cuda")
    off = torch.zeros(1, dtype=torch.int32, device="cuda")
    before = launch_counts()
    got = flash_attention(q, q, q, q_offset=off)
    assert launch_counts() == before
    assert torch.equal(got, ref.attention(q, q, q, q_offset=off))
    pool = torch.zeros((4, 8, 2, 8), device="cuda")
    tables = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    kvp = torch.full((4, 8), -1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="block_tables"):
        paged_decode_attention_fwd(q[:, :1], pool, pool, tables.long(), off,
                                   kvp, scale=1.0, sliding_window=None,
                                   softcap=None)
    with pytest.raises(ValueError):
        dequantize_int8(torch.zeros((2, 3), dtype=torch.int8, device="cuda"),
                        torch.ones((2, 1), device="cuda"),
                        dtype=torch.float64)
    with pytest.raises(ValueError):
        flash_attention(q.double(), q.double(), q.double())


def test_engine_on_card_matches_cpu(gen):
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.launch.serve import personalized_bank
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (ServeConfig, ServeEngine, TenantBank,
                                   WorkloadConfig, synthetic_requests)
    from repro_torch.tree import tree_map
    cfg = get_config("qwen2.5-14b").reduced(n_layers=3, d_model=64, d_ff=128,
                                            vocab_size=128)
    model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=4), WireSpec.make("fp32"))
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    bank = personalized_bank(model, params, 2, jitter=0.2)
    reqs = synthetic_requests(WorkloadConfig(
        n_requests=5, prompt_choices=(6, 10), new_token_choices=(3, 5),
        n_tenants=2, vocab_size=128, seed=4))
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(
            model, tree_map(lambda x: x.to(dev), params),
            TenantBank(tree_map(lambda x: x.to(dev), bank.tails),
                       bank.prompts.to(dev)),
            ServeConfig(n_slots=2, max_seq=32, decode_block=2),
            collect_logits=True, device=dev)
        out[dev] = {f.req.rid: f for f in eng.run(reqs)["finished"]}
    for rid, f in out["cpu"].items():
        np.testing.assert_array_equal(out["cuda"][rid].tokens, f.tokens)
        np.testing.assert_allclose(out["cuda"][rid].logits, f.logits,
                                   atol=1e-4, rtol=1e-4)


def _paged_case(gen, B, nb, page, Hq, Hkv, Dh, lens):
    """Shuffled pool pages, NULL entries past each slot's length, stale
    positions past it on its last page, an all-SCRATCH idle row for a
    slot of length 0, an all-NULL fully masked row (query position 0) for
    a length of None."""
    P = 2 + B * nb + 3
    q = torch.randn((B, 1, Hq, Dh), generator=gen, device="cuda")
    k = torch.randn((P, page, Hkv, Dh), generator=gen, device="cuda")
    v = torch.randn((P, page, Hkv, Dh), generator=gen, device="cuda")
    perm = np.random.default_rng(B * nb + page).permutation(np.arange(2, P))
    kvp = np.full((P, page), -1, np.int32)
    kvp[1] = 0                                   # scratch: garbage
    tables = np.zeros((B, nb), np.int32)
    for b, n in enumerate(lens):
        if n is None:
            continue
        if n == 0:
            tables[b] = 1
            continue
        for j in range(-(-n // page)):
            pid = perm[b * nb + j]
            tables[b, j] = pid
            m = min(page, n - j * page)
            kvp[pid, :m] = j * page + np.arange(m)
            kvp[pid, m:] = 10 ** 6
    qp = torch.tensor([max((n or 0) - 1, 0) for n in lens],
                      dtype=torch.int32)
    return (q, k, v, torch.from_numpy(tables).cuda(), qp.cuda(),
            torch.from_numpy(kvp).cuda())


def _unaligned(x):
    """The same values in a view whose base and strides are not multiples
    of 4 floats, so the kernel takes its 4-byte copies."""
    P, page, H, D = x.shape
    out = torch.empty((P, page, H, D + 1), device=x.device)[..., 1:]
    out.copy_(x)
    return out


def _paged_lens(kind, nb, page):
    if kind == "masked":           # the all-NULL row 1 has no valid key
        return [0, None, 40, nb * page, 2 * page + 3]
    return [0, 1, 40, nb * page, 2 * page + 3]


@pytest.mark.parametrize("page,G,Dh,window,softcap,B,nb,Hkv,kind", [
    pytest.param(8, 5, 128, None, None, 5, 9, 2, "", id="8-5-128-None-None"),
    pytest.param(16, 5, 128, None, None, 5, 9, 2, "",
                 id="16-5-128-None-None"),
    pytest.param(5, 1, 32, None, None, 5, 9, 2, "", id="5-1-32-None-None"),
    pytest.param(16, 8, 64, None, 25.0, 5, 9, 2, "", id="16-8-64-None-25.0"),
    pytest.param(8, 5, 128, 64, 50.0, 5, 9, 2, "", id="8-5-128-64-50.0"),
    pytest.param(8, 5, 128, None, None, 5, 9, 2, "masked",
                 id="fully-masked-row"),
    # the window leaves slot 3 (144 keys) valid keys in its last tile only
    pytest.param(16, 5, 128, 8, None, 5, 9, 2, "", id="last-tile-window"),
    pytest.param(64, 5, 128, None, None, 5, 9, 2, "", id="page-64"),
    pytest.param(16, 5, 128, None, None, 50, 3, 8, "", id="one-split"),
    pytest.param(8, 5, 128, 64, 50.0, 5, 9, 2, "unaligned",
                 id="unaligned-pool"),
    # the wide shapes: head dims 160-256 and groups up to 16
    pytest.param(16, 4, 160, None, None, 5, 9, 2, "", id="stablelm-160"),
    pytest.param(16, 12, 192, 64, 50.0, 5, 9, 2, "", id="192-G12-softcap"),
    pytest.param(8, 2, 256, 8, 50.0, 5, 9, 2, "masked",
                 id="256-fully-masked-row"),
    pytest.param(16, 12, 192, None, None, 5, 9, 2, "unaligned",
                 id="192-G12-unaligned"),
    pytest.param(16, 16, 256, None, None, 50, 3, 8, "",
                 id="256-G16-one-split"),
])
def test_paged_decode_kernel_matches_plain(gen, page, G, Dh, window,
                                           softcap, B, nb, Hkv, kind):
    from repro_torch.kernels.flash_attention.decode import (
        paged_decode_attention, paged_decode_attention_fwd,
        decode_splits, paged_gather_decode, sm_count)
    lens = _paged_lens(kind, nb, page)
    lens = (lens * (-(-B // len(lens))))[:B]
    q, k, v, tables, qp, kvp = _paged_case(gen, B, nb, page, G * Hkv, Hkv,
                                           Dh, lens)
    if kind == "unaligned":
        k, v = _unaligned(k), _unaligned(v)
        assert k.data_ptr() % 16 and k.stride(2) % 4
    S = decode_splits(B, Hkv, nb * page, sm_count(q.device.index))
    if B == 50:
        assert S == 1     # 400 blocks put three on every SM
    elif page == 8:
        # 10 blocks, capped at the row's 3 tiles: slots 1 (1 key) and 2
        # (40 keys) hold fewer valid tiles than S
        assert S == 3
    n = paged_decode_attention_fwd.launches
    got = paged_decode_attention(q, k, v, block_tables=tables,
                                 q_positions=qp, kv_positions=kvp,
                                 sliding_window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert paged_decode_attention_fwd.launches == n + 1
    want = paged_gather_decode(q, k, v, tables, qp, kvp, scale=Dh ** -0.5,
                               sliding_window=window, softcap=softcap)
    assert torch.isfinite(got).all()            # the idle row included
    assert float((got - want).abs().max()) <= ATTN_TOL
    for b in (b for b, n in enumerate(lens) if n is None):
        mean = v[0].mean(0).repeat_interleave(G, 0)    # every key: NULL
        assert float((got[b, 0] - mean).abs().max()) <= ATTN_TOL


def test_paged_engine_on_card_matches_cpu(gen):
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.launch.serve import personalized_bank
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   TenantBank, WorkloadConfig,
                                   synthetic_requests)
    from repro_torch.tree import tree_map
    cfg = get_config("qwen2.5-14b").reduced(n_layers=3, d_model=64, d_ff=128,
                                            vocab_size=128)
    model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=4), WireSpec.make("fp32"))
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    bank = personalized_bank(model, params, 2, jitter=0.2)
    reqs = synthetic_requests(WorkloadConfig(
        n_requests=5, prompt_choices=(6, 10), new_token_choices=(3, 5),
        n_tenants=2, vocab_size=128, seed=4))
    out = {}
    for dev in ("cpu", "cuda"):
        eng = PagedServeEngine(
            model, tree_map(lambda x: x.to(dev), params),
            TenantBank(tree_map(lambda x: x.to(dev), bank.tails),
                       bank.prompts.to(dev)),
            PagedServeConfig(n_slots=2, max_seq=32, decode_block=2,
                             page_size=8, shared_prefix=(5, 6, 7),
                             prefill_chunk=4),
            collect_logits=True, device=dev)
        st = eng.run(reqs)
        out[dev] = ({f.req.rid: f for f in st["finished"]},
                    st["wire_bytes"], st["page_copies"], st["prefix_hits"])
    for rid, f in out["cpu"][0].items():
        np.testing.assert_array_equal(out["cuda"][0][rid].tokens, f.tokens)
        np.testing.assert_allclose(out["cuda"][0][rid].logits, f.logits,
                                   atol=1e-4, rtol=1e-4)
    assert out["cuda"][1:] == out["cpu"][1:]


@pytest.mark.parametrize("N,V,aligned", [
    (16, 100, True), (7, 1, True), (5, 13, True), (3, 1031, False),
    (64, 4099, False), (2, 152064, True)])
def test_el2n_kernel_matches_one_pass_plain(gen, N, V, aligned):
    """Held to the one-pass plain form within 1e-5; labels in the first and
    last column; rows read through a stride whose pointers are not 16-byte
    aligned when `aligned` is False."""
    from repro_torch.kernels.el2n import ref
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    from repro_torch.kernels.el2n.ops import el2n_scores
    base = 3.0 * torch.randn((N, V + 3), generator=gen, device="cuda")
    logits = base[:, :V] if aligned else base[:, 1:V + 1]
    labels = torch.randint(0, V, (N,), generator=gen, device="cuda")
    labels[0], labels[-1] = 0, V - 1
    n = el2n_fwd.launches
    e, c = el2n_scores(logits, labels)
    torch.cuda.synchronize()
    assert el2n_fwd.launches == n + 1
    we, wc = ref.fused_scores(logits, labels)
    torch.testing.assert_close(e, we, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(c, wc, atol=1e-5, rtol=1e-5)
    me, mc = ref.el2n_scores(logits, labels)
    torch.testing.assert_close(c, mc, atol=1e-5, rtol=1e-5)
    # the materialized form only where p_y is not near 1 (there the
    # one-pass identity cancels, up to about sqrt(1e-7) in EL2N)
    py = torch.softmax(logits, -1).gather(1, labels.long()[:, None])[:, 0]
    ok = py < 0.99
    torch.testing.assert_close(e[ok], me[ok], atol=1e-5, rtol=1e-5)


def test_el2n_kernel_near_certain_rows(gen):
    from repro_torch.kernels.el2n import ref
    from repro_torch.kernels.el2n.ops import el2n_scores
    logits = torch.zeros((4, 50), device="cuda")
    labels = torch.tensor([0, 7, 49, 20], device="cuda")
    logits[torch.arange(4), labels] = torch.tensor([30.0, 40.0, 25.0, 60.0],
                                                   device="cuda")
    e, c = el2n_scores(logits, labels)
    we, wc = ref.fused_scores(logits, labels)
    assert (e >= 0).all()
    torch.testing.assert_close(e, we, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(c, wc, atol=1e-5, rtol=1e-5)
    bad = el2n_scores(logits, torch.tensor([0, 50, -1, 3], device="cuda"))
    assert torch.isnan(bad[0][1:3]).all() and torch.isfinite(bad[0][0])


# Each layout of the EL2N kernel forced through `plan=` at its boundaries
# (plan, N, V): the warp at V 100, at its limit of 1024 and with 64-thread
# blocks; a block of 512 and of 256 one past the warp's limit, at it, at
# an LM vocabulary and past 65536, and a block whose threads mostly get no
# column. Row forms (pad, offset): dense rows, rows padded to a multiple of
# 8 values (every row 16-byte aligned, V not a multiple of a load), a
# stride of V + 3 (row 0 aligned), and that stride one value in.
EL2N_PLAN_CASES = [
    (("warp", 256), 16, 100), (("warp", 256), 9, 1024),
    (("warp", 64), 5, 1000), (("block", 512), 9, 1025),
    (("block", 256), 7, 1024), (("block", 512), 2, 152064),
    (("block", 256), 3, 1025), (("block", 256), 5, 65537),
    (("block", 512), 2, 152064 + 5), (("block", 64), 4, 13),
    (("block", 512), 4, 13)]
EL2N_ROW_FORMS = {"dense": (0, 0), "pad8": (None, 0), "stride+3": (3, 0),
                  "offset": (3, 1)}


@pytest.mark.parametrize("form", list(EL2N_ROW_FORMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("plan,N,V", EL2N_PLAN_CASES)
def test_el2n_kernel_every_layout(gen, plan, N, V, dtype, form):
    """Within 1e-5 (1 + |plain|) of the one-pass plain form in the layout
    forced and in the one `el2n_plan` picks, labels at columns 0 and
    V - 1."""
    from repro_torch.kernels.el2n import ref
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    pad, off = EL2N_ROW_FORMS[form]
    pad = (-V) % 8 + 8 if pad is None else pad
    base = _bf16((N, V + pad), gen, scale=3.0, dtype=getattr(torch, dtype))
    logits = base[:, off:off + V]
    labels = torch.randint(0, V, (N,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[0], labels[-1] = 0, V - 1
    we, wc = ref.fused_scores(logits, labels)
    for p in (plan, None):
        n = el2n_fwd.launches
        e, c = el2n_fwd(logits, labels, p)
        torch.cuda.synchronize()
        assert el2n_fwd.launches == n + 1
        assert e.dtype == c.dtype == torch.float32
        torch.testing.assert_close(e, we, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(c, wc, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("plan,V", [(("warp", 256), 50),
                                    (("block", 512), 1100),
                                    (("block", 256), 50)])
def test_el2n_kernel_every_layout_near_certain_and_bad_labels(gen, plan, V):
    """Near-certain rows stay >= 0 and within 1e-5 of the one-pass form in
    every layout; -inf logits add nothing; a row of -inf alone gives NaN in
    both outputs, as the plain form; a label outside [0, V) gives NaN in
    its row alone."""
    from repro_torch.kernels.el2n import ref
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    logits = torch.zeros((4, V), device="cuda")
    labels = torch.tensor([0, 7, V - 1, 20], dtype=torch.int32,
                          device="cuda")
    logits[torch.arange(4), labels.long()] = torch.tensor(
        [30.0, 40.0, 25.0, 60.0], device="cuda")
    logits[3, 30:40] = -torch.inf
    e, c = el2n_fwd(logits, labels, plan)
    we, wc = ref.fused_scores(logits, labels)
    assert (e >= 0).all() and torch.isfinite(c).all()
    torch.testing.assert_close(e, we, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(c, wc, atol=1e-5, rtol=1e-5)
    bad = torch.tensor([0, V, -1, 3], dtype=torch.int32, device="cuda")
    e, c = el2n_fwd(logits, bad, plan)
    assert torch.isnan(e[1:3]).all() and torch.isnan(c[1:3]).all()
    assert torch.isfinite(e[[0, 3]]).all() and torch.isfinite(c[[0, 3]]).all()
    logits[1] = -torch.inf
    e, c = el2n_fwd(logits, labels, plan)
    we, wc = ref.fused_scores(logits, labels)
    assert torch.isnan(we[1]) and torch.isnan(wc[1])
    assert torch.isnan(e[1]) and torch.isnan(c[1])
    keep = [0, 2, 3]
    torch.testing.assert_close(e[keep], we[keep], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(c[keep], wc[keep], atol=1e-5, rtol=1e-5)


def test_el2n_wrapper_refuses_bad_plans(gen):
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    logits = torch.randn((4, 1100), generator=gen, device="cuda")
    labels = torch.zeros(4, dtype=torch.int32, device="cuda")
    for plan in (("warp", 256), ("cluster", 512), ("block", 48),
                 ("block", 1024)):
        with pytest.raises(ValueError):
            el2n_fwd(logits, labels, plan)


def test_wrappers_refuse_inputs_that_require_grad(gen):
    """A kernel has no backward: with grad mode on, an input that requires
    grad raises instead of returning an output with no grad_fn. Under
    no_grad, and inside the wire codec's autograd roundtrip, they launch."""
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    from repro_torch.kernels.flash_attention.decode import (
        decode_attention_fwd, paged_decode_attention_fwd)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.quant.kernel import dequantize_fwd, quantize_fwd
    from repro_torch.runtime.codec import get_codec
    x = torch.randn((4, 8), device="cuda", requires_grad=True)
    u = torch.full((4, 8), 0.5, device="cuda")
    q = torch.randn((1, 4, 2, 8), device="cuda", requires_grad=True)
    qp = torch.zeros(1, dtype=torch.int32, device="cuda")
    kvp = torch.zeros((1, 4), dtype=torch.int32, device="cuda")
    tables = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    pool_pos = torch.zeros((1, 4), dtype=torch.int32, device="cuda")
    labels = torch.zeros(4, dtype=torch.int32, device="cuda")
    calls = [
        lambda: quantize_fwd(x, u),
        lambda: dequantize_fwd(torch.zeros((4, 8), dtype=torch.int8,
                                           device="cuda"),
                               torch.ones((4, 1), device="cuda",
                                          requires_grad=True)),
        lambda: flash_attention_fwd(q, q, q, causal=True,
                                    sliding_window=None, softcap=None,
                                    scale=1.0, kv_len=4),
        lambda: decode_attention_fwd(q[:, :1], q, q, qp, kvp, scale=1.0,
                                     sliding_window=None, softcap=None),
        lambda: paged_decode_attention_fwd(q[:, :1], q, q, tables, qp,
                                           pool_pos, scale=1.0,
                                           sliding_window=None,
                                           softcap=None),
        lambda: el2n_fwd(x, labels),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()
    y = get_codec("int8").roundtrip(x, u, u)
    y.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_training_round_on_card_matches_cpu(gen):
    """One SFPrompt round of the reduced ViT on the card and on the CPU from
    the same weights and data, fp32 wire: bytes and kept_frac ==, params
    within 1e-4; the card's scoring pass launched the EL2N kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core import (ProtocolConfig, SFPromptTrainer,
                                  SplitConfig, SplitModel)
    from repro_torch.data import (DATASETS, iid_partition, stack_clients,
                                  synthetic_image_dataset)
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    from repro_torch.runtime import WireSpec
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("vit-base").reduced(n_layers=3, d_model=64, d_ff=128)
    model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=4, prune_gamma=0.5),
                       WireSpec.make("fp32"))
    pcfg = ProtocolConfig(clients_per_round=2, local_epochs=1, batch_size=8)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    data = synthetic_image_dataset(DATASETS["cifar10-syn"], 48, seed=0,
                                   image_hw=32)
    cohort = stack_clients(iid_partition(data, 2, seed=0), [0, 1])
    out = {}
    for dev in ("cpu", "cuda"):
        tr = SFPromptTrainer(model, pcfg, device=dev)
        n = el2n_fwd.launches
        state, m = tr.round({"params": tree_map(lambda x: x.to(dev),
                                                params), "round": 0}, cohort)
        out[dev] = (state, m, el2n_fwd.launches - n)
    (sc, mc, lc), (sg, mg, lg) = out["cpu"], out["cuda"]
    assert lc == 0 and lg > 0
    for key in mc:
        if key.startswith(("wire/", "cohort/")) or key == "kept_frac":
            assert mg[key] == mc[key], key
    for a, b in zip(tree_leaves(sg["params"]), tree_leaves(sc["params"])):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


def _ring_case(n, seed):
    """Values on the card with round-half-even ties, saturating values and
    -0.0 at the front, and seeds including 0 and 0xFFFFFFFF."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n,), generator=g, device="cuda") * 3
    u = 2.0 ** -16
    edge = torch.tensor([0.5 * u, -0.5 * u, 1.5 * u, -1.5 * u, -0.0, 4e4,
                         -4e4, 32767.99], device="cuda")
    x[:edge.numel()] = edge
    seeds = torch.tensor([0, 0xFFFFFFFF, 12345, 0xDEADBEEF])
    signs = torch.tensor([1, -1, 0, 1], dtype=torch.int32)
    return x, seeds, signs


@pytest.mark.parametrize("n", [128, 128 * 7, 70016])
def test_masked_encode_kernel_bit_equal(gen, n):
    from repro_torch.kernels.secure_mask import ref
    from repro_torch.kernels.secure_mask.kernel import masked_encode_fwd
    from repro_torch.kernels.secure_mask.ops import masked_encode
    x, seeds, signs = _ring_case(n, n)
    before = masked_encode_fwd.launches
    got = masked_encode(x, seeds, signs)
    assert masked_encode_fwd.launches == before + 1
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got, ref.masked_encode(x, seeds, signs))
    # the same bits on the CPU
    assert torch.equal(got.cpu(), ref.masked_encode(x.cpu(), seeds, signs))


def test_summed_mask_kernel_bit_equal(gen):
    from repro_torch.kernels.secure_mask import ref
    from repro_torch.kernels.secure_mask.ops import summed_mask
    from repro_torch.privacy.masking import pair_seeds, recovery_pairs
    k, n = 4, 128 * 33
    seeds = pair_seeds((3, 5), k)
    ri, rj = recovery_pairs(k)
    alive = np.array([1, 0, 1, 1])
    signs = np.sign(rj - ri) * alive[ri] * (1 - alive[rj])
    got = summed_mask(seeds[ri, rj], signs, n, device="cuda")
    assert torch.equal(got.cpu(), ref.summed_mask(seeds[ri, rj], signs, n))
    with pytest.raises(ValueError):
        summed_mask(seeds[ri, rj], signs, 130, device="cuda")


@pytest.mark.parametrize("weights", [[3.0, 2.0, 7.0, 1.0],
                                     [3.0, 0.0, 7.0, 1.0],
                                     [0.0, 0.0, 0.0, 0.0]])
def test_secure_aggregator_on_card_equals_cpu(gen, weights):
    from repro_torch.kernels.secure_mask.kernel import masked_encode_fwd
    from repro_torch.privacy.secure_agg import SecureAggregator
    from repro_torch.tree import tree_flatten, tree_map
    g = torch.Generator().manual_seed(1)
    tree = {"tail": {"w": torch.randn((4, 33, 7), generator=g)},
            "prompt": torch.randn((4, 5, 16), generator=g)}
    fb = tree_map(lambda x: torch.full_like(x[0], 0.5), tree)
    agg = SecureAggregator(seed=9)
    w = torch.tensor(weights)
    cpu, cpu_wire = agg.aggregate(tree, w, fb, 2)
    before = masked_encode_fwd.launches
    card, card_wire = agg.aggregate(tree_map(lambda x: x.cuda(), tree),
                                    w.cuda(), tree_map(lambda x: x.cuda(),
                                                       fb), 2)
    dropped = any(x == 0 for x in weights)
    assert masked_encode_fwd.launches == before + 4 + int(dropped)
    assert card_wire == cpu_wire
    for (pa, a), (pb, b) in zip(tree_flatten(card), tree_flatten(cpu)):
        assert pa == pb and torch.equal(a.cpu(), b)


# ------------------------------------------------------------ recurrent scans
SCAN_TOL = 2e-5   # |kernel - plain| <= SCAN_TOL (1 + |plain|): other sum order


def _scan_close(got, want):
    err = (got - want).abs() / (1.0 + want.abs())
    return bool(torch.isfinite(got).all()) and float(err.max()) <= SCAN_TOL


@pytest.mark.parametrize("B,T,H,P,N,G,h0,strided", [
    (2, 1, 4, 16, 8, 1, False, False),
    (2, 37, 8, 16, 8, 2, True, False),
    (1, 65, 8, 32, 16, 4, True, True),
    (3, 100, 4, 64, 64, 1, True, True),
    (1, 33, 2, 8, 100, 2, False, False),     # N not a power of two
    # both sides of the step / chunked crossover and the chunk edges, at
    # zamba2's heads (P = N = 64) and with P 8, N 100 and N 200 (the
    # chunked kernel at T 1: the step kernel takes N <= 128)
    (8, 1, 16, 64, 64, 1, True, False),
    (2, 2, 8, 64, 64, 1, True, False),
    (2, 16, 8, 64, 64, 1, True, True),
    (1, 63, 8, 64, 64, 1, True, False),
    (1, 64, 8, 64, 64, 1, False, False),
    (1, 65, 8, 64, 64, 1, True, False),
    (1, 132, 16, 64, 64, 1, True, True),
    (2, 2, 2, 8, 100, 2, True, False),
    (1, 1, 2, 8, 100, 2, True, False),
    (2, 1, 4, 32, 200, 2, True, False),
    (1, 70, 4, 40, 200, 1, True, False),
    # N above 328: the chunked kernel with one stage of inputs
    (1, 70, 4, 32, 400, 1, True, False),
    (2, 1, 2, 16, 512, 2, True, True),
])
@pytest.mark.parametrize("aliased", [False, True])
def test_mamba2_kernel_matches_plain(gen, B, T, H, P, N, G, h0, strided,
                                     aliased):
    """Both kernels within SCAN_TOL of the sequential plain version; with
    `aliased` the final state is written over the input state, as
    `apply_mamba2` passes its cache."""
    from repro_torch.kernels.mamba2_scan import ref
    from repro_torch.kernels.mamba2_scan.ops import mamba2_scan
    x = torch.randn((B, T, H * P + 3), generator=gen, device="cuda")
    x = x[..., 3:].reshape(B, T, H, P) if strided \
        else x[..., :H * P].contiguous().reshape(B, T, H, P)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((H,), generator=gen, device="cuda"))
    bc = torch.randn((B, T, 2, G, N), generator=gen, device="cuda")
    Bm, Cm = bc[:, :, 0], bc[:, :, 1]                 # strided views
    state = (torch.randn((B, H, P, N), generator=gen, device="cuda")
             if h0 else None)
    ry, rh = ref.mamba2_scan(x, dt, A, Bm, Cm, state)
    out = None
    if aliased:
        out = state if state is not None else torch.full(
            (B, H, P, N), float("nan"), device="cuda")
    y, h = mamba2_scan(x, dt, A, Bm, Cm, state, state_out=out)
    torch.cuda.synchronize()
    assert y.shape == (B, T, H, P) and h.shape == (B, H, P, N)
    assert out is None or h is out
    assert _scan_close(y, ry) and _scan_close(h, rh)


def _rwkv6_inputs(gen, B, T, H, K, V, s0, decay, dtypes=None):
    """r, k, v, w, u and the state; `dtypes` (r, k, v, w, u, state) casts
    each (f32 by default)."""
    dts = dtypes or (torch.float32,) * 6
    r, k = (torch.randn((B, T, H, K), generator=gen, device="cuda")
            for _ in range(2))
    v = torch.randn((B, T, H, V), generator=gen, device="cuda")
    w = (torch.full((B, T, H, K), decay, device="cuda") if decay is not None
         else -torch.exp(torch.randn((B, T, H, K), generator=gen,
                                     device="cuda")))
    u = torch.randn((H, K), generator=gen, device="cuda")
    state = (torch.randn((B, H, K, V), generator=gen, device="cuda")
             if s0 else None)
    out = [t.to(d) for t, d in zip((r, k, v, w, u), dts)]
    return out + [None if state is None else state.to(dts[5])]


@pytest.mark.parametrize("B,T,H,K,V,s0,decay", [
    (2, 1, 2, 16, 16, True, None),
    (2, 37, 3, 16, 16, False, None),
    (1, 100, 2, 64, 64, True, None),
    (2, 65, 2, 40, 48, True, None),          # K not a multiple of 16
    (1, 96, 1, 8, 8, False, -12.0),          # strong decay stays finite
    # both sides of the step / chunked crossover (T 1-5) and the chunk
    # edges (31-33, 65), at rwkv6-3b's heads (K = V = 64) and with V 16,
    # 48 and 96 (two step blocks, three chunk blocks) and K 16
    (8, 1, 8, 64, 64, True, None),
    (2, 2, 4, 64, 64, True, None),
    (2, 3, 4, 16, 48, True, None),
    (1, 4, 4, 64, 96, True, None),
    (2, 5, 4, 64, 64, True, None),
    (1, 31, 4, 64, 64, True, None),
    (1, 32, 4, 16, 96, False, None),
    (2, 33, 4, 64, 16, True, None),
    (1, 65, 4, 64, 64, True, -12.0),
    (1, 132, 8, 64, 64, True, None),
])
@pytest.mark.parametrize("aliased", [False, True])
def test_rwkv6_kernel_matches_plain(gen, B, T, H, K, V, s0, decay, aliased):
    """Both kernels within SCAN_TOL of the sequential plain version; with
    `aliased` the final state is written over the input state, as
    `apply_rwkv6` passes its cache."""
    from repro_torch.kernels.rwkv6_scan import ref
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    r, k, v, w, u, state = _rwkv6_inputs(gen, B, T, H, K, V, s0, decay)
    ry, rS = ref.rwkv6_scan(r, k, v, w, u, state)
    out = None
    if aliased:
        out = state if state is not None else torch.full(
            (B, H, K, V), float("nan"), device="cuda")
    y, S = rwkv6_scan(r, k, v, w, u, state, state_out=out)
    torch.cuda.synchronize()
    assert y.shape == (B, T, H, V) and S.shape == (B, H, K, V)
    assert out is None or S is out
    assert _scan_close(y, ry) and _scan_close(S, rS)


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("cols", [16, 32])
def test_rwkv6_chunk_shapes_match_plain(gen, monkeypatch, chunk, cols):
    """Every chunk-kernel shape chip_smoke.py sweeps (chunks of 32 and 64
    steps, blocks of 16 and 32 state columns), at f32, within SCAN_TOL."""
    from repro_torch.kernels.rwkv6_scan import kernel as KR
    from repro_torch.kernels.rwkv6_scan import ref
    monkeypatch.setattr(KR, "CHUNK", chunk)
    monkeypatch.setattr(KR, "COLS", cols)
    for B, T, H, K, V, decay in ((1, 132, 4, 64, 64, None),
                                 (2, 70, 2, 40, 48, None),
                                 (1, 100, 2, 64, 96, -12.0)):
        args = _rwkv6_inputs(gen, B, T, H, K, V, True, decay)
        y, S = KR.rwkv6_fwd(*args)
        ry, rS = ref.rwkv6_scan(*args)
        assert _scan_close(y, ry) and _scan_close(S, rS), (B, T, K, V)


@pytest.mark.parametrize("T", [1, 37])
@pytest.mark.parametrize("dtypes", [
    # r, k, v, w, u, state
    (torch.float32, torch.bfloat16, torch.float16, torch.bfloat16,
     torch.float16, torch.bfloat16),
    (torch.float16, torch.float32, torch.bfloat16, torch.float32,
     torch.float32, torch.float16),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32,
     torch.float32, torch.float32),
])
def test_rwkv6_kernel_matches_plain_mixed_dtypes(gen, T, dtypes):
    """Each input in a dtype of its own, as the JAX op takes them (each
    read with astype(f32)), through the step (T 1) and the chunked kernel;
    the last mix is the serving path's (the typed build)."""
    from repro_torch.kernels.rwkv6_scan import ref
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    args = _rwkv6_inputs(gen, 2, T, 4, 16, 16, True, None, dtypes)
    y, S = rwkv6_scan(*args)
    ry, rS = ref.rwkv6_scan(*args)
    assert y.dtype == dtypes[0] and S.dtype == torch.float32
    if dtypes[0] == torch.float32:
        assert _scan_close(y, ry)
    else:
        _close_bf16(y, ry)
    assert _scan_close(S, rS)


def test_scan_wrappers_refuse_grad_and_bad_inputs(gen):
    from repro_torch.kernels.mamba2_scan.kernel import mamba2_fwd
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_fwd
    x = torch.randn((1, 3, 2, 4), device="cuda", requires_grad=True)
    dt = torch.ones((1, 3, 2), device="cuda")
    A = -torch.ones((2,), device="cuda")
    bm = torch.randn((1, 3, 1, 4), device="cuda")
    r = torch.randn((1, 3, 2, 4), device="cuda", requires_grad=True)
    u = torch.zeros((2, 4), device="cuda")
    calls = [lambda: mamba2_fwd(x, dt, A, bm, bm),
             lambda: rwkv6_fwd(r, r, r, -r.detach().exp(), u)]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()
    with torch.no_grad():
        with pytest.raises(ValueError, match="G must divide H"):
            mamba2_fwd(x, dt, A, torch.zeros((1, 3, 3, 4), device="cuda"),
                       torch.zeros((1, 3, 3, 4), device="cuda"))
        with pytest.raises(ValueError, match="K <= 64"):
            big = torch.zeros((1, 2, 1, 65), device="cuda")
            rwkv6_fwd(big, big, big, big, torch.zeros((1, 65), device="cuda"))
        with pytest.raises(ValueError, match="N <= 568"):
            wide = torch.zeros((1, 8, 1, 576), device="cuda")
            mamba2_fwd(torch.zeros((1, 8, 2, 4), device="cuda"),
                       torch.ones((1, 8, 2), device="cuda"), A, wide, wide)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-3b"])
def test_recurrent_engine_on_card_matches_cpu(gen, arch):
    """The reduced family served by the dense engine on the card and on the
    CPU from the same weights: tokens equal, logits within 1e-4, and the
    scan kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import personalized_bank
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (ServeConfig, ServeEngine, TenantBank,
                                   WorkloadConfig, synthetic_requests)
    from repro_torch.tree import tree_map
    cfg = get_config(arch).reduced(n_layers=3 * (6 if "zamba" in arch
                                                 else 1),
                                   d_model=64, d_ff=128, vocab_size=128)
    model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=4), WireSpec.make("fp32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    bank = personalized_bank(model, params, 2, jitter=0.2)
    reqs = synthetic_requests(WorkloadConfig(
        n_requests=5, prompt_choices=(5, 12), new_token_choices=(3, 6),
        n_tenants=2, vocab_size=cfg.vocab_size, seed=2))
    runs = {}
    reset_launches()
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(
            model, tree_map(lambda x: x.to(dev), params),
            TenantBank(tree_map(lambda x: x.to(dev), bank.tails),
                       bank.prompts.to(dev)),
            ServeConfig(n_slots=2, max_seq=32, decode_block=3),
            collect_logits=True, device=dev)
        st = eng.run(reqs)
        runs[dev] = ({f.req.rid: f for f in st["finished"]},
                     st["wire_bytes"])
    scan = "mamba2_scan" if "zamba" in arch else "rwkv6_scan"
    assert launch_counts()[scan] > 0
    assert runs["cpu"][1] == runs["cuda"][1]
    for rid, f in runs["cpu"][0].items():
        g = runs["cuda"][0][rid]
        assert (f.tokens == g.tokens).all()
        assert float(abs(f.logits - g.logits).max()) <= 1e-4


# ------------------------------------------------------------------- bf16
BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # the JAX kernel tests' bf16 tolerance


# f16 keeps 11 significant bits: the kernel and plain round the same f32
# value once each, so they differ by an f16 ulp at most (2^-10 relative)
F16_TOL = dict(atol=2e-3, rtol=2e-3)
HALF_TOL = {torch.bfloat16: BF16_TOL, torch.float16: F16_TOL}


def _close_bf16(got, want):
    """Both bf16 (or both f16), finite, within BF16_TOL (F16_TOL): the
    kernel and plain round the same f32 value, computed in different
    orders."""
    assert got.dtype == want.dtype and want.dtype in HALF_TOL
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(),
                               **HALF_TOL[want.dtype])


def _bf16(shape, gen, offset=0, scale=1.0, dtype=torch.bfloat16):
    """bf16 (or `dtype`) normals; `offset` values into their storage
    (2-byte steps)."""
    n = int(np.prod(shape))
    x = (scale * torch.randn(n + offset, generator=gen, device="cuda")
         ).to(dtype)
    return x[offset:].view(shape)


@pytest.mark.parametrize("shape", [(3, 7), (37, 160), (130, 5120)])
def test_quant_kernels_bit_equal_bf16(gen, shape):
    """bf16 x quantizes to the plain version's payload and scales, and the
    payload dequantizes to bf16 bit for bit."""
    _quant_half(gen, shape, torch.bfloat16)


@pytest.mark.parametrize("shape", [(3, 7), (37, 160), (130, 5120)])
def test_quant_kernels_bit_equal_f16(gen, shape):
    _quant_half(gen, shape, torch.float16)


def _quant_half(gen, shape, dtype):
    from repro_torch.kernels.quant import ref
    from repro_torch.kernels.quant.kernel import dequantize_fwd, quantize_fwd
    from repro_torch.kernels.quant.ops import dequantize_int8, quantize_int8
    x = _bf16(shape, gen, scale=4.0, dtype=dtype)
    for u in (0.5, torch.rand(shape, generator=gen, device="cuda")):
        nq, nd = quantize_fwd.launches, dequantize_fwd.launches
        v, s = quantize_int8(x, u)
        d = dequantize_int8(v, s, dtype=dtype)
        assert (quantize_fwd.launches, dequantize_fwd.launches) == \
            (nq + 1, nd + 1)
        rv, rs = ref.quantize(x, u)
        assert torch.equal(v, rv) and torch.equal(s, rs)
        assert d.dtype == dtype
        assert torch.equal(d, ref.dequantize(v, s, dtype))


# Head dims 8 mod 16 (a last 16-byte group of the row wholly past Dh), in
# each narrow instantiation the card probe found loading it: 24, 72, 136,
# 152 (and 40 above), aligned and off 16 bytes
PAST_DH_CASES = [
    (2, 70, 4, 2, 24, True, None, None, None, 0),
    (1, 129, 8, 4, 72, True, 16, None, 100, 0),
    (1, 66, 6, 3, 136, True, None, 30.0, None, 0),
    (2, 64, 4, 4, 152, False, None, None, None, 0),
    (1, 50, 4, 2, 72, True, None, None, None, 1),
    (1, 40, 4, 4, 136, True, None, None, None, 1),
]


# The 16-bit kernel's own cases: (..., offset, Dv, rows, q_layout). Values
# narrower than the keys (MLA's 192 / 128), rows that every key masks (a
# window ending before kv_len: rows from kv_len + window - 1 on average
# every key), each row count the plan can choose in the narrow (keys split
# between a pair of warps) and wide (columns split) layouts, and q strided
# (heads-major, a fused qkv tensor, and one value off 16 bytes)
PREFILL_16_CASES = [
    (2, 77, 24, 2, 192, True, 16, 50.0, None, 0, 128, None, None),
    (1, 77, 4, 2, 192, True, None, None, 60, 1, 128, 16, None),
    (1, 100, 4, 2, 64, True, 8, None, 40, 0, None, None, None),
    (1, 90, 8, 4, 256, True, 8, 30.0, 30, 0, None, 32, None),
    (1, 129, 6, 3, 160, False, 12, None, 50, 0, None, 16, None),
    *((1, 100, 8, 2, 128, True, None, None, None, 0, None, r, None)
      for r in (64, 32, 16)),
    *((2, 77, 8, 4, 256, True, 16, 50.0, None, 0, None, r, None)
      for r in (64, 32, 16)),
    *((1, 70, 6, 2, 80, False, None, None, 50, 0, None, r, None)
      for r in (64, 32, 16)),
    (1, 132, 40, 8, 128, True, None, None, None, 0, None, None, "transposed"),
    (2, 65, 8, 2, 256, True, 20, None, None, 0, None, 32, "transposed"),
    (1, 70, 10, 2, 64, True, None, None, 60, 0, None, None, "fused"),
    (1, 70, 10, 2, 64, True, None, None, 60, 1, None, 16, "fused"),
]


# The narrow f32 layout's own cases (head dims up to 160): (..., offset,
# Dv, rows, q_layout, splits, group, Skv). Every row count and every split
# count 1-8 forced over a long key axis (whisper's cross-attention: Sq 1
# and 64, non-causal, kv_len short of Skv), one head a block and the GQA
# group (G 4, 5, 8) at every row count, ragged Sq, rows that every key
# masks (a window ending before kv_len) under a split, q heads-major and
# from a fused qkv tensor, and one value off 16 bytes (4-byte copies).
PREFILL_F32_NARROW_CASES = [
    *((2, 1, 8, 2, 64, False, None, None, 650, 0, None, r, None, n, 4, 700)
      for r in (64, 32, 16) for n in range(1, 9)),
    *((2, 64, 8, 2, 64, False, None, 30.0, 650, 0, None, r, None, n, g, 700)
      for r in (64, 32, 16) for n in (1, 3, 8) for g in (1, 4)),
    *((1, 100, 10, 2, 128, True, None, None, 70, 0, None, r, None, n, g)
      for r in (64, 32, 16) for n in (1, 2) for g in (1, 5)),
    *((2, 77, 16, 2, 128, True, 16, 20.0, None, 0, None, r, None, 3, g)
      for r in (64, 32, 16) for g in (1, 8)),
    *((1, 120, 8, 1, 64, True, 8, None, 40, 0, None, r, None, n, g)
      for r in (64, 32, 16) for n in (1, 8) for g in (1, 8)),
    *((1, 133, 32, 8, 160, True, None, None, None, 0, None, r, None, 1, g)
      for r in (64, 32, 16) for g in (1, 4)),
    *((2, S, 6, 2, 80, True, None, None, None, 0, None, 16, None, 1, 3)
      for S in (1, 17, 33, 65, 129)),
    (1, 90, 8, 2, 80, False, None, None, None, 1, None, 32, None, 4, 4,
     600),
    (2, 50, 6, 2, 40, True, 12, None, None, 1, None, 16, None, 2, 3),
    (2, 65, 8, 2, 64, True, None, None, None, 0, None, 16, "transposed", 2,
     4),
    (1, 70, 10, 2, 160, True, None, None, 60, 0, None, 32, "fused", 1, 5),
    (1, 33, 8, 8, 32, False, None, None, None, 1, None, 64, "fused", 5, 1,
     900),
]


@pytest.mark.parametrize("case", [
    # (B, Sq, Hq, Hkv, Dh, causal, window, softcap, kv_len, offset)
    (2, 5, 4, 4, 32, True, None, None, None, 0),
    (1, 37, 8, 8, 80, True, None, None, None, 0),     # zamba2's head_dim 80
    (1, 33, 6, 3, 128, True, None, 30.0, 20, 0),
    (2, 77, 6, 3, 20, False, None, None, None, 0),    # 20: single loads
    (16, 213, 12, 12, 64, False, None, None, None, 0),  # ViT-Base scoring
    (2, 50, 6, 2, 64, True, None, None, None, 1),     # one value off 16 B
    (8, 100, 40, 8, 128, True, 32, 30.0, 90, 0),      # every option
    (1, 70, 16, 8, 256, True, 20, 50.0, None, 0),     # gemma2's widths
    (2, 133, 32, 8, 160, True, None, None, None, 0),  # stablelm's
    (1, 100, 24, 2, 192, True, None, None, 80, 1),    # nemotron's, single
    (1, 200, 4, 4, 40, True, 16, None, 60, 0),        # a 16-byte group
    (1, 64, 4, 4, 40, True, None, None, None, 0),     # past Dh, vector loads
    # the other head dims 8 mod 16 of the narrow and the wide layouts,
    # where the 16-bit loader once loaded the group past Dh
    *PAST_DH_CASES,
    *PREFILL_16_CASES,
])
def test_prefill_kernel_matches_plain_bf16(gen, case):
    _prefill_half(gen, case, torch.bfloat16)


# The narrow f32 layout's own cases (head dims up to 160): (..., offset,
# Dv, rows, q_layout, splits, group, Skv). Every row count and every split
# count 1-8 forced over a long key axis (whisper's cross-attention: Sq 1
# and 64, non-causal, kv_len short of Skv), one head a block and the GQA
# group (G 4, 5, 8) at every row count, ragged Sq, rows that every key
# masks (a window ending before kv_len) under a split, q heads-major and
# from a fused qkv tensor, and one value off 16 bytes (4-byte copies).
PREFILL_F32_NARROW_CASES = [
    *((2, 1, 8, 2, 64, False, None, None, 650, 0, None, r, None, n, 4, 700)
      for r in (64, 32, 16) for n in range(1, 9)),
    *((2, 64, 8, 2, 64, False, None, 30.0, 650, 0, None, r, None, n, g, 700)
      for r in (64, 32, 16) for n in (1, 3, 8) for g in (1, 4)),
    *((1, 100, 10, 2, 128, True, None, None, 70, 0, None, r, None, n, g)
      for r in (64, 32, 16) for n in (1, 2) for g in (1, 5)),
    *((2, 77, 16, 2, 128, True, 16, 20.0, None, 0, None, r, None, 3, g)
      for r in (64, 32, 16) for g in (1, 8)),
    *((1, 120, 8, 1, 64, True, 8, None, 40, 0, None, r, None, n, g)
      for r in (64, 32, 16) for n in (1, 8) for g in (1, 8)),
    *((1, 133, 32, 8, 160, True, None, None, None, 0, None, r, None, 1, g)
      for r in (64, 32, 16) for g in (1, 4)),
    *((2, S, 6, 2, 80, True, None, None, None, 0, None, 16, None, 1, 3)
      for S in (1, 17, 33, 65, 129)),
    (1, 90, 8, 2, 80, False, None, None, None, 1, None, 32, None, 4, 4,
     600),
    (2, 50, 6, 2, 40, True, 12, None, None, 1, None, 16, None, 2, 3),
    (2, 65, 8, 2, 64, True, None, None, None, 0, None, 16, "transposed", 2,
     4),
    (1, 70, 10, 2, 160, True, None, None, 60, 0, None, 32, "fused", 1, 5),
    (1, 33, 8, 8, 32, False, None, None, None, 1, None, 64, "fused", 5, 1,
     900),
]


@pytest.mark.parametrize("case", [
    # (B, Sq, Hq, Hkv, Dh, causal, window, softcap, kv_len, offset)
    (2, 5, 4, 4, 32, True, None, None, None, 0),
    (1, 45, 10, 2, 16, True, None, None, None, 0),
    (2, 70, 8, 1, 96, True, 9, None, None, 0),
    (1, 33, 6, 3, 128, True, None, 30.0, 20, 0),
    (1, 64, 10, 2, 64, True, 16, 20.0, 17, 0),
    (2, 21, 4, 2, 16, False, None, None, None, 0),
    (1, 37, 8, 8, 80, True, None, None, None, 0),     # zamba2's head_dim 80
    (16, 213, 12, 12, 64, False, None, None, None, 0),  # ViT-Base scoring
    (1, 1, 4, 2, 64, True, None, None, None, 0),     # Sq ragged over the
    (1, 65, 8, 2, 64, True, 20, None, None, 0),      # 64-row query block
    (2, 129, 4, 1, 32, True, None, 30.0, 100, 0),
    (2, 77, 6, 3, 20, False, None, None, None, 0),   # widths not a multiple
    (1, 200, 4, 4, 40, True, 16, None, 60, 0),       # of 8 (zero-padded)
    (2, 50, 6, 2, 64, True, None, None, None, 1),    # one float off 16-byte
    (1, 90, 4, 4, 40, False, 24, 10.0, None, 1),     # alignment: 4-byte copies
    (1, 100, 10, 2, 128, True, None, None, 70, 0),   # GQA 5, kv_len < Sq
    (8, 100, 40, 8, 128, True, 32, 30.0, 90, 0),     # batched, with every
    (4, 129, 24, 8, 40, True, None, None, 100, 1),   # option at once
    # the wide head dims: gemma2's 256 (G 2, window, softcap 50),
    # stablelm's 160 (G 4), nemotron's 192 (G 12), 176 (an odd number of
    # 16-column pairs), 4-byte copies and a non-causal call at 256
    (1, 70, 16, 8, 256, True, 20, 50.0, None, 0),
    (2, 133, 32, 8, 160, True, None, None, None, 0),
    (1, 100, 24, 2, 192, True, None, None, 80, 0),
    (1, 200, 8, 4, 176, True, 16, None, 60, 0),
    (2, 65, 4, 2, 256, False, None, None, None, 1),
    (1, 90, 12, 1, 192, True, 24, 10.0, None, 1),
    *PAST_DH_CASES,
    *PREFILL_16_CASES,
])
def test_prefill_kernel_matches_plain_f16(gen, case):
    _prefill_half(gen, case, torch.float16)


def _prefill_half(gen, case, dtype):
    """One case, (B, Sq, Hq, Hkv, Dh, causal, window, softcap, kv_len,
    offset) and optionally (Dv, rows, q_layout): values Dv wide (default
    Dh), the plan forced to `rows` query rows a block, q heads-major
    ("transposed": a (B, Hq, Sq, Dh) tensor's transpose) or taken from a
    fused qkv tensor ("fused")."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, prefill_plan)
    from repro_torch.kernels.flash_attention.ops import prefill_attention
    B, S, Hq, Hkv, Dh, causal, window, softcap, kv_len, offset = case[:10]
    Dv, rows, q_layout = tuple(case[10:]) + (None,) * (13 - len(case))
    Dv = Dv or Dh
    if q_layout == "transposed":
        q = _bf16((B, Hq, S, Dh), gen, offset, dtype=dtype).transpose(1, 2)
    elif q_layout == "fused":
        q = _bf16((B, S, 2 * Hq, Dh), gen, offset, dtype=dtype)[:, :, Hq:]
    else:
        q = _bf16((B, S, Hq, Dh), gen, offset, dtype=dtype)
    if Dv == Dh:
        kv = _bf16((B, S, 2 * Hkv, Dh), gen, offset, dtype=dtype)
        k, v = kv[:, :, :Hkv], kv[:, :, Hkv:]       # strided views
    else:
        k = _bf16((B, S, Hkv, Dh), gen, offset, dtype=dtype)
        v = _bf16((B, S, Hkv, Dv), gen, offset, dtype=dtype)
    n = flash_attention_fwd.launches
    L = kv_len or S
    if rows is None:
        got = prefill_attention(q, k, v, causal=causal,
                                sliding_window=window, softcap=softcap,
                                kv_len=kv_len)
    else:
        plan = prefill_plan(B, S, Hq, Dh, Dv, 2)._replace(rows=rows)
        got = flash_attention_fwd(q, k, v, causal=causal,
                                  sliding_window=window, softcap=softcap,
                                  scale=Dh ** -0.5, kv_len=L, plan=plan)
    assert flash_attention_fwd.launches == n + 1
    assert got.shape == (B, S, Hq, Dv)
    _close_bf16(got, ref.attention(q, k[:, :L], v[:, :L], causal=causal,
                                   sliding_window=window, softcap=softcap))


def _kernel_names(fn, pad=8):
    """The names of the CUDA kernels `fn` launches, in order, from one
    torch.profiler session. `pad` one-value fills run before and after it
    and are left out: a trace can lose a few events at its ends (as
    chip_smoke.device_ms_cases finds), and a lost fill costs nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    marker = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            marker.fill_(0.0)
        fn()
        for _ in range(pad):
            marker.fill_(0.0)
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and "FillFunctor" not in e.name]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,Hq,Hkv,Dh,Dv,window,softcap", [
    (1, 132, 40, 8, 128, 128, None, None),    # Qwen2.5-14B
    (1, 132, 32, 32, 80, 80, None, None),     # zamba2
    (1, 132, 16, 8, 256, 256, None, 50.0),    # gemma2-9b
    (1, 132, 32, 8, 160, 160, None, None),    # stablelm-12b
    (2, 77, 24, 2, 192, 128, 16, 50.0),       # MLA's widths
])
def test_prefill_16_bit_kernel_is_f32_accurate(gen, dtype, B, S, Hq, Hkv, Dh,
                                               Dv, window, softcap):
    """The 16-bit kernel keeps the f32 kernel's accuracy: the share of
    its output values that differ from plain (the f32 function rounded
    once) is at most that of the f32 kernel's output on the widened
    inputs, rounded once to the same dtype, plus 0.5 percentage points.
    And the call runs the 16-bit kernel alone (the profiler's names)."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.ops import prefill_attention
    q = _bf16((B, S, Hq, Dh), gen, dtype=dtype)
    k = _bf16((B, S, Hkv, Dh), gen, dtype=dtype)
    v = _bf16((B, S, Hkv, Dv), gen, dtype=dtype)
    kw = dict(causal=True, sliding_window=window, softcap=softcap)
    want = ref.attention(q, k, v, **kw)
    out = []
    names = set(_kernel_names(
        lambda: out.append(prefill_attention(q, k, v, **kw))))
    got = out[0]
    assert any("flash16_kernel" in x for x in names), names
    assert not any("flash_fwd" in x for x in names), names
    f32 = prefill_attention(q.float(), k.float(), v.float(), **kw).to(dtype)
    _close_bf16(got, want)

    def share(x):
        return float((x.float() != want.float()).float().mean())
    assert share(got) <= share(f32) + 0.005, (share(got), share(f32))


@pytest.mark.parametrize("shape", [
    # (B, Sq, Skv, Hq, Hkv, Dh, causal): whisper-base's cross-attention at
    # Sq 1 and 64 over 1500 frames (split), its encoder, qwen2-vl-72b (G 8,
    # grouped), Qwen2.5-14B (G 5), ViT-Base, zamba2 and stablelm-12b
    (4, 1, 1500, 8, 8, 64, False), (4, 64, 1500, 8, 8, 64, False),
    (4, 1500, 1500, 8, 8, 64, False), (2, 132, 132, 64, 8, 128, True),
    (1, 132, 132, 40, 8, 128, True), (16, 213, 213, 12, 12, 64, False),
    (1, 132, 132, 32, 32, 80, True), (1, 132, 132, 32, 8, 160, True)])
def test_prefill_f32_narrow_runs_the_narrow_kernel(gen, shape):
    """f32 calls at head dims up to 160 run the narrow kernel of their width
    class once (the profiler's names), then the decode kernels' combine
    exactly where the plan splits the keys, and nothing else: no 16-bit
    kernel, no wide one, none of the 64-row layout it replaced
    (flash_fwd_kernel)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, prefill_plan, prefill_width)
    B, Sq, Skv, Hq, Hkv, Dh, causal = shape
    q = torch.randn((B, Sq, Hq, Dh), generator=gen, device="cuda")
    k, v = (torch.randn((B, Skv, Hkv, Dh), generator=gen, device="cuda")
            for _ in range(2))
    kw = dict(causal=causal, sliding_window=None, softcap=None,
              scale=Dh ** -0.5, kv_len=Skv)
    flash_attention_fwd(q, k, v, **kw)
    plan = prefill_plan(B, Sq, Hq, Dh, Dh, 4, torch.cuda.get_device_properties(
        0).multi_processor_count, Hkv=Hkv, kv_len=Skv)
    names = _kernel_names(lambda: flash_attention_fwd(q, k, v, **kw))
    nd = prefill_width(Dh, Dh)
    assert len(names) == (2 if plan.splits > 1 else 1), (plan, names)
    assert "flash_narrow_kernel" in names[0] and re.search(
        rf"flash_narrow_kernel(<{nd}, |ILi{nd}E)", names[0]), names
    if plan.splits > 1:
        assert "decode_combine_kernel" in names[1], names
    assert (plan.splits > 1) == (Skv == 1500 and Sq < 1500), plan
    assert (plan.group > 1) == (Hq // Hkv in (4, 8)), plan


def test_prefill_f32_wide_runs_the_wide_kernel(gen):
    """f32 calls at head dim 256 (gemma2-9b's) and at MLA's 192 / 128 run
    the wide kernel alone (the profiler's names): no narrow f32
    instantiation, no 16-bit kernel, no other kernel, and none of the old
    wide kernel (flash_fwd_wide_kernel)."""
    from repro_torch.kernels.flash_attention.ops import prefill_attention
    args = [tuple(torch.randn((1, 132, h, d), generator=gen, device="cuda")
                  for h, d in ((Hq, Dh), (Hkv, Dh), (Hkv, Dv)))
            for Hq, Hkv, Dh, Dv in ((16, 8, 256, 256), (64, 64, 192, 128))]
    for a in args:
        prefill_attention(*a, causal=True, softcap=50.0)

    def calls():
        for a in args:
            prefill_attention(*a, causal=True, softcap=50.0)
    names = _kernel_names(calls)
    assert len(names) == 2, names
    assert all("flash_wide_kernel" in x for x in names), names
    # widths classes 32 / 32 then 24 / 16, demangled or mangled
    assert re.search(r"flash_wide_kernel(<32, 32,|ILi32ELi32E)", names[0]) \
        and re.search(r"flash_wide_kernel(<24, 16,|ILi24ELi16E)",
                      names[1]), names


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Dh,window,kind", [
    (5, 128, None, ""), (1, 80, None, ""), (5, 128, 16, "seam"),
    (5, 128, None, "empty"), (3, 64, None, "unaligned"),
    (12, 192, None, ""), (2, 256, 16, "seam"), (4, 160, None, "unaligned")])
def test_decode_kernel_matches_plain_bf16(gen, monkeypatch, kv_dtype, G,
                                          Dh, window, kind):
    """q bf16 over an f32 cache (the engines' case) and over a bf16 one,
    at the wrapper's split count and at 1 and 8."""
    _decode_half(gen, monkeypatch, torch.bfloat16, kv_dtype, G, Dh, window,
                 kind)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("G,Dh,window,kind", [
    (5, 128, None, ""), (1, 80, None, ""), (5, 128, 16, "seam"),
    (5, 128, None, "empty"), (3, 64, None, "unaligned"),
    (12, 192, None, ""), (2, 256, 16, "seam"), (4, 160, None, "unaligned")])
def test_decode_kernel_matches_plain_f16(gen, monkeypatch, kv_dtype, G,
                                         Dh, window, kind):
    _decode_half(gen, monkeypatch, torch.float16, kv_dtype, G, Dh, window,
                 kind)


def _decode_half(gen, monkeypatch, dtype, kv_dtype, G, Dh, window, kind):
    from repro_torch.kernels.flash_attention import decode
    from repro_torch.kernels.flash_attention.decode import (
        decode_attention, decode_attention_fwd, grouped_decode)
    B, W, Hkv = 5, 77, 2
    q = _bf16((B, 1, G * Hkv, Dh), gen, dtype=dtype)
    k = torch.randn((B, W, Hkv, Dh), generator=gen, device="cuda")
    v = torch.randn((B, W, Hkv, Dh), generator=gen, device="cuda")
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    if kind == "unaligned":       # a view one value into its storage
        k = torch.empty((B, W, Hkv, Dh + 1), dtype=kv_dtype,
                        device="cuda")[..., 1:].copy_(k)
        v = torch.empty((B, W, Hkv, Dh + 1), dtype=kv_dtype,
                        device="cuda")[..., 1:].copy_(v)
        assert k.data_ptr() % 8 and k.stride(2) % 4
    kvp = torch.full((B, W), -1, dtype=torch.int32)
    qp = torch.zeros((B,), dtype=torch.int32)
    for b, n in enumerate(_decode_lens(kind, W)):
        if b == 4:                                  # wrapped ring
            pos = torch.arange(n, n + W, dtype=torch.int32)
            kvp[b, pos % W] = pos
            qp[b] = n + W - 1
        elif n:
            kvp[b, :n] = torch.arange(n, dtype=torch.int32)
            qp[b] = n - 1
    qp, kvp = qp.cuda(), kvp.cuda()
    want = grouped_decode(q, k, v, qp, kvp, scale=Dh ** -0.5,
                          sliding_window=window, softcap=None)
    for S in (None, 1, 8):
        if S is not None:
            monkeypatch.setattr(decode, "decode_splits",
                                lambda *shape, S=S: S)
        n = decode_attention_fwd.launches
        got = decode_attention(q, k, v, q_positions=qp, kv_positions=kvp,
                               sliding_window=window)
        torch.cuda.synchronize()
        assert decode_attention_fwd.launches == n + 1
        _close_bf16(got, want)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page,kind", [(8, ""), (16, "masked"),
                                       (8, "unaligned")])
def test_paged_decode_kernel_matches_plain_bf16(gen, kv_dtype, page, kind):
    _paged_half(gen, torch.bfloat16, kv_dtype, page, kind)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("page,kind", [(8, ""), (16, "masked"),
                                       (8, "unaligned")])
def test_paged_decode_kernel_matches_plain_f16(gen, kv_dtype, page, kind):
    _paged_half(gen, torch.float16, kv_dtype, page, kind)


def _paged_half(gen, dtype, kv_dtype, page, kind):
    from repro_torch.kernels.flash_attention.decode import (
        paged_decode_attention, paged_decode_attention_fwd,
        paged_gather_decode)
    B, nb, G, Hkv, Dh = 5, 9, 5, 2, 128
    lens = _paged_lens(kind, nb, page)
    q, k, v, tables, qp, kvp = _paged_case(gen, B, nb, page, G * Hkv, Hkv,
                                           Dh, lens)
    q, k, v = q.to(dtype), k.to(kv_dtype), v.to(kv_dtype)
    if kind == "unaligned":
        P = k.shape[0]
        k = torch.empty((P, page, Hkv, Dh + 1), dtype=kv_dtype,
                        device="cuda")[..., 1:].copy_(k)
        v = torch.empty((P, page, Hkv, Dh + 1), dtype=kv_dtype,
                        device="cuda")[..., 1:].copy_(v)
    n = paged_decode_attention_fwd.launches
    got = paged_decode_attention(q, k, v, block_tables=tables,
                                 q_positions=qp, kv_positions=kvp)
    torch.cuda.synchronize()
    assert paged_decode_attention_fwd.launches == n + 1
    _close_bf16(got, paged_gather_decode(q, k, v, tables, qp, kvp,
                                         scale=Dh ** -0.5,
                                         sliding_window=None, softcap=None))


@pytest.mark.parametrize("N,V,aligned", [(16, 100, True), (3, 1031, False),
                                         (2, 152064, True)])
def test_el2n_kernel_matches_one_pass_plain_bf16(gen, N, V, aligned):
    """bf16 logits, read by the kernel itself: within 1e-5 of the one-pass
    plain form of the same bf16 logits (f32 after an exact widening)."""
    _el2n_half(gen, N, V, aligned, torch.bfloat16)


@pytest.mark.parametrize("N,V,aligned", [(16, 100, True), (3, 1031, False),
                                         (2, 152064, True)])
def test_el2n_kernel_matches_one_pass_plain_f16(gen, N, V, aligned):
    _el2n_half(gen, N, V, aligned, torch.float16)


def _el2n_half(gen, N, V, aligned, dtype):
    from repro_torch.kernels.el2n import ref
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    from repro_torch.kernels.el2n.ops import el2n_scores
    base = _bf16((N, V + 3), gen, scale=3.0, dtype=dtype)
    logits = base[:, :V] if aligned else base[:, 1:V + 1]
    labels = torch.randint(0, V, (N,), generator=gen, device="cuda")
    n = el2n_fwd.launches
    e, c = el2n_scores(logits, labels)
    assert el2n_fwd.launches == n + 1
    assert e.dtype == c.dtype == torch.float32
    we, wc = ref.fused_scores(logits, labels)
    torch.testing.assert_close(e, we, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(c, wc, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [128, 70016])
def test_masked_encode_kernel_bit_equal_bf16(gen, n):
    _masked_encode_half(n, torch.bfloat16)


@pytest.mark.parametrize("n", [128, 70016])
def test_masked_encode_kernel_bit_equal_f16(gen, n):
    _masked_encode_half(n, torch.float16)


def _masked_encode_half(n, dtype):
    from repro_torch.kernels.secure_mask import ref
    from repro_torch.kernels.secure_mask.ops import masked_encode
    x, seeds, signs = _ring_case(n, n)
    x = x.to(dtype)
    got = masked_encode(x, seeds, signs)
    assert torch.equal(got, ref.masked_encode(x, seeds, signs))
    # a view one value off an 8-byte boundary is copied, not refused
    y = torch.cat([x[:1], x])[1:]
    assert torch.equal(masked_encode(y, seeds, signs), got)


def test_mamba2_kernel_matches_plain_bf16(gen):
    """The layer's dtype mix: x, B and C bf16, dt, A and h0 f32."""
    _mamba2_half(gen, torch.bfloat16, 37)


@pytest.mark.parametrize("T", [1, 37])
def test_mamba2_kernel_matches_plain_f16(gen, T):
    """The layer's dtype mix at f16, through the step (T 1) and the
    chunked kernel; an f16 state read by both."""
    _mamba2_half(gen, torch.float16, T)
    _mamba2_half(gen, torch.float16, T, state_dtype=torch.float16)


@pytest.mark.parametrize("T", [1, 37])
@pytest.mark.parametrize("dtypes", [
    # x, B, C, dt, A, state
    (torch.float32, torch.bfloat16, torch.float16, torch.bfloat16,
     torch.float16, torch.bfloat16),
    (torch.float16, torch.float32, torch.bfloat16, torch.float32,
     torch.float32, torch.float16),
])
def test_mamba2_kernel_matches_plain_mixed_dtypes(gen, T, dtypes):
    """Each input in a dtype of its own, as the JAX op takes them (each
    read with astype(f32)), through the step (T 1) and the chunked
    kernel."""
    from repro_torch.kernels.mamba2_scan import ref
    from repro_torch.kernels.mamba2_scan.ops import mamba2_scan
    B, H, P, N, G = 2, 8, 16, 16, 2
    dx, db, dc, ddt, da, ds = dtypes
    x = _bf16((B, T, H, P), gen, dtype=dx)
    Bm = _bf16((B, T, G, N), gen, dtype=db)
    Cm = _bf16((B, T, G, N), gen, dtype=dc)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=gen, device="cuda")).to(ddt)
    A = (-torch.exp(torch.randn((H,), generator=gen, device="cuda"))).to(da)
    state = torch.randn((B, H, P, N), generator=gen, device="cuda").to(ds)
    y, h = mamba2_scan(x, dt, A, Bm, Cm, state)
    ry, rh = ref.mamba2_scan(x, dt, A, Bm, Cm, state)
    assert y.dtype == dx and h.dtype == torch.float32
    if dx == torch.float32:
        assert _scan_close(y, ry)
    else:
        _close_bf16(y, ry)
    assert _scan_close(h, rh)


def _mamba2_half(gen, dtype, T, state_dtype=torch.float32):
    from repro_torch.kernels.mamba2_scan import ref
    from repro_torch.kernels.mamba2_scan.ops import mamba2_scan
    B, H, P, N, G = 2, 8, 16, 16, 2
    x = _bf16((B, T, H, P), gen, dtype=dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((H,), generator=gen, device="cuda"))
    Bm = _bf16((B, T, G, N), gen, dtype=dtype)
    Cm = _bf16((B, T, G, N), gen, dtype=dtype)
    state = torch.randn((B, H, P, N), generator=gen,
                        device="cuda").to(state_dtype)
    y, h = mamba2_scan(x, dt, A, Bm, Cm, state)
    ry, rh = ref.mamba2_scan(x, dt, A, Bm, Cm, state)
    _close_bf16(y, ry)
    assert h.dtype == torch.float32 and _scan_close(h, rh)


def test_rwkv6_kernel_matches_plain_bf16(gen):
    """Every input bf16 but the f32 state, as tests/test_kernels.py runs
    the JAX kernel."""
    _rwkv6_half(gen, torch.bfloat16)


def test_rwkv6_kernel_matches_plain_f16(gen):
    _rwkv6_half(gen, torch.float16)


def _rwkv6_half(gen, dtype):
    from repro_torch.kernels.rwkv6_scan import ref
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    B, T, H, K, V = 2, 40, 2, 16, 16
    r, k, v = (_bf16((B, T, H, K), gen, dtype=dtype) for _ in range(3))
    w = (-torch.exp(torch.randn((B, T, H, K), generator=gen,
                                device="cuda"))).to(dtype)
    u = _bf16((H, K), gen, dtype=dtype)
    state = torch.randn((B, H, K, V), generator=gen, device="cuda")
    y, S = rwkv6_scan(r, k, v, w, u, state)
    ry, rS = ref.rwkv6_scan(r, k, v, w, u, state)
    _close_bf16(y, ry)
    assert S.dtype == torch.float32 and _scan_close(S, rS)


def test_wrappers_refuse_f16_and_f64(gen):
    """bf16 and f16 are taken (f16 since the kernels read it: the f16
    tests above); float64 still raises, naming the input."""
    from repro_torch.kernels.el2n.kernel import el2n_fwd
    from repro_torch.kernels.flash_attention.decode import \
        decode_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.mamba2_scan.kernel import mamba2_fwd
    from repro_torch.kernels.quant.kernel import quantize_fwd
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_fwd
    from repro_torch.kernels.secure_mask.kernel import masked_encode_fwd
    for dt in (torch.float64,):
        x = torch.zeros((2, 8), dtype=dt, device="cuda")
        q = torch.zeros((1, 1, 2, 8), dtype=dt, device="cuda")
        pos = torch.zeros((1,), dtype=torch.int32, device="cuda")
        calls = [
            lambda: quantize_fwd(x, torch.full((2, 8), 0.5, device="cuda")),
            lambda: flash_attention_fwd(q, q, q, causal=True,
                                        sliding_window=None, softcap=None,
                                        scale=1.0, kv_len=1),
            lambda: decode_attention_fwd(
                q, q.float(), q.float(), pos, pos[:, None], scale=1.0,
                sliding_window=None, softcap=None),
            lambda: el2n_fwd(x, torch.zeros((2,), dtype=torch.int32,
                                            device="cuda")),
            lambda: masked_encode_fwd(
                x.view(-1), torch.zeros((1,), dtype=torch.int32,
                                        device="cuda"),
                torch.ones((1,), dtype=torch.int32, device="cuda"), n=16,
                frac_bits=16),
            lambda: mamba2_fwd(q, torch.ones((1, 1, 2), device="cuda"),
                               -torch.ones((2,), device="cuda"),
                               torch.zeros((1, 1, 1, 8), device="cuda"),
                               torch.zeros((1, 1, 1, 8), device="cuda")),
            lambda: rwkv6_fwd(q, q, q, q, x),
        ]
        for call in calls:
            with pytest.raises(ValueError,
                               match="float32, bfloat16 or float16"):
                call()


def test_bf16_engine_on_card_matches_cpu(gen):
    """A bf16 dense engine on the int8 wire, card against CPU from the same
    weights: wire bytes and counters equal, and the gap rule with the card
    in the port's place: teacher-forced on the CPU run's tokens, the mean
    |card_bf16 - cpu_bf16| over every logit is no more than the mean
    |cpu_bf16 - cpu_f32|."""
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import personalized_bank
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (ServeConfig, ServeEngine, TenantBank,
                                   WorkloadConfig, synthetic_requests)
    from repro_torch.serve.steps import forced_logits
    from repro_torch.tree import tree_map
    cfg = get_config("qwen2.5-14b").reduced(n_layers=3, d_model=64, d_ff=128,
                                            vocab_size=128)
    model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=4), WireSpec.make("int8"))
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    bank = personalized_bank(model, params, 2, jitter=0.2)
    reqs = synthetic_requests(WorkloadConfig(
        n_requests=5, prompt_choices=(6, 10), new_token_choices=(3, 5),
        n_tenants=2, vocab_size=128, seed=4))
    on = {}
    for dev in ("cpu", "cuda"):
        on[dev] = (tree_map(lambda x: x.to(dev), params),
                   TenantBank(tree_map(lambda x: x.to(dev), bank.tails),
                              bank.prompts.to(dev)))
    runs = {}
    reset_launches()
    for dev in ("cpu", "cuda"):
        st = ServeEngine(model, *on[dev], ServeConfig(
            n_slots=2, max_seq=32, decode_block=2, dtype=torch.bfloat16),
            collect_logits=True, device=dev).run(reqs)
        runs[dev] = st
        assert st["n_finished"] == len(reqs)
    counts = launch_counts()
    for name in ("quantize_int8", "dequantize_int8",
                 "flash_attention_prefill", "decode_attention"):
        assert counts[name] > 0, name
    for key in ("wire_bytes", "tokens_out", "decode_steps", "prefills"):
        assert runs["cpu"][key] == runs["cuda"][key], key
    gap, ref_gap = [], []
    for f in runs["cpu"]["finished"]:
        toks = f.tokens.tolist()

        def forced(dev, dtype):
            p, b = on[dev]
            return forced_logits(model, {"head": p["head"], "body": p["body"]},
                                 b, f.req, toks, dtype=dtype, max_seq=32,
                                 device=dev)
        cpu = forced("cpu", torch.bfloat16)
        gap.append(np.abs(forced("cuda", torch.bfloat16) - cpu).ravel())
        ref_gap.append(np.abs(cpu - forced("cpu", torch.float32)).ravel())
    gap, ref_gap = np.concatenate(gap), np.concatenate(ref_gap)
    assert np.isfinite(gap).all()
    assert gap.mean() <= ref_gap.mean(), (gap.mean(), ref_gap.mean())


# ------------------------------------------------- wide heads, big groups
def wide_reduced(arch, get_config=None):
    """A reduced model of `arch` (three cycles of its layer pattern,
    d_model 64) at its published head dim and GQA group: gemma2-9b 4 / 2
    heads of 256 with both softcaps and a window of 8 (so the local layers
    mask at the tests' lengths), stablelm-12b 8 / 2 of 160,
    nemotron-4-340b 24 / 2 of 192. `get_config` is the port's by default;
    tests/test_torch_wide_heads.py passes the JAX package's."""
    import dataclasses
    if get_config is None:
        from repro_torch.configs import get_config
    heads, kv, dh = {"gemma2-9b": (4, 2, 256), "stablelm-12b": (8, 2, 160),
                     "nemotron-4-340b": (24, 2, 192)}[arch]
    base = get_config(arch)
    cfg = base.reduced(n_layers=3 * len(base.layer_pattern), d_model=64,
                       d_ff=128, vocab_size=128)
    att = dataclasses.replace(
        cfg.attention, n_heads=heads, n_kv_heads=kv, head_dim=dh,
        sliding_window=8 if cfg.attention.sliding_window else None)
    return dataclasses.replace(cfg, attention=att)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Dh,kind", [(4, 160, ""), (12, 192, "masked"),
                                       (2, 256, "")])
def test_paged_decode_kernel_matches_plain_bf16_wide(gen, kv_dtype, G, Dh,
                                                     kind):
    """A bf16 query over an f32 and a bf16 pool at the wide shapes."""
    from repro_torch.kernels.flash_attention.decode import (
        paged_decode_attention, paged_decode_attention_fwd,
        paged_gather_decode)
    B, nb, page, Hkv = 5, 9, 16, 2
    q, k, v, tables, qp, kvp = _paged_case(
        gen, B, nb, page, G * Hkv, Hkv, Dh, _paged_lens(kind, nb, page))
    q, k, v = q.bfloat16(), k.to(kv_dtype), v.to(kv_dtype)
    n = paged_decode_attention_fwd.launches
    got = paged_decode_attention(q, k, v, block_tables=tables,
                                 q_positions=qp, kv_positions=kvp,
                                 softcap=50.0)
    torch.cuda.synchronize()
    assert paged_decode_attention_fwd.launches == n + 1
    _close_bf16(got, paged_gather_decode(q, k, v, tables, qp, kvp,
                                         scale=Dh ** -0.5,
                                         sliding_window=None, softcap=50.0))


@pytest.mark.parametrize("Dh,Dv,G", [(192, 128, 12), (256, 160, 2),
                                     (128, 64, 16)])
def test_attention_kernels_take_dv_other_than_dh(gen, Dh, Dv, G):
    """Values narrower than the keys (an MLA-shaped 192 / 128) through the
    prefill, dense decode and paged decode kernels, within ATTN_TOL of
    plain."""
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.decode import (
        grouped_decode, paged_decode_attention, paged_gather_decode,
        decode_attention)
    from repro_torch.kernels.flash_attention.ops import prefill_attention
    Hkv, S = 2, 77
    q = torch.randn((2, S, G * Hkv, Dh), generator=gen, device="cuda")
    k = torch.randn((2, S, Hkv, Dh), generator=gen, device="cuda")
    v = torch.randn((2, S, Hkv, Dv), generator=gen, device="cuda")
    got = prefill_attention(q, k, v, sliding_window=16, softcap=50.0)
    want = ref.attention(q, k, v, sliding_window=16, softcap=50.0)
    assert got.shape == (2, S, G * Hkv, Dv)
    assert float((got - want).abs().max()) <= ATTN_TOL
    qp = torch.tensor([40, S - 1], dtype=torch.int32, device="cuda")
    kvp = torch.arange(S, dtype=torch.int32, device="cuda")[None].repeat(2, 1)
    kvp[0, 41:] = -1
    got = decode_attention(q[:, :1], k, v, q_positions=qp, kv_positions=kvp,
                           softcap=50.0)
    want = grouped_decode(q[:, :1], k, v, qp, kvp, scale=Dh ** -0.5,
                          sliding_window=None, softcap=50.0)
    assert float((got - want).abs().max()) <= ATTN_TOL
    qd, kp, _, tables, qpp, kvpp = _paged_case(
        gen, 5, 9, 8, G * Hkv, Hkv, Dh, _paged_lens("", 9, 8))
    vp = torch.randn(kp.shape[:3] + (Dv,), generator=gen, device="cuda")
    got = paged_decode_attention(qd, kp, vp, block_tables=tables,
                                 q_positions=qpp, kv_positions=kvpp)
    want = paged_gather_decode(qd, kp, vp, tables, qpp, kvpp,
                               scale=Dh ** -0.5, sliding_window=None,
                               softcap=None)
    assert float((got - want).abs().max()) <= ATTN_TOL


def test_attention_wrappers_refuse_past_the_wide_limits(gen):
    """Head dims up to 256 and groups up to 16 launch; one past either
    raises a ValueError naming the limit, on CUDA tensors, with no launch."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention.decode import (
        decode_attention_fwd, paged_decode_attention_fwd)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    pos = torch.zeros((1,), dtype=torch.int32, device="cuda")
    tables = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    kvp = torch.zeros((1, 8), dtype=torch.int32, device="cuda")

    def calls(G, Dh):
        q = torch.randn((1, 1, G, Dh), generator=gen, device="cuda")
        kv = torch.randn((1, 8, 1, Dh), generator=gen, device="cuda")
        return [
            lambda: flash_attention_fwd(q, kv, kv, causal=True,
                                        sliding_window=None, softcap=None,
                                        scale=1.0, kv_len=1),
            lambda: decode_attention_fwd(q, kv, kv, pos, kvp, scale=1.0,
                                         sliding_window=None, softcap=None),
            lambda: paged_decode_attention_fwd(
                q, kv, kv, tables, pos, kvp, scale=1.0, sliding_window=None,
                softcap=None)]
    for call in calls(16, 256):
        assert torch.isfinite(call()).all()
    torch.cuda.synchronize()
    before = launch_counts()
    for G, Dh, match in ((1, 264, "head dims <= 256"),
                         (17, 64, "GQA group <= 16")):
        for i, call in enumerate(calls(G, Dh)):
            if i == 0 and G > 16:
                continue             # prefill takes any group
            with pytest.raises(ValueError, match=match):
                call()
    assert launch_counts() == before


@pytest.mark.parametrize("arch,paged", [("gemma2-9b", False),
                                        ("stablelm-12b", True),
                                        ("nemotron-4-340b", False)])
def test_wide_head_engine_on_card_matches_cpu(gen, arch, paged):
    """Reduced models at the wide families' head dims and groups, served on
    the card and on the CPU from the same weights: tokens equal, logits
    within 1e-4, wire bytes equal, every attention kernel of the path
    launched."""
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import personalized_bank
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   ServeConfig, ServeEngine, TenantBank,
                                   WorkloadConfig, synthetic_requests)
    from repro_torch.tree import tree_map
    cfg = wide_reduced(arch)
    model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=4), WireSpec.make("fp32"))
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    bank = personalized_bank(model, params, 2, jitter=0.2)
    reqs = synthetic_requests(WorkloadConfig(
        n_requests=5, prompt_choices=(6, 14), new_token_choices=(3, 6),
        n_tenants=2, vocab_size=128, seed=4))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev), params)
        b = TenantBank(tree_map(lambda x: x.to(dev), bank.tails),
                       bank.prompts.to(dev))
        reset_launches()
        if paged:
            eng = PagedServeEngine(model, p, b, PagedServeConfig(
                n_slots=2, max_seq=32, decode_block=2, page_size=8,
                shared_prefix=(5, 6, 7), prefill_chunk=4),
                collect_logits=True, device=dev)
        else:
            eng = ServeEngine(model, p, b, ServeConfig(
                n_slots=2, max_seq=32, decode_block=2),
                collect_logits=True, device=dev)
        st = eng.run(reqs)
        out[dev] = ({f.req.rid: f for f in st["finished"]}, st["wire_bytes"])
    counts = launch_counts()
    for name in ("flash_attention_prefill", "paged_decode_attention"
                 if paged else "decode_attention"):
        assert counts[name] > 0, name
    for rid, f in out["cpu"][0].items():
        np.testing.assert_array_equal(out["cuda"][0][rid].tokens, f.tokens)
        np.testing.assert_allclose(out["cuda"][0][rid].logits, f.logits,
                                   atol=1e-4, rtol=1e-4)
    assert out["cuda"][1] == out["cpu"][1]
