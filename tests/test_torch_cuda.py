"""The port's CUDA kernels against their plain versions on the card, at
small and odd shapes (chip_smoke.py holds them at the full-width serving
shapes). Marked `cuda`: they skip without a CUDA device and run on the card
with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import torch

torch.set_num_threads(2)

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


@pytest.mark.parametrize("case", [
    # (B, Sq, Hq, Hkv, Dh, causal, window, softcap, kv_len)
    (2, 5, 4, 4, 32, True, None, None, None),
    (1, 45, 10, 2, 16, True, None, None, None),
    (2, 70, 8, 1, 96, True, 9, None, None),
    (1, 33, 6, 3, 128, True, None, 30.0, 20),
    (1, 64, 10, 2, 64, True, 16, 20.0, 17),
    (2, 21, 4, 2, 16, False, None, None, None),
])
def test_prefill_kernel_matches_plain(gen, case):
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.ops import prefill_attention
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    B, S, Hq, Hkv, Dh, causal, window, softcap, kv_len = case
    q = torch.randn((B, S, Hq, Dh), generator=gen, device="cuda")
    kv = torch.randn((B, S, 2 * Hkv, Dh), generator=gen, device="cuda")
    k, v = kv[:, :, :Hkv], kv[:, :, Hkv:]          # strided views
    n = flash_attention_fwd.launches
    got = prefill_attention(q, k, v, causal=causal, sliding_window=window,
                            softcap=softcap, kv_len=kv_len)
    assert flash_attention_fwd.launches == n + 1
    L = kv_len or S
    want = ref.attention(q, k[:, :L], v[:, :L], causal=causal,
                         sliding_window=window, softcap=softcap)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATTN_TOL


@pytest.mark.parametrize("G,Dh,window,softcap", [
    (1, 32, None, None), (5, 128, None, None), (8, 16, 7, None),
    (3, 64, None, 25.0), (5, 128, 64, 50.0)])
def test_decode_kernel_matches_plain(gen, G, Dh, window, softcap):
    from repro_torch.kernels.flash_attention.decode import (decode_attention,
                                                            grouped_decode)
    B, W, Hkv = 5, 77, 2
    q = torch.randn((B, 1, G * Hkv, Dh), generator=gen, device="cuda")
    k = torch.randn((B, W, Hkv, Dh), generator=gen, device="cuda")
    v = torch.randn((B, W, Hkv, Dh), generator=gen, device="cuda")
    kvp = torch.full((B, W), -1, dtype=torch.int32)
    qp = torch.zeros((B,), dtype=torch.int32)
    for b, n in enumerate([0, 1, 40, W, 30]):
        if b == 4:                                  # wrapped ring
            pos = torch.arange(n, n + W, dtype=torch.int32)
            kvp[b, pos % W] = pos
            qp[b] = n + W - 1
        elif n:
            kvp[b, :n] = torch.arange(n, dtype=torch.int32)
            qp[b] = n - 1
    qp, kvp = qp.cuda(), kvp.cuda()
    got = decode_attention(q, k, v, q_positions=qp, kv_positions=kvp,
                           sliding_window=window, softcap=softcap)
    want = grouped_decode(q, k, v, qp, kvp, scale=Dh ** -0.5,
                          sliding_window=window, softcap=softcap)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATTN_TOL


def test_wrappers_raise_instead_of_falling_back(gen):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.quant.ops import dequantize_int8
    q = torch.randn((1, 4, 2, 8), device="cuda")
    with pytest.raises(NotImplementedError, match="paged"):
        flash_attention(q, q, q, q_offset=torch.zeros(1, dtype=torch.int32,
                                                      device="cuda"))
    with pytest.raises(ValueError):
        dequantize_int8(torch.zeros((2, 3), dtype=torch.int8, device="cuda"),
                        torch.ones((2, 1), device="cuda"),
                        dtype=torch.bfloat16)
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
