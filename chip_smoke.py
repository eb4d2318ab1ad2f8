#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run with a nonzero exit:
  1. the card's name and power limit (nvidia-smi), TF32 switched off;
  2. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source,
     all at once, linked into one library);
  3. each kernel against its plain PyTorch version on the card, at the
     serving paths' shapes (Qwen2.5-14B widths), with its time, the plain
     version's, one PyTorch library call's where one computes the same
     function, and the least time the card could take (bound);
  4. engine parity: the reduced Qwen2.5 family (with a GQA group of 5)
     served on the card and on the CPU from the same seeded weights, by the
     dense engine and by the paged engine (shared prefix, chunked prefill)
     — tokens equal, logits within 1e-4, wire bytes and page counters
     equal;
  5. the dense path at full width: Qwen2.5-14B widths cut to 6 layers, 4
     tenants, 8 slots, max_seq 512, int8 wire, decode_block 8, 16 synthetic
     requests through `ServeEngine.run`; every request finishes, metered
     wire bytes are within 5% of `serve_comm_breakdown`, and every kernel
     of the dense path was launched (launch counts zeroed just before the
     run), then a profiled replay;
  6. the paged path at full width: the same model and tenants, 16 slots
     over a pool of 128 usable pages of 16 tokens (the KV memory of 4
     dense 512-token slots), a 32-token shared prefix, prefill chunks of
     64, 24 synthetic requests through `PagedServeEngine.run`; every
     request finishes, the pool drains, every join copies its boundary
     page, metered wire bytes are within 0.1% of the exact count, and
     every kernel of the paged path was launched, then a profiled replay;
  7. the `kernels` JSON line, then the device line last.

Needs a CUDA device and the repository's src/ beside this file; without
either it exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
ATTN_TOL = 2e-5
PARITY_TOL = 1e-4
PAGED_WIRE_TOL = 1e-3

# TPU kernels each CUDA kernel replaces (file:line of the def)
REPLACES = {
    "quantize_int8": "src/repro/kernels/quant/kernel.py:46",
    "dequantize_int8": "src/repro/kernels/quant/kernel.py:73",
    "flash_attention_prefill": "src/repro/kernels/flash_attention/kernel.py:93",
    "decode_attention": "src/repro/kernels/flash_attention/decode.py:124",
    "paged_decode_attention":
        "src/repro/kernels/flash_attention/decode.py:261",
}
SOURCES = {
    "quantize_int8": "src/repro_torch/csrc/quant.cu",
    "dequantize_int8": "src/repro_torch/csrc/quant.cu",
    "flash_attention_prefill": "src/repro_torch/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "paged_decode_attention": "src/repro_torch/csrc/paged_decode_attention.cu",
}
# the kernels each full-width path must launch
PATHS = {
    "dense": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
              "decode_attention"),
    "paged": ("quantize_int8", "dequantize_int8", "flash_attention_prefill",
              "paged_decode_attention"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ timing
def time_ms(fns, iters: int = 40) -> float:
    """Mean device time of one call, cycling through `fns` (closures over
    distinct input copies, so the inputs are not L2-resident from the
    previous call, as on the serving path)."""
    import torch
    for fn in fns[:3]:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def n_copies(bytes_per_set: int) -> int:
    """Input copies to cycle through so their total exceeds the 50 MB L2."""
    return max(2, min(1024, math.ceil(128e6 / max(bytes_per_set, 1))))


def bound(nbytes: float, flops: float):
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


# ---------------------------------------------------------------- phase 3
def check_quant(torch, gen, results):
    from repro_torch.kernels.quant import ref
    from repro_torch.kernels.quant.kernel import dequantize_fwd, quantize_fwd
    D = 5120
    for N in (1, 8, 132):
        x = torch.randn((N, D), generator=gen, device="cuda") * 3.0
        x[0, :7] = 0.0
        for u in (torch.full((), 0.5, device="cuda"),
                  torch.rand((N, D), generator=gen, device="cuda")):
            v, s = quantize_fwd(x, u.expand(N, D))
            rv, rs = ref.quantize(x, u)
            if not (torch.equal(v, rv) and torch.equal(s, rs)):
                fail(f"quantize_int8 N={N} D={D} u{tuple(u.shape)}: "
                     f"{int((v != rv).sum())} values, "
                     f"{int((s != rs).sum())} scales differ from plain")
            out = dequantize_fwd(v, s)
            if not torch.equal(out, ref.dequantize(v, s)):
                fail(f"dequantize_int8 N={N} D={D} differs from plain")
    say(f"quant: kernel == plain at N in (1, 8, 132), D={D}, scalar and "
        f"random u")

    # timing at the decode shape (8 slots x d_model, scalar u), the one the
    # main path launches most
    N = 8
    k = n_copies(N * D * 5)
    xs = [torch.randn((N, D), generator=gen, device="cuda") for _ in range(k)]
    half = torch.full((), 0.5, device="cuda").expand(N, D)
    payloads = [quantize_fwd(x, half) for x in xs]
    t_q = time_ms([lambda x=x: quantize_fwd(x, half) for x in xs])
    t_qp = time_ms([lambda x=x: ref.quantize(x, 0.5) for x in xs])
    t_d = time_ms([lambda p=p: dequantize_fwd(*p) for p in payloads])
    t_dp = time_ms([lambda p=p: ref.dequantize(*p) for p in payloads])
    bq = bound(N * D * 4 + 4 + N * D + N * 4, 4 * N * D)
    bd = bound(N * D + N * 4 + N * D * 4, N * D)
    results["quantize_int8"] = dict(max_abs_err=0.0, ms=t_q, plain_ms=t_qp,
                                    bound_ms=bq[0], bound_by=bq[1],
                                    library_ms=None, shape=f"x ({N}, {D})")
    results["dequantize_int8"] = dict(max_abs_err=0.0, ms=t_d, plain_ms=t_dp,
                                      bound_ms=bd[0], bound_by=bd[1],
                                      library_ms=None, shape=f"v ({N}, {D})")


def _prefill_pairs(S, kv_len, window):
    """Unmasked (query, key) pairs of causal prefill: the work the data
    needs."""
    total = 0
    for r in range(S):
        hi = min(r, kv_len - 1)
        lo = max(0, r - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def check_prefill(torch, F, gen, results):
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    B, Hq, Hkv, Dh = 1, 40, 8, 128
    scale = Dh ** -0.5

    def inputs(S):
        return (torch.randn((B, S, Hq, Dh), generator=gen, device="cuda"),
                torch.randn((B, S, Hkv, Dh), generator=gen, device="cuda"),
                torch.randn((B, S, Hkv, Dh), generator=gen, device="cuda"))

    worst = 0.0
    cases = [(37, None, None, 37), (132, None, None, 132),
             (260, None, None, 260), (260, 64, 50.0, 201), (260, 64, 50.0, 37)]
    for S, window, softcap, kv_len in cases:
        q, k, v = inputs(S)
        got = flash_attention_fwd(q, k, v, causal=True, sliding_window=window,
                                  softcap=softcap, scale=scale, kv_len=kv_len)
        want = ref.attention(q, k[:, :kv_len], v[:, :kv_len], causal=True,
                             sliding_window=window, softcap=softcap,
                             scale=scale)
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and err <= ATTN_TOL):
            fail(f"prefill S={S} window={window} softcap={softcap} "
                 f"kv_len={kv_len}: max|kernel - plain| = {err:.3g} "
                 f"> {ATTN_TOL}")
        worst = max(worst, err)
        say(f"prefill: S={S} window={window} softcap={softcap} "
            f"kv_len={kv_len}: max abs err {err:.3g}")

    S = 132   # the main path's longest prompt (128 tokens + 4 soft prompt)
    per = (B * S * (Hq + 2 * Hkv) * Dh + B * S * Hq * Dh) * 4
    sets = [inputs(S) for _ in range(n_copies(per))]
    t_k = time_ms([lambda s=s: flash_attention_fwd(
        *s, causal=True, sliding_window=None, softcap=None, scale=scale,
        kv_len=S) for s in sets])
    t_p = time_ms([lambda s=s: ref.attention(*s, causal=True, scale=scale)
                   for s in sets])
    lib = [(q.transpose(1, 2).contiguous(),
            k.repeat_interleave(Hq // Hkv, 2).transpose(1, 2).contiguous(),
            v.repeat_interleave(Hq // Hkv, 2).transpose(1, 2).contiguous())
           for q, k, v in sets]
    t_l = time_ms([lambda s=s: F.scaled_dot_product_attention(
        *s, is_causal=True, scale=scale) for s in lib])
    flops = _prefill_pairs(S, S, None) * B * Hq * 4 * Dh
    b = bound(per, flops)
    results["flash_attention_prefill"] = dict(
        max_abs_err=worst, ms=t_k, plain_ms=t_p, bound_ms=b[0],
        bound_by=b[1], library_ms=t_l,
        shape=f"q ({B}, {S}, {Hq}, {Dh}), kv ({B}, {S}, {Hkv}, {Dh}), causal")


def decode_case(torch, gen, B, W, Hq, Hkv, Dh, lengths, wrap_slot=None):
    """Ring caches: slot b holds lengths[b] tokens (0 = empty, all -1); the
    `wrap_slot` has run past W so its ring has wrapped."""
    q = torch.randn((B, 1, Hq, Dh), generator=gen, device="cuda")
    k = torch.randn((B, W, Hkv, Dh), generator=gen, device="cuda")
    v = torch.randn((B, W, Hkv, Dh), generator=gen, device="cuda")
    kvp = torch.full((B, W), -1, dtype=torch.int32)
    qp = torch.zeros((B,), dtype=torch.int32)
    for b, n in enumerate(lengths):
        if b == wrap_slot:
            total = W + n                      # ring wrapped: positions
            pos = torch.arange(total - W, total, dtype=torch.int32)
            kvp[b, pos % W] = pos              # total-W .. total-1 at pos % W
            qp[b] = total - 1
        elif n:
            kvp[b, :n] = torch.arange(n, dtype=torch.int32)
            qp[b] = n - 1
    return q, k, v, qp.cuda(), kvp.cuda()


def check_decode(torch, F, gen, results):
    from repro_torch.kernels.flash_attention.decode import (
        decode_attention_fwd, grouped_decode)
    B, W, Hq, Hkv, Dh = 8, 512, 40, 8, 128
    scale = Dh ** -0.5
    lengths = [37, 0, 512, 200, 0, 1, 333, 100]
    worst = 0.0
    for window, softcap in ((None, None), (64, 50.0)):
        args = decode_case(torch, gen, B, W, Hq, Hkv, Dh, lengths,
                           wrap_slot=7)
        got = decode_attention_fwd(*args, scale=scale,
                                   sliding_window=window, softcap=softcap)
        want = grouped_decode(*args, scale=scale, sliding_window=window,
                              softcap=softcap)
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and err <= ATTN_TOL):
            fail(f"decode window={window} softcap={softcap}: max|kernel - "
                 f"plain| = {err:.3g} > {ATTN_TOL}")
        worst = max(worst, err)
        say(f"decode: B={B} W={W} G={Hq // Hkv} lengths={lengths} "
            f"(slot 7 wrapped) window={window} softcap={softcap}: max abs "
            f"err {err:.3g}")

    per = (B * W * Hkv * Dh * 2 + B * Hq * Dh * 2) * 4 + B * W * 4
    sets = [decode_case(torch, gen, B, W, Hq, Hkv, Dh, lengths, wrap_slot=7)
            for _ in range(n_copies(per))]
    t_k = time_ms([lambda s=s: decode_attention_fwd(
        *s, scale=scale, sliding_window=None, softcap=None) for s in sets])
    t_p = time_ms([lambda s=s: grouped_decode(
        *s, scale=scale, sliding_window=None, softcap=None) for s in sets])
    lib = []
    for q, k, v, qp, kvp in sets:
        mask = ((kvp >= 0) & (kvp <= qp[:, None]))[:, None, None, :]
        lib.append((q.transpose(1, 2).contiguous(),
                    k.repeat_interleave(Hq // Hkv, 2).transpose(1, 2)
                    .contiguous(),
                    v.repeat_interleave(Hq // Hkv, 2).transpose(1, 2)
                    .contiguous(), mask))
    t_l = time_ms([lambda s=s: F.scaled_dot_product_attention(
        s[0], s[1], s[2], attn_mask=s[3], scale=scale) for s in lib])
    q, k, v, qp, kvp = sets[0]
    n_valid = int(((kvp >= 0) & (kvp <= qp[:, None])).sum())
    nbytes = (B * Hq * Dh * 2 + n_valid * Hkv * Dh * 2) * 4 + B * W * 4 + B * 4
    b = bound(nbytes, n_valid * (Hq // Hkv) * Hkv * 4 * Dh)
    results["decode_attention"] = dict(
        max_abs_err=worst, ms=t_k, plain_ms=t_p, bound_ms=b[0],
        bound_by=b[1], library_ms=t_l,
        shape=f"q ({B}, 1, {Hq}, {Dh}), cache ({B}, {W}, {Hkv}, {Dh}), "
              f"{n_valid} valid entries")


def paged_case(torch, gen, lengths, page, nb, P, Hq=40, Hkv=8, Dh=128):
    """A page pool as the paged engine leaves it: slot b owns
    ceil(lengths[b] / page) shuffled, non-contiguous pages holding
    positions 0..lengths[b]-1, NULL (page 0) table entries past them and
    stale positions past its length on its last page; a slot of length 0
    is idle, every block at SCRATCH (page 1)."""
    import numpy as np
    B = len(lengths)
    rng = np.random.default_rng(sum(lengths) + page)
    perm = rng.permutation(np.arange(2, P))
    kvp = np.full((P, page), -1, np.int32)
    kvp[1] = rng.integers(0, 4, page)            # scratch: garbage
    tables = np.zeros((B, nb), np.int32)
    used = 0
    for b, n in enumerate(lengths):
        if n == 0:
            tables[b] = 1
            continue
        for j in range(-(-n // page)):
            pid = perm[used]
            used += 1
            tables[b, j] = pid
            m = min(page, n - j * page)
            kvp[pid, :m] = j * page + np.arange(m)
            kvp[pid, m:] = 10 ** 6
    if used > P - 2:
        raise ValueError(f"{used} pages do not fit a pool of {P}")
    q = torch.randn((B, 1, Hq, Dh), generator=gen, device="cuda")
    k = torch.randn((P, page, Hkv, Dh), generator=gen, device="cuda")
    v = torch.randn((P, page, Hkv, Dh), generator=gen, device="cuda")
    qp = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
    return (q, k, v, torch.from_numpy(tables).cuda(), qp.cuda(),
            torch.from_numpy(kvp).cuda())


def check_paged_decode(torch, F, gen, results):
    from repro_torch.kernels.flash_attention.decode import (
        decode_attention_fwd, paged_decode_attention_fwd,
        paged_gather_decode)
    Hq, Hkv, Dh = 40, 8, 128
    scale = Dh ** -0.5
    # 16 slots, ragged 1..512 tokens, slot 4 idle: 119 of the 128 usable
    # pages of 16 tokens
    lengths = [1, 512, 37, 200, 0, 129, 16, 17, 300, 64, 5, 96, 250, 33, 128,
               9]
    cases = [(16, 32, 130, None, None), (8, 64, 2 + 240, 64, 50.0)]
    worst = 0.0
    for page, nb, P, window, softcap in cases:
        args = paged_case(torch, gen, lengths, page, nb, P)
        got = paged_decode_attention_fwd(*args, scale=scale,
                                         sliding_window=window,
                                         softcap=softcap)
        want = paged_gather_decode(*args, scale=scale, sliding_window=window,
                                   softcap=softcap)
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and err <= ATTN_TOL):
            fail(f"paged decode page={page} window={window} "
                 f"softcap={softcap}: max|kernel - plain| = {err:.3g} > "
                 f"{ATTN_TOL}")
        worst = max(worst, err)
        say(f"paged decode: 16 slots, page {page}, nb {nb}, pool {P} pages, "
            f"G={Hq // Hkv}, lengths 1..512 + an idle scratch row, "
            f"window={window} softcap={softcap}: max abs err {err:.3g}")

    page, nb, P = 16, 32, 130
    B, W = len(lengths), nb * page
    n_valid = sum(lengths)
    # bytes the kernel must move: q, out, the valid entries' K/V and
    # positions, the tables and query positions
    nbytes = ((B * Hq * Dh * 2 + n_valid * Hkv * Dh * 2) * 4 + n_valid * 4
              + B * nb * 4 + B * 4)
    sets = [paged_case(torch, gen, lengths, page, nb, P)
            for _ in range(n_copies(nbytes))]
    t_k = time_ms([lambda s=s: paged_decode_attention_fwd(
        *s, scale=scale, sliding_window=None, softcap=None) for s in sets])
    t_p = time_ms([lambda s=s: paged_gather_decode(
        *s, scale=scale, sliding_window=None, softcap=None) for s in sets])
    # the same data gathered into dense per-slot caches: the library
    # yardstick runs on it, and so does the dense decode kernel, which
    # tells the cost of the page indirection apart from the slot count
    dense = []
    for q, k, v, tables, qp, kvp in sets:
        bt = tables.long()
        dense.append((q, k[bt].reshape(B, W, Hkv, Dh),
                      v[bt].reshape(B, W, Hkv, Dh), qp,
                      kvp[bt].reshape(B, W)))
    t_d = time_ms([lambda s=s: decode_attention_fwd(
        *s, scale=scale, sliding_window=None, softcap=None) for s in dense])
    lib = []
    for q, kg, vg, qp, pg in dense:
        mask = ((pg >= 0) & (pg <= qp[:, None]))[:, None, None, :]
        lib.append((q.transpose(1, 2).contiguous(),
                    kg.repeat_interleave(Hq // Hkv, 2).transpose(1, 2)
                    .contiguous(),
                    vg.repeat_interleave(Hq // Hkv, 2).transpose(1, 2)
                    .contiguous(), mask))
    t_l = time_ms([lambda s=s: F.scaled_dot_product_attention(
        s[0], s[1], s[2], attn_mask=s[3], scale=scale) for s in lib])
    del lib, dense
    say(f"paged decode timing: kernel {t_k:.4f} ms, dense decode kernel on "
        f"the same data gathered {t_d:.4f} ms, plain {t_p:.4f} ms, SDPA "
        f"{t_l:.4f} ms")
    b = bound(nbytes, n_valid * Hq * 4 * Dh)
    results["paged_decode_attention"] = dict(
        max_abs_err=worst, ms=t_k, plain_ms=t_p, bound_ms=b[0],
        bound_by=b[1], library_ms=t_l, dense_kernel_same_data_ms=t_d,
        shape=f"q ({B}, 1, {Hq}, {Dh}), pool ({P}, {page}, {Hkv}, {Dh}), "
              f"tables ({B}, {nb}), {n_valid} valid entries")


# ---------------------------------------------------------------- phase 4
def gqa_reduced():
    from repro_torch.configs import get_config
    cfg = get_config("qwen2.5-14b").reduced(n_layers=3, d_model=160,
                                            d_ff=128, vocab_size=128)
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, n_heads=10, n_kv_heads=2, head_dim=16))


def engine_parity(torch):
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.launch.serve import personalized_bank, \
        shared_prefix_tokens
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   ServeConfig, ServeEngine, TenantBank,
                                   WorkloadConfig, synthetic_requests)
    from repro_torch.tree import tree_map
    cfg = gqa_reduced()
    model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=4), WireSpec.make("fp32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    bank = personalized_bank(model, params, 3, jitter=0.2)
    reqs = synthetic_requests(WorkloadConfig(
        n_requests=6, prompt_choices=(6, 11), new_token_choices=(3, 6),
        n_tenants=3, vocab_size=cfg.vocab_size, seed=3))
    engines = {
        "dense": lambda p, b, dev: ServeEngine(
            model, p, b, ServeConfig(n_slots=3, max_seq=48, decode_block=4),
            collect_logits=True, device=dev),
        "paged": lambda p, b, dev: PagedServeEngine(
            model, p, b, PagedServeConfig(
                n_slots=3, max_seq=48, decode_block=4, page_size=8,
                shared_prefix=shared_prefix_tokens(8, cfg.vocab_size),
                prefill_chunk=4),
            collect_logits=True, device=dev),
    }
    counters = ("wire_bytes", "page_copies", "prefix_hits", "prefix_misses",
                "prefill_chunks", "peak_pages", "pages_in_use")
    for kind, make in engines.items():
        runs = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda x: x.to(dev), params)
            b = TenantBank(tree_map(lambda x: x.to(dev), bank.tails),
                           bank.prompts.to(dev))
            st = make(p, b, dev).run(reqs)
            runs[dev] = ({f.req.rid: f for f in st["finished"]},
                         {k: st.get(k) for k in counters})
        worst = 0.0
        for rid, f_cpu in runs["cpu"][0].items():
            f_gpu = runs["cuda"][0][rid]
            if not (f_cpu.tokens == f_gpu.tokens).all():
                fail(f"{kind} engine parity rid={rid}: tokens "
                     f"{f_gpu.tokens.tolist()} on the card vs "
                     f"{f_cpu.tokens.tolist()} on the CPU")
            worst = max(worst, float(abs(f_cpu.logits - f_gpu.logits).max()))
        if worst > PARITY_TOL:
            fail(f"{kind} engine parity: max logit difference {worst:.3g} > "
                 f"{PARITY_TOL}")
        if runs["cpu"][1] != runs["cuda"][1]:
            fail(f"{kind} engine parity: wire bytes or page counters differ "
                 f"between devices: {runs['cuda'][1]} vs {runs['cpu'][1]}")
        say(f"{kind} engine parity ({cfg.name}, G=5, fp32 wire, 6 requests"
            f"{', page 8, shared prefix 8, chunks of 4' if kind == 'paged' else ''}"
            f"): tokens ==, max logit diff {worst:.3g}, wire bytes "
            f"{'and page counters ' if kind == 'paged' else ''}==")


# ------------------------------------------------------------ phases 5-6
def full_width_model(torch):
    """Qwen2.5-14B widths cut to 6 layers (head 1 / body 4 / tail 1), soft
    prompt 4, int8 wire, fp32, 4 tenants, seeded random weights: shared by
    the dense and the paged full-width runs."""
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.launch.serve import personalized_bank
    from repro_torch.runtime import WireSpec
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), n_layers=6)
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4)
    model = SplitModel(cfg, split, WireSpec.make("int8"))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, device="cuda")
    bank = personalized_bank(model, params, 4)
    del params["tail"]
    torch.cuda.synchronize()
    return dict(cfg=cfg, split=split, model=model, params=params, bank=bank,
                setup_s=time.perf_counter() - t0)


def run_path(torch, path, engine, reqs, warm):
    """Warm the engine up on `warm`, then run `reqs` with every launch
    count zeroed just before and read just after; fail unless every
    request finished with in-range tokens and every kernel of `path` was
    launched."""
    from repro_torch.kernels import launch_counts, reset_launches
    engine.run(warm)       # cuBLAS handles, allocator pools, the library
    engine.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stats = engine.run(reqs)
    torch.cuda.synchronize()
    launches = launch_counts()
    vocab = engine.model.cfg.vocab_size
    if stats["n_finished"] != len(reqs):
        fail(f"{path} full width: {stats['n_finished']} of {len(reqs)} "
             f"requests finished")
    for f in stats["finished"]:
        if len(f.tokens) != f.req.max_new or f.tokens.min() < 0 \
                or f.tokens.max() >= vocab:
            fail(f"{path} full width: request {f.req.rid} gave "
                 f"{f.tokens.tolist()}")
    missing = [k for k in PATHS[path] if launches[k] <= 0]
    if missing:
        fail(f"{path} full width: kernels of the path never launched: "
             f"{missing}")
    return stats, launches


def _summary(torch, stats, fw, extra):
    out = {
        "requests": stats["n_finished"], "tokens_out": stats["tokens_out"],
        "wall_s": stats["wall_s"], "tok_per_s": stats["tok_per_s"],
        "p50_latency_s": stats["p50_latency_s"],
        "slowest_latency_s": max(f.latency_s for f in stats["finished"]),
        "decode_steps": stats["decode_steps"],
        "occupancy": stats["occupancy"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "setup_s": fw["setup_s"],
    }
    out.update(extra)
    return out


WORKLOAD = dict(mean_interarrival=1.0, prompt_choices=(32, 64, 96, 128),
                new_token_choices=(16, 24, 32), n_tenants=4)


def full_width(torch, fw):
    from repro_torch.core.comm import serve_comm_breakdown
    from repro_torch.serve import (ServeConfig, ServeEngine, WorkloadConfig,
                                   synthetic_requests)
    cfg, split, model = fw["cfg"], fw["split"], fw["model"]
    engine = ServeEngine(model, fw["params"], fw["bank"],
                         ServeConfig(n_slots=8, max_seq=512, decode_block=8),
                         device="cuda")
    wl = dict(WORKLOAD, vocab_size=cfg.vocab_size)
    reqs = synthetic_requests(WorkloadConfig(n_requests=16, seed=0, **wl))
    stats, launches = run_path(
        torch, "dense", engine, reqs,
        synthetic_requests(WorkloadConfig(n_requests=2, seed=1, **wl)))
    analytical = serve_comm_breakdown(
        model.wire, d_model=cfg.d_model, soft_prompt_len=split.prompt_len,
        requests=[(len(r.tokens), r.max_new) for r in reqs])
    wire_err = {}
    for name, want in analytical.items():
        got = stats["wire_bytes"][name]
        wire_err[name] = abs(got - want) / want
        if wire_err[name] > 0.05:
            fail(f"dense full width: {name} measured {got} B vs analytical "
                 f"{want} B")
    summary = _summary(torch, stats, fw, {
        "config": f"{cfg.name} widths, {cfg.n_layers} layers (1 head / 4 "
                  f"body / 1 tail), 4 tenants, 8 slots, max_seq 512, int8 "
                  f"wire, decode_block 8, fp32",
        "wire_rel_err": wire_err, "launches": launches})
    say("dense full width: " + json.dumps(summary, sort_keys=True))
    summary["profile"] = profile_replay(torch, engine, reqs)
    say("dense profile: " + json.dumps(summary["profile"], sort_keys=True))
    del engine
    return launches, summary


def full_width_paged(torch, fw):
    """The paged path at full width: 16 slots over a pool of 128 usable
    pages of 16 tokens — the KV memory of 4 dense 512-token slots (786,432
    B a page over 6 layers) — with a 32-token shared prefix and prefill
    chunks of 64."""
    from repro_torch.launch.serve import shared_prefix_tokens
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   WorkloadConfig, synthetic_requests)
    cfg, split, model = fw["cfg"], fw["split"], fw["model"]
    prefix = shared_prefix_tokens(32, cfg.vocab_size)
    pcfg = PagedServeConfig(n_slots=16, max_seq=512, decode_block=8,
                            page_size=16, n_pages=130, shared_prefix=prefix,
                            prefill_chunk=64)
    engine = PagedServeEngine(model, fw["params"], fw["bank"], pcfg,
                              device="cuda")
    wl = dict(WORKLOAD, vocab_size=cfg.vocab_size)
    reqs = synthetic_requests(WorkloadConfig(n_requests=24, seed=0, **wl))
    stats, launches = run_path(
        torch, "paged", engine, reqs,
        synthetic_requests(WorkloadConfig(n_requests=2, seed=1, **wl)))
    joins = stats["prefix_hits"] + stats["prefix_misses"]
    if stats["pages_in_use"] != 0 or joins != len(reqs) \
            or stats["page_copies"] != len(reqs):
        fail(f"paged full width: pages_in_use {stats['pages_in_use']}, "
             f"prefix joins {joins}, page copies {stats['page_copies']} "
             f"(want 0, {len(reqs)}, {len(reqs)}: the {len(prefix)}-token "
             f"prefix + soft prompt is not page-aligned)")
    # exact bytes: each request's own tokens at prefill (the prefix is not
    # re-sent), max_new - 1 decode crossings, and one [soft prompt |
    # prefix] prefill per prefix MISS; the int8 payload is linear in rows,
    # so chunking does not change it
    wire_err = {}
    for b in model.wire.boundaries:
        nbytes = b.codec.payload_nbytes
        want = sum(nbytes((1, len(r.tokens), cfg.d_model))
                   + (r.max_new - 1) * nbytes((1, 1, cfg.d_model))
                   for r in reqs)
        want += stats["prefix_misses"] * nbytes(
            (1, split.prompt_len + len(prefix), cfg.d_model))
        got = stats["wire_bytes"][b.name]
        wire_err[b.name] = abs(got - want) / want
        if wire_err[b.name] > PAGED_WIRE_TOL:
            fail(f"paged full width: {b.name} measured {got} B vs exact "
                 f"{want} B")
    summary = _summary(torch, stats, fw, {
        "config": f"{cfg.name} widths, {cfg.n_layers} layers (1 head / 4 "
                  f"body / 1 tail), 4 tenants, 16 slots, max_seq 512, "
                  f"page 16, 130 pages (128 usable), shared prefix "
                  f"{len(prefix)}, prefill_chunk 64, int8 wire, "
                  f"decode_block 8, fp32",
        "peak_pages": stats["peak_pages"],
        "prefix_hit_ratio": stats["prefix_hit_ratio"],
        "prefix_misses": stats["prefix_misses"],
        "page_copies": stats["page_copies"],
        "prefill_chunks": stats["prefill_chunks"],
        "wire_rel_err": wire_err, "launches": launches})
    say("paged full width: " + json.dumps(summary, sort_keys=True))
    summary["profile"] = profile_replay(torch, engine, reqs)
    say("paged profile: " + json.dumps(summary["profile"], sort_keys=True))
    return launches, summary


def profile_replay(torch, engine, reqs):
    """Replay the measured trace under torch.profiler (CUDA activity) and
    the engine's own step-level tracer: device busy share, device time by
    kernel, and host time in prefill vs decode spans. A separate run, so
    the measured run above carries no tracing cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.trace import Tracer
    engine.reset_stats()
    engine.tracer = Tracer("step")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = {}
    for rec in engine.tracer.records():
        if rec.get("kind") == "span":
            spans[rec["name"]] = spans.get(rec["name"], 0) + rec["dur_ns"]
    # device work only: kernels and memcpy/memset. The profiler also lists
    # operator ranges (aten::mm, record_function annotations) on the device
    # timeline; they span the kernels they launch and would count them twice.
    # Kernels are keyed by the first 60 characters of their names, so the
    # template instances of one cuBLAS kernel add up under one key.
    kernels, by_kind, spans_us = {}, {}, []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA \
                or getattr(evt, "is_user_annotation", False) \
                or evt.name.startswith("aten::"):
            continue
        us = evt.time_range.elapsed_us()
        kernels[evt.name[:60]] = kernels.get(evt.name[:60], 0) + us
        kind = _device_kind(evt.name)
        by_kind[kind] = by_kind.get(kind, 0) + us
        spans_us.append((evt.time_range.start, evt.time_range.end))
    busy_us, reach = 0, None   # union of the device intervals
    for start, end in sorted(spans_us):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "wall_s": wall, "tokens_out": stats["tokens_out"],
        "device_busy_share": busy_us * 1e-6 / wall,
        "device_kernel_s": sum(kernels.values()) * 1e-6,
        "host_span_s": {k: v * 1e-9 for k, v in spans.items()},
        "device_kernels": len(kernels),
        "device_ms_by_kind": {k: us * 1e-3 for k, us in by_kind.items()},
        "top_device_ms": {name: us * 1e-3 for name, us in top},
    }


# device-side names of the port's own kernels (csrc/)
PORT_KERNELS = ("decode_kernel", "paged_decode_kernel", "flash_fwd_kernel",
                "quantize_kernel", "dequantize_kernel")


def _device_kind(name: str) -> str:
    """Coarse class of a device event, for the time breakdown in PERF.md."""
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    if "gemm" in name.lower() or "gemv" in name.lower():
        return "cuBLAS gemm/gemv"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "memcpy/memset"
    return "other (elementwise, reductions, index)"


# -------------------------------------------------------------------- main
def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a GPU")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    # 1. device line
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    from repro_torch.kernels import build
    seconds = build.timed_build()
    say(f"build: {len(build.sources())} sources -> "
        f"{build.library_path().name} in {seconds:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say("  ptxas " + line.strip())

    # 3. kernels against plain
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    check_quant(torch, gen, results)
    check_prefill(torch, F, gen, results)
    check_decode(torch, F, gen, results)
    check_paged_decode(torch, F, gen, results)

    # 4. engine parity card vs CPU, dense and paged
    engine_parity(torch)

    # 5-6. the dense and the paged path at full width
    fw = full_width_model(torch)
    by_path, summaries = {}, {}
    by_path["dense"], summaries["dense"] = full_width(torch, fw)
    by_path["paged"], summaries["paged"] = full_width_paged(torch, fw)

    # 7. kernels line, device line
    kernels = []
    for name in REPLACES:
        per_path = {path: counts[name] for path, counts in by_path.items()
                    if name in PATHS[path]}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=sum(per_path.values()),
            launches_by_path=per_path,
            **{k: results[name][k] for k in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}))
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "phase3": results,
         "full_width": summaries}, indent=1, sort_keys=True))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
