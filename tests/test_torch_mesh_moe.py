"""The MoE families tensor-parallel over 'model' — phi3.5-moe (top-2 of 4
experts) and deepseek-v3 (MLA throughout, its dense prefix layer, a
shared expert, the MTP head in the tail) — held against the JAX
package's single-device round and dense engine
(tests/torch_mesh_families.py sets them up).

On (data 1, model 2) and (data 1, model 4): the SFPrompt round's params
within rtol 1e-5 / atol 1e-6 of JAX's, metrics within rtol 1e-5, bytes
and kept sets `==`; deepseek-v3's `client_updates` (MoE and MLA) the
same; the dense engine's tokens `==`, logits within 1e-5 and wire bytes
`==`; every rank's frozen leaves at their local shapes (E/T experts a
rank; MLA's q_a, kv_a, q_b and kv_b by columns) with the latent cache
whole; on the int8 wire the 'model' ranks cross with bit-identical rows
and uniforms and route bit-identically. And the block alone: the
expert-parallel `apply_moe` on 2 and 4 ranks gives the whole block's
output and input gradient, its aux loss's gradient counted once; and
deepseek-v3's MLA block on local shards gives the whole block's output
and input gradient, at 4 heads (whole heads a rank on 'model' 2 and 4)
and at 2 heads (on 'model' 4 half a head a rank: q_b's and kv_b's
outputs gathered and every head attended).

Every run's router margin (the smallest gap between a token's k-th and
(k+1)-th router probability) is printed and held above 1e-5 (rounds) or
1e-4 (the engine), tests/test_torch_moe_round.py's floors: the sums of a
rank's partial outputs over 'model' are taken in another order than the
unsharded block's, and a draw that ties two experts more closely could
flip a choice. `CASES`' seeds are JAX init seeds: seed 0 holds both
families' rounds (margins 2.4e-5 and above); the engines take
tests/test_torch_moe_round.py's `ENGINE_SEED`s at its width (d_model
64)."""
import dataclasses

import numpy as np
import pytest
import torch

from torch_mesh_families import (ENGINE_MARGIN, ROUND_MARGIN, TOL, TP,
                                 check_local_shapes, check_margin,
                                 check_round, check_serve, run_ranks,
                                 section)

PHI, DS = "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"
CASES = {PHI: dict(seed=0, serve=True, serve_seed=0, wire=True),
         DS: dict(seed=0, serve=True, serve_seed=1, updates=True)}
BLOCK_SEED = 5
MLA_HEADS = (4, 2)


def block_case(arch):
    """A reduced family's MoE block (deepseek-v3: with its shared expert),
    its whole params and an input, from `BLOCK_SEED`."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from torch_mesh_families import family_cfg
    cfg = family_cfg(get_config, arch)
    gen = torch.Generator().manual_seed(BLOCK_SEED)
    params = L.init_moe(gen, cfg, device="cpu")
    x = torch.randn((2, 9, cfg.d_model), generator=gen)
    w = torch.randn((2, 9, cfg.d_model), generator=gen)
    return cfg, params, x, w


def block_grads(cfg, params, x, w, mesh=None):
    """apply_moe's output, aux and d/dx of sum(y * w) + 1000 * aux (the aux
    term large, so an aux gradient counted T times would show)."""
    from repro_torch.models import layers as L
    x = x.clone().requires_grad_(True)
    y, aux = L.apply_moe(params, cfg, x, mesh)
    g, = torch.autograd.grad((y * w).sum() + 1000.0 * aux, x)
    return y.detach().numpy(), float(aux), g.numpy()


def mla_case(n_heads):
    """deepseek-v3's reduced MLA block with `n_heads` heads, its whole
    params, an input and a weight, from `BLOCK_SEED`."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from torch_mesh_families import family_cfg
    cfg = family_cfg(get_config, DS)
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, n_heads=n_heads, n_kv_heads=n_heads))
    gen = torch.Generator().manual_seed(BLOCK_SEED)
    params = L.init_attention(gen, cfg, device="cpu")
    x = torch.randn((2, 9, cfg.d_model), generator=gen)
    w = torch.randn((2, 9, cfg.d_model), generator=gen)
    return cfg, params, x, w


def mla_grads(cfg, params, x, w, mesh=None):
    """The MLA block's causal train-mode delta and d/dx of
    sum(delta * w)."""
    from repro_torch.models import layers as L
    x = x.clone().requires_grad_(True)
    pos = torch.arange(9, dtype=torch.int32)[None].expand(2, 9)
    ctx = L.Ctx(mode="train", positions=pos, differentiable=True, mesh=mesh)
    y, _ = L.apply_attention(params, cfg, x, ctx, None)
    g, = torch.autograd.grad((y * w).sum(), x)
    return y.detach().numpy(), g.numpy()


def expert_parallel_blocks(meshes):
    """Every rank: each family's block on its local experts (and shared
    expert columns), and the MLA block on its local columns, on 'model' 2
    and 4."""
    import torch.distributed as dist

    from repro_torch.sharding import params_pspecs, parallel
    from repro_torch.sharding.rules import pop_sharding_fallbacks
    from repro_torch.tree import tree_map
    out = {}
    for arch in CASES:
        cfg, params, x, w = block_case(arch)
        for tp in TP:
            if dist.get_rank() >= tp:
                continue
            mesh = meshes[tp]
            specs = params_pspecs(params, mesh)
            pop_sharding_fallbacks()
            local = tree_map(lambda a, s: parallel.local_shard(a, s, mesh)
                             .clone(), params, specs)
            out[arch, tp] = block_grads(cfg, local, x, w, mesh) + (
                tuple(local["experts"]["up"].shape),)
    for heads in MLA_HEADS:
        cfg, params, x, w = mla_case(heads)
        for tp in TP:
            if dist.get_rank() >= tp:
                continue
            mesh = meshes[tp]
            specs = params_pspecs(params, mesh)
            pop_sharding_fallbacks()
            local = tree_map(lambda a, s: parallel.local_shard(a, s, mesh)
                             .clone(), params, specs)
            out["mla", heads, tp] = mla_grads(cfg, local, x, w, mesh) + (
                {n: local[n]["w"].shape[-1] for n in ("q_b", "kv_b")},)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("mesh_moe"), CASES,
                     expert_parallel_blocks)


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("arch", list(CASES))
def test_tp_round_matches_jax(runs, arch, tp):
    refs, ranks = runs
    for r in ranks[:tp]:
        got = r[arch][f"round{tp}"]
        check_margin(f"{arch} round on model {tp}", got["probe"]["margin"],
                     ROUND_MARGIN)
        check_round(refs, got, arch)
        np.testing.assert_array_equal(got["kept"], refs[f"{arch}/kept"])


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("arch", list(CASES))
def test_tp_frozen_leaves_held_at_local_shapes(runs, arch, tp):
    """Each rank's body holds E/T experts (4 -> 2 or 1), the attention
    (or MLA) projections by heads, deepseek-v3's shared expert by d_ff;
    the router whole."""
    _, ranks = runs
    for r in ranks[:tp]:
        cut = check_local_shapes(arch, tp, r[arch][f"round{tp}"]["body"],
                                 min_cut=7)
        assert cut >= (10 if arch == DS else 7)


@pytest.mark.parametrize("tp", TP)
def test_tp_client_updates_match_jax(runs, tp):
    refs, ranks = runs
    got = ranks[0][DS][f"updates{tp}"]
    check_margin(f"{DS} client_updates on model {tp}",
                 got["probe"]["margin"], ROUND_MARGIN)
    want = section(refs, f"{DS}/updates")
    assert got["params"].keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("arch", list(CASES))
def test_tp_serving_matches_jax(runs, arch, tp):
    refs, ranks = runs
    for r in ranks[:tp]:
        got = r[arch][f"serve{tp}"]
        check_margin(f"{arch} engine on model {tp}", got["probe"]["margin"],
                     ENGINE_MARGIN)
        check_serve(refs, got, arch)


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("arch", list(CASES))
def test_tp_serving_holds_local_shards(runs, arch, tp):
    """The engine's head and body at their local shapes; phi3.5-moe's body
    cache holds 2 / T kv heads (on 'model' 4, where 2 heads do not divide,
    both, as the rules replicate them), deepseek-v3's latent cache (ckv
    32, kr 16) stays whole on every rank; the tails' caches whole;
    `bridge.jax_to_local` cuts the same shards from JAX's arrays."""
    _, ranks = runs
    for r in ranks[:tp]:
        res = r[arch][f"serve{tp}"]
        assert res["bridge_equal"]      # jax_to_local cuts the 4-D experts
        for seg in ("head", "body"):
            check_local_shapes(arch, tp, res["shared"][seg], seg,
                               serve=True)
        body, tail = res["caches"]["body"], res["caches"]["tail"]
        if arch == PHI:
            assert body["pos0/k"][3] == {2: 1, 4: 2}[tp]
            assert tail["pos0/k"][3] == 2
        else:
            assert body["pos0/ckv"] == tail["pos0/ckv"]
            assert body["pos0/ckv"][-1] == 32 and body["pos0/kr"][-1] == 16


def test_tp_int8_rows_and_routing_identical_across_model_ranks(runs):
    """On the int8 wire the two 'model' ranks cross with bit-identical
    rows, uniforms and dequantized values, route every MoE call
    bit-identically (`top_e`), and meter the unsharded round's bytes."""
    from torch_mesh_families import _round
    refs, ranks = runs
    a, b = ranks[0][PHI]["int8"], ranks[1][PHI]["int8"]
    assert a["log"] and a["log"] == b["log"]
    assert a["routes"] and a["routes"] == b["routes"]
    assert a["meter"] == b["meter"] == _round(PHI, refs, None,
                                              wire="int8")["meter"]


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("arch", list(CASES))
def test_expert_parallel_block_and_aux_gradient(runs, arch, tp):
    """The block on E/T experts a rank gives the whole block's output,
    aux and input gradient (aux weighted 1000 in the loss: counted once,
    not T times)."""
    _, ranks = runs
    cfg, params, x, w = block_case(arch)
    y, aux, g = block_grads(cfg, params, x, w)
    for r in ranks[:tp]:
        ly, laux, lg, experts = r["extra"][arch, tp]
        assert experts[0] == 4 // tp
        np.testing.assert_allclose(ly, y, rtol=1e-5, atol=1e-6)
        assert laux == aux
        np.testing.assert_allclose(lg, g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("heads", MLA_HEADS)
def test_mla_block_on_local_shards_matches_whole(runs, heads, tp):
    """MLA on local columns of q_a, kv_a, q_b and kv_b and rows of o gives
    the whole block's output and input gradient within 1e-5; with 2 heads
    on 'model' 4 a rank's q_b and kv_b columns are half a head (the
    gathered path), elsewhere whole heads."""
    _, ranks = runs
    cfg, params, x, w = mla_case(heads)
    y, g = mla_grads(cfg, params, x, w)
    m = cfg.attention.mla
    per_head = {"q_b": m.qk_nope_head_dim + m.qk_rope_head_dim,
                "kv_b": m.qk_nope_head_dim + m.v_head_dim}
    for r in ranks[:tp]:
        ly, lg, cols = r["extra"]["mla", heads, tp]
        for n, width in per_head.items():
            assert cols[n] == heads * width // tp
            assert (cols[n] % width == 0) == (heads % tp == 0)
        np.testing.assert_allclose(ly, y, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(lg, g, rtol=1e-5, atol=1e-6)
