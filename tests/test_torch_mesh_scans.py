"""The recurrent families tensor-parallel over 'model' — zamba2 (Mamba-2
with its shared attention block) and rwkv6 (RWKV-6) — held against the
JAX package's single-device round and dense engine
(tests/torch_mesh_families.py sets them up).

On (data 1, model 2) and (data 1, model 4): the SFPrompt round's params
within rtol 1e-5 / atol 1e-6 of JAX's, metrics within rtol 1e-5, bytes
and kept sets `==`; rwkv6's `client_updates` the same; rwkv6's secure
round on (data 2, model 2) against JAX's secure round; the dense
engine's tokens `==`, logits within 1e-5 and wire bytes `==`; every
rank's frozen leaves at their local shapes (in_proj's columns, out_proj's
rows; r, k, v, g, cr and cv by columns, o by rows) and its caches' `ssm`
and `state` leaves at H/T heads where T divides the heads (the conv and
token-shift states whole); on the int8 wire the 'model' ranks cross
with bit-identical rows and uniforms. And the pieces alone:
`parallel.gather_replicated`'s backward keeps a rank's slice of the
gradient (one count, where `gather_model` sums T), and the Mamba-2 and
RWKV-6 blocks on local shards give the whole block's output and input
gradient, RWKV-6's too at 2 heads (half a head a rank on 'model' 4: its
r, k, v and g gathered, every head scanned), and Mamba-2 shards that are
not whole heads and an RWKV-6 channel mix with one of ck and cv sharded
are refused. Seeds: JAX init seed 0 throughout, as
tests/test_torch_lm_round.py's fp32 rounds and
test_torch_recurrent_serve.py's engines.

Two bounds are wider than the ViT mesh tests' (rtol 1e-5, atol 1e-6) and
the engine tests' (1e-5), because the unsharded port is already farther
than that from JAX on these draws, before any rank sums in another order:
rwkv6's round and `client_updates` at d_model 256 take
tests/test_torch_lm_round.py's atol 1e-5 (the unsharded port's params
are up to 2.2e-6 beyond rtol 1e-5 / atol 1e-6 of JAX's); zamba2's 18
layers take atol 1e-4 in the engine (the unsharded port's logits are up
to 3.8e-5 from JAX's, and the ranks' up to 6.3e-5 from the unsharded
port's, on logits up to 3.6). The secure round adds `roundtrip_tol(K)`:
a sum in another order can move a client's value across a fixed-point
rounding edge, one quantum (2^-16) of the aggregate."""
import numpy as np
import pytest
import torch

from torch_mesh_families import (K, LM_TOL, TOL, TP, check_local_shapes,
                                 check_round, check_serve, run_ranks,
                                 section)

ZAMBA, RWKV = "zamba2-2.7b", "rwkv6-3b"
CASES = {ZAMBA: dict(seed=0, serve=True, serve_seed=0, wire=True),
         RWKV: dict(seed=0, serve=True, serve_seed=0, secure=True,
                    updates=True)}
BLOCK_SEED = 3
ROUND_TOL = {ZAMBA: TOL, RWKV: LM_TOL}
ENGINE_TOL = {ZAMBA: dict(rtol=1e-5, atol=1e-4),
              RWKV: dict(rtol=1e-5, atol=1e-5)}


def gathered(x, w, tp, rank, mesh=None):
    """d/dx of sum(y * w + y * y) for y = x gathered over 'model' (`mesh`)
    from this rank's column block of x, or y = x without one."""
    from repro_torch.sharding import parallel
    width = x.shape[-1] // tp
    xl = (x[..., rank * width:(rank + 1) * width] if mesh is not None
          else x).clone().requires_grad_(True)
    y = parallel.gather_replicated(xl, mesh) if mesh is not None else xl
    g, = torch.autograd.grad((y * w + y * y).sum(), xl)
    return g.numpy()


def block_case(arch, kind, narrow=False):
    """A reduced family's Mamba-2 or RWKV-6 block, an input and a weight,
    from `BLOCK_SEED`; `narrow`: at the engine tests' d_model 64 (RWKV-6:
    2 heads)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from torch_mesh_families import family_cfg
    cfg = family_cfg(get_config, arch, serve=narrow)
    gen = torch.Generator().manual_seed(BLOCK_SEED)
    init = L.init_mamba2 if kind == "mamba2" else L.init_rwkv6
    params = init(gen, cfg, device="cpu")
    x = torch.randn((2, 5, cfg.d_model), generator=gen)
    w = torch.randn((2, 5, cfg.d_model), generator=gen)
    return cfg, params, x, w


def block_grads(kind, cfg, params, x, w, mesh=None):
    """The block's train-mode delta and d/dx of sum(delta * w)."""
    from repro_torch.models import layers as L
    x = x.clone().requires_grad_(True)
    pos = torch.arange(5, dtype=torch.int32)[None].expand(2, 5)
    ctx = L.Ctx(mode="train", positions=pos, differentiable=True, mesh=mesh)
    apply = L.apply_mamba2 if kind == "mamba2" else L.apply_rwkv6
    y, _ = apply(params, cfg, x, ctx, None)
    g, = torch.autograd.grad((y * w).sum(), x)
    return y.detach().numpy(), g.numpy()


BLOCKS = ((ZAMBA, "mamba2", False), (RWKV, "rwkv6", False))


def pieces(meshes):
    """Every rank: the gather's gradient and both blocks on local shards,
    on 'model' 2 and 4."""
    import torch.distributed as dist

    from repro_torch.sharding import params_pspecs, parallel
    from repro_torch.sharding.rules import pop_sharding_fallbacks
    from repro_torch.tree import tree_map
    gen = torch.Generator().manual_seed(BLOCK_SEED)
    x, w = torch.randn((3, 8), generator=gen), torch.randn((3, 8),
                                                          generator=gen)
    out = {}
    rank = dist.get_rank()
    for tp in TP:
        if rank >= tp:
            continue
        mesh = meshes[tp]
        out["gather", tp] = gathered(x, w, tp, rank, mesh)
        for arch, kind, narrow in BLOCKS + ((RWKV, "rwkv6", True),):
            cfg, params, bx, bw = block_case(arch, kind, narrow)
            specs = params_pspecs(params, mesh)
            pop_sharding_fallbacks()
            local = tree_map(lambda a, s: parallel.local_shard(a, s, mesh)
                             .clone(), params, specs)
            out[kind, narrow, tp] = block_grads(kind, cfg, local, bx, bw,
                                                mesh) + (
                local["r"]["w"].shape[-1] if kind == "rwkv6" else None,)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("mesh_scans"), CASES, pieces)


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("arch", list(CASES))
def test_tp_round_matches_jax(runs, arch, tp):
    refs, ranks = runs
    for r in ranks[:tp]:
        got = r[arch][f"round{tp}"]
        check_round(refs, got, arch, tol=ROUND_TOL[arch])
        np.testing.assert_array_equal(got["kept"], refs[f"{arch}/kept"])


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("arch", list(CASES))
def test_tp_frozen_leaves_held_at_local_shapes(runs, arch, tp):
    """zamba2: in_proj (256, 1072) by columns and out_proj (512, 256) by
    rows in each Mamba-2 layer, the shared block by heads; rwkv6: r, k, v,
    g, cr and cv by columns, o by rows, ck by d_ff."""
    _, ranks = runs
    for r in ranks[:tp]:
        check_local_shapes(arch, tp, r[arch][f"round{tp}"]["body"],
                           min_cut=8)


def test_tp_client_updates_match_jax(runs):
    refs, ranks = runs
    want = section(refs, f"{RWKV}/updates")
    for tp in TP:
        got = ranks[0][RWKV][f"updates{tp}"]["params"]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **ROUND_TOL[RWKV])


def test_tp_secure_round_on_data_and_model_matches_jax(runs):
    """rwkv6 on (data 2, model 2): each 'data' index trains one client on
    its two 'model' ranks, and the secure aggregate is JAX's."""
    from repro_torch.privacy.fixed_point import roundtrip_tol
    refs, ranks = runs
    tol = dict(rtol=1e-5, atol=roundtrip_tol(K) + LM_TOL["atol"])
    for r in ranks:
        check_round(refs, r[RWKV]["secure"], RWKV, "secure", tol)
        np.testing.assert_array_equal(r[RWKV]["secure"]["kept"],
                                      refs[f"{RWKV}/kept"])


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("arch", list(CASES))
def test_tp_serving_matches_jax(runs, arch, tp):
    refs, ranks = runs
    for r in ranks[:tp]:
        check_serve(refs, r[arch][f"serve{tp}"], arch, ENGINE_TOL[arch])


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("arch", list(CASES))
def test_tp_serving_caches_hold_local_heads(runs, arch, tp):
    """At the engine's width (d_model 64): zamba2's `ssm` holds 4 / T of
    its 4 Mamba-2 heads, rwkv6's `state` 2 / T of its 2 heads on 'model'
    2 and both on 'model' 4 (2 heads do not divide it, so the rules
    replicate the cache and every rank scans both); conv, shift_t and
    shift_c whole; the tails' caches whole; the engine's frozen leaves at
    their local shapes, the same shards `bridge.jax_to_local` cuts."""
    _, ranks = runs
    for r in ranks[:tp]:
        res = r[arch][f"serve{tp}"]
        assert res["bridge_equal"]      # jax_to_local: in_proj, cv, cr
        for seg in ("head", "body"):
            check_local_shapes(arch, tp, res["shared"][seg], seg,
                               serve=True)
        body, tail = res["caches"]["body"], res["caches"]["tail"]
        if arch == ZAMBA:
            assert body["pos0/ssm"][2] == 4 // tp
            assert tail["pos0/ssm"][2] == 4
            assert body["pos0/conv"] == tail["pos0/conv"]
        else:
            assert body["pos0/state"][2] == {2: 1, 4: 2}[tp]
            assert tail["pos0/state"][2] == 2
            for name in ("shift_t", "shift_c"):
                assert body[f"pos0/{name}"] == tail[f"pos0/{name}"]


def test_tp_int8_rows_identical_across_model_ranks(runs):
    from torch_mesh_families import _round
    refs, ranks = runs
    a, b = ranks[0][ZAMBA]["int8"], ranks[1][ZAMBA]["int8"]
    assert a["log"] and a["log"] == b["log"]
    assert a["meter"] == b["meter"] == _round(ZAMBA, refs, None,
                                              wire="int8")["meter"]


@pytest.mark.parametrize("tp", TP)
def test_gather_replicated_backward_keeps_the_slice(runs, tp):
    """y = gather_replicated(x's column block) into replicated compute:
    each rank's gradient is its block of the single-process gradient,
    counted once."""
    _, ranks = runs
    gen = torch.Generator().manual_seed(BLOCK_SEED)
    x, w = torch.randn((3, 8), generator=gen), torch.randn((3, 8),
                                                          generator=gen)
    want = gathered(x, w, tp, 0)
    width = 8 // tp
    for rank, r in enumerate(ranks[:tp]):
        np.testing.assert_array_equal(
            r["extra"]["gather", tp], want[:, rank * width:(rank + 1) * width])


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("arch,kind", [b[:2] for b in BLOCKS])
def test_block_on_local_shards_matches_whole(runs, arch, kind, tp):
    """The Mamba-2 block (norm over the gathered d_inner) and the RWKV-6
    block (its channel mix gathered into the residual stream) on local
    shards: output and input gradient within 1e-5 of the whole block."""
    _, ranks = runs
    y, g = block_grads(kind, *block_case(arch, kind))
    for r in ranks[:tp]:
        ly, lg, _ = r["extra"][kind, False, tp]
        np.testing.assert_allclose(ly, y, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(lg, g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tp", TP)
def test_rwkv6_split_heads_block_matches_whole(runs, tp):
    """RWKV-6 at d_model 64 (2 heads of 32): on 'model' 2 a head a rank,
    on 'model' 4 half a head (r, k, v and g gathered, every head scanned,
    o's rows kept); output and input gradient within 1e-5 of the whole
    block."""
    _, ranks = runs
    cfg, params, x, w = block_case(RWKV, "rwkv6", narrow=True)
    assert cfg.d_model // cfg.rwkv6.head_size == 2
    y, g = block_grads("rwkv6", cfg, params, x, w)
    for r in ranks[:tp]:
        ly, lg, cols = r["extra"]["rwkv6", True, tp]
        assert cols == 64 // tp
        np.testing.assert_allclose(ly, y, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(lg, g, rtol=1e-5, atol=1e-6)


def _cut(leaf, n, axis=-1):
    """The first of n blocks of a leaf's weight along `axis`: a rank's
    shard, cut by hand."""
    w = leaf["w"]
    return dict(leaf, w=w.narrow(axis % w.dim(), 0, w.shape[axis] // n))


@pytest.mark.parametrize("case", ["mamba2 heads", "rwkv6 channel mix"])
def test_split_heads_are_refused(case):
    """Mamba-2 shards that are not whole heads (6 heads at d_model 96 over
    'model' 4) and an RWKV-6 channel mix with cv sharded and ck whole
    raise NotImplementedError before any collective; the whole blocks
    run."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    arch = ZAMBA if case.startswith("mamba2") else RWKV
    base = get_config(arch)
    cfg = base.reduced(n_layers=3 * len(base.layer_pattern), d_model=96,
                       d_ff=192)
    kind = "mamba2" if arch == ZAMBA else "rwkv6"
    gen = torch.Generator().manual_seed(BLOCK_SEED)
    params = (L.init_mamba2 if kind == "mamba2" else L.init_rwkv6)(
        gen, cfg, device="cpu")
    x = torch.randn((2, 5, cfg.d_model), generator=gen)
    block_grads(kind, cfg, params, x, x)
    if case == "mamba2 heads":
        assert cfg.mamba2.n_heads(cfg.d_model) == 6
        params = dict(params, in_proj=_cut(params["in_proj"], 4),
                      out_proj=_cut(params["out_proj"], 4, axis=0))
        msg = "6 heads over a 'model' axis of 4"
    else:
        params = dict(params, cv=_cut(params["cv"], 2),
                      cr=_cut(params["cr"], 2))
        msg = "one of ck and cv sharded"
    with pytest.raises(NotImplementedError, match=msg):
        block_grads(kind, cfg, params, x, x)
