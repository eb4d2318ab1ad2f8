"""Whisper and Qwen2-VL tensor-parallel over 'model', held against the
JAX package's single-device round (tests/torch_mesh_families.py sets
them up): whisper-base (its encoder in the head, non-causal; decoder
blocks of self-attention, cross-attention and a GELU MLP) with `frames`
in the cohort, and qwen2-vl-72b (M-RoPE on a rank's heads, the patch
prefix replicated) with 8 patch embeddings and their grid positions.

On (data 1, model 2) and (data 1, model 4): the SFPrompt round's params
within rtol 1e-5 / atol 1e-6 of JAX's, metrics within rtol 1e-5, bytes
and kept sets `==`; whisper's `client_updates` the same; every rank's
frozen leaves at their local shapes (the encoder's attention and MLP in
the head, cq/ck/cv by columns and co by rows); on the int8 wire the
'model' ranks cross with bit-identical rows and uniforms. Neither family
has a token engine: both engines still refuse them with the JAX
package's message. Cross-attention shards that are not whole heads are
gathered, as self-attention's are. JAX init seed 0, as tests/test_torch_whisper.py's and
test_torch_vlm.py's rounds."""
import numpy as np
import pytest

from torch_mesh_families import (TOL, TP, check_local_shapes, check_round,
                                 family_cfg, run_ranks, section)

WHISPER, VLM = "whisper-base", "qwen2-vl-72b"
CASES = {WHISPER: dict(seed=0, updates=True, wire=True),
         VLM: dict(seed=0, wire=True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("mesh_encdec"), CASES)


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("arch", list(CASES))
def test_tp_round_matches_jax(runs, arch, tp):
    refs, ranks = runs
    for r in ranks[:tp]:
        got = r[arch][f"round{tp}"]
        check_round(refs, got, arch)
        np.testing.assert_array_equal(got["kept"], refs[f"{arch}/kept"])


@pytest.mark.parametrize("tp", TP)
def test_tp_client_updates_match_jax(runs, tp):
    refs, ranks = runs
    got = ranks[0][WHISPER][f"updates{tp}"]["params"]
    want = section(refs, f"{WHISPER}/updates")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("tp", TP)
@pytest.mark.parametrize("arch", list(CASES))
def test_tp_frozen_leaves_held_at_local_shapes(runs, arch, tp):
    """The body's attention (and whisper's cross-attention) by heads and
    its MLP by d_ff; the head's encoder layers likewise (whisper)."""
    _, ranks = runs
    for r in ranks[:tp]:
        cut = check_local_shapes(arch, tp, r[arch][f"round{tp}"]["body"],
                                 min_cut=6)
        assert cut >= (10 if arch == WHISPER else 6)


@pytest.mark.parametrize("tp", TP)
def test_whisper_encoder_runs_on_local_shards(runs, tp):
    """The head the round holds (`shard_params`) keeps the encoder's q, k,
    v, o, up and down cut over 'model' like the decoder's (at 'model' 4
    its 4 heads of 32 leave a rank one)."""
    from torch_mesh_families import local_shapes
    _, ranks = runs
    head = local_shapes(WHISPER, tp)["head"]
    assert sum("model" in spec for _, _, spec in head) >= 12
    for r in ranks[:tp]:
        check_local_shapes(WHISPER, tp, r[WHISPER][f"round{tp}"]["head"],
                           seg="head", min_cut=12)


@pytest.mark.parametrize("arch", list(CASES))
def test_tp_int8_rows_identical_across_model_ranks(runs, arch):
    from torch_mesh_families import _round
    refs, ranks = runs
    a, b = ranks[0][arch]["int8"], ranks[1][arch]["int8"]
    assert a["log"] and a["log"] == b["log"]
    assert a["meter"] == b["meter"] == _round(arch, refs, None,
                                              wire="int8")["meter"]


@pytest.mark.parametrize("arch", list(CASES))
def test_engines_still_refuse_on_a_model_axis(arch):
    """Both engines refuse the audio and VLM families on a mesh as without
    one, with the JAX package's message."""
    import torch

    from torch_mesh_families import _models
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   ServeConfig, ServeEngine, TenantBank)
    model = _models(arch)
    tp = type("Mesh", (), {"shape": {"data": 1, "model": 2}})()
    bank = TenantBank({"x": torch.zeros((1, 1))}, torch.zeros((1, 4, 256)))
    for engine, scfg, msg in (
            (ServeEngine, ServeConfig(), "no token decode loop"),
            (PagedServeEngine, PagedServeConfig(page_size=8),
             "paged serving unsupported")):
        with pytest.raises(ValueError, match=msg):
            engine(model, {}, bank, scfg, mesh=tp, device="cpu")


def _split_head_cfg():
    """The whisper family with 2 heads of 32: on 'model' 4 a rank's
    cq/ck/cv hold 16 columns, half a head."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = family_cfg(get_config, WHISPER)
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, n_heads=2, n_kv_heads=2))


def cross_attention_split_rank():
    """One rank of `test_cross_attention_refuses_split_heads`: the
    cross-attention half on local shards of half a head over a (data 1,
    model 4) mesh, forward and the gradients of its input and of the
    encoder output in a differentiated pass, beside the whole block on
    the same draws."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.sharding.parallel import axis_index
    cfg = _split_head_cfg()
    gen = torch.Generator().manual_seed(0)
    p = L.init_attention(gen, cfg, cross=True, device="cpu")
    p.update(L.init_cross_attention_extra(gen, cfg, device="cpu"))
    x = torch.randn((2, 3, cfg.d_model), generator=gen)
    enc = torch.randn((2, 5, cfg.d_model), generator=gen)
    pos = torch.zeros((2, 3), dtype=torch.int32)
    mesh = make_host_mesh(model=4)
    cut = cfg.attention.n_heads * cfg.attention.head_dim // 4
    cols = slice(axis_index(mesh, "model") * cut,
                 (axis_index(mesh, "model") + 1) * cut)
    local = dict(p)
    for n in ("cq", "ck", "cv"):
        local[n] = {k: (v[..., cols] if k in ("w", "b") else v)
                    for k, v in p[n].items()}
    local["co"] = dict(p["co"], w=p["co"]["w"][cols])
    out = {}
    for name, params, m in (("whole", p, None), ("split", local, mesh)):
        xs, es = x.clone().requires_grad_(), enc.clone().requires_grad_()
        ctx = L.Ctx(mode="train", positions=pos, differentiable=True,
                    encoder_out=es, mesh=m)
        y = L.apply_cross_attention(params, cfg, xs, ctx)
        (y * torch.arange(y.numel()).reshape(y.shape).sin()).sum().backward()
        out[name] = [t.detach().numpy() for t in (y, xs.grad, es.grad)]
    return out


def test_cross_attention_refuses_split_heads():
    """Whisper's cross-attention with cq/ck/cv shards of half a head (2
    heads of 32 over 'model' 4) no longer refuses: q, k and v are gathered
    over 'model' and every rank attends all heads, as self-attention
    does. On 4 ranks the output and the gradients of the input and of the
    encoder output equal the whole block's within 1e-5."""
    from repro_torch.launch.mesh import spawn_ranks
    att = _split_head_cfg().attention
    assert (att.n_heads * att.head_dim // 4) % att.head_dim
    for r in spawn_ranks(cross_attention_split_rank, 4):
        for got, want in zip(r["split"], r["whole"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
