"""The port's dry-run accounting (`launch/specs.py`, `launch/hlo.py`,
`launch/dryrun.py`, the accounting mesh and the collective log of
`sharding/parallel.py`) on the `meta` device, held against the JAX
package: the spec builders' shapes and dtypes leaf for leaf for every
assigned architecture and shape, `_model_flops` `==` JAX's (in a
subprocess: importing `repro.launch.dryrun` sets XLA's device count for
its process), one Megatron MLP's collective bytes, `account_one`'s keys
and rank-0 argument bytes on a (2, 2) accounting mesh, the unsharded
FLOPs of a reduced dense config within 10% of JAX's analysis-pass
`cost_analysis()`, the chunked scans on `meta`, and no process group
left behind."""
import torch

torch.set_num_threads(2)

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import ASSIGNED as JASSIGNED  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
import repro.launch.specs as jspecs  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.core import SplitConfig, SplitModel  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.sharding import parallel  # noqa: E402
from repro_torch.sharding.rules import (cache_pspecs,  # noqa: E402
                                        params_pspecs,
                                        pop_sharding_fallbacks)
from repro_torch.tree import tree_flatten  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=16)
JAX_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int32": torch.int32}
KEYS = ("arch", "shape", "mesh", "kind", "n_chips", "loss_mode",
        "microbatches", "memory", "op_counts_full", "collective_bytes",
        "hlo_flops", "hlo_bytes", "hlo_flops_global", "hlo_bytes_global",
        "roofline", "bottleneck", "model_flops", "useful_flops_frac")


def _jax_leaves(tree):
    return {tuple(p.key for p in path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    return {path: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for path, x in tree_flatten(tree)}


def _ordered(tree):
    return [p for p, _ in tree_flatten(tree)]


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_specs_match_jax(arch):
    """Params, caches and batches of every shape: the same leaves in the
    same order, each with JAX's shape and dtype, all on `meta`."""
    assert sorted(ASSIGNED) == sorted(JASSIGNED)
    assert specs.VLM_PATCH_FRACTION == jspecs.VLM_PATCH_FRACTION
    assert {k: (v.kind, v.seq, v.global_batch)
            for k, v in specs.SHAPES.items()} == {
        k: (v.kind, v.seq, v.global_batch)
        for k, v in jspecs.SHAPES.items()}
    jm = JSplitModel(jget_config(arch), JSplitConfig(**SPLIT))
    tm = SplitModel(get_config(arch), SplitConfig(**SPLIT))
    pairs = [(jspecs.param_specs(jm), specs.param_specs(tm))]
    for name, shape in specs.SHAPES.items():
        jshape = jspecs.SHAPES[name]
        if shape.kind != "train":
            pairs.append((jspecs.cache_specs(jm, jshape),
                          specs.cache_specs(tm, shape)))
        for lead in ((3,), (2, 3)):
            jb = jspecs.batch_specs(jm.cfg, jshape, leading=lead)
            tb = specs.batch_specs(tm.cfg, shape, leading=lead)
            pairs.append((jb, tb))
            pairs.append((jspecs.stack_client_axis(jb, 4),
                          specs.stack_client_axis(tb, 4)))
    for want, got in pairs:
        jw, pg = _jax_leaves(want), _port_leaves(got)
        assert list(jw) == _ordered(got)
        assert pg == jw
        for _, x in tree_flatten(got):
            assert x.is_meta


def test_model_flops_equal_jax():
    """`_model_flops` of every assigned architecture and shape `==` JAX's,
    computed in a child process."""
    code = ("import json, repro.launch.dryrun as d\n"
            "from repro.configs import ASSIGNED, get_config\n"
            "print(json.dumps({f'{a}|{s}': d._model_flops(get_config(a), "
            "d.SHAPES[s]) for a in ASSIGNED for s in d.SHAPES}))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = {f"{a}|{s}": dryrun._model_flops(get_config(a), specs.SHAPES[s])
           for a in ASSIGNED for s in specs.SHAPES}
    assert len(got) == 40
    assert got == want


def test_megatron_mlp_logs_one_all_reduce():
    """One MLP layer on local shards of a (data 1, model 2) accounting
    mesh, forward: one all-reduce over 'model' of the (B, T, D) partial
    output, its bytes in the log; its backward adds the all-reduce of the
    input's gradient (the same bytes), and a gather logs an all-gather of
    its gathered output."""
    from repro_torch.models import layers as L
    cfg = get_config("qwen2.5-14b").reduced(n_layers=1, d_model=64,
                                            d_ff=128)
    mesh = parallel.AccountingMesh({"data": 1, "model": 2})
    p = L.init_mlp(torch.Generator().manual_seed(0), cfg, device="cpu")
    spec = params_pspecs({"mlp": p}, mesh)["mlp"]
    local = {k: {"w": parallel.local_shard(v["w"], spec[k]["w"], mesh)}
             if k != "ln" else v for k, v in p.items()}
    B, T, D = 2, 5, 64
    x = torch.randn((B, T, D), device="meta", requires_grad=True)
    local = {k: {n: t.to("meta") for n, t in v.items()}
             for k, v in local.items()}
    with parallel.collective_log() as log:
        y = L.apply_mlp(local, cfg, x, mesh)
    assert y.shape == (B, T, D) and y.is_meta
    assert log.records == [("all-reduce", "model", B * T * D * 4)]
    with parallel.collective_log() as log:
        y.sum().backward()
        parallel.gather_model(torch.zeros((B, T, 8)), mesh)
    assert log.records == [("all-reduce", "model", B * T * D * 4),
                           ("all-gather", "model", B * T * 16 * 4)]


def _local_bytes(tree, specs_tree, mesh, skip_model=False):
    """Bytes of a rank's blocks of `tree` under `specs_tree`, by dividing
    each dim by its axes' sizes (the 'model' axis skipped where the port
    keeps the leaf's heads whole)."""
    sizes = mesh.shape
    total = 0
    for (path, x), (_, spec) in zip(tree_flatten(tree),
                                    tree_flatten(specs_tree)):
        n = x.numel()
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None and not (skip_model and a == "model"):
                    n //= sizes[a]
        total += n * x.element_size()
    return total


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_account_one_keys_and_rank_bytes(shape):
    """A reduced qwen2.5 on a (data 2, model 2) accounting mesh: JAX's
    result keys, finite positive roofline terms, a collective log, and
    `argument_size_in_bytes` equal to rank 0's blocks under the port's
    rules: the frozen head and body cut by `params_pspecs` (bf16), the
    tail and prompt whole (f32 and their SGD momentum for each of the
    rank's clients in training, bf16 in serving), the batch's rows over
    'data', the cache's slots over 'data' and the head's and body's kv
    heads over 'model' (the tail's whole)."""
    cfg = get_config("qwen2.5-14b").reduced(n_layers=3, d_model=64,
                                            d_ff=128, vocab_size=256)
    mesh = parallel.AccountingMesh({"data": 2, "model": 2}, name="2x2")
    res = dryrun.account_one("qwen2.5-14b", shape, cfg=cfg, mesh=mesh,
                             fsdp=False)
    for key in KEYS:
        assert key in res, key
    assert res["mesh"] == "2x2" and res["n_chips"] == 4
    for term in ("compute_s", "memory_s", "collective_s"):
        assert 0 < res["roofline"][term] < float("inf")
    assert res["collective_bytes"]["total"] == sum(
        v for k, v in res["collective_bytes"].items() if k != "total") > 0
    assert res["op_counts_full"]["dot"] > 0
    assert res["hlo_flops_global"] > res["hlo_flops"] > 0
    assert res["memory"]["temp_size_in_bytes"] > 0

    model = SplitModel(cfg, dryrun.DEFAULT_SPLIT)
    sp = specs.SHAPES[shape]
    whole = specs.param_specs(model)
    frozen = {"head": whole["head"], "body": whole["body"]}
    want = _local_bytes(frozen, params_pspecs(frozen, mesh), mesh)
    trainable = {"tail": whole["tail"], "prompt": whole["prompt"]}
    tb = sum(x.numel() for _, x in tree_flatten(trainable))
    if sp.kind == "train":
        b = sp.global_batch // 2
        want += 2 * tb * 4 + 4           # one client: params, momentum,
        want += b * sp.seq * 4           # its step count; its tokens
    else:
        rows = sp.global_batch // 2
        want += tb * 2
        want += rows * (sp.seq * 4 if sp.kind == "prefill" else 8)
        cache = specs.cache_specs(model, sp)
        cspec = cache_pspecs(cache, mesh)
        want += sum(_local_bytes(cache[seg], cspec[seg], mesh,
                                 skip_model=(seg == "tail"))
                    for seg in cache)
    pop_sharding_fallbacks()
    assert res["memory"]["argument_size_in_bytes"] == want


GLOBAL_CASES = {
    "qwen2.5-14b": dict(n_layers=3, d_model=256, d_ff=512, vocab_size=512),
    "phi3.5-moe-42b-a6.6b": dict(n_layers=3, d_model=256, d_ff=512,
                                 vocab_size=512),
    "rwkv6-3b": dict(n_layers=3, d_model=256, d_ff=512, vocab_size=512),
}
GLOBAL_PAIRS = [("qwen2.5-14b", "train_4k"), ("qwen2.5-14b", "decode_32k"),
                ("phi3.5-moe-42b-a6.6b", "decode_32k"),
                ("rwkv6-3b", "decode_32k")]


@pytest.fixture(scope="module")
def jax_global_flops():
    """JAX's analysis-pass FLOPs of every pair of GLOBAL_PAIRS, lowered
    (not compiled) in one child process."""
    code = (
        "import json, jax\n"
        "import repro.launch.dryrun as d\n"
        "from repro.configs import get_config\n"
        "from repro.core.split import SplitModel\n"
        "mesh = jax.make_mesh((1, 1), ('data', 'model'))\n"
        "out = {}\n"
        f"kws = {GLOBAL_CASES!r}\n"
        f"for arch, shape in {GLOBAL_PAIRS!r}:\n"
        "    model = SplitModel(get_config(arch).reduced(**kws[arch]), "
        "d.DEFAULT_SPLIT)\n"
        "    with mesh:\n"
        "        low = d._build_lowered(model, d.SHAPES[shape], mesh, "
        "loss_mode='logits', microbatches=1, remat=False, unroll=True, "
        "impl='analysis', fsdp=False)\n"
        "    cost = low.cost_analysis()\n"
        "    cost = cost[0] if isinstance(cost, (list, tuple)) else cost\n"
        "    out[f'{arch}|{shape}'] = float(cost['flops'])\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_global_flops(arch, shape, cfg):
    """The unsharded step's FLOPs on `meta` (`account_one`'s global
    pass alone)."""
    mesh = parallel.AccountingMesh({"data": 1, "model": 1})
    step, args = dryrun._build(
        SplitModel(cfg, dryrun.DEFAULT_SPLIT), specs.SHAPES[shape], mesh,
        None, loss_mode="logits", microbatches=1, impl="analysis",
        fsdp=False)
    return dryrun._run(step, args)[0].flops


@pytest.mark.parametrize("arch,shape", GLOBAL_PAIRS)
def test_global_flops_against_jax_analysis(arch, shape, jax_global_flops):
    """The unsharded step's FLOPs (`hlo.OpAccount` on `meta`, XLA's
    convention) against JAX's analysis pass (`_build_lowered(
    impl="analysis", unroll=True)` on a (1, 1) mesh,
    `cost_analysis()["flops"]`): the dense qwen2.5's decode within 10%.
    Its train step is held between 1 and 2 times JAX's: the port's
    differentiated attention is the plain version, which computes every
    score of the causal square (and its gradient), where JAX's analysis
    form skips the blocks above the diagonal, at most half of them. The
    MoE and RWKV-6 decode ratios are printed, not held (JAX's ragged dot
    and chunked scan cost other than the port's loops)."""
    want = jax_global_flops[f"{arch}|{shape}"]
    got = _port_global_flops(arch, shape,
                             get_config(arch).reduced(**GLOBAL_CASES[arch]))
    ratio = got / want
    print(f"{arch} {shape}: port {got:.4g} JAX {want:.4g} ratio "
          f"{ratio:.4f}")
    if arch == "qwen2.5-14b" and shape == "decode_32k":
        assert abs(ratio - 1) <= 0.10
    elif arch == "qwen2.5-14b":
        assert 1.0 <= ratio <= 2.0


def test_meta_scans_take_the_chunked_forms_and_no_group(monkeypatch):
    """A reduced rwkv6 and zamba2 prefill (256 tokens) accounted on `meta`
    as rank 0 of a (2, 2) mesh run each scan's chunked form (no
    sequential loop over T) and count them as kernel ops, with their
    collectives logged; no accounting run opens a process group."""
    from repro_torch.kernels.mamba2_scan import ref as mref
    from repro_torch.kernels.rwkv6_scan import ref as rref
    calls = []
    for mod, name in ((mref, "mamba2_scan"), (rref, "rwkv6_scan"),
                      (mref, "mamba2_chunked"), (rref, "rwkv6_chunked")):
        plain = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _p=plain, _n=name, **k: (
            calls.append(_n), _p(*a, **k))[1])
    mesh = parallel.AccountingMesh({"data": 2, "model": 2})
    shape = specs.ShapeSpec("prefill_256", "prefill", 256, 4)
    for arch, n in (("rwkv6-3b", 3), ("zamba2-2.7b", 18)):
        cfg = get_config(arch).reduced(n_layers=n, d_model=64, d_ff=128,
                                       vocab_size=128)
        step, args = dryrun._build(
            SplitModel(cfg, dryrun.DEFAULT_SPLIT), shape, mesh, mesh,
            loss_mode="logits", microbatches=1, impl="analysis", fsdp=False)
        acc, log, _ = dryrun._run(step, args)
        assert acc.ops["custom-call"] > 0 and log.records
    assert calls and set(calls) == {"rwkv6_chunked", "mamba2_chunked"}
    assert not dist.is_initialized()
