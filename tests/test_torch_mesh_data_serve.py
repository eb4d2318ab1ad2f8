"""Serving with slots over 'data' in both engines, held against the JAX
package's unsharded engines on bridged weights.

Four host ranks are spawned once for the module (a gloo group on the CPU,
one thread each) and run every case on the mesh of the ranks it needs
(the rest wait): the dense engine on (data 2, model 2) on the fp32 and
int8 wires, on (data 2) at int8, on (data 4), and with 3 slots on (data
2), which divide no block (the slots replicated, the fallback recorded);
the paged engine on (data 2, model 2) with a shared prefix and chunked
prefill (its pool replicated over 'data', every 'data' row running the
whole batch); and zamba2 (Mamba-2 with a shared attention block) on
(data 2). The model is tests/test_mesh_tp.py's serving fixture (qwen2.5
reduced to d_model 128, 4 heads of 32, vocab 128; 2 tenants, 3
requests), zamba2 reduced to 18 layers of d_model 64. The ranks import
no JAX: the references are computed here and handed over as an .npz
file.

Held on every rank: tokens `==` JAX's, logits within 1e-5 (the bound of
tests/test_torch_mesh_tp.py; at int8 with a 'model' axis, JAX's own
int8-vs-fp32 gap), wire bytes `==` (every rank meters the whole batch's
rows, as JAX's meter does), the rank's block of slots in every cache
leaf, the pool drained. Then the slot ops on a rank's block, and the
launcher's `--mesh-devices 4 --mesh-model 2` from a plain shell against
its one-process run."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_ranks
from test_torch_mesh_round import flat, nest, section

torch.set_num_threads(2)

RANKS = 4
TOL = dict(rtol=1e-5, atol=1e-5)
SERVE = dict(max_seq=48, decode_block=4)
PAGED = dict(page_size=8, shared_prefix=(5, 9, 2), prefill_chunk=6)
# label: (family, wire, engine, slots, ranks, model axis)
CASES = {
    "dense_d2m2_fp32": ("qwen", "fp32", "dense", 4, 4, 2),
    "dense_d2m2_int8": ("qwen", "int8", "dense", 4, 4, 2),
    "dense_d2_int8": ("qwen", "int8", "dense", 4, 2, 1),
    "dense_d4": ("qwen", "fp32", "dense", 4, 4, 1),
    "dense_3slots_d2": ("qwen", "fp32", "dense", 3, 2, 1),
    "paged_d2m2_prefix": ("qwen", "fp32", "paged", 4, 4, 2),
    "zamba2_d2": ("zamba2", "fp32", "dense", 4, 2, 1),
}
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _ref_key(case):
    family, wire, engine, slots = case[:4]
    return f"{family}_{wire}_{engine}_{slots}"


def _cfg(get_config, family):
    if family == "qwen":
        return get_config("qwen2.5-14b").reduced(n_layers=3, d_model=128,
                                                 d_ff=256, vocab_size=128)
    return get_config("zamba2-2.7b").reduced(n_layers=18, d_model=64,
                                             d_ff=128, vocab_size=128)


# ------------------------------------------------------ the JAX side
def jax_references(path):
    """The families' params and banks, the requests, and JAX's unsharded
    engine on every distinct case: tokens, logits and bytes."""
    import jax

    from repro.configs import get_config
    from repro.core import SplitConfig, SplitModel
    from repro.runtime import WireSpec
    from repro.serve import (PagedServeConfig, PagedServeEngine,
                             ServeConfig, ServeEngine, TenantBank)
    from test_mesh_tp import _serve_fixture

    _, params, bank, reqs = _serve_fixture()
    out = {}
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4)
    zparams = SplitModel(_cfg(get_config, "zamba2"), split).init(
        jax.random.PRNGKey(3))
    zbank = TenantBank.from_lists(
        [zparams["tail"], jax.tree.map(lambda x: x * 1.1, zparams["tail"])],
        [zparams["prompt"], zparams["prompt"] * 0.9])
    fams = {"qwen": (params, bank), "zamba2": (zparams, zbank)}
    for family, (p, b) in fams.items():
        for key, v in flat(jax.tree.map(np.asarray, p)).items():
            out[f"{family}/params/{key}"] = v
        for key, v in flat(jax.tree.map(np.asarray, b.tails)).items():
            out[f"{family}/tails/{key}"] = v
        out[f"{family}/prompts"] = np.asarray(b.prompts)
    for r in reqs:
        out[f"req/{r.rid}"] = np.array([r.tenant, r.max_new, r.arrival])
        out[f"req_tokens/{r.rid}"] = np.asarray(r.tokens)
    done = set()
    for case in CASES.values():
        key = _ref_key(case)
        if key in done:
            continue
        done.add(key)
        family, wire, engine, slots = case[:4]
        model = SplitModel(_cfg(get_config, family), split,
                           WireSpec.make(wire))
        p, b = fams[family]
        if engine == "dense":
            eng = ServeEngine(model, p, b, ServeConfig(n_slots=slots,
                                                       **SERVE),
                              collect_logits=True)
        else:
            eng = PagedServeEngine(model, p, b, PagedServeConfig(
                n_slots=slots, **SERVE, **PAGED), collect_logits=True)
        stats = eng.run(list(reqs))
        for f in stats["finished"]:
            out[f"{key}/tokens/{f.req.rid}"] = f.tokens
            out[f"{key}/logits/{f.req.rid}"] = f.logits
        for k, v in stats["wire_bytes"].items():
            out[f"{key}/wire/{k}"] = np.float64(v)
    np.savez(path, **out)


# ------------------------------------------------------- the ranks
def rank_program(ref_path):
    import torch.distributed as dist

    from repro_torch.bridge import bank_from_arrays, jax_to_torch
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   Request, ServeConfig, ServeEngine)
    from repro_torch.sharding.parallel import axis_index
    from repro_torch.tree import tree_leaves

    refs = np.load(ref_path)
    reqs = [Request(rid=int(r), tenant=int(v[0]),
                    tokens=refs[f"req_tokens/{r}"], max_new=int(v[1]),
                    arrival=int(v[2]))
            for r, v in section(refs, "req").items()]
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4)
    out = {}
    for label, (family, wire, engine, slots, n, tp) in CASES.items():
        mesh = make_host_mesh(n, model=tp)
        if dist.get_rank() >= n:
            continue
        model = SplitModel(_cfg(get_config, family), split,
                           WireSpec.make(wire))
        params = jax_to_torch(nest(section(refs, f"{family}/params")),
                              "cpu")
        bank = bank_from_arrays(nest(section(refs, f"{family}/tails")),
                                refs[f"{family}/prompts"], "cpu")
        if engine == "dense":
            eng = ServeEngine(model, params, bank,
                              ServeConfig(n_slots=slots, **SERVE),
                              collect_logits=True, mesh=mesh, device="cpu")
        else:
            eng = PagedServeEngine(model, params, bank, PagedServeConfig(
                n_slots=slots, **SERVE, **PAGED), collect_logits=True,
                mesh=mesh, device="cpu")
        stats = eng.run(list(reqs))
        held = (eng.pool if engine == "paged" else eng.cache)
        out[label] = {
            "coords": (axis_index(mesh, "data"), axis_index(mesh, "model")),
            "tokens": {f.req.rid: f.tokens for f in stats["finished"]},
            "logits": {f.req.rid: f.logits for f in stats["finished"]},
            "wire": stats["wire_bytes"], "n_finished": stats["n_finished"],
            "slots": eng.slots, "fallbacks": eng.fallbacks,
            "axis1": {leaf.shape[1] for leaf in tree_leaves(held)
                      if leaf.dim() >= 2},
            "page_copies": stats.get("page_copies"),
            "prefill_chunks": stats.get("prefill_chunks"),
            "pages_in_use": (eng.pool_alloc.n_used if engine == "paged"
                             else None)}
    return out


# ---------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data_serve") / "refs.npz")
    jax_references(path)
    return np.load(path), spawn_ranks(rank_program, RANKS, path)


# ------------------------------------------------------------- tests
def _int8_own_gap(refs):
    """JAX's own logit gap between its int8 and fp32 engines on the
    fixture (every request's rows)."""
    a, b = _ref_key(CASES["dense_d2m2_int8"]), _ref_key(
        CASES["dense_d2m2_fp32"])
    return max(float(np.abs(v - refs[f"{b}/logits/{rid}"]).max())
               for rid, v in section(refs, f"{a}/logits").items())


@pytest.mark.parametrize("label", list(CASES))
def test_serving_over_data_matches_jax(runs, label):
    """Every rank of the case's mesh: JAX's tokens, its logits within
    1e-5, its wire bytes. On (data 2, model 2) at int8 the logits are held
    within JAX's own int8-vs-fp32 gap instead: the 'model' all-reduce sums
    the body's partials in another order, and a last-bit difference that
    crosses an int8 rounding edge moves a value by a quantum (1.0e-4 here);
    at int8 on (data 2) no sum is reordered and 1e-5 holds."""
    refs, ranks = runs
    key = _ref_key(CASES[label])
    want = section(refs, f"{key}/tokens")
    assert want
    tol = TOL
    if label == "dense_d2m2_int8":
        tol = dict(rtol=0, atol=_int8_own_gap(refs))
    for r in ranks[:CASES[label][4]]:
        got = r[label]
        assert got["n_finished"] == len(want)
        for rid, toks in want.items():
            np.testing.assert_array_equal(got["tokens"][int(rid)], toks)
            np.testing.assert_allclose(got["logits"][int(rid)],
                                       refs[f"{key}/logits/{rid}"], **tol)
        assert got["wire"] == {k: float(v) for k, v in
                               section(refs, f"{key}/wire").items()}


@pytest.mark.parametrize("label", list(CASES))
def test_each_rank_holds_its_block_of_slots(runs, label):
    """The dense cache's slot axis is cut over 'data' (each rank its
    coordinate's block, every leaf), or held whole where the slots divide
    no block, with the fallback recorded for the data axis; the paged
    pool keeps every page on every rank and drains."""
    _, ranks = runs
    family, wire, engine, slots, n, tp = CASES[label]
    data = n // tp
    for r in ranks[:n]:
        got = r[label]
        d, _ = got["coords"]
        if engine == "paged":
            assert got["slots"] == (0, slots)
            assert got["pages_in_use"] == 0
            assert got["page_copies"] >= 1 and got["prefill_chunks"] >= 1
        elif slots % data:
            assert got["slots"] == (0, slots)
            assert got["axis1"] == {slots}
            assert got["fallbacks"] and all(
                axis == "data" for _, axis, _ in got["fallbacks"])
        else:
            block = slots // data
            assert got["slots"] == (d * block, (d + 1) * block)
            assert got["axis1"] == {block}
            assert not any(axis == "data" for _, axis, _ in
                           got["fallbacks"])


def test_slot_ops_take_a_global_slot_against_a_block():
    """`cache_write_slot` / `cache_read_slot` with `first`: a rank holding
    slots [2, 4) of 4 writes global slot 3 into its row 1, skips slot 0
    (another rank's), reads slot 3 back and refuses to read slot 1."""
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.tree import tree_leaves
    model = SplitModel(_cfg(get_config, "qwen"), SplitConfig(
        head_cycles=1, tail_cycles=1, prompt_len=4))
    block = model.init_cache(2, 16, device="cpu")
    one = model.blank_slot_cache(16, device="cpu")
    for leaf in tree_leaves(one):
        leaf.fill_(7)
    model.cache_write_slot(block, one, 0, first=2)
    assert all((leaf != 7).all() for leaf in tree_leaves(block))
    model.cache_write_slot(block, one, 3, first=2)
    for leaf in tree_leaves(block):
        assert (leaf[:, 1] == 7).all() and (leaf[:, 0] != 7).all()
    back = model.cache_read_slot(block, 3, first=2)
    assert all((leaf == 7).all() for leaf in tree_leaves(back))
    with pytest.raises(ValueError, match="not in this block"):
        model.cache_read_slot(block, 1, first=2)


def test_launcher_mesh_devices_from_a_shell():
    """`--mesh-devices 4 --mesh-model 2` serves the same trace from a
    plain shell as one process: rank 0 alone prints, and the request,
    token and wire lines are the one-process run's."""
    flags = ["--device", "cpu", "--reduced", "--requests", "4", "--wire",
             "int8", "--slots", "4"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    lines = {}
    for name, extra in (("mesh", ["--mesh-devices", "4", "--mesh-model",
                                  "2"]), ("one", [])):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve"] + flags
            + extra, env=env, capture_output=True, text=True, timeout=300,
            cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out = proc.stdout.splitlines()
        assert sum("requests over" in s for s in out) == 1
        lines[name] = [s.split(" in ")[0] if "requests over" in s else s
                       for s in out if "requests over" in s
                       or s.startswith("wire")]
    assert lines["mesh"] == lines["one"]
