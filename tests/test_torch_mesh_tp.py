"""The port tensor-parallel over a (data, model) mesh of host ranks, held
against the JAX package's single-device round and engines.

Eight ranks are spawned once for the module (a gloo group on the CPU, one
thread each) and run every case in turn, each on the mesh of the ranks it
needs (the rest wait): the SFPrompt round of tests/test_mesh_round.py
(the reduced ViT: d_model 32, 2 heads of 32, d_ff 48) on (data 2, model
2) — a whole head a rank — and on (data 2, model 4), JAX's own test
mesh, where a rank holds half a head and q/k/v are gathered over 'model';
then the dense and paged engines of tests/test_mesh_tp.py's serving
fixture (qwen2.5 reduced to d_model 128, 4 heads of 32, QKV bias, vocab
128) on (data 1, model 2) and (data 1, model 4). The ranks import no
JAX: the references are computed here and handed over as .npz files.

Held: TP params within rtol 1e-5 / atol 1e-6 of JAX's single-device
round, metrics within rtol 1e-5, metered bytes equal, the same for
`client_updates`; every rank's body leaves at their local shapes (no rank
holds a frozen leaf the rules shard at full size); on the int8 wire the
'model' ranks of a 'data' index cross the wire with bit-identical rows,
uniforms and payloads; TP serving gives JAX's tokens, logits within 1e-5
and its wire bytes, and the paged engine with a shared prefix and chunks
drains its pool. Then the families part 2 brought to the mesh, both
engines taking slots over 'data', and both launchers' mesh flags from a
subprocess."""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_ranks
from test_torch_mesh_round import (K, PCFG, SPLIT, TOL, _leaves, _round,
                                   dropout_participation, flat,
                                   jax_references, nest, reduced_vit,
                                   section)

RANKS = 8
TP_MESHES = {"2x2": (4, 2), "2x4": (8, 4)}     # (ranks, model)
SERVE_TP = (2, 4)
ROOT = os.path.join(os.path.dirname(__file__), "..")


# ------------------------------------------------------ the JAX side
def jax_serve_references(path):
    """tests/test_mesh_tp.py's `_serve_fixture` served by JAX's unsharded
    dense engine: its params, bank, requests, tokens, logits and bytes."""
    import jax

    from repro.serve import ServeConfig, ServeEngine
    from test_mesh_tp import _serve_fixture

    model, params, bank, reqs = _serve_fixture()
    eng = ServeEngine(model, params, bank,
                      ServeConfig(n_slots=4, max_seq=48, decode_block=4),
                      collect_logits=True)
    stats = eng.run(list(reqs))
    out = {}
    for key, v in flat(jax.tree.map(np.asarray, params)).items():
        out[f"params/{key}"] = v
    for key, v in flat(jax.tree.map(np.asarray, bank.tails)).items():
        out[f"tails/{key}"] = v
    out["prompts"] = np.asarray(bank.prompts)
    for r in reqs:
        out[f"req/{r.rid}"] = np.array([r.tenant, r.max_new, r.arrival])
        out[f"req_tokens/{r.rid}"] = np.asarray(r.tokens)
    for f in stats["finished"]:
        out[f"tokens/{f.req.rid}"] = f.tokens
        out[f"logits/{f.req.rid}"] = f.logits
    for k, v in stats["wire_bytes"].items():
        out[f"wire/{k}"] = np.float64(v)
    np.savez(path, **out)


# ------------------------------------------------------- the ranks
def _record_wire(log):
    """Patch `Boundary.transmit` (in this rank's process) to log a digest
    of each crossing's rows, uniforms and received values."""
    from repro_torch.runtime.boundary import Boundary
    plain = Boundary.transmit

    def transmit(self, x, **kw):
        y, nbytes = plain(self, x, **kw)
        h = hashlib.sha256(x.detach().contiguous().numpy().tobytes())
        for u in kw.get("noise") or ():
            h.update(u.contiguous().numpy().tobytes())
        h.update(y.detach().contiguous().numpy().tobytes())
        log.append((self.name, h.hexdigest()))
        return y, nbytes
    Boundary.transmit = transmit
    return lambda: setattr(Boundary, "transmit", plain)


def _tp_cases(ref_path, out):
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import ProtocolConfig, SplitConfig, SplitModel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import WireSpec
    from repro_torch.sharding.parallel import axis_index

    refs = np.load(ref_path)
    init = nest(section(refs, "init"))
    cohort = section(refs, "data")
    part = dropout_participation(K)
    cfg = reduced_vit(get_config)
    model = SplitModel(cfg, SplitConfig(**SPLIT))
    int8 = SplitModel(cfg, SplitConfig(**SPLIT), WireSpec.make("int8"))
    pcfg = ProtocolConfig(**PCFG)
    upcfg = dataclasses.replace(pcfg, return_client_trainable=True)
    for label, (n, tp) in TP_MESHES.items():
        mesh = make_host_mesh(n, model=tp)
        if dist.get_rank() >= n:
            continue
        res = {"coords": (axis_index(mesh, "data"),
                          axis_index(mesh, "model"))}
        for name, kw in (("clear", {}), ("secure", {"secure": True})):
            res[name] = _round(model, pcfg, init, cohort, part, mesh=mesh,
                               **kw)
        res["updates"] = _round(model, upcfg, init, cohort, part, mesh=mesh,
                                updates=True)
        log = []
        restore = _record_wire(log)
        try:
            res["int8"] = _round(int8, pcfg, init, cohort, part, mesh=mesh)
        finally:
            restore()
        res["wire_log"] = log
        out[label] = res


def _serve_cases(ref_path, out):
    import torch.distributed as dist

    from repro_torch.bridge import bank_from_arrays, jax_to_local, jax_to_torch
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import WireSpec
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   Request, ServeConfig, ServeEngine)

    refs = np.load(ref_path)
    params = nest(section(refs, "params"))
    bank = bank_from_arrays(nest(section(refs, "tails")), refs["prompts"],
                            "cpu")
    reqs = [Request(rid=int(r), tenant=int(v[0]),
                    tokens=refs[f"req_tokens/{r}"], max_new=int(v[1]),
                    arrival=int(v[2]))
            for r, v in section(refs, "req").items()]
    cfg = get_config("qwen2.5-14b").reduced(n_layers=3, d_model=128,
                                            d_ff=256, vocab_size=128)
    model = SplitModel(cfg, SplitConfig(head_cycles=1, tail_cycles=1,
                                        prompt_len=4), WireSpec.make("fp32"))
    whole = jax_to_torch(params, "cpu")
    for tp in SERVE_TP:
        mesh = make_host_mesh(tp, model=tp)
        if dist.get_rank() >= tp:
            continue
        res = {}
        dense = ServeEngine(model, whole, bank,
                            ServeConfig(n_slots=4, max_seq=48,
                                        decode_block=4),
                            collect_logits=True, mesh=mesh, device="cpu")
        local = jax_to_local({"head": params["head"],
                              "body": params["body"]},
                             dense.step_specs["shared"], mesh, "cpu")
        res["bridge_equal"] = all(
            torch.equal(a, b) for a, b in zip(_leaves(dense.shared),
                                              _leaves(local)))
        res["shapes"] = {seg: [(tuple(a.shape), tuple(b.shape)) for a, b in
                               zip(_leaves(dense.shared[seg]),
                                   _leaves(whole[seg]))]
                         for seg in ("head", "body")}
        res["cache_kv_heads"] = {
            seg: dense.cache[seg]["stack"]["pos0"]["k"].shape[3]
            for seg in ("head", "body", "tail")}
        runs = {"dense": dense,
                "paged": PagedServeEngine(
                    model, whole, bank,
                    PagedServeConfig(n_slots=4, max_seq=48, decode_block=4,
                                     page_size=8),
                    collect_logits=True, mesh=mesh, device="cpu")}
        if tp == 2:
            runs["prefix"] = PagedServeEngine(
                model, whole, bank,
                PagedServeConfig(n_slots=4, max_seq=48, decode_block=4,
                                 page_size=8, shared_prefix=(5, 9, 2),
                                 prefill_chunk=6),
                collect_logits=True, mesh=mesh, device="cpu")
        for name, eng in runs.items():
            stats = eng.run(list(reqs))
            res[name] = {
                "tokens": {f.req.rid: f.tokens for f in stats["finished"]},
                "logits": {f.req.rid: f.logits for f in stats["finished"]},
                "wire": stats["wire_bytes"],
                "n_finished": stats["n_finished"],
                "page_copies": stats.get("page_copies"),
                "prefill_chunks": stats.get("prefill_chunks"),
                "pages_in_use": (eng.pool_alloc.n_used
                                 if hasattr(eng, "pool_alloc") else None),
                "pool_kv_heads": (eng.pool["body"]["stack"]["pos0"]["k"]
                                  .shape[3] if hasattr(eng, "pool")
                                  else None)}
        out[f"serve{tp}"] = res


def rank_program(round_refs, serve_refs):
    out = {}
    _tp_cases(round_refs, out)
    _serve_cases(serve_refs, out)
    return out


# ---------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_tp")
    round_refs, serve_refs = str(tmp / "round.npz"), str(tmp / "serve.npz")
    jax_references(round_refs)
    jax_serve_references(serve_refs)
    ranks = spawn_ranks(rank_program, RANKS, round_refs, serve_refs)
    return np.load(round_refs), np.load(serve_refs), ranks


def _whole_shapes():
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    model = SplitModel(reduced_vit(get_config), SplitConfig(**SPLIT))
    return model.init(torch.Generator(), device="meta")


# ------------------------------------------------------------- tests
@pytest.mark.parametrize("mesh", list(TP_MESHES))
@pytest.mark.parametrize("name", ["clear", "secure"])
def test_tp_round_matches_jax(runs, mesh, name):
    refs, _, ranks = runs
    n = TP_MESHES[mesh][0]
    got = ranks[0][mesh][name]
    want = section(refs, f"{name}/params")
    assert got["params"].keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], err_msg=k,
                                   **TOL)
    jm = section(refs, f"{name}/metrics")
    assert set(got["metrics"]) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
        if k.startswith(("wire/", "cohort/")):
            assert got["metrics"][k] == v, k
    assert got["meter"] == {k: float(v) for k, v in
                            section(refs, f"{name}/meter").items()}
    # every rank of the mesh ends holding the same params and bytes
    for r in ranks[1:n]:
        for k in want:
            np.testing.assert_array_equal(r[mesh][name]["params"][k],
                                          got["params"][k], err_msg=k)
        assert r[mesh][name]["meter"] == got["meter"]


@pytest.mark.parametrize("mesh", list(TP_MESHES))
def test_tp_client_updates_match_jax(runs, mesh):
    refs, _, ranks = runs
    got = ranks[0][mesh]["updates"]["params"]
    want = section(refs, "updates")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("mesh", list(TP_MESHES))
def test_tp_local_shard_shapes_per_rank(runs, mesh):
    """Every body leaf a rank holds has its local shape under
    `params_pspecs`; a leaf the rules shard over 'model' is never held
    whole (q/k/v/o and up/down: 64 -> 32 or 16 columns, 48 -> 24 or 12)."""
    from repro_torch.sharding import params_pspecs
    from repro_torch.sharding.rules import pop_sharding_fallbacks
    n, tp = TP_MESHES[mesh]
    whole = _whole_shapes()
    stub = type("Mesh", (), {"shape": {"data": n // tp, "model": tp}})()
    specs = params_pspecs(whole, stub)["body"]
    pop_sharding_fallbacks()
    full, spec = _leaves(whole["body"]), _leaves(specs)
    sharded = 0
    for r in ranks_of(runs, mesh):
        held = r[mesh]["clear"]["body"]
        assert len(held) == len(full)
        for (local, _), leaf, s in zip(held, full, spec):
            shape = tuple(leaf.shape)
            want = tuple(d // tp if e == "model" else d
                         for d, e in zip(shape, tuple(s)))
            assert local == want
            if "model" in s:
                assert local != shape
                sharded += 1
    assert sharded >= 6 * n      # q, k, v, o, up, down on every rank


def ranks_of(runs, mesh):
    return runs[2][:TP_MESHES[mesh][0]]


@pytest.mark.parametrize("mesh", list(TP_MESHES))
def test_tp_wire_rows_identical_across_model_ranks(runs, mesh):
    """On the int8 wire, the 'model' ranks of one 'data' index cross the
    wire with bit-identical rows, uniforms and dequantized values (so the
    int8 payload is the same), and the round's bytes are the unsharded
    round's."""
    refs, _, ranks = runs
    by_data = {}
    for r in ranks_of(runs, mesh):
        d, _ = r[mesh]["coords"]
        by_data.setdefault(d, []).append(r[mesh]["wire_log"])
    assert len(by_data) == 2
    for logs in by_data.values():
        assert len(logs) == TP_MESHES[mesh][1]
        assert logs[0] and all(log == logs[0] for log in logs)
    assert by_data[0][0] != by_data[1][0]          # each its own clients
    # the bytes are counted once a crossing: every rank's meter holds the
    # unsharded round's
    from repro_torch.configs import get_config
    from repro_torch.core import ProtocolConfig, SplitConfig, SplitModel
    from repro_torch.runtime import WireSpec
    one = _round(SplitModel(reduced_vit(get_config), SplitConfig(**SPLIT),
                            WireSpec.make("int8")),
                 ProtocolConfig(**PCFG), nest(section(refs, "init")),
                 section(refs, "data"), dropout_participation(K))
    for r in ranks_of(runs, mesh):
        assert r[mesh]["int8"]["meter"] == one["meter"]
        for k, v in one["metrics"].items():
            if k.startswith(("wire/", "cohort/")):
                assert r[mesh]["int8"]["metrics"][k] == v, k


@pytest.mark.parametrize("tp", SERVE_TP)
@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_tp_serving_matches_jax(runs, engine, tp):
    _, srefs, ranks = runs
    for r in ranks[:tp]:
        got = r[f"serve{tp}"][engine]
        want_tokens = section(srefs, "tokens")
        assert {str(k) for k in got["tokens"]} == set(want_tokens)
        for rid, toks in want_tokens.items():
            np.testing.assert_array_equal(got["tokens"][int(rid)], toks)
            np.testing.assert_allclose(got["logits"][int(rid)],
                                       srefs[f"logits/{rid}"], rtol=1e-5,
                                       atol=1e-5)
        assert got["wire"] == {k: float(v) for k, v in
                               section(srefs, "wire").items()}


@pytest.mark.parametrize("tp", SERVE_TP)
def test_tp_serving_holds_local_shards(runs, tp):
    """The engine's head and body are the bridge's local shards (4 heads
    of 32 and 256 of d_ff over 'model'; the 128-row token table
    vocab-parallel); the head's and body's caches and the page pool hold
    4 / tp kv heads, the tail's cache all 4."""
    _, _, ranks = runs
    for r in ranks[:tp]:
        res = r[f"serve{tp}"]
        assert res["bridge_equal"]
        n_cut = sum(local != whole for seg in res["shapes"].values()
                    for local, whole in seg)
        assert n_cut >= 7
        tok_local, tok_whole = res["shapes"]["head"][0]
        assert tok_local == (128 // tp, 128) and tok_whole == (128, 128)
        assert res["cache_kv_heads"] == {"head": 4 // tp, "body": 4 // tp,
                                         "tail": 4}
        assert res["paged"]["pool_kv_heads"] == 4 // tp


def test_tp_paged_prefix_and_chunks_run(runs):
    _, srefs, ranks = runs
    for r in ranks[:2]:
        res = r["serve2"]["prefix"]
        assert res["n_finished"] == 3
        assert res["page_copies"] >= 1
        assert res["prefill_chunks"] >= 1
        assert res["pages_in_use"] == 0


def test_part2_cases_refuse_naming_it():
    """Slice H part 2 is ported: the six families it refused take a
    'model' axis (their TP rounds and engines run in
    tests/test_torch_mesh_{moe,scans,encdec}.py). Slots over 'data' are
    ported too (tests/test_torch_mesh_data_serve.py): both engines take a
    (data 2, model 2) mesh, here an accounting mesh seen from rank 0, the
    dense cache holding rank 0's block of slots and its kv heads, the
    paged pool every page; the one refusal left is the paged engine's of
    recurrent state, with the JAX package's message."""
    from repro_torch.sharding.parallel import AccountingMesh
    from repro_torch.configs import get_config
    from repro_torch.core import (ProtocolConfig, SFPromptTrainer,
                                  SplitConfig, SplitModel)
    from repro_torch.serve import (PagedServeConfig, PagedServeEngine,
                                   ServeConfig, ServeEngine, TenantBank)
    tp = type("Mesh", (), {"shape": {"data": 1, "model": 2}})()
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4)
    for arch in ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b", "zamba2-2.7b",
                 "rwkv6-3b", "whisper-base", "qwen2-vl-72b"):
        base = get_config(arch)
        model = SplitModel(base.reduced(n_layers=3 * len(
            base.layer_pattern)), split)
        tr = SFPromptTrainer(model, ProtocolConfig(), mesh=tp, device="cpu")
        assert tr.mesh is tp and tr.model.mesh is tp
    bank = TenantBank({k: v for k, v in
                       {"x": torch.zeros((1, 1))}.items()},
                      torch.zeros((1, 4, 256)))
    two_d = AccountingMesh({"data": 2, "model": 2})
    for arch in ("qwen2.5-14b", "rwkv6-3b"):
        model = SplitModel(get_config(arch).reduced(n_layers=3), split)
        params = model.init(torch.Generator(), device="cpu")
        for engine, scfg in ((ServeEngine, ServeConfig()),
                             (PagedServeEngine,
                              PagedServeConfig(page_size=8))):
            if engine is PagedServeEngine and arch == "rwkv6-3b":
                # the paged engine refuses the recurrent state first, with
                # the JAX package's message
                with pytest.raises(ValueError, match="paged serving "
                                   "unsupported"):
                    engine(model, params, bank, scfg, mesh=two_d,
                           device="cpu")
                continue
            eng = engine(model, params, bank, scfg, mesh=two_d,
                         device="cpu")
            if engine is ServeEngine:
                assert eng.slots == (0, scfg.n_slots // 2)
                held = eng.cache["body"]["stack"]["pos0"]
                assert all(leaf.shape[1] == scfg.n_slots // 2
                           for leaf in held.values())
            else:
                assert eng.slots == (0, scfg.n_slots)
                pool = eng.pool["body"]["stack"]["pos0"]
                assert pool["k"].shape[1] == eng.n_pages
                assert pool["k"].shape[3] == model.cfg.attention.n_kv_heads \
                    // 2


def _launch(module, args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", module] + args, env=env,
                          capture_output=True, text=True, timeout=240,
                          cwd=ROOT)


def test_train_launcher_mesh_flags_from_a_shell(tmp_path):
    """`--mesh-devices 4 --mesh-model 2 --fsdp` from a plain shell: the
    launcher starts its 4 ranks, rank 0 alone prints and writes the log,
    and the rounds are the single-process launcher's."""
    flags = ["--device", "cpu", "--reduced", "--layers", "3", "--dataset",
             "cifar10-syn", "--clients", "8", "--k", "4", "--samples", "64",
             "--image-hw", "32", "--batch-size", "4", "--local-epochs", "1",
             "--rounds", "1"]
    log = "vit-base_sfprompt_cifar10-syn.jsonl"
    recs = {}
    for name, extra in (("mesh", ["--mesh-devices", "4", "--mesh-model",
                                  "2", "--fsdp"]), ("one", [])):
        out = tmp_path / name
        proc = _launch("repro_torch.launch.train",
                       flags + extra + ["--out", str(out)])
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.count("'round': 0") == 1     # rank 0 alone
        assert (out / "final.npz").exists()
        recs[name] = json.loads((out / log).read_text().splitlines()[0])
    for k, v in recs["one"].items():
        if k == "wall_s":
            continue
        if isinstance(v, float) and not k.startswith(("wire/", "cohort")):
            np.testing.assert_allclose(recs["mesh"][k], v, rtol=1e-5,
                                       err_msg=k)
        else:
            assert recs["mesh"][k] == v, k
    # JAX's refusals and messages
    proc = _launch("repro_torch.launch.train",
                   flags + ["--mesh-devices", "3", "--mesh-model", "2",
                            "--out", str(tmp_path / "x")])
    assert proc.returncode == 2 and "does not divide" in proc.stderr
    proc = _launch("repro_torch.launch.train",
                   flags + ["--mesh-model", "2", "--out",
                            str(tmp_path / "x")])
    assert proc.returncode == 2 and "needs --mesh-devices" in proc.stderr


def test_serve_launcher_mesh_model_from_a_shell():
    flags = ["--device", "cpu", "--requests", "4", "--wire", "int8",
             "--prompt-choices", "6", "10", "--new-token-choices", "3", "5"]
    outs = {}
    for name, extra in (("tp", ["--mesh-model", "2"]), ("one", []),
                        ("paged", ["--mesh-model", "2", "--page-size", "8",
                                   "--shared-prefix", "5",
                                   "--prefill-chunk", "4"])):
        proc = _launch("repro_torch.launch.serve", flags + extra)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.count("tok/s") == 1           # rank 0 alone
        outs[name] = [line for line in proc.stdout.splitlines()
                      if line.startswith("wire [")]
    assert outs["tp"] == outs["one"]
    assert "COW copies" in _launch(
        "repro_torch.launch.serve",
        flags + ["--mesh-model", "2", "--page-size", "8", "--shared-prefix",
                 "5"]).stdout
