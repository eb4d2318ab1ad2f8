"""Shared setup of the tensor-parallel family tests
(tests/test_torch_mesh_moe.py, test_torch_mesh_scans.py and
test_torch_mesh_encdec.py): the port's SFPrompt round, `client_updates`
and dense engine on a (data, model) mesh of host ranks, held against the
JAX package's single-device round and engine.

Each family is reduced as the JAX package's tests reduce it,
`reduced(n_layers=3 * len(layer_pattern))` (d_model 256, d_ff 512, vocab
512, 4 heads of 32, top-2 of 4 experts; MLA q_lora 64, kv_lora 32, nope /
rope / v 16 / 16 / 32; Mamba-2 16 heads of 32, d_state 16; RWKV-6 8
heads of 32; a 1-layer encoder over 16 frames), split head 1 / body 1 /
tail 1 with a prompt of 4; a round is K 2 clients of 8 sequences of 16,
batch 4, one local epoch, gamma 0.5, on the fp32 wire.

The JAX side runs in the pytest process (`jax_refs`) and writes its init,
cohort, results, kept sets and engine runs to an .npz file; four ranks
(a gloo group on the CPU, one thread each, spawned once a module) read it
and run the cases (`rank_program`), importing no JAX. A case on 'model' T
runs on the first T ranks (the others wait); the secure round runs on
(data 2, model 2)."""
import hashlib

import numpy as np
import torch

from test_torch_mesh_round import _leaves, flat, nest, section

RANKS = 4
TP = (2, 4)
K, N_LOCAL, BATCH, SEQ, PROMPT = 2, 8, 4, 16, 4
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=PROMPT,
             prune_gamma=0.5, local_epochs=1)
PCFG = dict(clients_per_round=K, local_epochs=1, batch_size=BATCH,
            lr_local=0.05, lr_split=0.05)
TOL = dict(rtol=1e-5, atol=1e-6)        # tests/test_torch_mesh_tp.py's
LM_TOL = dict(rtol=1e-5, atol=1e-5)     # tests/test_torch_lm_round.py's
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)  # the port's engine tests'
SECURE_SEED = 11
MAX_SEQ = 40
ROUND_MARGIN = 1e-5      # tests/test_torch_moe_round.py's floor for a round
ENGINE_MARGIN = 1e-4     # and for the engine


def family_cfg(get, arch, serve=False):
    """The family reduced for a round, or for the engine (`serve`): at
    d_model 64, d_ff 128 and vocab 128, the width of the port's engine
    tests against JAX (tests/test_torch_moe_round.py and
    test_torch_recurrent_serve.py). At the round's width the tenants'
    jittered tails give logits near 12, and the unsharded port's engine
    already differs from JAX's by up to 1.6e-3 (zamba2) there."""
    base = get(arch)
    if serve:
        return base.reduced(n_layers=3 * len(base.layer_pattern),
                            d_model=64, d_ff=128, vocab_size=128)
    return base.reduced(n_layers=3 * len(base.layer_pattern))


def extras(c, rng, n):
    """The batch keys a family's frontend stub brings for n samples
    (tests/test_torch_whisper.py's): Whisper's `frames` (n, n_frames, D);
    Qwen2-VL's 8 `patch_embeds` (n, 8, D) and their M-RoPE positions on a
    (2, 2, 2) grid, stored client-axis-first as (n, 3, 8)."""
    if c.arch_type == "audio":
        return {"frames": (0.02 * rng.standard_normal(
            (n, c.encoder.n_frames, c.d_model))).astype(np.float32)}
    if c.arch_type != "vlm":
        return {}
    g = np.stack(np.meshgrid(np.arange(2), np.arange(2), np.arange(2),
                             indexing="ij")).reshape(3, 8)
    return {"patch_embeds": (0.02 * rng.standard_normal(
        (n, 8, c.d_model))).astype(np.float32),
        "mrope_positions": np.ascontiguousarray(
            np.broadcast_to(g[None], (n, 3, 8)), dtype=np.int32)}


def requests():
    """tests/test_torch_recurrent_serve.py's trace: 3 requests on 2 slots,
    the third joining a retired slot."""
    from repro_torch.serve import Request
    return [Request(rid=0, tenant=0, tokens=np.arange(9, dtype=np.int32),
                    max_new=5, arrival=0),
            Request(rid=1, tenant=1,
                    tokens=(np.arange(12, dtype=np.int32) * 3) % 128,
                    max_new=3, arrival=0),
            Request(rid=2, tenant=2,
                    tokens=(np.arange(9, dtype=np.int32) * 7) % 128,
                    max_new=6, arrival=2)]


# ------------------------------------------------------------ the JAX side
def jax_refs(path, cases):
    """JAX's single-device references for `cases`, {arch: dict(seed=...,
    secure=bool, updates=bool, serve=bool, serve_seed=...)}, written to
    `path`: per arch its init params (JAX init seed `seed`), cohort, round
    (params, metrics, meter), the kept sets of its phases 1a and 1b, and
    where asked the secure round (aggregator seed SECURE_SEED),
    `client_updates` and a dense engine run (the engine's width, fp32
    wire, 3 tenants jittered by 0.2, 2 slots) from the init of
    `serve_seed`."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core import ProtocolConfig, SFPromptTrainer, SplitConfig
    from repro.core import SplitModel
    from repro.core.aggregation import get_aggregator
    from repro.data import (iid_partition, select_clients, stack_clients,
                            synthetic_lm_dataset)
    from repro.runtime import WireSpec

    out = {}
    for arch, case in cases.items():
        cfg = family_cfg(get_config, arch)
        model = SplitModel(cfg, SplitConfig(**SPLIT), WireSpec.make("fp32"))
        data = synthetic_lm_dataset(4 * N_LOCAL, SEQ, cfg.vocab_size, seed=0)
        data.update(extras(cfg, np.random.default_rng(100), 4 * N_LOCAL))
        cohort = stack_clients(iid_partition(data, 4, seed=0),
                               select_clients(4, K, seed=0, round_idx=0))
        jdata = {k: jnp.asarray(v) for k, v in cohort.items()}
        for k, v in cohort.items():
            out[f"{arch}/data/{k}"] = v
        runs = [("clear", None)]
        if case.get("secure"):
            runs.append(("secure", get_aggregator(secure=True, impl="ref",
                                                  seed=SECURE_SEED)))
        for tag, agg in runs:
            tr = SFPromptTrainer(model, ProtocolConfig(**PCFG), agg)
            state = tr.init(jax.random.PRNGKey(case["seed"]))
            new, metrics = tr.round(state, jdata)
            for key, v in flat(jax.tree.map(np.asarray,
                                            new["params"])).items():
                out[f"{arch}/{tag}/params/{key}"] = v
            for key, v in metrics.items():
                out[f"{arch}/{tag}/metrics/{key}"] = np.float64(v)
            for key, v in tr.meter.totals.items():
                out[f"{arch}/{tag}/meter/{key}"] = np.float64(v)
            if tag == "clear":
                init = state["params"]
                out[f"{arch}/kept"] = _jax_kept(model, tr, init, jdata)
        for key, v in flat(jax.tree.map(np.asarray, init)).items():
            out[f"{arch}/init/{key}"] = v
        if case.get("updates"):
            tr = SFPromptTrainer(model, ProtocolConfig(
                **PCFG, return_client_trainable=True))
            contrib, _ = tr.client_updates(
                tr.init(jax.random.PRNGKey(case["seed"])), jdata)
            for key, v in flat(jax.tree.map(np.asarray, contrib)).items():
                out[f"{arch}/updates/{key}"] = v
        if case.get("serve"):
            smodel = SplitModel(family_cfg(get_config, arch, serve=True),
                                SplitConfig(**SPLIT), WireSpec.make("fp32"))
            params = smodel.init(jax.random.PRNGKey(case["serve_seed"]))
            for key, v in flat(jax.tree.map(np.asarray, params)).items():
                out[f"{arch}/serve_init/{key}"] = v
            out.update(_jax_serve(arch, smodel, params))
    np.savez(path, **out)


def _jax_kept(model, tr, params, data):
    """The kept sets of JAX's phases 1a and 1b
    (`repro/core/protocol.py::_round`) from `params`, one client at a
    time (the MoE block's `ragged_dot` has no vmap rule for this
    gradient), in rank order."""
    import jax
    import jax.numpy as jnp

    from repro.core.local_update import local_epochs
    from repro.core.pruning import score_client_data
    opt = tr.opt_local

    @jax.jit
    def client(d):
        trainable = {"tail": params["tail"], "prompt": params["prompt"]}
        trainable, _, _ = local_epochs(model, params["head"], trainable, opt,
                                       opt.init(trainable), d,
                                       batch_size=BATCH, n_epochs=1,
                                       impl="ref")
        return score_client_data(model, params["head"], trainable["tail"],
                                 trainable["prompt"], d, batch_size=BATCH,
                                 impl="ref")

    scores = jnp.stack([client(jax.tree.map(lambda x: x[c], data))
                        for c in range(K)])
    return np.asarray(jnp.argsort(-scores, axis=1)[:, :tr.phase2_keep(
        N_LOCAL)])


def _jax_serve(arch, model, params):
    """JAX's unsharded dense engine over `requests()`: its bank (3
    tenants, tails and prompts jittered by 0.2, as
    tests/test_torch_recurrent_serve.py's), tokens, logits and bytes."""
    import jax

    from repro.serve import ServeConfig, ServeEngine, TenantBank
    tails, prompts = [], []
    for t in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(7), t)
        leaves, treedef = jax.tree.flatten(params["tail"])
        ks = jax.random.split(key, len(leaves) + 1)
        tails.append(jax.tree.unflatten(treedef, [
            x + 0.2 * jax.random.normal(k, x.shape, x.dtype)
            for x, k in zip(leaves, ks[:-1])]))
        prompts.append(params["prompt"] + 0.2 * jax.random.normal(
            ks[-1], params["prompt"].shape))
    bank = TenantBank.from_lists(tails, prompts)
    stats = ServeEngine(model, params, bank,
                        ServeConfig(n_slots=2, max_seq=MAX_SEQ,
                                    decode_block=2),
                        collect_logits=True).run(requests())
    out = {}
    for key, v in flat(jax.tree.map(np.asarray, bank.tails)).items():
        out[f"{arch}/bank/tails/{key}"] = v
    out[f"{arch}/bank/prompts"] = np.asarray(bank.prompts)
    for f in stats["finished"]:
        out[f"{arch}/serve/tokens/{f.req.rid}"] = np.asarray(f.tokens)
        out[f"{arch}/serve/logits/{f.req.rid}"] = np.asarray(f.logits)
    for k, v in stats["wire_bytes"].items():
        out[f"{arch}/serve/wire/{k}"] = np.float64(v)
    return out


# ---------------------------------------------------------- the ranks
class _Probe:
    """Records, in this rank's process, each MoE call's router margin
    (`models/layers.py::router_margin`) and a digest of its routing (the
    sorted expert ids, of which `top_e` is the first k columns)."""

    def __init__(self):
        from repro_torch.models import layers as L
        self.L, self.margins, self.routes = L, [], []
        self.moe, self.route = L.apply_moe, L._route

        def apply_moe(p, cfg, x, *mesh):
            self.margins.append(L.router_margin(p, cfg, x))
            return self.moe(p, cfg, x, *mesh)

        def route(p, cfg, x):
            out = self.route(p, cfg, x)
            self.routes.append(hashlib.sha256(
                out[4].contiguous().numpy().tobytes()).hexdigest())
            return out
        L.apply_moe, L._route = apply_moe, route

    def close(self):
        self.L.apply_moe, self.L._route = self.moe, self.route
        return {"margin": min(self.margins, default=float("inf")),
                "routes": self.routes}


def _models(arch, wire="fp32", serve=False):
    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.runtime import WireSpec
    return SplitModel(family_cfg(get_config, arch, serve),
                      SplitConfig(**SPLIT), WireSpec.make(wire))


def _round(arch, refs, mesh, *, wire="fp32", secure=False, updates=False):
    """One round (or `client_updates`) on `mesh` from JAX's init: the whole
    params after it (or the contributions), metrics, meter, kept sets,
    every head and body leaf's local shape, and the MoE probe's record."""
    import dataclasses

    from repro_torch.bridge import jax_to_torch
    from repro_torch.core import ProtocolConfig, SFPromptTrainer
    from repro_torch.core.aggregation import get_aggregator
    pcfg = ProtocolConfig(**PCFG)
    if updates:
        pcfg = dataclasses.replace(pcfg, return_client_trainable=True)
    agg = get_aggregator(secure=True, seed=SECURE_SEED) if secure else None
    tr = SFPromptTrainer(_models(arch, wire), pcfg, agg, mesh=mesh,
                         device="cpu")
    init = nest(section(refs, f"{arch}/init"))
    cohort = section(refs, f"{arch}/data")
    state = {"params": tr.shard_params(jax_to_torch(init, "cpu")),
             "round": 0}
    probe = _Probe()
    try:
        if updates:
            contrib, _ = tr.client_updates(state, cohort)
        else:
            new, metrics = tr.round(state, cohort)
    finally:
        record = probe.close()
    if updates:
        return {"params": flat(contrib), "probe": record}
    return {"params": flat(tr.full_params(new["params"])),
            "metrics": metrics, "meter": dict(tr.meter.totals),
            "kept": tr.last_kept.numpy(), "probe": record,
            **{seg: [tuple(x.shape) for x in _leaves(new["params"][seg])]
               for seg in ("head", "body")}}


def _serve(arch, refs, mesh):
    """The dense engine on `mesh` over `requests()` from JAX's init and
    bank: tokens, logits, bytes, the engine's local shapes of its head
    and body leaves and of its caches' recurrent and attention leaves,
    whether `bridge.jax_to_local` cuts the same shards, and the MoE
    probe's record."""
    from repro_torch.bridge import (bank_from_arrays, jax_to_local,
                                    jax_to_torch)
    from repro_torch.serve import ServeConfig, ServeEngine
    init = nest(section(refs, f"{arch}/serve_init"))
    params = jax_to_torch(init, "cpu")
    bank = bank_from_arrays(nest(section(refs, f"{arch}/bank/tails")),
                            refs[f"{arch}/bank/prompts"], "cpu")
    eng = ServeEngine(_models(arch, serve=True), params, bank,
                      ServeConfig(n_slots=2, max_seq=MAX_SEQ,
                                  decode_block=2),
                      collect_logits=True, mesh=mesh, device="cpu")
    probe = _Probe()
    try:
        stats = eng.run(requests())
    finally:
        record = probe.close()
    bridged = None
    if mesh is not None:
        local = jax_to_local({"head": init["head"], "body": init["body"]},
                             eng.step_specs["shared"], mesh, "cpu")
        bridged = all(torch.equal(a, b) for a, b in zip(
            _leaves(eng.shared), _leaves(local)))
    caches = {seg: {f"{pos}/{name}": tuple(leaf.shape)
                    for pos, stack in eng.cache[seg]["stack"].items()
                    for name, leaf in stack.items()}
              for seg in ("head", "body", "tail")}
    return {"tokens": {f.req.rid: np.asarray(f.tokens)
                       for f in stats["finished"]},
            "logits": {f.req.rid: np.asarray(f.logits)
                       for f in stats["finished"]},
            "wire": stats["wire_bytes"], "probe": record,
            "bridge_equal": bridged,
            "shared": {seg: [tuple(x.shape) for x in _leaves(
                eng.shared[seg])] for seg in ("head", "body")},
            "caches": caches}


def _wire_log(arch, refs, mesh):
    """An int8-wire round on `mesh` with a digest of every crossing's rows,
    uniforms and received values, and the MoE routing digests."""
    from test_torch_mesh_tp import _record_wire
    log = []
    restore = _record_wire(log)
    try:
        res = _round(arch, refs, mesh, wire="int8")
    finally:
        restore()
    return {"log": log, "routes": res["probe"]["routes"],
            "meter": res["meter"]}


def rank_program(ref_path, cases, extra=None):
    """Every rank: the meshes, then each arch's cases on the meshes this
    rank has a place in; `extra(meshes)` adds what a module's own tests
    need. Returns {arch: {case: result}}."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    refs = np.load(ref_path)
    meshes = {tp: make_host_mesh(tp, model=tp) for tp in TP}
    meshes["2x2"] = make_host_mesh(RANKS, model=2)
    rank = dist.get_rank()
    out = {}
    for arch, case in cases.items():
        res = out.setdefault(arch, {})
        for tp in TP:
            if rank >= tp:
                continue
            res[f"round{tp}"] = _round(arch, refs, meshes[tp])
            if case.get("updates"):
                res[f"updates{tp}"] = _round(arch, refs, meshes[tp],
                                             updates=True)
            if case.get("serve"):
                res[f"serve{tp}"] = _serve(arch, refs, meshes[tp])
        if case.get("wire") and rank < 2:
            res["int8"] = _wire_log(arch, refs, meshes[2])
        if case.get("secure"):
            res["secure"] = _round(arch, refs, meshes["2x2"], secure=True)
    if extra is not None:
        out["extra"] = extra(meshes)
    return out


def run_ranks(tmp, cases, extra=None):
    """The JAX references for `cases`, then the ranks; returns (refs,
    the ranks' results)."""
    from repro_torch.launch.mesh import spawn_ranks
    path = str(tmp / "refs.npz")
    jax_refs(path, cases)
    return np.load(path), spawn_ranks(rank_program, RANKS, path, cases,
                                      extra)


# ------------------------------------------------------------- checks
def check_round(refs, got, arch, tag="clear", tol=TOL):
    """Params within `tol` of JAX's single-device round, every metric
    within rtol 1e-5, bytes, cohort counts and kept_frac `==`, and the
    meter's totals `==`."""
    want = section(refs, f"{arch}/{tag}/params")
    assert got["params"].keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], err_msg=k,
                                   **tol)
    jm = section(refs, f"{arch}/{tag}/metrics")
    assert set(got["metrics"]) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
        if k.startswith(("wire/", "cohort/")) or k == "kept_frac":
            assert got["metrics"][k] == v, k
    assert got["meter"] == {k: float(v) for k, v in
                            section(refs, f"{arch}/{tag}/meter").items()}


def check_serve(refs, got, arch, tol=SERVE_TOL):
    """Tokens `==`, logits within `tol` and wire bytes `==` JAX's
    unsharded engine."""
    want = section(refs, f"{arch}/serve/tokens")
    assert {str(k) for k in got["tokens"]} == set(want)
    for rid, toks in want.items():
        np.testing.assert_array_equal(got["tokens"][int(rid)], toks)
        np.testing.assert_allclose(got["logits"][int(rid)],
                                   refs[f"{arch}/serve/logits/{rid}"],
                                   err_msg=rid, **tol)
    assert got["wire"] == {k: float(v) for k, v in
                           section(refs, f"{arch}/serve/wire").items()}


def local_shapes(arch, tp, serve=False):
    """(local shape, whole shape, spec) of every head and body leaf of the
    family's split model under `params_pspecs` on (data 1, model tp)."""
    from repro_torch.sharding import params_pspecs
    from repro_torch.sharding.rules import pop_sharding_fallbacks
    whole = _models(arch, serve=serve).init(torch.Generator(),
                                            device="meta")
    stub = type("Mesh", (), {"shape": {"data": 1, "model": tp}})()
    specs = params_pspecs(whole, stub)
    pop_sharding_fallbacks()
    out = {}
    for seg in ("head", "body"):
        out[seg] = [(tuple(d // tp if e == "model" else d
                           for d, e in zip(leaf.shape, tuple(s))),
                     tuple(leaf.shape), tuple(s))
                    for leaf, s in zip(_leaves(whole[seg]),
                                       _leaves(specs[seg]))]
    return out


def check_local_shapes(arch, tp, held, seg="body", min_cut=1, serve=False):
    """Every leaf a rank holds has its local shape under the rules: no
    rank holds a leaf the rules shard over 'model' at full size."""
    want = local_shapes(arch, tp, serve)[seg]
    assert len(held) == len(want)
    cut = 0
    for got, (local, whole, spec) in zip(held, want):
        assert got == local, (got, local, spec)
        if "model" in spec:
            assert got != whole
            cut += 1
    assert cut >= min_cut, cut
    return cut


def check_margin(label, margin, floor):
    print(f"{label}: router margin {margin:.3g}")
    assert margin > floor, (label, margin)
