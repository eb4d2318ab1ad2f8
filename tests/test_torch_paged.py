"""The port's paged serving path against the JAX package's, on the same
numpy inputs and bridged weights: the paged decode op (plain version), the
page-pool ops of core/split.py, the chunked-prefill continuation, the
PagedServeEngine (plain, shared prefix with chunked prefill, head-of-line
wait) against the JAX engine, the port's paged engine against its own
dense engine bit for bit, and the paged launcher."""
import torch

torch.set_num_threads(2)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.kernels.flash_attention.decode import \
    paged_decode_attention as jpaged  # noqa: E402
from repro.models.layers import \
    _paged_cache_write as j_paged_cache_write  # noqa: E402
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro.serve import PagedServeConfig as JPagedServeConfig  # noqa: E402
from repro.serve import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro.serve import TenantBank as JTenantBank  # noqa: E402
from repro_torch.bridge import bank_from_arrays, jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SplitConfig, SplitModel  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    BLOCKS_PER_SM, MAX_SPLITS, decode_splits, grouped_decode,
    paged_decode_attention)
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.layers import _paged_cache_write  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.serve import (PagedServeConfig,  # noqa: E402
                               PagedServeEngine, PagePool, Request,
                               ServeConfig, ServeEngine)
from repro_torch.tree import tree_leaves  # noqa: E402

MAX_SEQ = 48
PROMPT_LEN = 4
PAGE = 8
TOL = dict(atol=1e-5, rtol=1e-5)
PREFIX = (3, 1, 4, 1, 5, 9, 2, 6)   # L_pre = 12: one full page + boundary


def _cfg(get, variant="g1"):
    """The reduced Qwen2.5 family; "gqa5" is chip_smoke.gqa_reduced (a GQA
    group of 5, as at full width)."""
    if variant == "gqa5":
        cfg = get("qwen2.5-14b").reduced(n_layers=3, d_model=160, d_ff=128,
                                         vocab_size=128)
        return dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, n_heads=10, n_kv_heads=2, head_dim=16))
    return get("qwen2.5-14b").reduced(n_layers=3, d_model=64, d_ff=128,
                                      vocab_size=128)


def _jax_bank(params, n_tenants=3, jitter=0.2):
    """Distinct per-tenant (tail, prompt), as tests/test_serve_paged.py
    builds."""
    tails, prompts = [], []
    for t in range(n_tenants):
        key = jax.random.fold_in(jax.random.PRNGKey(7), t)
        leaves, treedef = jax.tree.flatten(params["tail"])
        ks = jax.random.split(key, len(leaves) + 1)
        tails.append(jax.tree.unflatten(treedef, [
            x + jitter * jax.random.normal(k, x.shape, x.dtype)
            for x, k in zip(leaves, ks[:-1])]))
        prompts.append(params["prompt"] + jitter * jax.random.normal(
            ks[-1], params["prompt"].shape))
    return JTenantBank.from_lists(tails, prompts)


def _build(variant):
    split = dict(head_cycles=1, tail_cycles=1, prompt_len=PROMPT_LEN)
    jm = JSplitModel(_cfg(jget_config, variant), JSplitConfig(**split),
                     JWireSpec.make("fp32"))
    tm = SplitModel(_cfg(get_config, variant), SplitConfig(**split),
                    WireSpec.make("fp32"))
    params = jm.init(jax.random.PRNGKey(0))
    jb = _jax_bank(params)
    return dict(jm=jm, params=params, jb=jb, tm=tm,
                tparams=jax_to_torch(params, "cpu"),
                tbank=bank_from_arrays(jb.tails, jb.prompts, "cpu"))


@pytest.fixture(scope="module")
def g1():
    return _build("g1")


@pytest.fixture(scope="module")
def gqa5():
    return _build("gqa5")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _toks(n, mult):
    return (np.arange(n, dtype=np.int32) * mult) % 128


# the trace of tests/test_serve_paged.py: ragged joins/leaves, staggered
# arrivals, a tenant repeat
REQS = [
    Request(rid=0, tenant=0, tokens=_toks(9, 1), max_new=5, arrival=0),
    Request(rid=1, tenant=1, tokens=_toks(14, 3), max_new=4, arrival=0),
    Request(rid=2, tenant=2, tokens=_toks(6, 7), max_new=6, arrival=2),
    Request(rid=3, tenant=1, tokens=_toks(11, 5), max_new=3, arrival=3),
]
# plus a tenant-0 request that overlaps rid 0, so a shared prefix is hit
REQS_HIT = REQS + [
    Request(rid=4, tenant=0, tokens=_toks(7, 2), max_new=4, arrival=1)]


# ------------------------------------------------------------ paged op
def _paged_inputs(seed, B, nb, page, Hq, Hkv, Dh, lens):
    """A shuffled, non-contiguous pool: the reserved pages, each slot's
    pages, spares; NULL entries past each slot's length, an idle row of
    all SCRATCH for a slot of length 0, and a fully masked row of all NULL
    (every position -1, query position 0) for a length of None."""
    rng = np.random.default_rng(seed)
    P = 2 + B * nb + 3
    q = rng.standard_normal((B, 1, Hq, Dh)).astype(np.float32)
    k_pool = rng.standard_normal((P, page, Hkv, Dh)).astype(np.float32)
    v_pool = rng.standard_normal((P, page, Hkv, Dh)).astype(np.float32)
    perm = rng.permutation(np.arange(2, P))
    kv_pos = np.full((P, page), -1, np.int32)
    kv_pos[1] = rng.integers(0, 5, page)            # scratch: garbage
    tables = np.zeros((B, nb), np.int32)             # NULL page
    for b, n in enumerate(lens):
        if n is None:
            continue
        if n == 0:
            tables[b] = PagePool.SCRATCH_PAGE
            continue
        for j in range(-(-n // page)):
            pid = perm[b * nb + j]
            tables[b, j] = pid
            m = min(page, n - j * page)
            kv_pos[pid, :m] = j * page + np.arange(m)
            # stale positions past the slot's length on its last page
            kv_pos[pid, m:] = -1 if j % 2 else 10 ** 6
    q_pos = np.asarray([max((n or 0) - 1, 0) for n in lens], np.int32)
    return q, k_pool, v_pool, tables, q_pos, kv_pos


PAGED_CASES = [
    # (B, nb, page, Hq, Hkv, Dh, lens, window, softcap)
    (3, 3, 8, 4, 2, 32, [20, 7, 24], None, None),
    (4, 4, 8, 10, 2, 16, [1, 0, 32, 13], None, None),
    (3, 5, 5, 10, 2, 16, [25, 11, 3], 6, 15.0),
    (2, 3, 16, 8, 8, 32, [33, 48], None, 30.0),
    # row 1 is fully masked: no valid key anywhere in its table
    (3, 4, 8, 10, 2, 16, [13, None, 32], 6, 15.0),
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_matches_jax_paged_op(case):
    """The port's plain paged decode against the JAX op on the same
    inputs: within 1e-5 of its XLA path, within 2e-5 of its Pallas kernel
    on the interpreter, and == the port's own grouped decode over the
    gathered caches. A fully masked row gets the mean of every value of
    its table in both packages; the CUDA kernel keeps that answer."""
    B, nb, page, Hq, Hkv, Dh, lens, window, softcap = case
    q, kp, vp, tables, qpos, kvpos = _paged_inputs(
        sum(n or 0 for n in lens), B, nb, page, Hq, Hkv, Dh, lens)
    got = paged_decode_attention(
        _t(q), _t(kp), _t(vp), block_tables=_t(tables), q_positions=_t(qpos),
        kv_positions=_t(kvpos), sliding_window=window,
        softcap=softcap).numpy()
    assert np.isfinite(got).all()
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp))
    jkw = dict(block_tables=jnp.asarray(tables),
               q_positions=jnp.asarray(qpos),
               kv_positions=jnp.asarray(kvpos), sliding_window=window,
               softcap=softcap)
    np.testing.assert_allclose(
        got, np.asarray(jpaged(*jargs, **jkw, impl="xla")), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jpaged(*jargs, **jkw, impl="interpret")),
        atol=2e-5, rtol=2e-5)
    W = nb * page
    dense = grouped_decode(
        _t(q), _t(kp[tables].reshape(B, W, Hkv, Dh)),
        _t(vp[tables].reshape(B, W, Hkv, Dh)), _t(qpos),
        _t(kvpos[tables].reshape(B, W)), scale=Dh ** -0.5,
        sliding_window=window, softcap=softcap).numpy()
    np.testing.assert_array_equal(got, dense)
    for b in (b for b, n in enumerate(lens) if n is None):
        mean = vp[tables[b]].reshape(W, Hkv, Dh).mean(0)     # (Hkv, Dh)
        np.testing.assert_allclose(
            got[b, 0], np.repeat(mean, Hq // Hkv, axis=0), **TOL)


@pytest.mark.parametrize("B,Hkv,width,sms,want", [
    (16, 8, 512, 132, 4),    # the serving paths' 16 slots x 8 kv heads
    (1, 8, 4096, 132, 8),    # capped at MAX_SPLITS
    (1, 2, 70, 132, 3),      # capped at the row's 3 tiles of 32 keys
    (50, 8, 512, 132, 1),    # 400 blocks already put 3 on each of 132 SMs
    (5, 2, 16, 132, 1),      # a table narrower than one tile
])
def test_paged_splits(B, Hkv, width, sms, want):
    """The paged kernel's split count, a function of shapes alone."""
    assert decode_splits(B, Hkv, width, sms) == want


@pytest.mark.parametrize("B,Hkv,width,sms,want", [
    (8, 8, 512, 132, 7),     # Qwen2.5-14B's 8 slots x 8 kv heads
    (8, 32, 512, 132, 2),    # zamba2's shared block, 32 kv heads
    (5, 2, 77, 132, 3),      # capped at the row's 3 tiles of 32 keys
])
def test_decode_splits_at_the_dense_shapes(B, Hkv, width, sms, want):
    """The slot-cache kernel's split count: the same function of shapes
    as the paged kernel's, over the cache's W keys."""
    assert decode_splits(B, Hkv, width, sms) == want


def test_paged_splits_is_the_smallest_that_fills_the_card():
    for B in (1, 2, 3, 8, 16, 17, 64):
        for Hkv in (1, 2, 8):
            for width in (1, 31, 32, 33, 100, 512, 5000):
                tiles = -(-width // 32)
                S = decode_splits(B, Hkv, width, 132)
                assert 1 <= S <= min(MAX_SPLITS, tiles)
                if S < min(MAX_SPLITS, tiles):
                    assert B * Hkv * S >= BLOCKS_PER_SM * 132
                assert S == 1 or B * Hkv * (S - 1) < BLOCKS_PER_SM * 132


# ------------------------------------------------------------ pool ops
def _random_pool(jm, seed, n_pages):
    """A page pool of the model's structure with random K/V and
    positions, as numpy leaves."""
    rng = np.random.default_rng(seed)

    def fill(x):
        if x.dtype == jnp.int32:
            return rng.integers(-1, 40, x.shape).astype(np.int32)
        return rng.standard_normal(x.shape).astype(np.float32)
    return jax.tree.map(fill, jm.init_paged_cache(n_pages, PAGE))


def _assert_pools_equal(tpool, jpool, skip_scratch=False):
    jflat = jax.tree_util.tree_flatten_with_path(_np(jpool))[0]
    assert len(jflat) == len(tree_leaves(tpool))
    for path, want in jflat:
        node = tpool
        for p in path:
            node = node[p.key]
        got = node.numpy()
        if skip_scratch:      # duplicate scratch writes: either may win
            keep = np.arange(got.shape[1]) != PagePool.SCRATCH_PAGE
            got, want = got[:, keep], want[:, keep]
        np.testing.assert_array_equal(got, want, err_msg=str(path))


@pytest.mark.parametrize("op", ["cache_write", "gather", "scatter_token",
                                "scatter_slot", "copy_page"])
def test_pool_ops_equal_jax(g1, op):
    """Each page-pool op leaves the pool (or returns a view) `==` to the
    JAX op's on the same inputs; the port writes in place."""
    jm, tm = g1["jm"], g1["tm"]
    P, S, nb = 12, 3, 3
    npool = _random_pool(jm, 1, P)
    tpool = jax_to_torch(npool, "cpu")
    jpool = jax.tree.map(jnp.asarray, npool)
    rng = np.random.default_rng(2)
    tables = rng.permutation(np.arange(2, P))[:S * nb].reshape(S, nb)
    tables = tables.astype(np.int32)
    pos = np.asarray([3, 17, 23], np.int32)
    if op == "cache_write":
        leaf = npool["body"]["stack"]["pos0"]
        cache = {k: v[0] for k, v in leaf.items()}
        cache["block_tables"] = tables
        H, D = cache["k"].shape[2:]
        kv = [rng.standard_normal((S, 1, H, D)).astype(np.float32)
              for _ in range(2)]
        want = j_paged_cache_write(jax.tree.map(jnp.asarray, cache),
                                   ("k", "v"), [jnp.asarray(a) for a in kv],
                                   jnp.asarray(pos))
        tcache = {k: _t(v) for k, v in cache.items()}
        got = _paged_cache_write(tcache, ("k", "v"), [_t(a) for a in kv],
                                 _t(pos))
        assert got is tcache
        for key in ("k", "v", "positions"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]), key)
        return
    if op == "gather":
        want = jm.paged_gather(jpool, jnp.asarray(tables))
        got = tm.paged_gather(tpool, _t(tables))
        _assert_pools_equal(got, want)
        return
    if op == "scatter_token":
        jdense = jm.paged_gather(jpool, jnp.asarray(tables))
        jdense = jax.tree.map(
            lambda x: x + jnp.ones_like(x), jdense)   # new token values
        want = jm.paged_scatter_token(jpool, jdense, jnp.asarray(tables),
                                      jnp.asarray(pos))
        got = tm.paged_scatter_token(tpool, jax_to_torch(_np(jdense), "cpu"),
                                     _t(tables), _t(pos))
        assert got is tpool
        _assert_pools_equal(got, want)
        return
    if op == "scatter_slot":
        single = _np(jm.paged_gather(jpool, jnp.asarray(tables[1:2])))
        single = jax.tree.map(lambda x: x * 2, single)
        mask = np.asarray([True, False, True])
        want = jm.paged_scatter_slot(jpool, jax.tree.map(jnp.asarray, single),
                                     jnp.asarray(tables[0]),
                                     jnp.asarray(mask), jnp.int32(1))
        got = tm.paged_scatter_slot(tpool, jax_to_torch(single, "cpu"),
                                    _t(tables[0]), _t(mask),
                                    PagePool.SCRATCH_PAGE)
        _assert_pools_equal(got, want, skip_scratch=True)
        return
    want = jm.paged_copy_page(jpool, jnp.int32(5), jnp.int32(9))
    got = tm.paged_copy_page(tpool, 5, 9)
    _assert_pools_equal(got, want)


def test_paged_seg_view_shares_the_pool(g1):
    """The view injects the tables over every layer and aliases the pool:
    a write through it lands in the pool; stripping returns the bare
    tree."""
    tm = g1["tm"]
    pool = tm.init_paged_cache(6, PAGE, device="cpu")
    tables = torch.tensor([[2, 3], [4, 0]], dtype=torch.int32)
    view = tm.paged_seg_view(pool["tail"], tables)
    stack = view["stack"]["pos0"]
    assert stack["block_tables"].shape == (1, 2, 2)
    stack["k"][0, 3, 1] = 7.0
    assert float(pool["tail"]["stack"]["pos0"]["k"][0, 3, 1, 0, 0]) == 7.0
    bare = tm.strip_paged_view(view)
    assert set(bare["stack"]["pos0"]) == {"k", "v", "positions"}


# ----------------------------------------------------- chunked prefill
@pytest.mark.parametrize("variant", ["g1", "gqa5"])
def test_chunk_continuation_matches_jax(g1, gqa5, variant):
    """forward(chunk_start=...) against JAX's on the cache the first chunk
    left: logits within 1e-5, cache k/v within 1e-5, positions and wire
    bytes ==."""
    s = g1 if variant == "g1" else gqa5
    jm, tm, params, tparams = s["jm"], s["tm"], s["params"], s["tparams"]
    toks = np.random.default_rng(3).integers(0, 128, (1, 13)).astype(
        np.int32)
    first, rest = toks[:, :5], toks[:, 5:]
    jout = jm.forward(params, {"tokens": jnp.asarray(first)},
                      mode="prefill", cache=jm.blank_slot_cache(MAX_SEQ))
    tout = tm.forward(tparams, {"tokens": _t(first)}, mode="prefill",
                      cache=tm.blank_slot_cache(MAX_SEQ, device="cpu"))
    start = np.asarray([PROMPT_LEN + 5], np.int32)
    jout = jm.forward(params, {"tokens": jnp.asarray(rest)}, mode="prefill",
                      cache=jout["cache"], chunk_start=jnp.asarray(start))
    tout = tm.forward(tparams, {"tokens": _t(rest)}, mode="prefill",
                      cache=tout["cache"], chunk_start=_t(start))
    np.testing.assert_allclose(tout["logits"].numpy(),
                               np.asarray(jout["logits"]), **TOL)
    assert tout["wire_bytes"] == {k: float(v) for k, v in
                                  jout["wire_bytes"].items()}
    jc = _np(jout["cache"])
    for seg in ("head", "body", "tail"):
        want = jc[seg]["stack"]["pos0"]
        got = tout["cache"][seg]["stack"]["pos0"]
        np.testing.assert_array_equal(got["positions"].numpy(),
                                      want["positions"])
        for key in ("k", "v"):
            np.testing.assert_allclose(got[key].numpy(), want[key], **TOL)


def test_chunked_prefill_matches_monolithic(gqa5):
    """A prompt prefilled in chunks of 3 equals its monolithic prefill:
    last logits and cache within 1e-5, positions and total bytes ==."""
    tm, tparams = gqa5["tm"], gqa5["tparams"]
    toks = _t(np.random.default_rng(4).integers(0, 128, (1, 11)).astype(
        np.int32))
    mono = tm.forward(tparams, {"tokens": toks}, mode="prefill",
                      cache=tm.blank_slot_cache(MAX_SEQ, device="cpu"))
    out = tm.forward(tparams, {"tokens": toks[:, :3]}, mode="prefill",
                     cache=tm.blank_slot_cache(MAX_SEQ, device="cpu"))
    total = dict(out["wire_bytes"])
    for i in range(3, 11, 3):
        out = tm.forward(tparams, {"tokens": toks[:, i:i + 3]},
                         mode="prefill", cache=out["cache"],
                         chunk_start=torch.tensor([PROMPT_LEN + i],
                                                  dtype=torch.int32))
        total = {k: total[k] + v for k, v in out["wire_bytes"].items()}
    np.testing.assert_allclose(out["logits"].numpy(),
                               mono["logits"].numpy(), **TOL)
    assert total == mono["wire_bytes"]
    for a, b in zip(tree_leaves(out["cache"]), tree_leaves(mono["cache"])):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ------------------------------------------------------------- engines
ENGINE_CASES = {
    "plain": dict(),
    "prefix_chunked": dict(shared_prefix=PREFIX, prefill_chunk=3),
    # 4 usable pages: one 3-page request at a time, so the head of the
    # queue waits for pages
    "pool_wait": dict(n_pages=2 + 4),
}
COUNTERS = ("page_copies", "prefix_hits", "prefix_misses", "prefill_chunks",
            "peak_pages", "pages_in_use", "decode_steps", "prefills",
            "tokens_out")


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_paged_engine_matches_jax_engine(g1, case):
    """Tokens ==, per-step logits within 1e-5, wire bytes == and every
    page counter == the JAX PagedServeEngine on the same trace."""
    kw = dict(n_slots=3, max_seq=MAX_SEQ, decode_block=2, page_size=PAGE,
              **ENGINE_CASES[case])
    jeng = JPagedServeEngine(g1["jm"], g1["params"], g1["jb"],
                             JPagedServeConfig(**kw), collect_logits=True)
    want = jeng.run(REQS_HIT)
    teng = PagedServeEngine(g1["tm"], g1["tparams"], g1["tbank"],
                            PagedServeConfig(**kw), collect_logits=True,
                            device="cpu")
    got = teng.run(REQS_HIT)
    assert got["n_finished"] == want["n_finished"] == len(REQS_HIT)
    w_by = {f.req.rid: f for f in want["finished"]}
    for f in got["finished"]:
        np.testing.assert_array_equal(f.tokens, w_by[f.req.rid].tokens)
        np.testing.assert_allclose(f.logits, w_by[f.req.rid].logits, **TOL)
    assert got["wire_bytes"] == want["wire_bytes"]
    for key in COUNTERS:
        assert got[key] == want[key], key
    assert teng.prefill_step_calls == jeng.prefill_step_calls
    assert teng.pool_alloc.free_list() == jeng.pool_alloc.free_list()
    if case == "pool_wait":
        assert got["peak_pages"] <= 4
    if case == "prefix_chunked":
        assert got["prefix_hits"] >= 1 and got["prefill_chunks"] > 0


def test_paged_matches_dense_bitwise(g1):
    """At fp32 with a dense-equivalent pool (page | max_seq, default
    n_pages) the port's paged engine equals its dense engine bit for bit:
    tokens, every logit row, every metered byte; the pool drains."""
    tm, tp, tb = g1["tm"], g1["tparams"], g1["tbank"]
    dense = ServeEngine(tm, tp, tb, ServeConfig(n_slots=3, max_seq=MAX_SEQ,
                                                decode_block=2),
                        collect_logits=True, device="cpu").run(REQS)
    peng = PagedServeEngine(tm, tp, tb,
                            PagedServeConfig(n_slots=3, max_seq=MAX_SEQ,
                                             decode_block=2, page_size=PAGE),
                            collect_logits=True, device="cpu")
    assert peng.cache is None           # the dense cache is never built
    paged = peng.run(REQS)
    d = {f.req.rid: f for f in dense["finished"]}
    for f in paged["finished"]:
        np.testing.assert_array_equal(f.tokens, d[f.req.rid].tokens)
        np.testing.assert_array_equal(f.logits, d[f.req.rid].logits)
    assert paged["wire_bytes"] == dense["wire_bytes"]
    assert paged["pages_in_use"] == 0
    assert peng.pool_alloc.n_free == peng.pool_alloc.n_pages - 2


def test_cow_lifecycle_and_no_cpu_launches(g1):
    """The prefix is prefilled once per tenant, each join copies the
    boundary page once, the last sharer's retirement returns every page;
    reset_stats clears the paged counters for a warm replay. No kernel
    launches on CPU tensors."""
    before = launch_counts()
    reqs = [Request(rid=0, tenant=1, tokens=_toks(9, 3), max_new=6,
                    arrival=0),
            Request(rid=1, tenant=1, tokens=_toks(5, 5), max_new=6,
                    arrival=1)]
    peng = PagedServeEngine(
        g1["tm"], g1["tparams"], g1["tbank"],
        PagedServeConfig(n_slots=3, max_seq=MAX_SEQ, decode_block=2,
                         page_size=PAGE, shared_prefix=PREFIX,
                         prefill_chunk=4), device="cpu")
    first = peng.run(reqs)
    assert peng.prefill_step_calls == 1
    assert (peng.prefix_misses, peng.prefix_hits, peng.page_copies) == \
        (1, 1, 2)
    assert not peng._prefix and first["pages_in_use"] == 0
    peng.reset_stats()
    assert peng.peak_pages == 0 and peng.page_copies == 0
    second = peng.run(reqs)
    assert {f.req.rid: f.tokens.tolist() for f in first["finished"]} == \
        {f.req.rid: f.tokens.tolist() for f in second["finished"]}
    assert first["wire_bytes"] == second["wire_bytes"]
    assert launch_counts() == before


def test_paged_launcher_on_cpu(capsys):
    stats = launch_serve.main([
        "--device", "cpu", "--page-size", "8", "--shared-prefix", "8",
        "--prefill-chunk", "4", "--requests", "4", "--slots", "3",
        "--tenants", "2", "--prompt-choices", "6", "10",
        "--new-token-choices", "3", "5", "--decode-block", "4"])
    assert stats["n_finished"] == 4 and stats["pages_in_use"] == 0
    out = capsys.readouterr().out
    assert "pages:" in out and "COW copies" in out
    assert launch_serve.shared_prefix_tokens(4, 128) == (1, 14, 27, 40)
    with pytest.raises(SystemExit, match="page-size"):
        launch_serve.main(["--device", "cpu", "--prefill-chunk", "4"])


def test_paged_entry_points_refuse_cpu_fallback(g1):
    """Without --device cpu the paged launcher and engine ask for CUDA and
    raise on a box without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks a CUDA-less box")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--page-size", "16", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedServeEngine(g1["tm"], g1["tparams"], g1["tbank"],
                         PagedServeConfig(n_slots=2, max_seq=32,
                                          page_size=8))
    with pytest.raises(ValueError, match="paged"):
        vit = SplitModel(get_config("vit-base").reduced(
            n_layers=3, d_model=64, d_ff=128), SplitConfig(prompt_len=4))
        vit.init_paged_cache(4, 8, device="cpu")
