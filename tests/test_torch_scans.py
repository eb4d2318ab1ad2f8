"""The port's plain Mamba-2 and RWKV-6 scans and the two recurrent blocks
against the JAX package on the same numpy inputs: the scans against JAX's
`impl="ref"` (the same sequential recurrence) and `impl="interpret"` (the
Pallas kernel on the CPU, chunked), streaming, strong decays, and
`apply_mamba2` / `apply_rwkv6` on bridged weights with and without a
cache."""
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels.mamba2_scan import mamba2_scan as jmamba2  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as jrwkv6  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mamba2_scan import ref as mamba2_ref  # noqa: E402
from repro_torch.kernels.mamba2_scan.ops import mamba2_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as rwkv6_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# the Pallas kernel runs the chunked SSD / chunked stepping in another sum
# order: the JAX package's own tests hold it to these (tests/test_kernels.py)
INTERPRET_Y = dict(atol=2e-3, rtol=2e-3)
INTERPRET_STATE = dict(atol=1e-3, rtol=1e-3)


def mamba2_inputs(seed, B, T, H, P, G, N, h0=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(B, T, H))).astype(np.float32)       # softplus
    A = -np.exp(f(H)).astype(np.float32)
    return (f(B, T, H, P), dt, A, f(B, T, G, N), f(B, T, G, N),
            f(B, H, P, N) if h0 else None)


def rwkv6_inputs(seed, B, T, H, K, V, s0=True, decay=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w = (np.full((B, T, H, K), decay, np.float32) if decay is not None
         else -np.exp(f(B, T, H, K)).astype(np.float32))
    return (f(B, T, H, K), f(B, T, H, K), f(B, T, H, V), w, f(H, K),
            f(B, H, K, V) if s0 else None)


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


# ------------------------------------------------------------------ scans
@pytest.mark.parametrize("T,G,chunk", [(64, 1, 16), (100, 2, 32),
                                       (128, 4, 64)])
def test_mamba2_plain_matches_jax(T, G, chunk):
    """The JAX tests' shapes (B 2, H 4, P 16, N 8, with h0): within 1e-5 of
    `impl="ref"`, and within the JAX tests' own tolerances of the Pallas
    kernel run in interpret mode."""
    args = mamba2_inputs(T + G, 2, T, 4, 16, G, 8)
    y, h = mamba2_scan(*_torch(args))
    jy, jh = jmamba2(*_jax(args), impl="ref")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    py, ph = jmamba2(*_jax(args), impl="interpret", chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **INTERPRET_Y)
    np.testing.assert_allclose(h.numpy(), np.asarray(ph), **INTERPRET_STATE)


@pytest.mark.parametrize("aliased", [True, False])
def test_mamba2_state_out_matches_jax(aliased):
    """`state_out=` receives the final state (the input state itself when
    aliased, as `apply_mamba2` passes its cache), y and the state within
    1e-5 of JAX's `impl="ref"`, and the op returns that tensor."""
    args = mamba2_inputs(21, 2, 37, 4, 16, 2, 8)
    x, dt, A, Bm, Cm, h0 = _torch(args)
    state = h0.clone()
    out = state if aliased else torch.full_like(state, float("nan"))
    y, h = mamba2_scan(x, dt, A, Bm, Cm, state, state_out=out)
    assert h is out
    jy, jh = jmamba2(*_jax(args), impl="ref")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jh), **TOL)
    if not aliased:
        assert torch.equal(state, h0)


@pytest.mark.parametrize("T,G,chunk", [(37, 1, 16), (100, 2, 32),
                                       (65, 4, 64)])
def test_mamba2_chunked_plain_matches_jax_and_sequential(T, G, chunk):
    """The ported chunked form (the chunked kernel's algorithm) at T not a
    multiple of the chunk: within 1e-5 of the sequential plain version,
    and of JAX's `mamba2_chunked` within the rounding both chunked forms
    carry, capped at the scans' card gate (2e-5 (1 + |JAX|)). Each takes
    L's exponent as acum_t - acum_s, the difference of two f32 cumsums
    that reach chunk * max|dt A| within a chunk, so its absolute error,
    L's relative one, is up to 2^-23 of that in either package (XLA and
    PyTorch sum in other orders); the sequential form has no such
    difference."""
    from repro.kernels.mamba2_scan.ref import mamba2_chunked as jchunked
    args = mamba2_inputs(T + 7 * G, 2, T, 4, 16, G, 8)
    y, h = mamba2_ref.mamba2_chunked(*_torch(args), chunk=chunk)
    jy, jh = jchunked(*_jax(args), chunk=chunk)
    rounding = 2.0 ** -23 * chunk * float(np.abs(args[1] * args[2]).max())
    c = max(TOL["atol"], min(rounding, 2e-5))
    tol = dict(atol=c, rtol=c)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **tol)
    sy, sh = mamba2_ref.mamba2_scan(*_torch(args))
    np.testing.assert_allclose(y.numpy(), sy.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), sh.numpy(), **TOL)


@pytest.mark.parametrize("T,chunk", [(64, 16), (100, 32), (128, 128)])
def test_rwkv6_plain_matches_jax(T, chunk):
    """The JAX tests' shapes (B 2, H 2, K = V = 16, with s0)."""
    args = rwkv6_inputs(T, 2, T, 2, 16, 16)
    y, S = rwkv6_scan(*_torch(args))
    jy, jS = jrwkv6(*_jax(args), impl="ref")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **TOL)
    py, pS = jrwkv6(*_jax(args), impl="interpret", chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **INTERPRET_Y)
    np.testing.assert_allclose(S.numpy(), np.asarray(pS), **INTERPRET_STATE)


@pytest.mark.parametrize("aliased", [True, False])
def test_rwkv6_state_out_matches_jax(aliased):
    """`state_out=` receives the final state (the input state itself when
    aliased, as `apply_rwkv6` passes its cache), y and the state within
    1e-5 of JAX's `impl="ref"`, and the op returns that tensor."""
    args = rwkv6_inputs(22, 2, 37, 3, 16, 16)
    r, k, v, w, u, s0 = _torch(args)
    state = s0.clone()
    out = state if aliased else torch.full_like(state, float("nan"))
    y, S = rwkv6_scan(r, k, v, w, u, state, state_out=out)
    assert S is out
    jy, jS = jrwkv6(*_jax(args), impl="ref")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jS), **TOL)
    if not aliased:
        assert torch.equal(state, s0)


@pytest.mark.parametrize("T,chunk,decay", [
    (37, 32, None), (100, 32, None), (132, 32, None),
    (37, 64, None), (100, 64, None), (132, 64, None),
    (37, 32, -12.0), (132, 32, -12.0), (100, 64, -12.0)])
def test_rwkv6_subchunked_plain_matches_jax_and_sequential(T, chunk, decay):
    """The chunked kernel's decomposition in plain PyTorch (sub-chunks of
    16, every exponent a sum of w's of one sign) at the JAX tests' shapes
    (B 2, H 2, K = V = 16, with s0), T not a multiple of the chunk: within
    1e-5 of JAX's sequential `impl="ref"` and of the port's sequential
    version, finite at w = -12. Against JAX's chunked GLA form
    (`rwkv6_chunked`) it is held to that form's own distance from JAX's
    sequential ref, plus 1e-5: `rwkv6_chunked` takes its intra-chunk
    exponent as cwe_t - cw_s, a difference of f32 cumsums that reach
    chunk * max|w| (~100 at these decays), whose rounding puts it up to
    1.3e-4 from the sequential result, past the card's 2e-5 gate, while
    the sub-chunked form stays within 1e-5 of it."""
    from repro.kernels.rwkv6_scan.ref import rwkv6_chunked as jchunked
    args = rwkv6_inputs(T + chunk + int(decay or 0), 2, T, 2, 16, 16,
                        decay=decay)
    y, S = rwkv6_ref.rwkv6_subchunked(*_torch(args), chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    jy, jS = jrwkv6(*_jax(args), impl="ref")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **TOL)
    sy, sS = rwkv6_ref.rwkv6_scan(*_torch(args))
    np.testing.assert_allclose(y.numpy(), sy.numpy(), **TOL)
    np.testing.assert_allclose(S.numpy(), sS.numpy(), **TOL)
    cy, cS = jchunked(*_jax(args), chunk=chunk)
    for got, chk, ref in ((y, cy, jy), (S, cS, jS)):
        chk, ref = np.asarray(chk), np.asarray(ref)
        own = np.abs(chk - ref)
        assert (np.abs(got.numpy() - chk)
                <= own + TOL["atol"] * (1 + np.abs(chk))).all()


@pytest.mark.parametrize("scan", ["mamba2", "rwkv6"])
def test_streaming_in_two_halves_equals_one_pass(scan):
    if scan == "mamba2":
        x, dt, A, Bm, Cm, _ = _torch(mamba2_inputs(5, 1, 64, 2, 8, 1, 8,
                                                   h0=False))
        y, h = mamba2_scan(x, dt, A, Bm, Cm)
        y1, h1 = mamba2_scan(x[:, :32], dt[:, :32], A, Bm[:, :32],
                             Cm[:, :32])
        y2, h2 = mamba2_scan(x[:, 32:], dt[:, 32:], A, Bm[:, 32:],
                             Cm[:, 32:], h1)
    else:
        r, k, v, w, u, _ = _torch(rwkv6_inputs(5, 1, 64, 2, 8, 8, s0=False))
        y, h = rwkv6_scan(r, k, v, w, u)
        y1, h1 = rwkv6_scan(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u)
        y2, h2 = rwkv6_scan(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], u,
                            h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               **TOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), **TOL)


def test_rwkv6_strong_decay_stays_finite():
    """w = -12 a step (decay ~ e^-12): the sequential form has no
    exp(-cumsum) factor to overflow."""
    args = rwkv6_inputs(9, 1, 96, 1, 8, 8, s0=False, decay=-12.0)
    y, S = rwkv6_scan(*_torch(args))
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    jy, jS = jrwkv6(*_jax(args), impl="ref")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **TOL)


def test_ops_on_cpu_are_the_plain_versions():
    margs = _torch(mamba2_inputs(3, 1, 7, 2, 4, 1, 4))
    rargs = _torch(rwkv6_inputs(3, 1, 7, 2, 4, 4))
    for got, want in ((mamba2_scan(*margs), mamba2_ref.mamba2_scan(*margs)),
                      (rwkv6_scan(*rargs), rwkv6_ref.rwkv6_scan(*rargs))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("s0", [True, False])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("T", [1, 63, 64, 130])
def test_rwkv6_chunked_matches_jax_and_sequential(T, chunk, s0):
    """The port of JAX's chunked GLA form (`rwkv6_chunked`, chunk capped at
    T as the JAX op caps it) at the JAX tests' shapes (B 2, H 2, K = V =
    16), with and without a state: against JAX's `rwkv6_chunked` and the
    port's sequential plain version within 1e-5, or, where larger, the
    rounding both chunked forms carry: the intra-chunk exponent cwe_t -
    cw_s is a difference of f32 cumsums reaching chunk * max|w|, off by
    up to 2^-23 of that in either package (JAX's own chunked form is
    6.9e-5 from its sequential ref at chunk 64 here; the sequential form
    has no such difference)."""
    from repro.kernels.rwkv6_scan.ref import rwkv6_chunked as jchunked
    args = rwkv6_inputs(T + chunk + s0, 2, T, 2, 16, 16, s0=s0)
    c = min(chunk, T)
    y, S = rwkv6_ref.rwkv6_chunked(*_torch(args), chunk=c)
    jy, jS = jchunked(*_jax(args), chunk=c)
    rounding = 2.0 ** -23 * c * float(np.abs(args[3]).max())
    tol = dict(atol=max(TOL["atol"], rounding),
               rtol=max(TOL["rtol"], rounding))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **tol)
    sy, sS = rwkv6_ref.rwkv6_scan(*_torch(args))
    np.testing.assert_allclose(y.numpy(), sy.numpy(), **tol)
    np.testing.assert_allclose(S.numpy(), sS.numpy(), **tol)


def test_meta_and_chunked_take_the_chunked_forms(monkeypatch):
    """A `meta` tensor takes each scan's chunked form (shapes and dtypes as
    the plain version's, nothing computed), in the op and in the
    differentiable `plain_scan`; `chunked=True` takes it on the CPU; any
    other device raises."""
    from repro_torch import kernels
    from repro_torch.kernels.mamba2_scan import ops as mops
    from repro_torch.kernels.rwkv6_scan import ops as rops
    calls = []
    for mod, name in ((mamba2_ref, "mamba2_chunked"),
                      (rwkv6_ref, "rwkv6_chunked")):
        plain = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _p=plain, _n=name, **k: (
            calls.append(_n), _p(*a, **k))[1])
    margs = _torch(mamba2_inputs(5, 2, 9, 2, 4, 1, 4))
    rargs = _torch(rwkv6_inputs(5, 2, 9, 2, 4, 4))
    meta = lambda args: [a.to("meta") for a in args]  # noqa: E731
    before = kernels.accounted_ops
    for op, plain_scan, args, want in (
            (mamba2_scan, mops.plain_scan, margs, mamba2_ref.mamba2_scan),
            (rwkv6_scan, rops.plain_scan, rargs, rwkv6_ref.rwkv6_scan)):
        ref_y, ref_s = want(*args)
        for fn in (op, plain_scan):
            y, st = fn(*meta(args))
            assert y.is_meta and st.is_meta
            assert (y.shape, y.dtype, st.shape, st.dtype) == (
                ref_y.shape, ref_y.dtype, ref_s.shape, ref_s.dtype)
        y, st = op(*args, chunked=True)
        np.testing.assert_allclose(y.numpy(), ref_y.numpy(), **TOL)
        np.testing.assert_allclose(st.numpy(), ref_s.numpy(), **TOL)
    assert calls == ["mamba2_chunked"] * 3 + ["rwkv6_chunked"] * 3
    assert kernels.accounted_ops == before + 2
    other = type("T", (), {"is_cuda": False,
                           "device": torch.device("xpu")})()
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kernels.route(other)


# ------------------------------------------------------------------ blocks
def _block_cfgs(arch):
    kw = dict(n_layers=6 if arch == "zamba2-2.7b" else 1, d_model=64,
              d_ff=128, vocab_size=128)
    return jget_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


BLOCKS = {
    "mamba2": ("zamba2-2.7b", JL.init_mamba2, JL.apply_mamba2,
               JL.init_mamba2_cache, L.apply_mamba2, L.init_mamba2_cache),
    "rwkv6": ("rwkv6-3b", JL.init_rwkv6, JL.apply_rwkv6, JL.init_rwkv6_cache,
              L.apply_rwkv6, L.init_rwkv6_cache),
}


def _ctxs(mode, B, S, start=0):
    pos = np.broadcast_to(np.arange(start, start + S, dtype=np.int32),
                          (B, S)).copy()
    return (JL.Ctx(mode=mode, positions=jnp.asarray(pos), impl="ref"),
            L.Ctx(mode=mode, positions=torch.from_numpy(pos)))


@pytest.mark.parametrize("block", ["mamba2", "rwkv6"])
def test_block_with_cache_matches_jax(block):
    """Prefill of 9 tokens, then 4 decode steps: the block's output and
    every cache leaf within 1e-5 of JAX's; the port writes its cache in
    place, JAX returns a new one."""
    arch, jinit, japply, jcache_init, tapply, tcache_init = BLOCKS[block]
    jcfg, tcfg = _block_cfgs(arch)
    p = jinit(jax.random.PRNGKey(1), jcfg)
    tp = jax_to_torch(p, "cpu")
    rng = np.random.default_rng(4)
    B, S = 2, 9
    jcache = jcache_init(jcfg, B)
    tcache = tcache_init(tcfg, B, device="cpu")
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    jctx, tctx = _ctxs("prefill", B, S)
    for step in range(5):
        jy, jcache = japply(p, jcfg, jnp.asarray(x), jctx, jcache)
        ty, same = tapply(tp, tcfg, torch.from_numpy(x), tctx, tcache)
        assert same is tcache
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        assert set(tcache) == set(jcache)
        for name, leaf in jcache.items():
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(leaf), **TOL)
        x = rng.standard_normal((B, 1, 64)).astype(np.float32)
        jctx, tctx = _ctxs("decode", B, 1, S + step)


@pytest.mark.parametrize("block", ["mamba2", "rwkv6"])
def test_block_without_cache_matches_jax(block):
    """A full-sequence (train-mode) pass with no cache, and the same pass
    marked differentiable (the plain scan, gradients flowing)."""
    arch, jinit, japply, _, tapply, _ = BLOCKS[block]
    jcfg, tcfg = _block_cfgs(arch)
    p = jinit(jax.random.PRNGKey(2), jcfg)
    tp = jax_to_torch(p, "cpu")
    x = np.random.default_rng(6).standard_normal((3, 11, 64)).astype(
        np.float32)
    jctx, tctx = _ctxs("train", 3, 11)
    jy, jc = japply(p, jcfg, jnp.asarray(x), jctx, None)
    ty, tc = tapply(tp, tcfg, torch.from_numpy(x), tctx, None)
    assert jc is None and tc is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    tctx.differentiable = True
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, _ = tapply(tp, tcfg, xt, tctx, None)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    ty.sum().backward()
    assert torch.isfinite(xt.grad).all() and xt.grad.abs().sum() > 0


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-3b"])
def test_chunked_impl_steps_match_jax(arch, monkeypatch):
    """`launch/steps.py` at `impl="chunked"` (f32 activations in both
    packages) on bridged weights of the reduced family: the prefill
    step's last logits and a K-2 train step's params and loss within 1e-5
    of JAX's. JAX's rwkv6 runs `impl="chunked"`; its zamba2 runs
    `"analysis"`, the same chunked scans, because at `"chunked"` its
    shared attention block reaches a Pallas kernel, which runs only
    interpreted on the CPU."""
    import repro.launch.steps as jsteps
    import repro_torch.launch.steps as tsteps
    from repro.core import SplitConfig as JSplitConfig
    from repro.core import SplitModel as JSplitModel
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.tree import tree_flatten
    monkeypatch.setattr(jsteps, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(tsteps, "ACT_DTYPE", torch.float32)
    kw = dict(n_layers=18 if arch == "zamba2-2.7b" else 3, d_model=64,
              d_ff=128, vocab_size=128)
    split = dict(head_cycles=1, tail_cycles=1, prompt_len=4)
    jm = JSplitModel(jget_config(arch).reduced(**kw), JSplitConfig(**split))
    tm = SplitModel(get_config(arch).reduced(**kw), SplitConfig(**split))
    jimpl = "analysis" if arch == "zamba2-2.7b" else "chunked"
    params = jm.init(jax.random.PRNGKey(0))
    tparams = jax_to_torch(params, "cpu")
    toks = np.random.default_rng(7).integers(0, 128, (2, 4, 20)).astype(
        np.int32)

    jlg, _ = jax.jit(jsteps.make_prefill_step(
        jm, impl=jimpl, dtype=jnp.float32))(
        params, {"tokens": jnp.asarray(toks[0])}, jm.init_cache(4, 32))
    tlg, _ = tsteps.make_prefill_step(tm, impl="chunked",
                                      dtype=torch.float32)(
        tparams, {"tokens": torch.from_numpy(toks[0])},
        tm.init_cache(4, 32, device="cpu"))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)

    def split_k(p, k):
        return ({"head": p["head"], "body": p["body"]},
                {"tail": p["tail"], "prompt": p["prompt"]})
    jf, jt = split_k(params, 2)
    jtk = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (2,) + x.shape),
                       jt)
    jstep, jopt = jsteps.make_train_step(jm, n_clients=2, impl=jimpl)
    jtr, _, jloss = jax.jit(jstep)(jf, jtk, jax.vmap(jopt.init)(jtk),
                                   {"tokens": jnp.asarray(toks)})
    tstep, topt = tsteps.make_train_step(tm, n_clients=2, impl="chunked")
    tf, _ = split_k(tparams, 2)
    ttk = jax_to_torch(jtk, "cpu")
    ttr, _, tloss = tstep(tf, ttk, tsteps.init_opt_states(topt, ttk),
                          {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    want = dict(tree_flatten(jax.tree.map(np.asarray, jtr)))
    for path, leaf in tree_flatten(ttr):
        np.testing.assert_allclose(leaf.detach().numpy(), want[path],
                                   err_msg="/".join(path), **TOL)
