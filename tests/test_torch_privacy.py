"""The port's privacy engine against the JAX package's, on the CPU: the
secure-mask op (fixed-point codec, threefry mask streams, masked uploads,
recovery streams) bit for bit, round keys and pair seeds, the masked secure
aggregator (decoded aggregate and wire bytes `==`), DP-SGD clipping and
noising with JAX's own draws injected, the zCDP accountant, and one secure
+ DP SFPrompt round on bridged weights.

Ring tensors are compared as uint32 bit patterns: the port carries the ring
as int32 (`.numpy().view(np.uint32)`)."""
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.core import SFPromptTrainer as JSFPromptTrainer  # noqa: E402
from repro.core import SplitConfig as JSplitConfig  # noqa: E402
from repro.core import SplitModel as JSplitModel  # noqa: E402
from repro.core.aggregation import get_aggregator as jget_aggregator  # noqa: E402
from repro.core.local_update import \
    dp_clip_and_noise as jdp_clip_and_noise  # noqa: E402
from repro.data import (DATASETS, iid_partition,  # noqa: E402
                        select_clients, stack_clients,
                        synthetic_image_dataset)
from repro.kernels.secure_mask import ops as jops  # noqa: E402
from repro.kernels.secure_mask import ref as jref  # noqa: E402
from repro.privacy import dp as jdp  # noqa: E402
from repro.privacy import masking as jmasking  # noqa: E402
from repro.privacy.fixed_point import headroom as jheadroom  # noqa: E402
from repro.runtime import WireSpec as JWireSpec  # noqa: E402
from repro_torch.bridge import jax_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ProtocolConfig, SFPromptTrainer,  # noqa: E402
                              SplitConfig, SplitModel)
from repro_torch.core.aggregation import (fedavg_partial,  # noqa: E402
                                          get_aggregator)
from repro_torch.core.comm import secure_agg_breakdown  # noqa: E402
from repro_torch.core.local_update import dp_clip_and_noise  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.secure_mask import ops, ref  # noqa: E402
from repro_torch.privacy import dp, fixed_point, masking  # noqa: E402
from repro_torch.privacy.secure_agg import SecureAggregator  # noqa: E402
from repro_torch.runtime import WireSpec  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

SEEDS = [0, 1, 12345, 0xDEADBEEF, 0xFFFFFFFF]


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(t_tree, j_tree, **tol):
    jflat = jax.tree_util.tree_flatten_with_path(_np(j_tree))[0]
    tflat = tree_flatten(t_tree)
    assert [tuple(p.key for p in path) for path, _ in jflat] == \
        [path for path, _ in tflat]
    for (path, leaf), (_, tleaf) in zip(jflat, tflat):
        np.testing.assert_allclose(tleaf.detach().numpy(), leaf,
                                   err_msg=jax.tree_util.keystr(path), **tol)


# ------------------------------------------------------------ the codec
def edge_values(n: int) -> np.ndarray:
    """Ties at +-0.5 and +-1.5 units of 2^-16 (round half to even), values
    beyond +-headroom (saturation), -0.0, inf, then seeded normals."""
    u = 2.0 ** -16
    edge = np.array([0.5 * u, -0.5 * u, 1.5 * u, -1.5 * u, 2.5 * u, -2.5 * u,
                     -0.0, 0.0, jheadroom(), -jheadroom(), 1e6, -1e6,
                     np.inf, -np.inf, 32767.99, -32768.0], np.float32)
    rest = np.random.default_rng(n).standard_normal(n - edge.size) * 3
    return np.concatenate([edge, rest.astype(np.float32)])


def test_encode_decode_bit_equal():
    x = edge_values(1024)
    got = ops.encode(torch.from_numpy(x))
    want = np.asarray(jref.encode(jnp.asarray(x)))
    np.testing.assert_array_equal(_u32(got), want)
    # decode of every corner of the ring and random words
    words = np.concatenate([
        np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, 2 ** 32 - 1],
                 np.uint32),
        np.random.default_rng(1).integers(0, 2 ** 32, 4090,
                                          dtype=np.uint32)])
    got = ops.decode(torch.from_numpy(words.view(np.int32)))
    want = np.asarray(jref.decode(jnp.asarray(words)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert (ops.FRAC_BITS, ref.RING_EDGE, ref.SAT) == \
        (jref.FRAC_BITS, jref.RING_EDGE, jref.SAT)


@pytest.mark.parametrize("n", [128, 896, 70016])
def test_mask_streams_and_masked_encode_bit_equal(n):
    for seed in SEEDS:
        np.testing.assert_array_equal(
            ref.mask_stream(seed, n).numpy().astype(np.uint32),
            np.asarray(jref.mask_stream(seed, n)))
    seeds = np.array(SEEDS, np.uint32)
    signs = np.array([1, -1, 0, -1, 1], np.int32)
    x = edge_values(n)
    want_enc = np.asarray(jops.masked_encode(
        jnp.asarray(x), jnp.asarray(seeds), jnp.asarray(signs), impl="ref"))
    want_sum = np.asarray(jops.summed_mask(
        jnp.asarray(seeds), jnp.asarray(signs), n, impl="ref"))
    before = launch_counts()
    got_enc = ops.masked_encode(torch.from_numpy(x),
                                torch.from_numpy(seeds.astype(np.int64)),
                                torch.from_numpy(signs))
    got_sum = ops.summed_mask(seeds.astype(np.int64), signs, n, device="cpu")
    assert launch_counts() == before          # no kernel on CPU tensors
    np.testing.assert_array_equal(_u32(got_enc), want_enc)
    np.testing.assert_array_equal(_u32(got_sum), want_sum)
    # the eager reference too (the jitted op traces the seeds as uint32)
    np.testing.assert_array_equal(_u32(got_enc), np.asarray(
        jref.masked_encode(jnp.asarray(x), jnp.asarray(seeds),
                           jnp.asarray(signs))))
    assert ops.ring_size(n - 5) == jops.ring_size(n - 5) == n


@pytest.mark.parametrize("seed,round_idx", [(0, 0), (7, 3), (123456, 41)])
def test_round_key_and_pair_seeds_equal_jax(seed, round_idx):
    jkey = jmasking.round_key(seed, round_idx)
    key = masking.round_key(seed, round_idx)
    assert key == tuple(int(w) for w in np.asarray(jkey))
    for k in (2, 3, 5):
        np.testing.assert_array_equal(
            masking.pair_seeds(key, k).numpy().astype(np.uint32),
            np.asarray(jmasking.pair_seeds(jkey, k)))
        np.testing.assert_array_equal(masking.pair_signs(k),
                                      jmasking.pair_signs(k))
        for c in range(k):
            for a, b in zip(masking.client_pairs(k, c),
                            jmasking.client_pairs(k, c)):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(masking.recovery_pairs(k), jmasking.recovery_pairs(k)):
            np.testing.assert_array_equal(a, b)
    assert (masking.MASK_SEED, masking.PK_BYTES, masking.SEED_BYTES) == \
        (jmasking.MASK_SEED, jmasking.PK_BYTES, jmasking.SEED_BYTES)


# ------------------------------------------------------- the aggregator
def cohort_tree(k: int, seed: int = 0):
    """A K-stacked (tail, prompt) tree, 125 elements a client (padded to
    128 in the ring), values up to a few units."""
    rng = np.random.default_rng(seed)
    return {"tail": {"w": rng.standard_normal((k, 7, 3)).astype(np.float32),
                     "b": rng.standard_normal((k, 5)).astype(np.float32) * 4,
                     "head": {"w": rng.standard_normal((k, 3, 6))
                              .astype(np.float32)}},
            "prompt": rng.standard_normal((k, 4, 16)).astype(np.float32)}


@pytest.mark.parametrize("weights", [
    [3.0, 2.0, 7.0, 1.0],        # full participation
    [3.0, 0.0, 7.0, 1.0],        # one dropped
    [0.0, 4.0, 0.0, 2.0],        # two dropped
    [0.0, 0.0, 0.0, 0.0],        # all dropped: the fallback
])
def test_secure_aggregate_equals_jax(weights):
    k = len(weights)
    tree = cohort_tree(k)
    fallback = jax.tree.map(lambda x: np.full_like(x[0], 2.5), tree)
    jagg, jwire = jget_aggregator(secure=True, impl="ref", seed=5).aggregate(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(weights, jnp.float32),
        jax.tree.map(jnp.asarray, fallback), jnp.int32(3))
    tfallback = jax_to_torch(fallback, "cpu")
    agg = get_aggregator(secure=True, seed=5)
    assert isinstance(agg, SecureAggregator)
    assert agg.describe() == jget_aggregator(secure=True, seed=5).describe()
    before = launch_counts()
    tagg, twire = agg.aggregate(jax_to_torch(tree, "cpu"),
                                torch.tensor(weights), tfallback, 3)
    assert launch_counts() == before
    _assert_tree_close(tagg, jagg, atol=0, rtol=0)
    assert {k_: float(v) for k_, v in twire.items()} == \
        {k_: float(v) for k_, v in jwire.items()}
    clear = fedavg_partial(jax_to_torch(tree, "cpu"), torch.tensor(weights),
                           tfallback)
    tol = fixed_point.roundtrip_tol(k)
    for (pa, a), (pb, b) in zip(tree_flatten(tagg), tree_flatten(clear)):
        assert pa == pb and float((a - b).abs().max()) <= tol
    n_up = sum(w > 0 for w in weights)
    n_trainable = sum(x[0].size for x in jax.tree.leaves(tree))
    want = secure_agg_breakdown(n_trainable=n_trainable,
                                param_nbytes=4 * n_trainable, K=k,
                                n_uploads=n_up)
    assert float(twire["params_up"]) == want["params"] - 4 * k * n_trainable
    assert float(twire["secure"]) == want["secure"]


def test_fixed_point_helpers_equal_jax():
    from repro.privacy import fixed_point as jfp
    for fb in (8, 16, 20):
        assert fixed_point.resolution(fb) == jfp.resolution(fb)
        assert fixed_point.headroom(fb) == jfp.headroom(fb)
        for k in (1, 3, 8):
            assert fixed_point.roundtrip_tol(k, fb) == jfp.roundtrip_tol(k,
                                                                        fb)
    assert fixed_point.RING_BYTES == jfp.RING_BYTES
    tree = cohort_tree(3, seed=2)
    jflat, _, jshapes, jn = jfp.flatten_tree(jax.tree.map(jnp.asarray, tree))
    flat, paths, shapes, n = fixed_point.flatten_tree(
        jax_to_torch(tree, "cpu"))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert (shapes, n) == ([tuple(s) for s in jshapes], jn)
    like = jax_to_torch(jax.tree.map(lambda x: x[0], tree), "cpu")
    back = fixed_point.unflatten_tree(flat[1], paths, shapes, n, like)
    _assert_tree_close(back, jax.tree.map(lambda x: x[1], tree), atol=0,
                       rtol=0)


# ------------------------------------------------------------------- DP
def test_clip_tree_and_dp_clip_and_noise_match_jax():
    tree = jax.tree.map(lambda x: x[0], cohort_tree(1, seed=3))
    ref_tree = jax.tree.map(lambda x: x[0] * 0.5, cohort_tree(1, seed=4))
    for clip in (0.5, 100.0):      # clipped, and under the clip (no-op)
        jc, jn = jdp.clip_tree(jax.tree.map(jnp.asarray, tree), clip)
        tc, tn = dp.clip_tree(jax_to_torch(tree, "cpu"), clip)
        _assert_tree_close(tc, jc, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    key = jax.random.PRNGKey(11)
    jout, jnorm = jdp_clip_and_noise(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, ref_tree),
        key, l2_clip=1.0, noise_multiplier=0.8)
    leaf_keys = jax.random.split(key, len(jax.tree.leaves(tree)))
    paths = [p for p, _ in tree_flatten(ref_tree)]
    draws = {p: torch.from_numpy(np.array(jax.random.normal(
        leaf_keys[i], np.shape(leaf), jnp.float32)))
        for i, (p, leaf) in enumerate(tree_flatten(ref_tree))}
    assert len(paths) == len(leaf_keys)
    tout, tnorm = dp_clip_and_noise(
        jax_to_torch(tree, "cpu"), jax_to_torch(ref_tree, "cpu"),
        lambda path, shape: draws[path], l2_clip=1.0, noise_multiplier=0.8)
    _assert_tree_close(tout, jout, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    noise = dp.gaussian_noise_tree(g, jax_to_torch(tree, "cpu"), 0.5)
    assert [p for p, _ in tree_flatten(noise)] == paths
    assert dp.DP_SEED == jdp.DP_SEED


def test_accountant_equals_jax_and_checks_mechanism():
    for eps, delta, rounds in [(8.0, 1e-5, 2), (1.0, 1e-6, 50),
                               (3.3, 1e-3, 7)]:
        assert dp.calibrate_noise(eps, delta, rounds) == \
            jdp.calibrate_noise(eps, delta, rounds)
    z = dp.calibrate_noise(8.0, 1e-5, 2)
    a = dp.PrivacyAccountant(noise_multiplier=z, l2_clip=1.0, delta=1e-5)
    b = jdp.PrivacyAccountant(noise_multiplier=z, l2_clip=1.0, delta=1e-5)
    assert a.epsilon() == b.epsilon() == 0.0
    for _ in range(3):
        a.spend()
        b.spend()
        assert (a.rho, a.releases, a.epsilon()) == \
            (b.rho, b.releases, b.epsilon())
    assert a.report() == b.report()
    assert {k: float(v) for k, v in a.state_dict().items()} == \
        {k: float(v) for k, v in b.state_dict().items()}
    assert dp.rho_per_release(z) == jdp.rho_per_release(z)
    assert dp.epsilon_from_rho(0.3, 1e-5) == jdp.epsilon_from_rho(0.3, 1e-5)
    c = dp.PrivacyAccountant(noise_multiplier=z, l2_clip=1.0, delta=1e-5)
    c.load_state_dict(b.state_dict())
    assert (c.rho, c.releases) == (b.rho, b.releases)
    other = dp.PrivacyAccountant(noise_multiplier=z * 2, l2_clip=1.0)
    with pytest.raises(ValueError, match="mismatch"):
        other.load_state_dict(a.state_dict())
    with pytest.raises(ValueError):
        dp.PrivacyAccountant(noise_multiplier=0.0, l2_clip=1.0)
    with pytest.raises(ValueError, match="dp_clip"):
        SFPromptTrainer(SplitModel(_cfg(get_config), SplitConfig(**SPLIT)),
                        ProtocolConfig(dp_noise_multiplier=1.0),
                        device="cpu")


# ------------------------------------------- one secure + DP round
K, N_LOCAL, BATCH = 3, 24, 8
SPLIT = dict(head_cycles=1, tail_cycles=1, prompt_len=4, prune_gamma=0.5,
             local_epochs=1)
DP_Z, DP_CLIP = 0.8, 1.0
PCFG = dict(clients_per_round=K, local_epochs=1, batch_size=BATCH,
            lr_local=0.05, lr_split=0.05, dp_clip=DP_CLIP,
            dp_noise_multiplier=DP_Z, dp_delta=1e-5)
PART = {"transmit": np.array([1.0, 0.5, 1.0], np.float32),
        "aggregate": np.array([1.0, 0.0, 1.0], np.float32)}
# The int8 wire is exact only while the packages' fp32 differences
# upstream of a boundary push no element across a quantizer rounding
# boundary (ROADMAP Queue 3); this draw flips none.
ROUND_SEED = 0


def _cfg(get):
    return get("vit-base").reduced(n_layers=3, d_model=64, d_ff=128)


def jax_wire_noise(round_idx, k):
    """The uniforms the JAX round draws: fold_in(PRNGKey(23), round) ->
    split(K) -> fold_in(step) -> split into (k_hb, k_bt) -> each split into
    (kf, kb) -> uniform."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(23),
                                               round_idx), k)

    def noise(client, step, name, shape):
        k_hb, k_bt = jax.random.split(jax.random.fold_in(keys[client], step))
        kf, kb = jax.random.split(k_hb if name == "head_body" else k_bt)
        return tuple(torch.from_numpy(np.array(
            jax.random.uniform(key, shape, jnp.float32))) for key in (kf, kb))
    return noise


def jax_dp_noise(round_idx, k, reference):
    """The unit normals of the JAX round's DP noise: fold_in(PRNGKey(97),
    round) -> split(K) -> split(n_leaves) in `jax.tree` order -> normal."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(97),
                                               round_idx), k)
    index = {p: i for i, (p, _) in enumerate(tree_flatten(reference))}

    def noise(client, path, shape):
        leaf_keys = jax.random.split(keys[client], len(index))
        return torch.from_numpy(np.array(jax.random.normal(
            leaf_keys[index[path]], shape, jnp.float32)))
    return noise


@pytest.fixture(scope="module")
def cohort():
    d = synthetic_image_dataset(DATASETS["cifar10-syn"], 8 * N_LOCAL, seed=0,
                                image_hw=32)
    clients = iid_partition(d, 8, seed=0)
    return stack_clients(clients, select_clients(8, K, seed=0, round_idx=0))


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_secure_dp_round_matches_jax(cohort, wire):
    jm = JSplitModel(_cfg(jget_config), JSplitConfig(**SPLIT),
                     JWireSpec.make(wire))
    tm = SplitModel(_cfg(get_config), SplitConfig(**SPLIT),
                    WireSpec.make(wire))
    jtr = JSFPromptTrainer(jm, JProtocolConfig(**PCFG),
                           jget_aggregator(secure=True, impl="ref", seed=3))
    jstate = jtr.init(jax.random.PRNGKey(ROUND_SEED))
    jnew, jmetrics = jtr.round(
        jstate, {k: jnp.asarray(v) for k, v in cohort.items()},
        {k: jnp.asarray(v) for k, v in PART.items()})
    ttr = SFPromptTrainer(tm, ProtocolConfig(**PCFG),
                          get_aggregator(secure=True, seed=3), device="cpu")
    params = jax_to_torch(jstate["params"], "cpu")
    reference = {"tail": params["tail"], "prompt": params["prompt"]}
    before = launch_counts()
    tnew, tmetrics = ttr.round(
        {"params": params, "round": 0}, cohort, PART,
        wire_noise=jax_wire_noise(0, K),
        dp_noise=jax_dp_noise(0, K, reference))
    assert launch_counts() == before
    assert set(tmetrics) == set(jmetrics)
    for key in tmetrics:
        if key.startswith(("wire/", "cohort/", "dp/epsilon")) \
                or key == "kept_frac":
            assert tmetrics[key] == jmetrics[key], key
    assert tmetrics["wire/secure_bytes"] == K * K * 32 + 2 * 1 * 4
    np.testing.assert_allclose(tmetrics["dp/delta_norm"],
                               jmetrics["dp/delta_norm"], rtol=1e-4)
    tol = fixed_point.roundtrip_tol(K) + 1e-5
    _assert_tree_close(tnew["params"], jnew["params"], atol=tol, rtol=0)
    assert ttr.accountant.epsilon() == jtr.accountant.epsilon()
    assert tnew["round"] == 1
