"""The port's partition rules (`repro_torch.sharding.rules`) against the JAX
package's (`repro.sharding.rules`), and the host mesh's refusals.

Both builders read only `mesh.shape`, so they run here on shape-only stub
meshes: {data: 8}, {data: 2, model: 4} and {pod: 2, data: 2, model: 2}.
For every `configs.ASSIGNED` architecture and vit-base, reduced, every
param leaf's spec must equal JAX's `PartitionSpec` entry for entry, with
and without the client axis, with and without FSDP (at a low threshold,
so FSDP fires at these sizes), and the recorded divisibility fallbacks
must be the same, in the same order; likewise `cohort_pspecs`,
`batch_pspec` and `cache_pspecs` (dense, and paged where the family
pages)."""
import warnings

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from repro.configs import ASSIGNED
from repro.configs import get_config as jget_config
from repro.core import SplitConfig as JSplitConfig
from repro.core import SplitModel as JSplitModel
from repro.sharding import rules as jrules
from repro_torch.launch.mesh import (check_host_mesh, data_parallel_size,
                                     make_host_mesh,
                                     report_sharding_fallbacks)
from repro_torch.obs.trace import Tracer
from repro_torch.sharding import parallel, rules

ARCHS = sorted(ASSIGNED) + ["vit-base"]
MESHES = {"data8": {"data": 8}, "data2_model4": {"data": 2, "model": 4},
          "pod2_data2_model2": {"pod": 2, "data": 2, "model": 2},
          "data2_model2": {"data": 2, "model": 2}, "data4": {"data": 4}}
FSDP_THRESHOLD = 64


def stub(shape):
    return type("Mesh", (), {"shape": dict(shape)})()


_SHAPES = {}


def jax_shapes(arch):
    """(params, dense cache, paged pool or None) shape trees of the
    reduced `arch` split as the JAX tests split it."""
    if arch not in _SHAPES:
        base = jget_config(arch)
        cfg = base.reduced(n_layers=3 * len(base.layer_pattern))
        model = JSplitModel(cfg, JSplitConfig(head_cycles=1, tail_cycles=1,
                                              prompt_len=4))
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        cache = jax.eval_shape(lambda: model.init_cache(4, 16))
        pool = (None if model.paged_cache_unsupported() else
                jax.eval_shape(lambda: model.init_paged_cache(10, 8)))
        _SHAPES[arch] = (params, cache, pool)
    return _SHAPES[arch]


def _is_spec(x):
    return isinstance(x, PartitionSpec)


def assert_specs_equal(port, want, label):
    flat = jax.tree_util.tree_flatten_with_path(want, is_leaf=_is_spec)[0]
    assert flat, label
    n = 0
    for path, spec in flat:
        node = port
        for p in path:
            node = node[p.key]
        assert isinstance(node, rules.P), (label, path)
        assert tuple(node) == tuple(spec), (label,
                                            jax.tree_util.keystr(path),
                                            node, spec)
        n += 1
    assert n == len(jax.tree.leaves(port)), label


def both(fn_name, *args, **kw):
    """(port specs, JAX specs, port fallbacks, JAX fallbacks) of one
    builder on the same arguments, each log drained before and after."""
    jrules.pop_sharding_fallbacks()
    rules.pop_sharding_fallbacks()
    want = getattr(jrules, fn_name)(*args, **kw)
    got = getattr(rules, fn_name)(*args, **kw)
    return got, want, rules.pop_sharding_fallbacks(), \
        jrules.pop_sharding_fallbacks()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_pspecs_match_jax(arch, mesh):
    params, _, _ = jax_shapes(arch)
    m = stub(MESHES[mesh])
    stacked = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((8,) + x.shape, x.dtype), params)
    for client_axis in (False, True):
        for fsdp in (False, True):
            tree = stacked if client_axis else params
            got, want, fb, jfb = both(
                "params_pspecs", tree, m, client_axis=client_axis,
                fsdp=fsdp, fsdp_threshold=FSDP_THRESHOLD)
            label = (arch, mesh, client_axis, fsdp)
            assert_specs_equal(got, want, label)
            assert fb == jfb, label
    if "model" in MESHES[mesh]:
        # the reduced widths divide 'model' 4 where the rules shard
        got, _, _, _ = both("params_pspecs", params, m)
        assert any("model" in s for s in jax.tree.leaves(got)), arch


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cohort_batch_and_cache_pspecs_match_jax(arch, mesh):
    params, cache, pool = jax_shapes(arch)
    m = stub(MESHES[mesh])
    for k in (8, 7):           # 7 divides no client plane: replicated
        cohort = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct((k,) + x.shape, x.dtype),
            {"tail": params["tail"], "prompt": params["prompt"]})
        for name in ("cohort_pspecs", "batch_pspec"):
            got, want, fb, jfb = both(name, cohort, m)
            assert_specs_equal(got, want, (arch, mesh, name, k))
            assert fb == jfb == ()
    got, want, fb, jfb = both("cache_pspecs", cache, m)
    assert_specs_equal(got, want, (arch, mesh, "cache"))
    assert fb == jfb
    if pool is not None:
        got, want, fb, jfb = both("cache_pspecs", pool, m, paged=True)
        assert_specs_equal(got, want, (arch, mesh, "pool"))
        assert fb == jfb
        # the page axis stays replicated whatever the client plane
        for spec in jax.tree.leaves(got):
            assert spec[1] is None


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "zamba2-2.7b",
                                  "rwkv6-3b"])
def test_cache_slots_over_data_and_their_fallback_as_jax(arch):
    """The serving engines' cache rules on the meshes that serve slots
    over 'data': 4 slots on (data 2, model 2) and (data 4) put every
    leaf's slot axis over 'data', nothing recorded; 3 slots on (data 2)
    replicate it, every leaf of more than one slot recorded, as JAX's
    `cache_pspecs` records them."""
    base = jget_config(arch)
    model = JSplitModel(base.reduced(n_layers=3 * len(base.layer_pattern)),
                        JSplitConfig(head_cycles=1, tail_cycles=1,
                                     prompt_len=4))
    for slots, mesh, shards in ((4, {"data": 2, "model": 2}, True),
                                (4, {"data": 4}, True),
                                (3, {"data": 2}, False)):
        cache = jax.eval_shape(lambda: model.init_cache(slots, 16))
        got, want, fb, jfb = both("cache_pspecs", cache, stub(mesh))
        assert_specs_equal(got, want, (arch, slots, mesh))
        assert fb == jfb
        slot_axes = {spec[1] for spec in jax.tree.leaves(got)
                     if len(spec) >= 2}
        if shards:
            assert slot_axes == {"data"} and fb == ()
        else:
            assert slot_axes == {None}
            assert fb and all(axis == "data" and shape[1] == 3
                              for _, axis, shape in fb)


def test_guard_divisibility_and_unit_dims_as_jax():
    m = stub({"data": 2, "model": 4})
    cases = [((None, "model"), (32, 48)), ((None, "model"), (32, 10)),
             ((("pod", "data"), None), (6, 3)), (("data", None), (1, 5)),
             (("model", "data"), (0, 4))]
    for spec, shape in cases:
        jrules.pop_sharding_fallbacks()
        rules.pop_sharding_fallbacks()
        want = jrules.guard_divisibility(spec, shape, m, path="x/w")
        got = rules.guard_divisibility(spec, shape, m, path="x/w")
        assert tuple(got) == tuple(want), (spec, shape)
        assert rules.pop_sharding_fallbacks() == \
            jrules.pop_sharding_fallbacks()
    assert rules.format_sharding_fallbacks([("a/w", "model", (3, 5))]) == \
        jrules.format_sharding_fallbacks([("a/w", "model", (3, 5))])


def test_fallback_warned_once_with_one_tracer_event():
    """As tests/test_obs.py holds the JAX package: one warning and one
    `sharding.fallback` event a drain; a second report says nothing."""
    m = stub({"data": 2, "model": 4})
    params = {"tail": {"head": {"w": np.zeros((32, 10), np.float32)}},
              "body": {"q": {"w": np.zeros((32, 48), np.float32)}}}
    rules.pop_sharding_fallbacks()
    specs = rules.params_pspecs(params, m)
    assert specs["body"]["q"]["w"] == rules.P(None, "model")
    assert specs["tail"]["head"]["w"] == rules.P(None, None)
    tracer = Tracer("round")
    with pytest.warns(UserWarning, match=r"(?s)\[unit\].*head/w"):
        entries = report_sharding_fallbacks("unit", tracer)
    assert entries == (("tail/head/w", "model", (32, 10)),)
    events = [r for r in tracer.records()
              if r["name"] == "sharding.fallback"]
    assert len(events) == 1
    assert events[0]["attrs"] == {"context": "unit", "n": 1,
                                  "entries": [["tail/head/w", "model",
                                               [32, 10]]]}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert rules.report_fallbacks("unit", tracer) == ()
    assert len([r for r in tracer.records()
                if r["name"] == "sharding.fallback"]) == 1


def test_mesh_absent_axes_drop_unrecorded():
    rules.pop_sharding_fallbacks()
    specs = rules.params_pspecs({"q": {"w": np.zeros((32, 48))}},
                                stub({"data": 2}))
    assert specs["q"]["w"] == rules.P(None, None)
    rules.cache_pspecs({"k": np.zeros((3, 1, 8, 4, 8))},
                       stub({"data": 2, "model": 4}))
    assert rules.pop_sharding_fallbacks() == ()


def test_placements_one_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = type("Mesh", (), {"mesh_dim_names": ("data", "model"),
                             "shape": (2, 4)})()
    assert rules.axis_sizes(mesh) == {"data": 2, "model": 4}
    assert rules.placements(rules.P(None, "model"), mesh) == (
        Replicate(), Shard(1))
    assert rules.placements(rules.P("data", None, "model"), mesh) == (
        Shard(0), Shard(2))
    assert rules.placements(rules.P(), mesh) == (Replicate(), Replicate())


def test_local_shard_blocks_in_coordinate_order():
    """`local_shard` cuts the block the JAX layout puts on a device:
    row-major over a tuple of axes, major first."""
    import torch

    class Coord:
        def __init__(self, **coords):
            self.coords = coords
            self.shape = {"pod": 2, "data": 2, "model": 2}

        def get_local_rank(self, name):
            return self.coords[name]

    full = torch.arange(8 * 6).reshape(8, 6)
    spec = rules.P(("pod", "data"), "model")
    seen = []
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                mesh = Coord(pod=pod, data=data, model=model)
                block = parallel.local_shard(full, spec, mesh)
                assert tuple(block.shape) == (2, 3)
                i = pod * 2 + data
                assert torch.equal(block, full[2 * i:2 * i + 2,
                                               3 * model:3 * model + 3])
                seen.append(block)
    assert torch.equal(torch.cat([torch.cat(seen[i:i + 2], 1)
                                  for i in range(0, 8, 2)]), full)


def test_make_host_mesh_refusals_as_jax():
    with pytest.raises(ValueError, match="device"):
        make_host_mesh(2)                # one process, no ranks started
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(model=3)
    with pytest.raises(ValueError, match="does not divide"):
        check_host_mesh(6, 8, 4)
    check_host_mesh(8, 8, 4)
    with pytest.raises(RuntimeError, match="spawn_ranks"):
        make_host_mesh(1)
    assert data_parallel_size(stub({"pod": 2, "data": 4, "model": 2})) == 8


def test_part2_families_refuse_a_model_axis():
    """Slice H part 2 is ported: no family refuses a 'model' axis any
    more, and at 'model' 2 the rules record no divisibility fallback for
    the six it brought at their reduced widths; at their published widths
    (shapes only) none in a block: whisper-base's odd vocabulary (51865)
    alone replicates its token table and LM head."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import SplitConfig, SplitModel
    from repro_torch.tree import tree_leaves
    assert not hasattr(parallel, "refuse_part2")
    tp = stub({"data": 1, "model": 2})
    split = SplitConfig(head_cycles=1, tail_cycles=1, prompt_len=4)
    for arch in ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b", "zamba2-2.7b",
                 "rwkv6-3b", "whisper-base", "qwen2-vl-72b"):
        base = get_config(arch)
        for cfg in (base.reduced(n_layers=3 * len(base.layer_pattern)),
                    base):
            params = SplitModel(cfg, split).init(torch.Generator(),
                                                 device="meta")
            rules.pop_sharding_fallbacks()
            specs = rules.params_pspecs(params, tp)
            vocab = (("embed/tok", "head/w") if cfg is base
                     and arch == "whisper-base" else ())
            assert [path for path, _, _ in rules.pop_sharding_fallbacks()
                    if not path.endswith(vocab)] == [], (arch, cfg.name)
            assert any("model" in s for s in tree_leaves(specs["body"]))