"""Name-based partition rules for the SFPrompt mesh mapping — the port of
`repro/sharding/rules.py`.

Client plane: tensors with a leading client axis (trainable tail/prompt
copies, per-client batches) shard that axis over ('pod', 'data').
Server plane: the frozen body is tensor-parallel over 'model' — attention
projections by output columns, MLP by d_ff, MoE by experts, embeddings/LM
head by vocab.

Rules are right-aligned to trailing dims, so the same rule covers a bare
(D, F) leaf and its stacked (n_layers, D, F) form. Every assignment is
divisibility-guarded: a dim that does not divide its mesh axis is
replicated on that axis instead (kv_heads=8 on model=16 replicates).

The builders return `P` specs, one entry a tensor dim (None, an axis name
or a tuple of names), equal entry for entry to the JAX package's
`PartitionSpec`s, and they walk a tree in `jax.tree` order (dict keys
sorted), so the fallback records come in the JAX package's order too. A
mesh is anything with `.shape` as a name -> size mapping (the JAX
package's stubs) or a `torch.distributed.DeviceMesh` (`axis_sizes`).
`placements` turns a spec into the DTensor placements of a DeviceMesh.
"""
from __future__ import annotations

import re
import warnings
from typing import Any, Dict, Tuple

import numpy as np

# (path regex, trailing-dims spec). First match wins.
_PARAM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # --- embeddings / output head: vocab-parallel
    (r"embed/tok$", ("model", None)),
    (r"embed/(patch)/w$", (None, None)),
    (r"embed/(cls|pos)$", (None, None)),
    (r"(^|/)head/w$", (None, "model")),
    # --- MoE experts: expert-parallel
    (r"experts/(up|gate|down)$", ("model", None, None)),
    (r"router/w$", (None, None)),
    # --- attention projections: head-parallel (output dim)
    (r"(q|k|v|q_a|q_b|kv_a|kv_b|cq|ck|cv|g|r)/w$", (None, "model")),
    (r"(o|co)/w$", ("model", None)),
    # --- MLP: d_ff-parallel
    (r"(up|gate|ck)/w$", (None, "model")),
    (r"(down|cv)/w$", ("model", None)),
    # --- mamba2 / rwkv6 projections
    (r"in_proj/w$", (None, "model")),
    (r"out_proj/w$", ("model", None)),
    (r"(w_lora_a|w_lora_b)$", (None, None)),
    # --- everything else (norms, biases, scalars): replicated
)


class P(tuple):
    """A partition spec: one entry a tensor dim — None (replicated), a mesh
    axis name, or a tuple of names (sharded over their product, major
    first). `tuple(jax_spec) == tuple(P(...))` compares it with the JAX
    package's `PartitionSpec`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a stub with a `.shape`
    mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return dict(mesh.shape)


def _rule_for(path: str) -> Tuple:
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            return spec
    return ()


# Divisibility fallbacks recorded by guard_divisibility: a rule WANTED to
# shard a dim over a mesh axis that exists, but the dim does not divide the
# axis size, so the leaf replicated on that axis. Quietly slow on a
# mis-sized mesh — the launchers and engines drain this with
# pop_sharding_fallbacks() and report once (report_fallbacks).
_SHARDING_FALLBACKS: list = []


def pop_sharding_fallbacks() -> Tuple[Tuple[str, Any, Tuple[int, ...]], ...]:
    """Drain the recorded (path, dropped_axis, shape) divisibility
    fallbacks accumulated by guard_divisibility since the last drain.
    Deduplicated, insertion-ordered. Mesh-absent axis drops (e.g. 'model'
    rules on a data-only host mesh) are intentional and never recorded."""
    seen, out = set(), []
    for entry in _SHARDING_FALLBACKS:
        if entry not in seen:
            seen.add(entry)
            out.append(entry)
    _SHARDING_FALLBACKS.clear()
    return tuple(out)


def format_sharding_fallbacks(entries) -> str:
    """One human-readable line per fallback, for warnings/logs."""
    lines = [f"  {path or '<unnamed>'}: shape {shape} does not divide "
             f"mesh axis {axis!r} — replicated on it instead"
             for path, axis, shape in entries]
    return ("sharding rules fell back to replication on "
            f"{len(entries)} leaf dim(s):\n" + "\n".join(lines))


def report_fallbacks(context: str = "", tracer=None) -> tuple:
    """Drain + surface the recorded fallbacks at one build site: with an
    enabled tracer ONE `sharding.fallback` event carrying every drained
    entry, and a warning either way, so mis-sized meshes are loud even
    untraced. Returns the drained (path, axis, shape) tuples."""
    entries = pop_sharding_fallbacks()
    if entries:
        if tracer is not None and tracer.enabled:
            tracer.event(
                "sharding.fallback", context=context, n=len(entries),
                entries=[[path, str(axis), list(shape)]
                         for path, axis, shape in entries])
        prefix = f"[{context}] " if context else ""
        warnings.warn(prefix + format_sharding_fallbacks(entries),
                      stacklevel=2)
    return entries


def guard_divisibility(spec: Tuple, shape: Tuple[int, ...], mesh, *,
                       path: str = None) -> P:
    """Drop axis assignments whose dim is not divisible by the axis size.
    Axes the mesh does not have at all are dropped the same way, so the
    rule tables stay mesh-shape agnostic. Divisibility drops (axis
    present, dim indivisible) are recorded when `path` is given."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, axis in zip(shape, spec):
        if axis is None:
            out.append(None)
            continue
        axes = tuple(a for a in
                     (axis if isinstance(axis, tuple) else (axis,))
                     if a in sizes)
        if not axes:
            out.append(None)
            continue
        axis = axes if len(axes) > 1 else axes[0]
        size = int(np.prod([sizes[a] for a in axes]))
        if dim % size == 0 and dim > 0:
            out.append(axis)
        else:
            # dim <= 1 carries nothing to shard — replication is free,
            # not a fallback worth surfacing
            if path is not None and dim > 1:
                _SHARDING_FALLBACKS.append((path, axis, tuple(shape)))
            out.append(None)
    return P(*out)


def _map_sorted(fn, tree, path: Tuple[str, ...] = ()):
    """`fn(path, leaf)` over a nested dict in `jax.tree` order (keys
    sorted at every level)."""
    if isinstance(tree, dict):
        return {k: _map_sorted(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    return fn(path, tree)


def _client_axes(sizes) -> Any:
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    return data_axes if len(data_axes) > 1 else (
        data_axes[0] if data_axes else None)


def client_axes(mesh) -> Any:
    """The client plane of `mesh`: ('pod', 'data'), one of them, or None
    (whichever the mesh has), as the specs name it."""
    return _client_axes(axis_sizes(mesh))


def params_pspecs(params_shape: Any, mesh, *, client_axis: bool = False,
                  fsdp: bool = False, fsdp_threshold: int = 1 << 21) -> Any:
    """Tree of `P` for a params tree (leaves: anything with `.shape`).

    client_axis=True: leaves carry a leading client axis K sharded over
    ('pod', 'data') (whichever exist in the mesh).
    fsdp=True: leaves of at least `fsdp_threshold` elements additionally
    shard their biggest still-replicated dim over 'data' (FSDP-style
    storage of the frozen server body)."""
    sizes = axis_sizes(mesh)
    data_axes = _client_axes(sizes)

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        name = "/".join(path)
        spec = tuple(_rule_for(name))
        lead = 1 if client_axis else 0
        # right-align the rule to the trailing dims
        n_lead = len(shape) - len(spec) - lead
        if n_lead < 0:
            spec = spec[-len(shape) + lead:] if len(shape) > lead else ()
            n_lead = len(shape) - len(spec) - lead
        full = ((data_axes,) if client_axis else ()) + \
            (None,) * n_lead + spec
        guarded = list(guard_divisibility(full, shape, mesh, path=name))
        guarded += [None] * (len(shape) - len(guarded))

        if (fsdp and not client_axis and "data" in sizes
                and int(np.prod(shape, dtype=np.int64)) >= fsdp_threshold):
            dsize = sizes["data"]
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if guarded[i] is None and shape[i] % dsize == 0 \
                        and shape[i] >= dsize:
                    guarded[i] = "data"
                    break
        return P(*guarded)

    return _map_sorted(leaf_spec, params_shape)


def _leading_client_spec(tree, mesh):
    data_axes = _client_axes(axis_sizes(mesh))

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        spec = (data_axes,) + (None,) * (len(shape) - 1)
        return guard_divisibility(spec, shape, mesh)

    return _map_sorted(leaf_spec, tree)


def cohort_pspecs(cohort_shape: Any, mesh) -> Any:
    """Specs of COHORT tensors — anything with a leading client axis K
    (stacked per-client trainables, the (K, n_local, ...) client data,
    (K,) participation vectors): K over the client plane ('pod', 'data' —
    whichever the mesh has), every other dim replicated. A K that does
    not divide the plane replicates (unrecorded)."""
    return _leading_client_spec(cohort_shape, mesh)


def batch_pspec(batch_shape: Any, mesh, *, client_axis: bool = False) -> Any:
    """Batch tensors: the leading (K or batch) dim over ('pod', 'data');
    everything else replicated."""
    return _leading_client_spec(batch_shape, mesh)


def cache_pspecs(cache_shape: Any, mesh, *, paged: bool = False) -> Any:
    """KV/state caches: (n_layers, B, W, heads, dh)-style leaves — batch
    dim (axis 1) over ('pod', 'data'); the kv-heads dim over 'model' when
    divisible.

    paged=True: the leaves are a PAGE POOL — (n_layers, n_pages,
    page_size, heads, dh). Axis 1 is pages and stays REPLICATED over the
    client plane (any slot's block table may point at any page); only the
    kv-heads dim shards over 'model'."""
    data_axes = _client_axes(axis_sizes(mesh))

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        name = "/".join(path)
        if len(shape) < 2:
            return P(*([None] * len(shape)))
        spec = [None] * len(shape)
        if not paged:
            spec[1] = data_axes                  # batch (slot) dim
        if re.search(r"(^|/)(k|v)$", name) and len(shape) == 5:
            spec[3] = "model"                    # kv heads
        if not paged:
            if re.search(r"(^|/)ssm$", name) and len(shape) == 5:
                spec[2] = "model"                # mamba heads
            if re.search(r"(^|/)state$", name) and len(shape) == 5:
                spec[2] = "model"                # rwkv heads
        return guard_divisibility(tuple(spec), shape, mesh, path=name)

    return _map_sorted(leaf_spec, cache_shape)


def placements(spec: Tuple, mesh) -> tuple:
    """The DTensor placements of `spec` on a DeviceMesh: one a mesh dim,
    `Shard(d)` where tensor dim d's entry names that mesh dim, else
    `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec) if entry is not None
                and name in (entry if isinstance(entry, tuple)
                             else (entry,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)
