"""Local shards and the collectives between them: the port's counterpart
of XLA's SPMD partitioner on a (data, model) mesh.

A rank holds plain local tensors — never a DTensor — cut from the full
ones by their `P` specs (`local_shard`), and the model code calls the
collectives below where a partitioned computation needs one:

* `copy_to_model` — identity forward, all-reduce of the gradient over
  'model' backward: the replicated input of a column-parallel product;
* `reduce_from_model` — all-reduce over 'model' forward, identity
  backward: the partial output of a row-parallel product. (Not
  `torch.distributed.nn.functional.all_reduce`, whose backward reduces
  the gradient again and multiplies it by the model size.)
* `gather_model` — all-gather over 'model' along the last dim forward,
  all-reduce and this rank's slice backward: split heads gathered whole,
  or a column product's output feeding compute that stays partial a rank;
* `gather_replicated` — the same forward, but its backward keeps this
  rank's slice without a sum: a column product's output gathered into
  replicated compute (RWKV-6's channel mix into the residual stream);
* `gather_axis` / `reduce_sum` — the same gathers and sums outside
  autograd (client blocks over 'data', FSDP leaves, vocab-parallel rows).

Only all-reduce (sum) runs: a gather is an all-reduce of a zero-filled
buffer into which each rank writes its block, which is exact (x + 0 is
x). That is the collective gloo runs on CUDA tensors. A collective that
fails raises; nothing falls back.

Every collective passes through `_all_reduce`, which adds it to each open
`collective_log()` under its LOGICAL kind (`all-reduce`, or `all-gather`
for the gathers, whatever runs underneath) with its output bytes, the
convention of the JAX package's `launch/hlo.py`. `AccountingMesh` is a
mesh of axis names and sizes seen from one rank, with no process group:
its collectives are recorded and return their input as it is (on the
`meta` device, its shape), which is how the dry-run accounts a rank's
step of a production mesh in one process.

`DataSharded` is a frozen leaf stored sharded over 'data' for FSDP;
`materialize` gathers it (whole, or one layer of a stacked leaf) just
before use.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.rules import P, axis_sizes


# ----------------------------------------------------------------- mesh
class AccountingMesh:
    """A mesh seen from one rank for accounting: JAX's axis names and
    sizes (`shape`, name -> size, in mesh order) and this rank's
    coordinates (`coords`, rank 0's by default). It opens no process
    group; the collectives below record on it and return their input
    unchanged, so a step runs whole on the `meta` device as one rank's."""

    def __init__(self, shape: Dict[str, int], *, name: str = "",
                 coords: Optional[Dict[str, int]] = None):
        self.shape = dict(shape)
        self.name = name
        self.coords = {k: 0 for k in self.shape}
        self.coords.update(coords or {})

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def get_local_rank(self, name: str) -> int:
        return self.coords[name]

    def __repr__(self) -> str:
        return f"AccountingMesh({self.name or self.shape}, {self.coords})"


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def axis_size(mesh, name) -> int:
    """Size of mesh axis `name` (or the product over a tuple of names); 1
    where the mesh (or the axis) is absent."""
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes.get(a, 1) for a in _axes(name)]))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on mesh axis `name` (0 when absent)."""
    if axis_size(mesh, name) == 1:
        return 0
    return int(mesh.get_local_rank(name))


def block_index(mesh, entry) -> Tuple[int, int]:
    """(this rank's block, number of blocks) of a dim whose spec entry is
    `entry` (an axis name or a tuple of them, major first)."""
    idx, n = 0, 1
    for name in _axes(entry):
        size = axis_size(mesh, name)
        idx, n = idx * size + axis_index(mesh, name), n * size
    return idx, n


def local_shard(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of `full` under `spec` (a view; no collective)."""
    out = full
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = block_index(mesh, entry)
        chunk = full.shape[d] // n
        out = out.narrow(d, idx * chunk, chunk)
    return out


# ------------------------------------------------------- collective log
_LOGS: list = []


class CollectiveLog:
    """The collectives run while it is open: `records` (kind, axis, output
    bytes) in order; `bytes_by_kind()` and `count()` sum them."""

    def __init__(self):
        self.records: list = []

    def bytes_by_kind(self) -> Dict[str, int]:
        out: Counter = Counter()
        for kind, _, nbytes in self.records:
            out[kind] += nbytes
        return dict(out)

    def count(self) -> Dict[str, int]:
        return dict(Counter(kind for kind, _, _ in self.records))


@contextlib.contextmanager
def collective_log():
    """Record every collective run inside the block (nested logs each get
    every record)."""
    log = CollectiveLog()
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def _all_reduce(x: torch.Tensor, mesh, name: str, kind: str = "all-reduce",
                out_bytes: Optional[int] = None) -> torch.Tensor:
    """The one place a collective runs: an in-place sum of `x` over mesh
    axis `name`, logged as `kind` with the logical op's output bytes
    (`out_bytes`, default x's). On an `AccountingMesh` nothing runs and
    `x` comes back as it is."""
    nbytes = x.numel() * x.element_size() if out_bytes is None else out_bytes
    for log in _LOGS:
        log.records.append((kind, name, nbytes))
    if isinstance(mesh, AccountingMesh):
        return x
    if isinstance(name, tuple):
        raise ValueError(f"a host mesh sums over one axis at a time, not "
                         f"{name}")
    dist.all_reduce(x, group=mesh.get_group(name))
    return x


# --------------------------------------------------- outside autograd
def reduce_sum(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """Sum `x` over mesh axis `name`, in place; returns `x`."""
    if axis_size(mesh, name) > 1:
        _all_reduce(x, mesh, name)
    return x


def gather_axis(x: torch.Tensor, dim: int, mesh, name: str,
                full: Optional[int] = None) -> torch.Tensor:
    """All-gather `x` along `dim` over axis `name` (blocks in coordinate
    order): each rank writes its block into zeros, then an all-reduce.
    `full` is the gathered size (default: local size x axis size)."""
    n = axis_size(mesh, name)
    if n == 1:
        return x
    chunk = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = full if full is not None else chunk * n
    buf = x.new_zeros(shape)
    buf.narrow(dim, axis_index(mesh, name) * chunk, chunk).copy_(x)
    return _all_reduce(buf, mesh, name, "all-gather")


# ------------------------------------------------------ autograd pairs
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x.contiguous().clone(), mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return gather_axis(x.contiguous(), x.dim() - 1, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        # a reduce-scatter: the sum, of which this rank keeps its slice
        g = _all_reduce(g.contiguous().clone(), ctx.mesh, "model",
                        "reduce-scatter", g.numel() * g.element_size()
                        // axis_size(ctx.mesh, "model"))
        i = axis_index(ctx.mesh, "model")
        return g[..., i * ctx.width:(i + 1) * ctx.width], None


class _GatherReplicated(_GatherModel):
    @staticmethod
    def backward(ctx, g):
        i = axis_index(ctx.mesh, "model")
        return g[..., i * ctx.width:(i + 1) * ctx.width].contiguous(), None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The replicated input of a column-parallel product: identity forward;
    backward sums the gradient's partials over 'model'."""
    if axis_size(mesh, "model") == 1 or not _tracked(x):
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum a row-parallel product's partials over 'model'; the gradient
    passes through unchanged (every rank's copy of it is the same)."""
    if axis_size(mesh, "model") == 1:
        return x
    if not _tracked(x):
        return reduce_sum(x.contiguous(), mesh, "model")
    return _ReduceFromModel.apply(x, mesh)


def gather_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """All-gather the last dim over 'model'; backward sums the gathered
    gradient over 'model' and keeps this rank's slice."""
    if axis_size(mesh, "model") == 1:
        return x
    if not _tracked(x):
        return gather_axis(x.contiguous(), x.dim() - 1, mesh, "model")
    return _GatherModel.apply(x, mesh)


def gather_replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """All-gather the last dim over 'model' into a tensor that every rank
    then uses whole in replicated compute. Every rank's gradient of the
    gathered tensor is then already the whole gradient, so the backward
    keeps this rank's slice and sums nothing (`gather_model`'s sum would
    count it once a rank)."""
    if axis_size(mesh, "model") == 1:
        return x
    if not _tracked(x):
        return gather_axis(x.contiguous(), x.dim() - 1, mesh, "model")
    return _GatherReplicated.apply(x, mesh)


def model_slice(x: torch.Tensor, width: int, mesh) -> torch.Tensor:
    """This rank's `width` columns of a last dim held whole."""
    i = axis_index(mesh, "model")
    return x[..., i * width:(i + 1) * width]


# ------------------------------------------------------------ FSDP leaves
class DataSharded:
    """A frozen leaf stored sharded over 'data' along `dim` (FSDP):
    `local` is this rank's block, `full` the size of that dim once
    gathered (any 'model' sharding of the leaf stays in `local`)."""

    def __init__(self, local: torch.Tensor, dim: int, full: int):
        self.local, self.dim, self.full = local, dim, full

    @property
    def shape(self):
        s = list(self.local.shape)
        s[self.dim] = self.full
        return tuple(s)

    def gather(self, mesh, layer: Optional[int] = None) -> torch.Tensor:
        """The leaf (or layer `layer` of a stacked leaf) gathered over
        'data'."""
        if layer is None:
            return gather_axis(self.local, self.dim, mesh, "data", self.full)
        if self.dim > 0:
            return gather_axis(self.local[layer], self.dim - 1, mesh, "data",
                               self.full)
        # sharded on the layer axis: the layer's owner contributes it
        chunk = self.local.shape[0]
        owner, row = divmod(layer, chunk)
        buf = self.local.new_zeros(self.local.shape[1:])
        if owner == axis_index(mesh, "data"):
            buf.copy_(self.local[row])
        return _all_reduce(buf, mesh, "data", "all-gather")


def cut_leaf(x: torch.Tensor, spec, mesh):
    """This rank's copy of a frozen leaf held whole: `x` itself where the
    spec replicates it, else its 'model' block, stored as a `DataSharded`
    block where the spec also puts a dim over 'data' (FSDP)."""
    if all(e is None for e in spec):
        return x
    on_model = P(*(None if e == "data" else e for e in spec))
    y = local_shard(x, on_model, mesh)
    if "data" not in spec:
        return y.clone()
    d = spec.index("data")
    on_data = P(*(e if e == "data" else None for e in spec))
    return DataSharded(local_shard(y, on_data, mesh).clone(), d, y.shape[d])


def take_layer(leaf, layer: int, mesh) -> torch.Tensor:
    """Layer `layer` of a stacked leaf, gathered first if FSDP holds it."""
    if isinstance(leaf, DataSharded):
        return leaf.gather(mesh, layer)
    return leaf[layer]


def materialize(tree: Any, mesh) -> Any:
    """`tree` with every `DataSharded` leaf gathered whole."""
    if isinstance(tree, dict):
        return {k: materialize(v, mesh) for k, v in tree.items()}
    if isinstance(tree, DataSharded):
        return tree.gather(mesh)
    return tree


# ---------------------------------------------------------- client plane
def client_block(k: int, mesh) -> Tuple[int, int]:
    """[lo, hi) of the K cohort clients this rank trains: its contiguous
    block of `cohort_pspecs`'s K axis over 'data', or all K where K does
    not divide the plane (replicated, as the JAX guard falls back)."""
    n = axis_size(mesh, "data")
    if n == 1 or k % n:
        return 0, k
    i = axis_index(mesh, "data")
    return i * (k // n), (i + 1) * (k // n)


def assemble_clients(rows: Sequence[Optional[torch.Tensor]], mesh,
                     device) -> torch.Tensor:
    """K float32 rows of which this rank filled its client block (the rest
    None), stacked whole on every rank: its block written into zeros,
    then one all-reduce over 'data' (exact). With every row present, the
    plain stack."""
    mine = [r for r in rows if r is not None]
    if len(mine) == len(rows):
        return torch.stack(rows)
    width = mine[0].numel()
    buf = torch.zeros((len(rows), width), dtype=torch.float32, device=device)
    for k, r in enumerate(rows):
        if r is not None:
            buf[k] = r.reshape(-1)
    return _all_reduce(buf, mesh, "data", "all-gather").reshape(
        (len(rows),) + tuple(mine[0].shape))


def pack(values, device) -> Tuple[torch.Tensor, list]:
    """Tensors and numbers flattened into one float32 row on `device`, with
    the layout `unpack` needs. Every float32 and every integer up to 2^24
    survives the trip."""
    parts, layout = [], []
    for v in values:
        t = v.detach() if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v))
        layout.append((tuple(t.shape), t.dtype, torch.is_tensor(v)))
        parts.append(t.reshape(-1).to(device=device, dtype=torch.float32))
    return torch.cat(parts), layout


def unpack(row: torch.Tensor, layout) -> list:
    """The values `pack` flattened, from a row of the same layout: tensors
    on the row's device, numbers as numpy scalars."""
    out, at = [], 0
    for shape, dtype, was_tensor in layout:
        n = int(np.prod(shape, dtype=np.int64))
        v = row[at:at + n].reshape(shape).to(dtype)
        at += n
        out.append(v if was_tensor else v.cpu().numpy()[()])
    return out
