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

Only all-reduce (sum) and broadcast run: a gather is an all-reduce of a
zero-filled buffer into which each rank writes its block, which is exact
(x + 0 is x). Those are the collectives gloo runs on CUDA tensors. A
collective that fails raises; nothing falls back.

`DataSharded` is a frozen leaf stored sharded over 'data' for FSDP;
`materialize` gathers it (whole, or one layer of a stacked leaf) just
before use.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.rules import axis_sizes


# ----------------------------------------------------------------- mesh
def axis_size(mesh, name: str) -> int:
    """Size of mesh axis `name`; 1 when the mesh (or `mesh`) is absent."""
    if mesh is None:
        return 1
    return axis_sizes(mesh).get(name, 1)


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on mesh axis `name` (0 when absent)."""
    if axis_size(mesh, name) == 1:
        return 0
    return int(mesh.get_local_rank(name))


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


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


def _group(mesh, name: str):
    return mesh.get_group(name)


# --------------------------------------------------- outside autograd
def reduce_sum(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """Sum `x` over mesh axis `name`, in place; returns `x`."""
    if axis_size(mesh, name) > 1:
        dist.all_reduce(x, group=_group(mesh, name))
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
    dist.all_reduce(buf, group=_group(mesh, name))
    return buf


# ------------------------------------------------------ autograd pairs
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_group(ctx.mesh, "model"))
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=_group(mesh, "model"))
        return y

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
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_group(ctx.mesh, "model"))
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
        return reduce_sum(buf, mesh, "data")


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
    return reduce_sum(buf, mesh, "data").reshape(
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
