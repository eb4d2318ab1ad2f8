"""Host meshes of ranks — the port of `repro/launch/mesh.py`.

SFPrompt mapping: the client plane is 'data' — each index trains a block
of the sampled cohort; the server plane is 'model' — the frozen body is
tensor-parallel over it (and FSDP-sharded over 'data' for storage).

A "device" of the JAX host mesh is a RANK here: one process in a
`torch.distributed` gloo group. `spawn_ranks` starts n of them (start
method `spawn`, a `file://` store in a temporary directory, so concurrent
runs never share a port) and `make_host_mesh` lays the group's ranks out
as a `DeviceMesh` with dims ('data',) or ('data', 'model'). Every rank
computes on the same `device`: on a card all of them share `cuda:0`, and
gloo moves CUDA tensors through host memory. NCCL (one GPU a rank) waits
for a machine with more than one card.

The production meshes of the dry-run (`make_production_mesh`) are
`parallel.AccountingMesh`es: JAX's axis names and sizes seen from rank 0,
with no process group, so a rank's step runs on the `meta` device in one
process. The roofline's constants are the card's, per card, from
NVIDIA's H100 SXM5 80GB HBM3 datasheet at 700 W (the card of PERF.md), in
place of the JAX module's v5e numbers: dense bf16 tensor-core FLOP/s, HBM
bytes/s, and an NVLink link rate of 900 GB/s in all, 450 GB/s a
direction, where JAX has its ICI link. The NVLink Switch System joins up
to 256 GPUs, so pod16x16's 256 ranks stay on NVLink; the 'pod' axis of
pod2x16x16 would cross InfiniBand, which the roofline does not model: it
keeps JAX's single collective term.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.sharding.parallel import AccountingMesh
from repro_torch.sharding.rules import axis_sizes, report_fallbacks

COLLECTIVE_TIMEOUT_S = 900   # a rank waiting longer on a collective fails

# H100 SXM5 80GB HBM3 at 700 W, NVIDIA's datasheet (per card)
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12               # bytes/s
LINK_BW = 450e9                # bytes/s: NVLink's 900 GB/s, one direction


def make_production_mesh(*, multi_pod: bool = False) -> AccountingMesh:
    """The dry-run's mesh, seen from rank 0: (data 16, model 16) =
    256 ranks, named pod16x16, or (pod 2, data 16, model 16) = 512,
    named pod2x16x16. Opens no process group."""
    if multi_pod:
        return AccountingMesh({"pod": 2, "data": 16, "model": 16},
                              name="pod2x16x16")
    return AccountingMesh({"data": 16, "model": 16}, name="pod16x16")


def check_host_mesh(n: int, world: int, model: int = 1) -> None:
    """The JAX package's ValueErrors for an n-rank mesh over `world` ranks:
    larger than the group, or a model size that does not divide it."""
    if n > world:
        raise ValueError(
            f"requested a {n}-device host mesh but only {world} "
            "device(s) are visible — start that many host ranks with "
            "repro_torch.launch.mesh.spawn_ranks")
    if model > 1 and n % model != 0:
        raise ValueError(
            f"model={model} does not divide the {n}-device host mesh — "
            "pick a model-axis size that divides the device count")


def make_host_mesh(n: int = 0, *, model: int = 1):
    """The host mesh over the first n ranks of the process group (n=0:
    every rank). model=1: 1-D ('data',); model>1: 2-D ('data', 'model')
    with the client plane shrunk to n // model. Raises `check_host_mesh`'s
    errors; a rank outside the first n gets a mesh it has no place in."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n <= 0 else n
    check_host_mesh(n, world, model)
    if not dist.is_initialized():
        raise RuntimeError("a host mesh needs the ranks' process group: "
                           "run under repro_torch.launch.mesh.spawn_ranks")
    from torch.distributed.device_mesh import DeviceMesh
    if model <= 1:
        shape, names = (n,), ("data",)
    else:
        shape, names = (n // model, model), ("data", "model")
    # the mesh's device type names its groups' backend (gloo); the ranks'
    # tensors may live on a card all the same
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def report_sharding_fallbacks(context: str = "", tracer=None) -> tuple:
    """Drain the divisibility fallbacks recorded while building partition
    specs and warn ONCE if any rule fell back to replication (with a
    tracer, also one `sharding.fallback` event). Returns the drained
    (path, axis, shape) tuples."""
    return report_fallbacks(context, tracer)


def data_parallel_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return sizes["data"] * sizes.get("pod", 1)


def is_lead(mesh) -> bool:
    """True on the rank that prints and writes files (global rank 0, or
    every process without a mesh)."""
    return mesh is None or dist.get_rank() == 0


def _rank_main(rank, fn, n, tmp, args, threads):
    torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=n,
        timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


def spawn_ranks(fn, n: int, *args, threads: int = 1) -> list:
    """Run `fn(*args)` on n new host ranks joined in a gloo process group
    and return their results in rank order. `fn` must be importable by
    name (the ranks start from a fresh interpreter) and its result
    picklable. A rank that raises fails the call: the others are stopped
    and the parent raises with the rank's traceback. Each rank uses
    `threads` intra-op threads."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_mesh_") as tmp:
        mp.start_processes(_rank_main,
                           args=(fn, n, tmp, args, threads),
                           nprocs=n, start_method="spawn", join=True)
        out = []
        for r in range(n):
            # written by this call's own ranks
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
