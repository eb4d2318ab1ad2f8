"""Collective and op accounting for the dry-run — the port of
`repro/launch/hlo.py`.

The JAX module reads a compiled module's HLO text: output bytes of every
collective by kind (with while-loop bodies multiplied by their trip
counts) and a count of fusions, custom-calls, dots and convolutions. No
path of the port makes HLO text, so the text parser is not copied; the
same numbers come from what runs:

* collectives from `sharding.parallel.collective_log()`, where every
  collective of the port records its logical kind (`all-reduce`,
  `all-gather`, `reduce-scatter`) and its output bytes — JAX's
  convention: the op's output size, with a ring's wire amplification
  left to the roofline;
* products, kernel ops and bytes from `OpAccount`, a dispatch mode over
  the step's aten ops: "dot" (the matrix products), "convolution",
  "custom-call" (the port's kernel ops, each taking its accounting form
  on `meta`: `kernels.accounted_ops`), FLOPs by XLA's convention (the
  products by `torch.utils.flop_counter`'s formulas, an elementwise op
  one an output element, a reduction one an input element, a
  transcendental none), bytes as each op's inputs plus
  outputs (views move nothing and are skipped: the unfused upper bound
  that JAX's unoptimized HLO gives), and the peak of live bytes the ops
  allocated.

A Python loop over layers runs every call, so each collective counts once
a call: no trip-count correction is needed.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
         "vdot", "_scaled_mm"}
_CONVS = {"convolution", "_convolution", "convolution_backward"}
# XLA counts these as transcendentals, not FLOPs
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "pow",
                   "softplus", "silu", "gelu", "logit"}
# reductions: one FLOP an input element, as XLA's reduce
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
           "argmin", "cumsum", "logsumexp", "var", "var_mean", "norm",
           "linalg_vector_norm"}
# softmax and its gradient: a max, a subtract, a sum and a divide an
# element (the exp a transcendental), as XLA's expansion
_SOFTMAX = {"_softmax", "_log_softmax", "_softmax_backward_data",
            "_log_softmax_backward_data"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(values):
    """The tensors among `values`, one level of lists and tuples down (an
    aten op's arguments and outputs)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, torch.Tensor))
    return out


def _flop_kind(func):
    """How an op's FLOPs count, by XLA's `cost_analysis` convention: a
    product by torch's flop formula; an elementwise op one an output
    element (a transcendental none); a reduction one an input element;
    softmax four an element."""
    name = func._overloadpacket.__name__
    if func._overloadpacket in flop_registry:
        return "formula"
    if name.rstrip("_") in _TRANSCENDENTAL:
        return None
    if name in _SOFTMAX:
        return "softmax"
    if name in _REDUCE:
        return "reduce"
    if torch.Tag.pointwise in func.tags:
        return "pointwise"
    return None


class OpAccount(TorchDispatchMode):
    """Counts the aten ops run inside it: `ops` by kind ("dot",
    "convolution", "custom-call"), `flops`, `bytes` (each non-view op's
    inputs and outputs) and, with `live`, `peak_bytes` (the most bytes of
    the ops' fresh outputs alive at once)."""

    def __init__(self, live: bool = True):
        super().__init__()
        self.ops: Counter = Counter()
        self.flops = 0
        self.bytes = 0
        self.track_live = live
        self.live = 0
        self.peak_bytes = 0
        self._refs: set = set()
        self._kinds: dict = {}
        self._kernel_ops = 0

    def __enter__(self):
        self._kernel_ops = kernels.accounted_ops
        return super().__enter__()

    def __exit__(self, *exc):
        self.ops["custom-call"] += kernels.accounted_ops - self._kernel_ops
        return super().__exit__(*exc)

    def _info(self, func):
        info = self._kinds.get(func)
        if info is None:
            name = func._overloadpacket.__name__
            returns = func._schema.returns
            view = bool(returns) and all(
                r.alias_info is not None and not r.alias_info.is_write
                for r in returns)
            fresh = tuple(r.alias_info is None for r in returns)
            op = ("dot" if name in _DOTS else
                  "convolution" if name in _CONVS else None)
            info = self._kinds[func] = (op, _flop_kind(func), view, fresh)
        return info

    def _freed(self, ref, n: int) -> None:
        self.live -= n
        self._refs.discard(ref)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op, flop_kind, view, fresh = self._info(func)
        if op is not None:
            self.ops[op] += 1
        if view:
            return out
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        ins = _tensors(args) + _tensors(kwargs.values())
        if flop_kind == "formula":
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        elif flop_kind == "pointwise" and outs:
            self.flops += outs[0].numel()
        elif flop_kind == "reduce" and ins:
            self.flops += ins[0].numel()
        elif flop_kind == "softmax" and outs:
            self.flops += 4 * outs[0].numel()
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if self.track_live:
            for t, new in zip(outs, fresh):
                if new:
                    n = _nbytes(t)
                    self.live += n
                    self._refs.add(weakref.ref(
                        t, lambda r, n=n: self._freed(r, n)))
            self.peak_bytes = max(self.peak_bytes, self.live)
        return out


def collective_bytes(log) -> Dict[str, int]:
    """Output bytes per collective kind of a `collective_log()`, plus
    'total' (the JAX module's `collective_bytes` keys)."""
    out = dict(log.bytes_by_kind())
    out["total"] = sum(out.values())
    return out


def count_ops(account: OpAccount, log) -> Dict[str, int]:
    """Ops by kind: the account's "dot", "convolution" and "custom-call",
    and the log's collectives (only the kinds that occur, as JAX's)."""
    counts = {k: v for k, v in account.ops.items() if v}
    counts.update(log.count())
    return counts
