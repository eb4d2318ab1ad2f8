"""TenantBank: per-tenant (tail, prompt) parameters for split serving.

SFPrompt's end state is a fine-tuned split model serving real clients: the
frozen body is SHARED on the server, while each tenant owns its
personalized tail and soft prompt.

The bank stacks all tenants' tails/prompts with a leading tenant axis, as
the JAX package's does. The port's decode step never gathers one tail copy
per slot: it groups the slots by tenant and runs each present tenant's tail
(`tail(t)`, a view) on that tenant's rows.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


class TenantBank:
    """Stacked per-tenant (tail, prompt) trees (leading axis = tenant)."""

    def __init__(self, tails: Params, prompts: torch.Tensor):
        n_t = tree_leaves(tails)[0].shape[0]
        if prompts.shape[0] != n_t:
            raise ValueError(
                f"tails carry {n_t} tenants but prompts {prompts.shape[0]}")
        self.tails = tails
        self.prompts = prompts
        self.n_tenants = n_t

    # ----------------------------------------------------------- builders
    @classmethod
    def from_lists(cls, tails: Sequence[Params],
                   prompts: Sequence[torch.Tensor]) -> "TenantBank":
        stacked = tree_map(lambda *xs: torch.stack(xs), *tails)
        return cls(stacked, torch.stack(list(prompts)))

    @classmethod
    def replicate(cls, tail: Params, prompt: torch.Tensor,
                  n_tenants: int) -> "TenantBank":
        """All tenants share the global (tail, prompt) — the pre-
        personalization deployment. Each tenant gets its own copy, so a
        tenant's entries can be updated in place."""
        tails = tree_map(
            lambda x: x[None].repeat((n_tenants,) + (1,) * x.dim()), tail)
        prompts = prompt[None].repeat((n_tenants,) + (1,) * prompt.dim())
        return cls(tails, prompts)

    # ------------------------------------------------------------- lookup
    def prompt(self, tenant_id: int) -> torch.Tensor:
        return self.prompts[int(tenant_id)]

    def tail(self, tenant_id: int) -> Params:
        return tree_map(lambda x: x[int(tenant_id)], self.tails)

    def nbytes(self) -> int:
        """Memory of the bank — the cost of personalization."""
        return int(sum(x.numel() * x.element_size()
                       for x in tree_leaves(self.tails) + [self.prompts]))
