"""Weight bridge: nested dicts of arrays -> nested dicts of tensors.

`jax_to_torch(tree, device)` copies a params pytree (nested dicts whose
leaves are numpy arrays or anything `numpy.asarray` takes, such as the JAX
package's arrays) key for key into tensors. Dense weights are (d_in, d_out)
in both packages, so no transpose is involved. Tests use it so both
packages compute on the same weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.serve.bank import TenantBank
from repro_torch.tree import tree_map


def jax_to_torch(tree: Any, device="cuda") -> Any:
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=device),
                    tree)


def bank_from_arrays(tails: Any, prompts: Any, device="cuda") -> TenantBank:
    """A TenantBank from stacked (leading tenant axis) tails and prompts,
    e.g. the JAX package's `TenantBank.tails` / `.prompts`."""
    return TenantBank(jax_to_torch(tails, device),
                      jax_to_torch(prompts, device))
