"""Plain PyTorch versions of fused EL2N scoring (+ cross-entropy).

EL2N [Paul et al. 2021, as used by SFPrompt Eq. (2)]:
    score(x, y) = || softmax(f(x)) - onehot(y) ||_2

Two forms of the same function:

  `el2n_scores` — materialized, the counterpart of
      `repro/kernels/el2n/ref.py::el2n_scores`: builds the (N, V)
      probability and onehot tensors. The ground truth; the differentiated
      cross-entropy of the losses runs through it.
  `fused_scores` — the one-pass identity the kernel computes, the
      counterpart of `repro/kernels/el2n/ops.py::_fused_scores`: with
      m = max logit, Z = sum exp(l - m), S2 = sum exp(2(l - m)),
          ||p - y||^2 = S2 / Z^2 - 2 exp(l_y - m) / Z + 1
          CE = m + log Z - l_y
      and no onehot or probability division. The kernel is held to it
      tightly: near a certain correct prediction (p_y -> 1) the three terms
      cancel, and the two forms differ there by up to about sqrt(1e-7) in
      EL2N, while the kernel and this form round alike.
"""
from __future__ import annotations

import torch


def el2n_scores(logits: torch.Tensor, labels: torch.Tensor):
    """logits (N, V) float, labels (N,) int -> (el2n (N,), ce (N,)) f32."""
    logits = logits.float()
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    z = p.sum(-1, keepdim=True)
    probs = p / z
    onehot = torch.arange(logits.shape[-1], device=logits.device)[None, :] \
        == labels[:, None]
    err = probs - onehot.float()
    el2n = torch.sqrt((err * err).sum(-1))
    ly = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    ce = (m[:, 0] + torch.log(z[:, 0])) - ly
    return el2n, ce


def fused_scores(logits: torch.Tensor, labels: torch.Tensor):
    """The one-pass identity; clamped at 0 before the sqrt, since near a
    perfectly confident correct prediction the terms cancel to rounding
    error, which must not go negative."""
    logits = logits.float()
    m = logits.amax(-1)
    ex = torch.exp(logits - m[:, None])
    z = ex.sum(-1)
    s2 = (ex * ex).sum(-1)
    ly = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    py = torch.exp(ly - m) / z
    el2n = torch.sqrt(torch.clamp_min(s2 / (z * z) - 2.0 * py + 1.0, 0.0))
    ce = m + torch.log(z) - ly
    return el2n, ce
