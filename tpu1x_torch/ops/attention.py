"""Plain multi-head attention, the oracle that the attention kernels' plain
versions build on."""

from __future__ import annotations

import torch

NEG_INF = torch.finfo(torch.float32).min


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = False) -> torch.Tensor:
    """Attention over axis -3 of q, k, v shaped (..., N, H, D).

    Logits and softmax are fp32; the probabilities are cast to v's dtype
    before the PV product, which accumulates in fp32. Returns v's dtype.
    """
    out_dtype = v.dtype
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float())
    logits = logits * scale
    if causal:
        n = q.shape[-3]
        mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(out_dtype)
    out = torch.einsum("...hqk,...khd->...qhd", probs.float(), v.float())
    return out.to(out_dtype)
