"""Plain decode attention of one or two query frames against the KV cache.

Only the plain functions are ported so far; the temporal+MLP block's plain
versions are built on them. The JAX package's decode-attention kernels
(bf16 and int8 caches) wait for the int8-cache slice.
"""

from __future__ import annotations

import torch

from tpu1x_torch.ops.attention import NEG_INF


def temporal_decode_attention_reference(q, k_cache_l, v_cache_l, k_cur, v_cur,
                                        t_B, *, scale: float, num_heads: int):
    """q, k_cur, v_cur (B, S, C); k/v_cache_l (T, B, S, C), one layer of the
    T-major cache; t_B (B,) int: cache slots >= t are masked. One joint fp32
    softmax over the cache slots and the current token. Returns q's dtype."""
    B, S, C = q.shape
    T = k_cache_l.shape[0]
    H = num_heads
    D = C // H
    qf = q.float().reshape(1, B, S, H, D)
    kf = k_cache_l.float().reshape(T, B, S, H, D)
    logits = (qf * kf).sum(-1).permute(1, 2, 0, 3) * scale  # (B, S, T, H)
    logit_s = (q.float() * k_cur.float()).reshape(B, S, H, D).sum(-1) * scale
    t_iota = torch.arange(T, device=q.device)
    valid = t_iota[None, :] < t_B.to(q.device)[:, None]  # (B, T)
    logits = torch.where(valid[:, None, :, None], logits,
                         torch.full_like(logits, NEG_INF))
    m = torch.maximum(logits.amax(2), logit_s)  # (B, S, H)
    e_c = torch.exp(logits - m[:, :, None, :])
    e_s = torch.exp(logit_s - m)
    denom = e_c.sum(2) + e_s
    p = e_c / denom[:, :, None, :]  # (B, S, T, H)
    vf = v_cache_l.float().reshape(T, B, S, H, D)
    out = (p.permute(2, 0, 1, 3)[..., None] * vf).sum(0)  # (B, S, H, D)
    out = out + (e_s / denom)[..., None] * v_cur.float().reshape(B, S, H, D)
    return out.reshape(B, S, C).to(q.dtype)


def _with_slot(cache_l, x_BSC, t_B):
    """A copy of a (T, B, S, C) cache with x written at each row's slot t."""
    T = cache_l.shape[0]
    t_iota = torch.arange(T, device=cache_l.device)
    sel = t_iota[:, None] == t_B.to(cache_l.device)[None, :]  # (T, B)
    sel = sel[:, :, None, None]
    return torch.where(sel, x_BSC[None].to(cache_l.dtype), cache_l)


def temporal_decode2_attention_reference(q_prev, q_cur, k_cache_l, v_cache_l,
                                         k_prev, v_prev, k_cur, v_cur,
                                         t_prev_B, *, scale: float,
                                         num_heads: int):
    """Two query frames against one cache read: prev (frame t_prev) attends
    slots < t_prev plus itself; cur (frame t_prev + 1) attends slots
    < t_prev, prev's k/v and itself. Returns (out_prev, out_cur)."""
    out_prev = temporal_decode_attention_reference(
        q_prev, k_cache_l, v_cache_l, k_prev, v_prev, t_prev_B, scale=scale,
        num_heads=num_heads)
    out_cur = temporal_decode_attention_reference(
        q_cur, _with_slot(k_cache_l, k_prev, t_prev_B),
        _with_slot(v_cache_l, v_prev, t_prev_B), k_cur, v_cur, t_prev_B + 1,
        scale=scale, num_heads=num_heads)
    return out_prev, out_cur
