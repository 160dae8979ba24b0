"""Per-block recompute ("remat") for training, with the JAX package's save
policies.

`recompute(run, x, params, policy, generator)` runs `run(x)` without
building a graph, keeps the block input and the tensors the policy names,
and in the backward runs `run` again under autograd, where every kept value
is handed back instead of computed, then differentiates the rerun. The
policies keep what `jax.checkpoint` keeps under the JAX package's policies
(tpu1x/models/st_transformer.py `_remat`):

- "none": nothing but the block input;
- "attn_outs": the attention outputs (the plain attention's through
  `attention`, and the fused spatial and temporal train blocks' outputs,
  which JAX tags "attn_out"); the fused attention kernel
  (`ops/attention.py` `flash_mha`) keeps its log-sum-exp beside its
  output, so its backward (K10) runs without a second forward (K9);
- "dots": every product's output: the weight products (`dense`) and the
  plain attention (its two products are batched dots in JAX; it keeps
  their result, the attention output). The fused attention kernel is no
  dot (a Pallas call in JAX), so its forward runs again in the backward;
- "dots_no_batch": the weight products' outputs only.

Inside a fused sub-layer (K11, K12 or K13 on the card) nothing is kept
under "dots": a Pallas call is no dot to JAX either. torch's own
selective checkpointing cannot do this: its policy sees dispatcher ops,
and the kernels are launched through ctypes.

A dropout mask drawn from an explicit `torch.Generator` inside the block is
drawn again in the rerun from the generator's state at the first run, which
is restored afterwards.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from tpu1x_torch.ops._util import dense as dense_plain

KEEPS = {"none": frozenset(), "attn_outs": frozenset({"attn_out"}),
         "dots": frozenset({"dot", "batch_dot"}),
         "dots_no_batch": frozenset({"dot"})}


class _Tape:
    """The values a block's first run keeps, in the order it made them."""

    def __init__(self, kinds, values=None):
        self.kinds = kinds
        self.values = [] if values is None else list(values)
        self.replay = values is not None
        self.pos = 0


_tape: Optional[_Tape] = None  # the block being run under `recompute`


def keep(kinds, compute: Callable):
    """`compute()` (a tensor or a tuple of tensors), kept by the block's
    first run when the running policy keeps one of `kinds`, and handed back
    without computing by its rerun. Outside `recompute`, `compute()`."""
    tape = _tape
    if tape is None or not kinds & tape.kinds:
        return compute()
    if tape.replay:  # new tensors, so that the rerun's graph is its own
        tape.pos += 1
        out = tape.values[tape.pos - 1]
        return (tuple(None if t is None else t.detach() for t in out)
                if isinstance(out, tuple) else out.detach())
    out = compute()
    tape.values.append(out)
    return out


def keeps(kind: str) -> bool:
    """Whether the block being run keeps values of `kind`."""
    return _tape is not None and kind in _tape.kinds


def _flatten(values):
    sizes = [len(v) if isinstance(v, tuple) else 0 for v in values]
    flat = [t for v in values for t in (v if isinstance(v, tuple) else (v,))]
    return sizes, flat


def _unflatten(sizes, flat):
    out, i = [], 0
    for n in sizes:
        out.append(tuple(flat[i:i + n]) if n else flat[i])
        i += max(n, 1)
    return out


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, kinds, generator, x, *params):
        global _tape
        ctx.run, ctx.kinds, ctx.generator = run, kinds, generator
        ctx.rng = None if generator is None else generator.get_state()
        outer, _tape = _tape, _Tape(kinds)
        try:
            y = run(x)
            values = _tape.values
        finally:
            _tape = outer
        ctx.sizes, flat = _flatten(values)
        ctx.n_kept = len(flat)
        ctx.save_for_backward(x, *flat, *params)
        return y

    @staticmethod
    def backward(ctx, dy):
        global _tape
        x, *rest = ctx.saved_tensors
        kept, params = rest[:ctx.n_kept], rest[ctx.n_kept:]
        x = x.detach().requires_grad_(ctx.needs_input_grad[3])
        gen, current = ctx.generator, None
        if gen is not None:
            current = gen.get_state()
            gen.set_state(ctx.rng)
        outer, _tape = _tape, _Tape(ctx.kinds, _unflatten(ctx.sizes, kept))
        try:
            with torch.enable_grad():
                y = ctx.run(x)
        finally:
            _tape = outer
            if gen is not None:
                gen.set_state(current)
        wrt = [t for t, need in zip((x, *params), ctx.needs_input_grad[3:])
               if need]
        grads = iter(torch.autograd.grad(y, wrt, dy, allow_unused=True))
        return (None, None, None, *(next(grads) if need else None
                                    for need in ctx.needs_input_grad[3:]))


def recompute(run: Callable, x: torch.Tensor, params: Sequence[torch.Tensor],
              policy: str, generator: Optional[torch.Generator] = None):
    """`run(x)`, differentiable in x and `params` (every parameter `run`
    reads), recomputed in the backward under `policy` (see the module
    docstring). `generator` is the one `run` draws dropout masks from, or
    None."""
    if policy not in KEEPS:
        raise ValueError(f"remat_policy must be one of {sorted(KEEPS)}, got "
                         f"{policy!r}")
    return _Recompute.apply(run, KEEPS[policy], generator, x, *params)


class _KeptAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, mha):
        o = keep(_PLAIN_ATTENTION,
                 lambda: mha(q, k, v, scale=scale, causal=causal))
        ctx.args = dict(scale=scale, causal=causal)
        ctx.mha = mha
        ctx.save_for_backward(q, k, v)
        return o

    @staticmethod
    def backward(ctx, dout):
        # the probabilities again, as JAX recomputes its softmax
        qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.mha(*qkv, **ctx.args)
        return (*torch.autograd.grad(out, qkv, dout), None, None, None)


# the plain attention's output: an attention output, and the result of its
# two batched dots
_PLAIN_ATTENTION = frozenset({"attn_out", "batch_dot"})


def attention(mha: Callable, q, k, v, *, scale: float, causal: bool):
    """The plain attention `mha(q, k, v, ...)`, its output kept when the
    running block keeps attention outputs or batched dots. (The fused
    kernel keeps its own output and log-sum-exp: `attention.flash_mha`.)"""
    if _tape is None or not _PLAIN_ATTENTION & _tape.kinds:
        return mha(q, k, v, scale=scale, causal=causal)
    return _KeptAttention.apply(q, k, v, scale, causal, mha)


class _KeptDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return keep(frozenset({"dot"}), lambda: dense_plain(x, w, b))

    @staticmethod
    def backward(ctx, dy):
        # the derivative autograd takes through `dense_plain`
        x, w, b = ctx.saved_tensors
        n = w.shape[-1]
        dy2 = dy.reshape(-1, n)
        dx = dy2.mm(w.to(x.dtype).t()).view(x.shape)
        dw = x.reshape(-1, w.shape[0]).t().mm(dy2).to(w.dtype)
        db = None if b is None else dy2.sum(0).to(b.dtype)
        return dx, dw, db


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`_util.dense`, its output kept when the running block keeps the
    weight products' outputs."""
    if not keeps("dot"):
        return dense_plain(x, w, b)
    return _KeptDense.apply(x, w, b)
