"""Batched world-model rollouts and policy ranking.

`RolloutEngine.rollout` draws K imagined futures per prompt. With
decode="cached" (the default) it runs the KV-cached, fused-commit MaskGIT
sampler over `DecodeEngine`; `cache_dtype="int8"` keeps the KV cache in
per-token int8 with fp32 scales (half the bytes of the cache read), and
`DecodeEngine` then runs each layer op by op, as it does for the qk_norm
models. decode="full" runs the uncached sampler, a whole-sequence forward
(`STMaskGIT.compute_logits`) per MaskGIT step, the reference's strategy.

`score_policies` scores P candidate continuations of one shared context by
the world model's teacher-forced cross-entropy, and `rank_policies` orders
them by it: the policy-ranking primitive of the evaluation challenge.

With a `mesh` (`parallel/mesh.py` `make_mesh`) the B K rollout rows and
the P scored policies split over every rank of it, data x model in rank
order (the JAX engine's `rollout_sharding`). Each rank decodes its rows
with the whole weights, as the JAX engine shards rows and not weights, its
sampler drawing each uniform for the whole batch and keeping its rows
(`sampler.RowShare`), and the rows are gathered: every rank returns what
one process returns, token for token.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.models.factorization import factorize_token_ids
from tpu1x_torch.models.sampler import (RowShare, generate,
                                        generate_cached_fused)
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.parallel import mesh as mesh_lib
from tpu1x_torch.serving import (DecodeEngine, prepare_serving_params,
                                 resolve_device)


def model_on(model, config: GenieConfig, device) -> STMaskGIT:
    """An `STMaskGIT` in eval mode on `device` with the weights of `model`
    (an `STMaskGIT` or its state dict); the caller's module is not moved."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    m = STMaskGIT(config, device=resolve_device(device))
    m.load_state_dict(sd)
    return m.eval()


class RolloutEngine:
    """Rollouts and policy scores of an `STMaskGIT` (or its state dict) on
    `device`.

    The serving weights are cast and laid out once
    (`prepare_serving_params`) for decode="cached"; the model itself, on the
    device, serves decode="full" and `score_policies`. On CUDA every op
    launches the port's kernels, on the CPU each takes its plain version.
    `mesh` spreads the rows of both over its ranks (every rank calls).
    """

    def __init__(self, model, config: GenieConfig, device="cuda",
                 maskgit_steps: int = 2, temperature: float = 0.0,
                 unmask_mode: str = "random", cache_dtype: str = "bf16",
                 decode: str = "cached",
                 mesh: Optional[mesh_lib.Mesh] = None):
        if decode not in ("cached", "full"):
            raise ValueError(f"decode must be 'cached' or 'full', got "
                             f"{decode!r}")
        if mesh is not None and mesh.dp * mesh.tp != mesh_lib.process_count():
            raise ValueError(f"a {mesh.dp} x {mesh.tp} mesh over "
                             f"{mesh_lib.process_count()} processes")
        self.mesh = mesh
        self.config = config
        self.maskgit_steps = maskgit_steps
        self.temperature = temperature
        self.unmask_mode = unmask_mode
        self.decode = decode
        self.engine = DecodeEngine(config, device=device,
                                   cache_dtype=cache_dtype)
        self.device = self.engine.device
        self.model = model_on(model, config, self.device)
        self.params = (prepare_serving_params(
            self.model, config, compute_dtype=self.engine.dtype,
            device=self.device) if decode == "cached" else None)

    def _rows(self, n: int) -> slice:
        """This rank's rows of a batch of n (all of them without a mesh)."""
        return slice(None) if self.mesh is None else mesh_lib.local_rows(n)

    def _gathered(self, part: torch.Tensor, rows: slice, n: int):
        """The whole batch of n rows, this rank's being `part`."""
        if self.mesh is None:
            return part
        return mesh_lib.gather_rows(part, rows, n)

    def logits_fn(self, actions_BT: Optional[torch.Tensor] = None):
        """(B, T, H, W) ids -> (B, T, S, V, F) fp32 logits of the model."""
        return functools.partial(self.model.compute_logits,
                                 actions_BT=actions_BT)

    @torch.no_grad()
    def rollout(self, prompt_tokens: torch.Tensor, num_new_frames: int,
                generator: Optional[torch.Generator] = None,
                num_futures: int = 1,
                actions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """prompt_tokens (B, P, H, W) int -> (B, K, P + new, H, W) int64.

        `generator` (on the engine's device) drives sampling and random
        unmasking; `actions` is an optional (B, T) or (B * K, T) id array.
        With a mesh, B K must split evenly over its ranks.
        """
        B, P, H, W = prompt_tokens.shape
        K = num_futures
        rows = self._rows(B * K)
        flat = prompt_tokens.to(self.device).long().repeat_interleave(
            K, dim=0).reshape(B * K, P * H * W)[rows]
        if actions is not None:
            actions = actions.to(self.device).long()
            if actions.shape[0] == B:
                actions = actions.repeat_interleave(K, dim=0)
            actions = actions[rows]
        if self.mesh is not None:
            generator = RowShare(generator, rows, B * K)
        sampling = dict(maskgit_steps=self.maskgit_steps,
                        temperature=self.temperature,
                        unmask_mode=self.unmask_mode)
        if self.decode == "full":
            tokens, _ = generate(self.logits_fn(actions), flat,
                                 num_new_frames, generator, self.config,
                                 **sampling)
        else:
            e, p = self.engine, self.params
            # the fused sampler commits only the pair decode's k/v
            tokens, _ = generate_cached_fused(
                functools.partial(e.prefill, p),
                functools.partial(e.decode_frame, p, return_kv=False),
                functools.partial(e.decode_frame_pair, p),
                flat, num_new_frames, generator, self.config,
                actions_BT=actions, **sampling)
        tokens = self._gathered(tokens, rows, B * K)
        return tokens.reshape(B, K, P + num_new_frames, H, W)

    @torch.no_grad()
    def score_policies(self, context_tokens: torch.Tensor,
                       continuation_tokens: torch.Tensor,
                       actions: Optional[torch.Tensor] = None,
                       per_frame: bool = False):
        """Score P candidate policy continuations by world-model likelihood.

        All policies share one observed context of T_ctx >= 1 frames; each
        contributes the T - T_ctx frames it would produce, and optionally
        its (P, T) action ids. The score is the teacher-forced factored
        cross-entropy (summed over the factors) averaged over the S tokens
        of each frame and over the frames at or after T_ctx only: context
        frames never enter it, and no token is masked.

        context_tokens (T_ctx, H, W), continuation_tokens (P, T - T_ctx, H,
        W) ids. Returns (P,) fp32 mean CE per policy on the device (lower:
        the world model finds that future more likely); with per_frame, also
        the (P, T - T_ctx) CE per frame.
        """
        cfg = self.config
        if context_tokens.dim() != 3:
            raise ValueError("the context is one (T_ctx, H, W) window shared "
                             "by all policies")
        T_ctx = context_tokens.shape[0]
        P, T_new = continuation_tokens.shape[:2]
        if T_ctx < 1 or T_ctx + T_new != cfg.T:
            raise ValueError(f"{T_ctx} context + {T_new} continuation frames "
                             f"!= T={cfg.T}, or no context frame")
        rows = self._rows(P)
        ctx = context_tokens.to(self.device).long()
        cont = continuation_tokens.to(self.device).long()[rows]
        windows = torch.cat([ctx.expand(cont.shape[0], *ctx.shape), cont],
                            dim=1)
        if actions is not None:
            actions = actions.to(self.device).long()[rows]
        # (P, T_new, S, V, F): the logits of the frames >= T_ctx only
        logits = self.model.compute_logits(windows, actions)[:, T_ctx:]
        targets = factorize_token_ids(cont.reshape(-1, T_new, cfg.S),
                                      cfg.num_factored_vocabs,
                                      cfg.factored_vocab_size)
        logp = F.log_softmax(logits.float(), dim=-2)
        ce = -logp.gather(-2, targets[:, :, :, None]).sum(-1)[..., 0]
        frame_ce = self._gathered(ce.mean(-1), rows, P)  # (P, T_new)
        scores = frame_ce.mean(-1)
        return (scores, frame_ce) if per_frame else scores

    def rank_policies(self, context_tokens, continuation_tokens,
                      actions=None) -> np.ndarray:
        """Policy indices, best (lowest CE) first."""
        scores = self.score_policies(context_tokens, continuation_tokens,
                                     actions)
        return torch.argsort(scores, stable=True).cpu().numpy()
