"""Batched world-model rollouts: K imagined futures per prompt, decoded with
the KV-cached, fused-commit MaskGIT sampler over `DecodeEngine`.

`cache_dtype="int8"` keeps the KV cache in per-token int8 with fp32 scales
(half the bytes of the cache read); `DecodeEngine` then runs each layer op
by op, as it does for the qk_norm models.

`score_policies`, `rank_policies` and the JAX package's uncached
decode="full" are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.models.sampler import generate_cached_fused
from tpu1x_torch.serving import DecodeEngine, prepare_serving_params


class RolloutEngine:
    """Rollouts of an `STMaskGIT` (or its state dict) on `device`.

    The weights are cast and laid out once (`prepare_serving_params`); every
    decode runs the port's kernels on CUDA and their plain versions on the
    CPU.
    """

    def __init__(self, model, config: GenieConfig, device="cuda",
                 maskgit_steps: int = 2, temperature: float = 0.0,
                 unmask_mode: str = "random", cache_dtype: str = "bf16"):
        self.config = config
        self.maskgit_steps = maskgit_steps
        self.temperature = temperature
        self.unmask_mode = unmask_mode
        self.engine = DecodeEngine(config, device=device,
                                   cache_dtype=cache_dtype)
        self.device = self.engine.device
        self.params = prepare_serving_params(
            model, config, compute_dtype=self.engine.dtype, device=self.device)

    @torch.no_grad()
    def rollout(self, prompt_tokens: torch.Tensor, num_new_frames: int,
                generator: Optional[torch.Generator] = None,
                num_futures: int = 1,
                actions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """prompt_tokens (B, P, H, W) int -> (B, K, P + new, H, W) int64.

        `generator` (on the engine's device) drives sampling and random
        unmasking; `actions` is an optional (B, T) or (B * K, T) id array.
        """
        B, P, H, W = prompt_tokens.shape
        K = num_futures
        flat = prompt_tokens.to(self.device).long().repeat_interleave(
            K, dim=0).reshape(B * K, P * H * W)
        if actions is not None:
            actions = actions.to(self.device).long()
            if actions.shape[0] == B:
                actions = actions.repeat_interleave(K, dim=0)
        e, p = self.engine, self.params
        # the fused sampler commits only the pair decode's k/v
        tokens, _ = generate_cached_fused(
            functools.partial(e.prefill, p),
            functools.partial(e.decode_frame, p, return_kv=False),
            functools.partial(e.decode_frame_pair, p),
            flat, num_new_frames, generator, self.config,
            maskgit_steps=self.maskgit_steps, temperature=self.temperature,
            unmask_mode=self.unmask_mode, actions_BT=actions)
        return tokens.reshape(B, K, P + num_new_frames, H, W)
