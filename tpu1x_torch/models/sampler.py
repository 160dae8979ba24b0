"""MaskGIT sampling over the KV-cached decode.

The same contract as the JAX package's sampler (tpu1x/models/sampler.py):
- temperature <= 1e-8 is greedy (argmax per factored digit); otherwise each
  digit is drawn from softmax(logits);
- after every step but the last, the n(step) = ceil(cos((step+1)/steps *
  pi/2) * S) least confident tokens that were not already committed are
  masked again; the ranking is a double *stable* argsort, as jnp.argsort;
- "greedy" unmask mode ranks by the product of the chosen digits'
  probabilities, "random" by uniform draws;
- returned logits are each frame's step-0 logits.

`maskgit_generate` and `generate` are the uncached sampler: every step runs
the whole (B, T) sequence through a `logits_fn` such as
`STMaskGIT.compute_logits`; `out_t` may differ from row to row, which lets
the evaluator decode all frame tasks of an example as batch rows. The cached
samplers decode one frame against the KV cache of `DecodeEngine`.

Randomness comes from one explicit `torch.Generator`; it cannot reproduce
`jax.random`, so only greedy sampling with greedy unmasking is comparable
token for token between the two packages. Every draw is a uniform per row
(a digit by inverse transform of its cumulative probabilities), so that a
rank decoding rows [a, b) of a batch spread over ranks (`RowShare`) draws
each uniform for the whole batch and keeps its rows: the result is the
one-process result, token for token. Python loops take the place of
`lax.scan`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.models.st_maskgit import cosine_schedule, update_cache


@dataclass
class RowShare:
    """A generator that draws for rows `rows` of a batch of `total` rows:
    each draw is made for the whole batch and sliced to those rows. Pass it
    wherever a sampler takes a generator."""
    generator: Optional[torch.Generator]
    rows: slice
    total: int


def _uniform(generator, shape, device) -> torch.Tensor:
    """Uniform [0, 1) draws of `shape` (rows first) from `generator` (a
    `torch.Generator`, a `RowShare` or None)."""
    if isinstance(generator, RowShare):
        whole = torch.rand((generator.total, *shape[1:]),
                           generator=generator.generator, device=device)
        return whole[generator.rows]
    return torch.rand(shape, generator=generator, device=device)


def n_per_step(config: GenieConfig, maskgit_steps: int):
    """Tokens masked again after each step but the last:
    ceil(cos((step + 1) / steps * pi / 2) * S)."""
    return [math.ceil(cosine_schedule((s + 1) / maskgit_steps) * config.S)
            for s in range(maskgit_steps - 1)]


def _sample_frame(frame_logits_BSVF: torch.Tensor,
                  generator: Optional[torch.Generator], temperature: float,
                  factored_vocab_size: int):
    """Sample each factored digit; return (ids (B, S) int64, confidences
    (B, S) fp32), the confidence being the product of the digits' probs."""
    V = factored_vocab_size
    B, S, _, F = frame_logits_BSVF.shape
    logits = frame_logits_BSVF.float()
    probs = torch.softmax(logits, dim=-2)
    samples = torch.zeros(B, S, dtype=torch.long, device=logits.device)
    conf = torch.ones(B, S, dtype=torch.float32, device=logits.device)
    for f in range(F):
        if temperature <= 1e-8:
            digit = logits[..., f].argmax(-1)
        else:  # the first digit whose cumulative probability passes u
            u = _uniform(generator, (B, S), logits.device)
            cdf = probs[..., f].cumsum(-1)
            digit = (cdf <= u[..., None]).sum(-1).clamp(max=V - 1)
        samples = samples + digit * V ** f
        conf = conf * probs[..., f].gather(-1, digit[..., None])[..., 0]
    return samples, conf


def _frame_update(frame_BS, unmasked_BS, frame_logits_BSVF, step: int,
                  maskgit_steps: int, n_steps, generator, config: GenieConfig,
                  temperature: float, unmask_mode: str):
    """One MaskGIT step on one frame's state -> (frame, unmasked)."""
    B, S = frame_BS.shape
    samples, conf = _sample_frame(frame_logits_BSVF, generator, temperature,
                                  config.factored_vocab_size)
    prev_unmasked = unmasked_BS
    if step != maskgit_steps - 1:
        if unmask_mode == "random":
            conf = _uniform(generator, (B, S), conf.device)
        conf = torch.where(unmasked_BS, torch.full_like(conf, float("inf")),
                           conf)
        order = torch.argsort(conf, dim=1, stable=True)
        ranks = torch.argsort(order, dim=1, stable=True)
        to_mask = ranks < n_steps[step]
        samples = torch.where(to_mask, torch.full_like(samples,
                                                       config.mask_token_id),
                              samples)
        unmasked_BS = ~to_mask
    samples = torch.where(prev_unmasked, frame_BS, samples)
    return samples, unmasked_BS


def _ref_layout(logits_BSVF, config: GenieConfig):
    """(B, S, V, F) -> the reference's (B, V, F, h, w)."""
    B, S, V, F = logits_BSVF.shape
    h = w = config.latent_side_len
    return logits_BSVF.permute(0, 2, 3, 1).reshape(B, V, F, h, w)


def _with_action(decode_fn, action_B):
    if action_B is None:
        return decode_fn
    return lambda f, t, c: decode_fn(f, t, c, action_B=action_B)


def maskgit_generate_cached(decode_fn, cache, out_t, generator,
                            config: GenieConfig, maskgit_steps: int = 2,
                            temperature: float = 0.0,
                            unmask_mode: str = "random",
                            batch_size: Optional[int] = None, action_B=None):
    """Decode frame `out_t` against the cache in `maskgit_steps` steps.

    decode_fn: (frame_tokens_BS, t_B, cache[, action_B]) ->
        (logits_BSVF, kv_cur), e.g. `DecodeEngine.decode_frame` bound to its
        params.
    Returns (frame (B, S), step-0 logits (B, V, F, h, w), kv_cur of the last
    step).
    """
    if unmask_mode not in ("greedy", "random"):
        raise ValueError(f"unmask_mode {unmask_mode!r}")
    B = cache["k"].shape[2] if batch_size is None else batch_size
    S = config.S
    dev = cache["k"].device
    n_steps = n_per_step(config, maskgit_steps)
    frame = torch.full((B, S), config.mask_token_id, dtype=torch.long,
                       device=dev)
    unmasked = torch.zeros(B, S, dtype=torch.bool, device=dev)
    decode = _with_action(decode_fn, action_B)
    orig_logits = kv_cur = None
    for step in range(maskgit_steps):
        logits, kv_cur = decode(frame, out_t, cache)
        if step == 0:
            orig_logits = logits
        frame, unmasked = _frame_update(frame, unmasked, logits, step,
                                        maskgit_steps, n_steps, generator,
                                        config, temperature, unmask_mode)
    return frame, _ref_layout(orig_logits, config), kv_cur


def _prompt(input_ids_BN, num_new_frames, config):
    B = input_ids_BN.shape[0]
    P = input_ids_BN.shape[1] // config.S
    if P + num_new_frames != config.T:
        raise ValueError(f"{P} prompt + {num_new_frames} new frames != "
                         f"T={config.T}")
    h = w = config.latent_side_len
    return input_ids_BN.long().reshape(B, P, h, w), P


def _action_at(actions_BT, t):
    return None if actions_BT is None else actions_BT[:, t]


def _finish(input_ids_BN, frames, logit_frames):
    B = input_ids_BN.shape[0]
    tokens = torch.cat([input_ids_BN.long(),
                        torch.stack(frames, dim=1).reshape(B, -1)], dim=1)
    return tokens, torch.stack(logit_frames, dim=3)


def generate_cached(prefill_fn, decode_fn, input_ids_BN: torch.Tensor,
                    num_new_frames: int, generator, config: GenieConfig,
                    maskgit_steps: int = 2, temperature: float = 0.0,
                    unmask_mode: str = "random", actions_BT=None):
    """KV-cached autoregressive rollout: per new frame, `maskgit_steps`
    decodes, then one decode of the final tokens whose k/v are committed.

    input_ids_BN: (B, P * S) prompt ids. Returns (tokens (B, T * S) int64,
    step-0 logits (B, V, F, num_new_frames, h, w) fp32).
    """
    prompt, P = _prompt(input_ids_BN, num_new_frames, config)
    B = prompt.shape[0]
    cache = (prefill_fn(prompt) if actions_BT is None
             else prefill_fn(prompt, actions_BT[:, :P]))
    frames, logit_frames = [], []
    for t in range(P, config.T):
        action_B = _action_at(actions_BT, t)
        frame, flogits, _ = maskgit_generate_cached(
            decode_fn, cache, t, generator, config,
            maskgit_steps=maskgit_steps, temperature=temperature,
            unmask_mode=unmask_mode, batch_size=B, action_B=action_B)
        _, kv_cur = _with_action(decode_fn, action_B)(frame, t, cache)
        update_cache(cache, kv_cur, t)
        frames.append(frame)
        logit_frames.append(flogits)
    return _finish(input_ids_BN, frames, logit_frames)


def generate_cached_fused(prefill_fn, decode_fn, decode_pair_fn,
                          input_ids_BN: torch.Tensor, num_new_frames: int,
                          generator, config: GenieConfig,
                          maskgit_steps: int = 2, temperature: float = 0.0,
                          unmask_mode: str = "random", actions_BT=None):
    """`generate_cached` with each frame's commit pass fused into the next
    frame's step-0 decode (`DecodeEngine.decode_frame_pair`): the cache is
    read `maskgit_steps` times per frame instead of `maskgit_steps + 1`, and
    the last frame is never committed (nothing reads it). The same tokens as
    `generate_cached` for greedy sampling.

    decode_pair_fn: (prev_BS, cur_BS, t_prev_B, cache[, action_prev,
        action_cur]) -> (logits_cur (B, S, V, F), kv_prev).
    """
    if num_new_frames < 1:
        raise ValueError("num_new_frames must be >= 1")
    prompt, P = _prompt(input_ids_BN, num_new_frames, config)
    B, S = prompt.shape[0], config.S
    n_steps = n_per_step(config, maskgit_steps)
    cache = (prefill_fn(prompt) if actions_BT is None
             else prefill_fn(prompt, actions_BT[:, :P]))
    masked = torch.full((B, S), config.mask_token_id, dtype=torch.long,
                        device=prompt.device)

    def sample_frame(logits0, t):
        """The MaskGIT steps of frame t, given its step-0 logits."""
        unmasked = torch.zeros(B, S, dtype=torch.bool, device=prompt.device)
        frame, unmasked = _frame_update(masked, unmasked, logits0, 0,
                                        maskgit_steps, n_steps, generator,
                                        config, temperature, unmask_mode)
        decode = _with_action(decode_fn, _action_at(actions_BT, t))
        for step in range(1, maskgit_steps):
            logits, _ = decode(frame, t, cache)
            frame, unmasked = _frame_update(frame, unmasked, logits, step,
                                            maskgit_steps, n_steps, generator,
                                            config, temperature, unmask_mode)
        return frame

    # the first new frame: a plain step-0 decode (its predecessor's k/v came
    # from the prefill), and no commit of its own yet
    logits0, _ = _with_action(decode_fn, _action_at(actions_BT, P))(
        masked, P, cache)
    frames = [sample_frame(logits0, P)]
    logit_frames = [_ref_layout(logits0, config)]
    for t in range(P + 1, config.T):
        kw = {}
        if actions_BT is not None:
            kw = dict(action_prev=actions_BT[:, t - 1],
                      action_cur=actions_BT[:, t])
        logits0, kv_prev = decode_pair_fn(frames[-1], masked, t - 1, cache,
                                          **kw)
        update_cache(cache, kv_prev, t - 1)
        frames.append(sample_frame(logits0, t))
        logit_frames.append(_ref_layout(logits0, config))
    return _finish(input_ids_BN, frames, logit_frames)


def maskgit_generate(logits_fn, prompt_BTHW: torch.Tensor, out_t, generator,
                     config: GenieConfig, maskgit_steps: int = 2,
                     temperature: float = 0.0, unmask_mode: str = "random"):
    """Predict frame `out_t` of each row with `maskgit_steps` full forwards.

    logits_fn: (B, T, H, W) ids -> (B, T, S, V, F) logits.
    prompt_BTHW: (B, T, H, W) ids; frames at or after a row's out_t must be
        fully masked.
    out_t: int or (B,) ints, each row's target frame (>= 1).
    Returns (sample (B, H, W) int64, step-0 logits (B, V, F, H, W) fp32).
    """
    if unmask_mode not in ("greedy", "random"):
        raise ValueError(f"unmask_mode {unmask_mode!r}")
    B, T, H, W = prompt_BTHW.shape
    S = H * W
    dev = prompt_BTHW.device
    rows = torch.arange(B, device=dev)
    out_t = torch.as_tensor(out_t, dtype=torch.long, device=dev).expand(B)
    n_steps = n_per_step(config, maskgit_steps)
    tokens = prompt_BTHW.long().clone()
    unmasked = torch.zeros(B, S, dtype=torch.bool, device=dev)
    orig_logits = None
    for step in range(maskgit_steps):
        frame_logits = logits_fn(tokens)[rows, out_t]  # (B, S, V, F)
        if step == 0:
            orig_logits = frame_logits
        frame, unmasked = _frame_update(
            tokens[rows, out_t].reshape(B, S), unmasked, frame_logits, step,
            maskgit_steps, n_steps, generator, config, temperature,
            unmask_mode)
        tokens[rows, out_t] = frame.reshape(B, H, W)
    return tokens[rows, out_t], _ref_layout(orig_logits, config)


def generate(logits_fn, input_ids_BN: torch.Tensor, num_new_frames: int,
             generator, config: GenieConfig, maskgit_steps: int = 2,
             temperature: float = 0.0, unmask_mode: str = "random"):
    """Uncached autoregressive rollout: each new frame by
    `maskgit_generate` over the whole sequence, the frames after it masked.

    input_ids_BN: (B, P * S) prompt ids. Returns (tokens (B, T * S) int64,
    step-0 logits (B, V, F, num_new_frames, h, w) fp32).
    """
    prompt, P = _prompt(input_ids_BN, num_new_frames, config)
    B, _, h, w = prompt.shape
    tokens = torch.cat([prompt, torch.full(
        (B, num_new_frames, h, w), config.mask_token_id, dtype=torch.long,
        device=prompt.device)], dim=1)
    logit_frames = []
    for t in range(P, config.T):
        sample, flogits = maskgit_generate(
            logits_fn, tokens, t, generator, config,
            maskgit_steps=maskgit_steps, temperature=temperature,
            unmask_mode=unmask_mode)
        tokens[:, t] = sample
        logit_frames.append(flogits)
    return tokens.reshape(B, -1), torch.stack(logit_frames, dim=3)
