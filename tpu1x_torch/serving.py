"""KV-cached decode engine: the prefill and the per-frame decode steps of the
MaskGIT rollout, over parameters prepared once for serving.

With the bf16 cache and a pre-LN model (qk_norm off), each layer of a
decode step is two kernels: `spatial_block` (LN1, qkv, bidirectional
attention over the frame, proj, residual) and `temporal_mlp_block` (temporal
qkv, attention over the cache, proj, residual, LN2, MLP, residual), or its
pair variant, which serves the commit of the previous frame and the first
MaskGIT step of the next one from one read of the cache. The prefill runs
`spatial_block` on all prompt frames, then the temporal attention kernel,
and LN2 through the layer-norm kernel; its temporal and MLP products are
plain matrix products, as in the JAX package, where they were left to XLA.

The int8 cache (`cache_dtype="int8"`: per-token symmetric int8 k and v with
fp32 scales, half the bytes of the cache read) and the qk_norm models
(identity pre-norms, one fp32 LayerNorm over head_dim shared by q and k)
take each layer op by op, as the JAX engine does: `spatial_block` (with the
qk-LN inside it), the temporal qkv product (and the qk-LN of q and k) in
plain torch, `temporal_decode_attention` or its two-frame variant against
the stacked cache and its scales, then the proj, LN2 (`layer_norm`; identity
under qk_norm) and MLP products in plain torch. Under qk_norm the prefill's
temporal attention is the plain transposed attention.

On CUDA every op launches its kernel; on the CPU each takes its plain
version. There is no switch to the plain versions on the card.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from tpu1x_torch.config import GenieConfig
from tpu1x_torch.models.factorization import factored_embed
from tpu1x_torch.ops import (decode_attention, layernorm, spatial_block,
                             temporal_attention)
from tpu1x_torch.ops import temporal_mlp_block as tmb
from tpu1x_torch.ops._util import dense, gelu

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device) -> torch.device:
    """torch.device(device); raises if CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for, but torch sees no CUDA device; "
            "pass device='cpu' to run the plain versions")
    return device


def prepare_serving_params(model, config: GenieConfig,
                           compute_dtype=torch.bfloat16,
                           device="cuda") -> Dict[str, Any]:
    """Cast and lay out the weights once for `DecodeEngine`.

    `model` is an `STMaskGIT` or its state dict. Matmul weights become
    `compute_dtype` in (in, out) layout, contiguous; LayerNorm parameters
    (norm1/norm2 of the pre-LN models, the attentions' qk-LN `norm` of the
    qk_norm models) stay fp32. The output head keeps fp32 storage of its
    compute-dtype values, so that it runs with compute-dtype operands and
    fp32 accumulation and bias, as the JAX package's head does.
    """
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    dev = resolve_device(device)
    cd = compute_dtype

    def get(name, dtype=cd, transpose=False):
        t = sd[name].detach()
        if transpose:
            t = t.t()
        return t.to(device=dev, dtype=dtype).contiguous()

    def opt(name, dtype=cd):
        return get(name, dtype) if name in sd else None

    def attn(pre):
        a = {"wqkv": get(f"{pre}.qkv.weight", transpose=True),
             "bqkv": opt(f"{pre}.qkv.bias"),
             "wproj": get(f"{pre}.proj.weight", transpose=True),
             "bproj": opt(f"{pre}.proj.bias")}
        if f"{pre}.norm.weight" in sd:  # the qk-LN, only under qk_norm
            a["norm"] = {"scale": get(f"{pre}.norm.weight", torch.float32),
                         "bias": get(f"{pre}.norm.bias", torch.float32)}
        return a

    layers = []
    for i in range(config.num_layers):
        pre = f"decoder.layers.{i}"
        lp = {"spatial_attn": attn(f"{pre}.spatial_attn"),
              "temporal_attn": attn(f"{pre}.temporal_attn"),
              "mlp": {"wfc1": get(f"{pre}.mlp.fc1.weight", transpose=True),
                      "bfc1": opt(f"{pre}.mlp.fc1.bias"),
                      "wfc2": get(f"{pre}.mlp.fc2.weight", transpose=True),
                      "bfc2": opt(f"{pre}.mlp.fc2.bias")}}
        for norm in ("norm1", "norm2"):
            if f"{pre}.{norm}.weight" in sd:
                lp[norm] = {
                    "scale": get(f"{pre}.{norm}.weight", torch.float32),
                    "bias": get(f"{pre}.{norm}.bias", torch.float32)}
        layers.append(lp)

    p = {
        "token_embed": [get(f"token_embed.factored_embeds.{k}.weight")
                        for k in range(config.num_factored_vocabs)],
        "mask_token_embed": get("token_embed.mask_token_embed")[0],
        "pos_embed": get("pos_embed_TSC")[0],  # (T, S, C)
        "layers": layers,
        "head_w": get("out_x_proj.weight", transpose=True).float(),
        "head_b": get("out_x_proj.bias", torch.float32),
    }
    if "action_embed.weight" in sd:
        p["action_embed"] = get("action_embed.weight")
    return p


def _rows(t, B: int, device) -> torch.Tensor:
    """A frame index per batch row: int or (B,) -> contiguous int32 (B,).
    An int becomes a fill on the device: a host-to-device copy of it would
    make the host wait for the work already queued on the stream."""
    if isinstance(t, int):
        return torch.full((B,), t, dtype=torch.int32, device=device)
    t = torch.as_tensor(t, dtype=torch.int32, device=device)
    return t.reshape(-1).expand(B).contiguous()


class DecodeEngine:
    """KV-cached prefill and decode over `prepare_serving_params` output.

    Holds only configuration; parameters are passed to every call, as in the
    JAX package. Cache layout: {"k", "v"} each (T, L, B, S, C), heads flat in
    C, slots beyond the committed frames zero; in the compute dtype, or with
    cache_dtype="int8" in int8 beside {"k_scale", "v_scale"}, each
    (L, B, T, S) fp32 (1 for the empty slots).
    """

    # The op of each step of a layer: the kernel wrappers, which take their
    # plain versions on CPU tensors.
    _ops = SimpleNamespace(
        spatial_block=spatial_block.spatial_block,
        temporal_attention=temporal_attention.temporal_attention,
        layer_norm=layernorm.layer_norm,
        temporal_mlp_block=tmb.temporal_mlp_block,
        temporal_mlp_block_pair=tmb.temporal_mlp_block_pair,
        temporal_decode_attention=decode_attention.temporal_decode_attention,
        temporal_decode2_attention=decode_attention.temporal_decode2_attention,
    )

    def __init__(self, config: GenieConfig, device="cuda", compute_dtype=None,
                 gelu: Optional[str] = None, cache_dtype: str = "bf16"):
        if cache_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"cache_dtype must be 'bf16' or 'int8', got {cache_dtype!r}")
        self.config = config
        self.cache_dtype = cache_dtype
        # the fused temporal+MLP block serves the compute-dtype cache of the
        # pre-LN models; everything else runs each layer op by op
        self.block_fusion = cache_dtype == "bf16" and not config.qk_norm
        self.device = resolve_device(device)
        self.dtype = (DTYPES[config.dtype] if compute_dtype is None
                      else compute_dtype)
        # tanh GELU for bf16 serving (its error is below bf16 rounding),
        # exact erf otherwise, as the JAX engine chooses
        gelu = gelu or ("tanh" if self.dtype == torch.bfloat16 else "exact")
        if gelu not in ("tanh", "exact"):
            raise ValueError(f"gelu must be 'tanh' or 'exact', got {gelu!r}")
        self.gelu_tanh = gelu == "tanh"
        self.scale = (8.0 / config.head_dim if config.use_mup
                      else config.head_dim ** -0.5)

    # -- building blocks ----------------------------------------------------

    def _embed(self, p, tokens, t, action=None):
        """tokens (B, ..., S) at frame index t (int or (B,) for a frame, or
        a slice of frames) -> (B, ..., S, C) in the compute dtype."""
        cfg = self.config
        x = factored_embed(p["token_embed"], p["mask_token_embed"], tokens,
                           cfg.mask_token_id)
        x = x + p["pos_embed"][t]
        if action is not None and "action_embed" in p:
            # (B,) or (B, P) ids -> one embedding added to every token
            x = x + p["action_embed"][action].unsqueeze(-2)
        return x

    def _spatial_half(self, lp, x_NSC):
        sp = lp["spatial_attn"]
        n1, qk = lp.get("norm1", {}), sp.get("norm", {})  # one of the two
        return self._ops.spatial_block(
            x_NSC, sp["wqkv"], sp["wproj"], num_heads=self.config.num_heads,
            scale=self.scale, bqkv=sp["bqkv"], bproj=sp["bproj"],
            ln_scale=n1.get("scale"), ln_bias=n1.get("bias"),
            qk_ln_scale=qk.get("scale"), qk_ln_bias=qk.get("bias"))

    def _qkv(self, ap, x):
        """x (..., C) -> q, k, v, each (..., C) with heads flat: column
        thirds of one product; under qk_norm q and k go through the qk-LN,
        both in one pass (they share its parameters), and are the halves of
        one new tensor, while v is still a view of the product."""
        C = x.shape[-1]
        qkv = dense(x, ap["wqkv"], ap["bqkv"])
        if "norm" not in ap:
            return qkv.split(C, dim=-1)
        heads = qkv[..., :2 * C].reshape(*x.shape[:-1],
                                         2 * self.config.num_heads, -1)
        qk = layernorm.layer_norm_plain(heads, ap["norm"]["scale"],
                                        ap["norm"]["bias"])
        q, k = qk.reshape(*x.shape[:-1], 2 * C).split(C, dim=-1)
        return q, k, qkv[..., 2 * C:]

    def _mlp_half(self, lp, x):
        """x + mlp(norm2(x)): norm2 is the layer-norm kernel, or the
        identity under qk_norm; the products are plain."""
        mp = lp["mlp"]
        h = x
        if "norm2" in lp:
            h = self._ops.layer_norm(x, lp["norm2"]["scale"],
                                     lp["norm2"]["bias"])
        h = gelu(dense(h, mp["wfc1"], mp["bfc1"]), self.gelu_tanh)
        return x + dense(h, mp["wfc2"], mp["bfc2"])

    def _attn_kwargs(self, cache, layer, kv):
        """What both decode attention ops take beside q, k, v and t."""
        return dict(layer=layer, scale=self.scale,
                    num_heads=self.config.num_heads,
                    k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                    kv_out=None if kv is None else (kv[0][0, layer],
                                                    kv[1][0, layer]))

    def _block_weights(self, lp):
        tp, mp, n2 = lp["temporal_attn"], lp["mlp"], lp["norm2"]
        return dict(wqkv=tp["wqkv"], bqkv=tp["bqkv"], wproj=tp["wproj"],
                    bproj=tp["bproj"], ln_scale=n2["scale"],
                    ln_bias=n2["bias"], wfc1=mp["wfc1"], bfc1=mp["bfc1"],
                    wfc2=mp["wfc2"], bfc2=mp["bfc2"], scale=self.scale,
                    num_heads=self.config.num_heads,
                    gelu_tanh=self.gelu_tanh)

    def _head(self, p, x):
        """compute-dtype operands, fp32 accumulation and bias ->
        (B, S, V, F) fp32 logits."""
        cfg = self.config
        if cfg.use_mup:
            x = x / cfg.width_mult
        y = torch.addmm(p["head_b"], x.reshape(-1, cfg.d_model).float(),
                        p["head_w"])
        B, S = x.shape[:2]
        return y.reshape(B, S, cfg.num_factored_vocabs,
                         cfg.factored_vocab_size).transpose(-1, -2)

    # -- public API ----------------------------------------------------------

    def prefill(self, params, tokens_BPHW: torch.Tensor,
                actions_BP: Optional[torch.Tensor] = None):
        """Build the cache from P committed frames (B, P, H, W)."""
        cfg = self.config
        B, P, H, W = tokens_BPHW.shape
        S, C, L = H * W, cfg.d_model, cfg.num_layers
        x = self._embed(params, tokens_BPHW.reshape(B, P, S), slice(0, P),
                        actions_BP)
        int8 = self.cache_dtype == "int8"
        cache = {key: torch.zeros(cfg.T, L, B, S, C, device=x.device,
                                  dtype=torch.int8 if int8 else self.dtype)
                 for key in ("k", "v")}
        if int8:
            for key in ("k_scale", "v_scale"):
                cache[key] = torch.ones(L, B, cfg.T, S, dtype=torch.float32,
                                        device=x.device)
        for layer, lp in enumerate(params["layers"]):
            x = self._spatial_half(lp, x.reshape(B * P, S, C)).reshape(
                B, P, S, C)
            tp = lp["temporal_attn"]
            q, k, v = self._qkv(tp, x)
            # under qk_norm the plain transposed attention, as in the JAX
            # engine; else the temporal attention op
            attend = (temporal_attention.temporal_attention_plain
                      if cfg.qk_norm else self._ops.temporal_attention)
            out = attend(q, k, v, scale=self.scale, num_heads=cfg.num_heads)
            x = x + dense(out, tp["wproj"], tp["bproj"])
            x = self._mlp_half(lp, x)
            for key, cur in (("k", k), ("v", v)):
                if int8:
                    cur, scale = decode_attention.quantize_kv(cur)
                    cache[key + "_scale"][layer, :, :P] = scale  # (B, P, S)
                cache[key][:P, layer] = cur.transpose(0, 1)
        return cache

    def _kv_stack(self, B: int, S: int, device):
        """Empty (1, L, B, S, C) k and v, which each layer's block writes
        into at [0, layer]."""
        cfg = self.config
        k = torch.empty(1, cfg.num_layers, B, S, cfg.d_model,
                        dtype=self.dtype, device=device)
        return k, torch.empty_like(k)

    def decode_frame(self, params, frame_tokens_BS: torch.Tensor, t_B,
                     cache: Dict[str, torch.Tensor],
                     action_B: Optional[torch.Tensor] = None,
                     return_kv: bool = True
                     ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor,
                                                             ...]]]:
        """Logits of one frame against the cache.

        Returns (logits (B, S, V, F) fp32, (k_cur, v_cur) each
        (1, L, B, S, C) in the compute dtype); with return_kv=False, the
        frame's k/v are neither written nor returned (None), for callers
        that only sample.
        """
        B, S = frame_tokens_BS.shape
        t_B = _rows(t_B, B, frame_tokens_BS.device)
        x = self._embed(params, frame_tokens_BS, t_B.long(), action_B)
        kv = self._kv_stack(B, S, x.device) if return_kv else None
        for layer, lp in enumerate(params["layers"]):
            x = self._spatial_half(lp, x)
            if self.block_fusion:
                x, _, _ = self._ops.temporal_mlp_block(
                    x, cache["k"], cache["v"], t_B, layer=layer,
                    kv_out=None if kv is None else (kv[0][0, layer],
                                                    kv[1][0, layer]),
                    return_kv=return_kv, **self._block_weights(lp))
                continue
            tp = lp["temporal_attn"]
            q, k, v = self._qkv(tp, x)
            out = self._ops.temporal_decode_attention(
                q, cache["k"], cache["v"], k, v, t_B,
                **self._attn_kwargs(cache, layer, kv))
            x = x + dense(out, tp["wproj"], tp["bproj"])
            x = self._mlp_half(lp, x)
        return self._head(params, x), kv

    def decode_frame_pair(self, params, prev_tokens_BS: torch.Tensor,
                          cur_tokens_BS: torch.Tensor, t_prev_B,
                          cache: Dict[str, torch.Tensor], action_prev=None,
                          action_cur=None):
        """The commit pass of frame t_prev's final tokens fused with the
        first MaskGIT step of frame t_prev + 1: one read of the cache and the
        weights serves both.

        Returns (logits_cur (B, S, V, F) fp32, (k_prev, v_prev) each
        (1, L, B, S, C) in the compute dtype); the caller commits them at
        slot t_prev.
        """
        cfg = self.config
        B, S = prev_tokens_BS.shape
        C = cfg.d_model
        t_prev = _rows(t_prev_B, B, prev_tokens_BS.device)
        frames = [
            self._embed(params, prev_tokens_BS, t_prev.long(), action_prev),
            self._embed(params, cur_tokens_BS, t_prev.long() + 1, action_cur)]
        kv = self._kv_stack(B, S, frames[0].device)
        if self.block_fusion:
            z = torch.stack(frames, dim=1)  # (B, 2, S, C): [prev, cur] per row
            for layer, lp in enumerate(params["layers"]):
                z = self._spatial_half(lp, z.reshape(2 * B, S, C))
                z, _, _ = self._ops.temporal_mlp_block_pair(
                    z.reshape(B, 2, S, C), cache["k"], cache["v"], t_prev,
                    layer=layer, kv_out=(kv[0][0, layer], kv[1][0, layer]),
                    **self._block_weights(lp))
            return self._head(params, z[:, 1]), kv
        z = torch.cat(frames, dim=0)  # (2B, S, C): prev rows, then cur rows
        for layer, lp in enumerate(params["layers"]):
            z = self._spatial_half(lp, z)
            tp = lp["temporal_attn"]
            q, k, v = self._qkv(tp, z)
            out = torch.empty_like(z)
            self._ops.temporal_decode2_attention(
                q[:B], q[B:], cache["k"], cache["v"], k[:B], v[:B], k[B:],
                v[B:], t_prev, out=(out[:B], out[B:]),
                **self._attn_kwargs(cache, layer, kv))
            z = z + dense(out, tp["wproj"], tp["bproj"])
            z = self._mlp_half(lp, z)
        return self._head(params, z[B:]), kv
