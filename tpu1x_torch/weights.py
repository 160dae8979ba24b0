"""Carry weights between the JAX package's parameter tree and the port.

`params_from_jax` is the counterpart of the JAX package's checkpoint
conversion (tpu1x/train/checkpoint.py, `convert_to_torch_state_dict`): it
takes the flax tree as nested dicts of arrays (numpy, or anything
`numpy.asarray` reads) in either layer layout, and returns a state dict with
the reference's names that `STMaskGIT.load_state_dict` takes.
The mapping is linear (transposes and unstacking), so it also carries a tree
shaped like the params (gradients, Adam moments) to the names of
`STMaskGIT.named_parameters()`. `params_to_jax` is its inverse.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from tpu1x_torch.config import GenieConfig


def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float32, copy=True)


def params_from_jax(params: Mapping[str, Any],
                    config: GenieConfig) -> Dict[str, torch.Tensor]:
    """Flax params -> reference-named fp32 torch state dict.

    Scan layout stacks every layer's leaves under `decoder/layers` (leading
    axis L); unrolled layout keeps `decoder/layers_{i}`. Dense kernels are
    (in, out) in flax and (out, in) in torch, so they are transposed.
    """
    sd: Dict[str, np.ndarray] = {}
    sd["pos_embed_TSC"] = _np(params["pos_embed_TSC"])
    te = params["token_embed"]
    sd["token_embed.mask_token_embed"] = _np(te["mask_token_embed"])[None]
    for k in range(config.num_factored_vocabs):
        sd[f"token_embed.factored_embeds.{k}.weight"] = _np(
            te[f"factored_embeds_{k}"]["embedding"])
    sd["out_x_proj.weight"] = _np(params["out_x_proj"]["kernel"]).T
    sd["out_x_proj.bias"] = _np(params["out_x_proj"]["bias"])
    if "action_embed" in params:
        sd["action_embed.weight"] = _np(params["action_embed"]["embedding"])

    decoder = params["decoder"]
    if "layers" in decoder:
        stacked = decoder["layers"]

        def layer(i, tree=stacked):
            return {k: layer(i, v) if isinstance(v, Mapping) else v[i]
                    for k, v in tree.items()}
    else:
        def layer(i):
            return decoder[f"layers_{i}"]

    def linear(prefix: str, p) -> None:
        sd[f"{prefix}.weight"] = _np(p["kernel"]).T
        if "bias" in p:
            sd[f"{prefix}.bias"] = _np(p["bias"])

    def norm(prefix: str, p) -> None:
        sd[f"{prefix}.weight"] = _np(p["scale"])
        sd[f"{prefix}.bias"] = _np(p["bias"])

    for i in range(config.num_layers):
        lp = layer(i)
        pre = f"decoder.layers.{i}"
        for name in ("spatial_attn", "temporal_attn"):
            linear(f"{pre}.{name}.qkv", lp[name]["qkv"])
            linear(f"{pre}.{name}.proj", lp[name]["proj"])
            if "norm" in lp[name]:
                norm(f"{pre}.{name}.norm", lp[name]["norm"])
        for name in ("norm1", "norm2"):
            if name in lp:
                norm(f"{pre}.{name}", lp[name])
        linear(f"{pre}.mlp.fc1", lp["mlp"]["fc1"])
        linear(f"{pre}.mlp.fc2", lp["mlp"]["fc2"])
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}



def params_to_jax(state_dict: Mapping[str, torch.Tensor],
                  config: GenieConfig) -> Dict[str, Any]:
    """Reference-named state dict -> the flax parameter tree of the JAX
    model, nested dicts of fp32 numpy arrays, in the layer layout that
    `config.scan_layers` names (stacked under `decoder/layers`, or
    `decoder/layers_{i}`); the inverse of `params_from_jax`."""
    sd = {k: np.ascontiguousarray(v.detach().cpu().float().numpy())
          for k, v in state_dict.items()}

    def linear(prefix: str) -> Dict[str, np.ndarray]:
        out = {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
        if f"{prefix}.bias" in sd:
            out["bias"] = sd[f"{prefix}.bias"]
        return out

    def norm(prefix: str) -> Dict[str, np.ndarray]:
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    te: Dict[str, Any] = {
        "mask_token_embed": sd["token_embed.mask_token_embed"][0]}
    for k in range(config.num_factored_vocabs):
        te[f"factored_embeds_{k}"] = {
            "embedding": sd[f"token_embed.factored_embeds.{k}.weight"]}
    params: Dict[str, Any] = {"pos_embed_TSC": sd["pos_embed_TSC"],
                              "token_embed": te,
                              "out_x_proj": linear("out_x_proj")}
    if "action_embed.weight" in sd:
        params["action_embed"] = {"embedding": sd["action_embed.weight"]}

    def layer(i: int) -> Dict[str, Any]:
        pre = f"decoder.layers.{i}"
        out: Dict[str, Any] = {}
        for name in ("spatial_attn", "temporal_attn"):
            out[name] = {"qkv": linear(f"{pre}.{name}.qkv"),
                         "proj": linear(f"{pre}.{name}.proj")}
            if f"{pre}.{name}.norm.weight" in sd:
                out[name]["norm"] = norm(f"{pre}.{name}.norm")
        for name in ("norm1", "norm2"):
            if f"{pre}.{name}.weight" in sd:
                out[name] = norm(f"{pre}.{name}")
        out["mlp"] = {"fc1": linear(f"{pre}.mlp.fc1"),
                      "fc2": linear(f"{pre}.mlp.fc2")}
        return out

    layers = [layer(i) for i in range(config.num_layers)]
    if config.scan_layers:
        def stack(*trees):
            if isinstance(trees[0], dict):
                return {k: stack(*(t[k] for t in trees)) for k in trees[0]}
            return np.stack(trees)
        params["decoder"] = {"layers": stack(*layers)}
    else:
        params["decoder"] = {f"layers_{i}": lp for i, lp in enumerate(layers)}
    return params
