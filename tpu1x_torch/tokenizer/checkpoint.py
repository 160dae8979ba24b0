"""Tokenizer checkpoints: the JAX package's format, and the reference's
MAGVIT2 Lightning checkpoint.

- `save_tokenizer` / `load_tokenizer`: a directory of `vq_config.json` and
  `tokenizer.msgpack` (the flax parameter tree in flax's msgpack layout,
  through the port's own codec), which both packages read and write; a
  `.ckpt` path is a reference Lightning checkpoint.
- `convert_magvit2_state_dict`: the reference's state dict -> the port's,
  which has the reference's names, so the conversion only selects the
  model's keys (the quantizer's buffers and anything else are dropped) and
  widens them to fp32.
- `load_magvit2_checkpoint`: prefers the EMA weights where the checkpoint
  has them (`model_ema.<name without dots>`, LitEma's naming; the
  reference evaluates under `ema_scope`), drops the `loss.` and `lpips.`
  entries.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple, Union

import torch
import torch.nn as nn

from tpu1x_torch.config import VQConfig
from tpu1x_torch.tokenizer.vqmodel import VQModel
from tpu1x_torch.train.checkpoint import read_flax_msgpack, write_flax_msgpack
from tpu1x_torch.weights import vq_params_from_jax, vq_params_to_jax


def save_tokenizer(save_dir, model: Union[nn.Module, Dict[str, torch.Tensor]],
                   config: VQConfig) -> None:
    """Write `vq_config.json` and `tokenizer.msgpack` for a `VQModel` or
    its state dict."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    config.save_pretrained(save_dir / "vq_config.json")
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    write_flax_msgpack(save_dir / "tokenizer.msgpack",
                       vq_params_to_jax(sd, config))


def load_tokenizer(path) -> Tuple[Dict[str, torch.Tensor], VQConfig]:
    """A `save_tokenizer` directory (either package's) or a reference
    `.ckpt` (at the default `VQConfig`) -> (fp32 state dict on the CPU,
    config)."""
    path = Path(path)
    if path.is_file() and path.suffix == ".ckpt":
        config = VQConfig()
        return load_magvit2_checkpoint(path, config), config
    config = VQConfig.from_pretrained(path / "vq_config.json")
    tree = read_flax_msgpack(path / "tokenizer.msgpack")
    if "params" in tree:
        tree = tree["params"]
    return vq_params_from_jax(tree, config), config


def convert_magvit2_state_dict(state_dict, config: VQConfig
                               ) -> Dict[str, torch.Tensor]:
    """The reference VQModel's state dict -> the port's: its encoder and
    decoder entries, fp32 on the CPU. Raises KeyError on a missing one."""
    with torch.device("meta"):  # the names alone, no memory
        names = list(VQModel(config).state_dict())
    return {k: torch.as_tensor(state_dict[k]).detach().cpu().float()
            for k in names}


def load_magvit2_checkpoint(path, config: VQConfig,
                            use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The reference's `magvit2.ckpt` (Lightning) -> the port's state
    dict, the EMA weights where present."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = dict(raw.get("state_dict", raw))
    if use_ema and any(k.startswith("model_ema.") for k in sd):
        sd = {k: sd.get("model_ema." + k.replace(".", ""), v)
              for k, v in sd.items()
              if not k.startswith(("model_ema.", "loss.", "lpips."))}
    return convert_magvit2_state_dict(sd, config)
