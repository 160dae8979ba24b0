"""Checkpoint helpers of the JAX package's `tpu1x/utils/misc.py`.

- `convert_lightning_checkpoint`: a Lightning-era GENIE state dict -> one
  that `train/checkpoint.py` reads (the `model.` prefix stripped, the
  Lightning bookkeeping entries dropped).
- `count_params`, re-exported.
"""

from __future__ import annotations

from typing import Any, Dict

from tpu1x_torch.models.st_maskgit import count_params  # noqa: F401

_BOOKKEEPING = ("epoch", "global_step", "optimizer_states", "lr_schedulers",
                "callbacks", "loops", "state_dict")


def convert_lightning_checkpoint(state_dict: Dict[str, Any]
                                 ) -> Dict[str, Any]:
    """Strip the Lightning `model.` prefix; drop undotted keys and those
    under Lightning's bookkeeping names."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("model."):
            out[key[len("model."):]] = value
        elif "." in key and key.split(".")[0] not in _BOOKKEEPING:
            out[key] = value
    return out
