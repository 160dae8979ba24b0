"""GENIE world-model configuration, read from the same JSON files as the
JAX package (`configs/*.json`).

The port keeps its own copy of the dataclass so that it never imports the
JAX package, without the JAX package's TPU knobs (kernel choice, remat,
layer scan). Unknown JSON keys are ignored and missing keys take their
defaults, so the reference's config files and the JAX package's files both
load.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


def nth_root(x: int, n: int) -> int:
    """Integer n-th root with an exactness check."""
    root = round(x ** (1 / n))
    if root ** n != x:
        raise ValueError(f"{x} is not a perfect {n}-th power")
    return root


@dataclass
class GenieConfig:
    """ST-MaskGIT world-model configuration."""

    num_layers: int
    num_heads: int
    d_model: int
    T: int = 16  # frames
    S: int = 256  # tokens per frame (16x16 grid)
    image_vocab_size: int = 262144  # the mask token id is one past the end
    use_mup: bool = False

    # factored vocabulary: id = sum_f digit_f * V**f
    num_factored_vocabs: int = 1
    factored_vocab_size: Optional[int] = None

    # MaskGIT training corruption
    max_corrupt_rate: float = 0.2
    non_mlm_ratio: float = 0.5
    num_prompt_frames: int = 8

    # attention
    qkv_bias: bool = False
    proj_bias: bool = True
    attn_drop: float = 0.0
    qk_norm: bool = True

    # MLP
    mlp_ratio: float = 4.0
    mlp_drop: float = 0.0
    mlp_bias: bool = True
    gelu_approx: bool = False  # tanh GELU in training; exact erf otherwise

    # additive per-frame action embedding; 0 disables it
    action_vocab_size: int = 0

    # compute and parameter dtypes, by their numpy/torch names
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # muP base width (the reference's base model has d_model 256)
    mup_base_d_model: int = 256

    def __post_init__(self):
        self.factored_vocab_size = nth_root(self.image_vocab_size,
                                            self.num_factored_vocabs)

    @property
    def mask_token_id(self) -> int:
        return self.image_vocab_size

    @property
    def latent_side_len(self) -> int:
        return nth_root(self.S, 2)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def width_mult(self) -> float:
        """muP width multiplier against the base model."""
        return self.d_model / self.mup_base_d_model

    @classmethod
    def from_pretrained(cls, json_path) -> "GenieConfig":
        json_path = Path(json_path)
        if json_path.is_dir():
            json_path = json_path / "config.json"
        with open(json_path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})
