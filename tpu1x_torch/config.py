"""GENIE world-model and MAGVIT2 tokenizer configurations, read from the
same JSON files as the JAX package (`configs/*.json`, `vq_config.json`).

The port keeps its own copy of the dataclass so that it never imports the
JAX package, without the JAX package's kernel choice (`attn_impl`: the card
always takes the port's kernels). Unknown JSON keys are ignored and missing
keys take their defaults, so the reference's config files and the JAX
package's files both load, and `save_pretrained` writes a file that both
packages read.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple


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

    # per-block recompute in training (models/st_transformer.py); the policy
    # names what a block keeps for its backward: "none", "attn_outs" (the
    # attention outputs), "dots" (every product's output) or
    # "dots_no_batch" (the weight products' outputs), as in the JAX package
    remat: bool = True
    remat_policy: str = "attn_outs"
    # the layer layout of an exported params.msgpack: stacked under
    # decoder/layers (the JAX package's lax.scan) or decoder/layers_{i}
    scan_layers: bool = True

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

    def save_pretrained(self, json_path) -> None:
        """Write the config as JSON, to `json_path` or to
        `json_path/config.json` for a directory."""
        json_path = Path(json_path)
        if json_path.is_dir() or json_path.suffix != ".json":
            json_path.mkdir(parents=True, exist_ok=True)
            json_path = json_path / "config.json"
        with open(json_path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_pretrained(cls, json_path) -> "GenieConfig":
        json_path = Path(json_path)
        if json_path.is_dir():
            json_path = json_path / "config.json"
        with open(json_path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


@dataclass
class VQConfig:
    """Open-MAGVIT2 LFQ tokenizer configuration: the JAX package's fields and
    defaults (the reference's `magvit2/config.py:9-55`). The port serves
    the tokenizer (encode, decode, LPIPS); the loss and EMA fields are kept
    so that a `vq_config.json` round-trips between the packages."""

    # architecture
    resolution: int = 256
    in_channels: int = 3
    out_channels: int = 3
    base_channels: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)  # 16x downsample: 256 -> 16
    num_res_blocks: int = 2
    z_channels: int = 18  # log2(codebook_size)
    codebook_size: int = 262144

    # quantizer / losses
    entropy_loss_weight: float = 0.1
    commit_loss_weight: float = 0.25
    entropy_temperature: float = 0.01
    token_factorization: bool = False

    # GAN loss
    disc_start: int = 0
    disc_weight: float = 0.8
    disc_num_layers: int = 3
    disc_in_channels: int = 3
    disc_loss: str = "hinge"  # "hinge" | "vanilla" | "non_saturate"
    use_actnorm: bool = False
    gen_loss_weight: Optional[float] = None  # None -> adaptive weight
    lecam_weight: float = 0.005
    perceptual_weight: float = 1.0
    recon_loss: str = "l1"

    # EMA
    use_ema: bool = True
    ema_decay: float = 0.999

    # compute and parameter dtypes, by their numpy/torch names
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        self.ch_mult = tuple(self.ch_mult)
        if 2 ** self.z_channels != self.codebook_size:
            raise ValueError(f"codebook_size {self.codebook_size} is not "
                             f"2 ** z_channels ({self.z_channels})")

    def save_pretrained(self, json_path) -> None:
        """Write the config as JSON, to `json_path` or to
        `json_path/vq_config.json` for a directory."""
        json_path = Path(json_path)
        if json_path.is_dir():
            json_path = json_path / "vq_config.json"
        with open(json_path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_pretrained(cls, json_path) -> "VQConfig":
        json_path = Path(json_path)
        if json_path.is_dir():
            json_path = json_path / "vq_config.json"
        with open(json_path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})
