"""Canonical model configurations, the same three as the JAX package's zoo.

GENIE_35M is the reference's shipped config (32 layers, 8 heads, d_model
256, factored 2x512 vocabulary, qk_norm off). GENIE_138M is its d_model=512
scale-up with 16 heads, chosen to match the ~138M parameters of the
reference's larger leaderboard model.
"""

from __future__ import annotations

from tpu1x_torch.config import GenieConfig


def genie_tiny(**overrides) -> GenieConfig:
    """Small fp32 config for tests."""
    kw = dict(num_layers=2, num_heads=2, d_model=16, T=4, S=16,
              image_vocab_size=64, num_factored_vocabs=2, qk_norm=False,
              use_mup=False, dtype="float32")
    kw.update(overrides)
    return GenieConfig(**kw)


def genie_35m(**overrides) -> GenieConfig:
    kw = dict(num_layers=32, num_heads=8, d_model=256, T=16, S=256,
              image_vocab_size=262144, num_factored_vocabs=2,
              qkv_bias=False, proj_bias=True, attn_drop=0.0, qk_norm=False,
              mlp_ratio=4.0, mlp_drop=0.0, mlp_bias=True, use_mup=False)
    kw.update(overrides)
    return GenieConfig(**kw)


def genie_138m(**overrides) -> GenieConfig:
    kw = dict(num_layers=32, num_heads=16, d_model=512, T=16, S=256,
              image_vocab_size=262144, num_factored_vocabs=2,
              qkv_bias=False, proj_bias=True, attn_drop=0.0, qk_norm=False,
              mlp_ratio=4.0, mlp_drop=0.0, mlp_bias=True, use_mup=False)
    kw.update(overrides)
    return GenieConfig(**kw)


MODEL_ZOO = {
    "tiny": genie_tiny,
    "genie_35m": genie_35m,
    "genie_138m": genie_138m,
}
