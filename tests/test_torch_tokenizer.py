"""The port's MAGVIT2/LFQ tokenizer against the JAX package's, on the CPU.

The LFQ math runs in this process on both sides (no convolution). Every
convolution of the JAX side runs once, in a fresh interpreter (in-process
JAX and torch convolutions have segfaulted in this suite), which writes its
inputs, weights and outputs to an .npz that the tests read: at a tiny
config (32 px, base 32, ch_mult (1, 2), z 6, codebook 64, one res block),
weights drawn with numpy from a seed, in fp32 and in bf16. Held: ids <->
bits in both orders, `codebook_entry`, the straight-through gradient, the
entropies against the JAX functions and the full 2^6 codebook math,
`factorized_indices`, `depth_to_space` against JAX and the reference's DCR
formula, the encoder, LFQ, decode and decode_tokens in fp32 (atol 1e-4)
and in bf16 (relative L2 2e-2: both sides round to bf16 at the same
places, but in another order of sums), the flax <-> port weight mapping,
a reference-named Lightning checkpoint (EMA weights preferred) loaded
strictly, and `save_tokenizer` / `load_tokenizer` across the packages.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x.config import VQConfig as JaxVQConfig
from tpu1x.tokenizer import lfq as jax_lfq
from tpu1x.tokenizer.vqmodel import rescale_magvit_output as jax_rescale
from tpu1x.utils.misc import convert_lightning_checkpoint as jax_convert_lt
from tpu1x_torch.config import VQConfig
from tpu1x_torch.tokenizer import lfq
from tpu1x_torch.tokenizer.checkpoint import (load_magvit2_checkpoint,
                                              load_tokenizer, save_tokenizer)
from tpu1x_torch.tokenizer.cnn import depth_to_space
from tpu1x_torch.tokenizer.vqmodel import VQModel, rescale_magvit_output
from tpu1x_torch.utils.misc import convert_lightning_checkpoint
from tpu1x_torch.weights import vq_params_from_jax, vq_params_to_jax

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)
SMALL = dict(resolution=32, base_channels=32, ch_mult=(1, 2), z_channels=6,
             codebook_size=64, num_res_blocks=1, dtype="float32")
FP32_TOL = dict(atol=1e-4, rtol=1e-4)

CHILD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from pathlib import Path
from tpu1x.config import VQConfig
from tpu1x.tokenizer.checkpoint import (load_magvit2_checkpoint,
                                        load_tokenizer, save_tokenizer)
from tpu1x.tokenizer.cnn import Encoder, depth_to_space
from tpu1x.tokenizer.vqmodel import VQModel

work = Path(sys.argv[1])
small = dict(resolution=32, base_channels=32, ch_mult=(1, 2), z_channels=6,
             codebook_size=64, num_res_blocks=1)
cfg32, cfg16 = VQConfig(**small, dtype="float32"), VQConfig(**small)
inp = np.load(work / "inputs.npz")
x, ids = jnp.asarray(inp["images"]), jnp.asarray(inp["ids"])
out = {}

def flat(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from flat(v, p)
        else:
            yield p, np.asarray(v)

rng = np.random.default_rng(0)
def draw(path, leaf):
    name = "/".join(str(getattr(k, "key", k)) for k in path)
    shape = np.shape(leaf)
    if name.endswith("kernel"):
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
    if name.endswith("scale"):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)

model = VQModel(cfg32)
tree = model.init(jax.random.PRNGKey(0), x)["params"]
params = jax.tree_util.tree_map_with_path(draw, jax.device_get(tree))
params = jax.tree_util.tree_map(np.asarray, params)
for k, v in flat(params):
    out["params/" + k] = v
for tag, cfg in (("fp32", cfg32), ("bf16", cfg16)):
    m = VQModel(cfg)
    v = {"params": params}
    z = Encoder(cfg).apply({"params": params["encoder"]}, x)
    res = m.apply(v, x, method=VQModel.encode)
    out[f"{tag}/z"] = np.asarray(z)
    out[f"{tag}/quantized"] = np.asarray(res.quantized)
    out[f"{tag}/indices"] = np.asarray(res.indices)
    out[f"{tag}/decode"] = np.asarray(m.apply(v, res.quantized,
                                              method=VQModel.decode))
    out[f"{tag}/decode_tokens"] = np.asarray(
        m.apply(v, ids, method=VQModel.decode_tokens))
save_tokenizer(work / "jax_tok", params, cfg32)

# the port's checkpoint, read by the JAX package
port_params, port_cfg = load_tokenizer(work / "port_tok")
for k, v in flat(port_params):
    out["port_params/" + k] = v
out["from_port/decode_tokens"] = np.asarray(VQModel(port_cfg).apply(
    {"params": port_params}, ids, method=VQModel.decode_tokens))

# a reference Lightning checkpoint with EMA weights
ref = load_magvit2_checkpoint(work / "magvit2.ckpt", cfg32)
m = VQModel(cfg32)
out["lightning/decode_tokens"] = np.asarray(
    m.apply({"params": ref}, ids, method=VQModel.decode_tokens))
out["lightning/indices"] = np.asarray(
    m.apply({"params": ref}, x, method=VQModel.encode).indices)

d2s_in = inp["d2s"]  # NCHW
out["d2s"] = np.asarray(depth_to_space(
    jnp.asarray(d2s_in.transpose(0, 2, 3, 1)), 2)).transpose(0, 3, 1, 2)
np.savez(work / "out.npz", **out)
print("child done")
"""


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def reference_state_dict(cfg, seed):
    """Every parameter of a reference-named VQModel, drawn with numpy."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in VQModel(cfg).state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        if len(shape) == 4:
            scale = 1.0 / np.sqrt(np.prod(shape[1:]))
            sd[k] = rng.standard_normal(shape) * scale
        elif ".norm" in k and k.endswith("weight"):
            sd[k] = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            sd[k] = 0.1 * rng.standard_normal(shape)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("tokenizer")
    rng = np.random.default_rng(1)
    np.savez(work / "inputs.npz",
             images=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
             ids=rng.integers(0, 64, (2, 16, 16)).astype(np.int32),
             d2s=rng.standard_normal((2, 12, 3, 5)).astype(np.float32))
    cfg = VQConfig(**SMALL)
    port_sd = reference_state_dict(cfg, seed=2)
    save_tokenizer(work / "port_tok", port_sd, cfg)
    plain, ema = reference_state_dict(cfg, 3), reference_state_dict(cfg, 4)
    ckpt = {k: v for k, v in plain.items()}
    ckpt.update({"model_ema." + k.replace(".", ""): v for k, v in ema.items()})
    ckpt.update({"loss.discriminator.main.0.weight": torch.zeros(2),
                 "lpips.net.slice1.0.weight": torch.zeros(2),
                 "quantize.codebook": torch.zeros(2)})
    torch.save({"state_dict": ckpt, "global_step": 7}, work / "magvit2.ckpt")

    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", CHILD, str(work)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    with np.load(work / "out.npz") as z:
        out = dict(z)
    inputs = dict(np.load(work / "inputs.npz"))
    params = unflatten({k[len("params/"):]: v for k, v in out.items()
                        if k.startswith("params/")})
    return dict(work=work, out=out, inputs=inputs, params=params, cfg=cfg,
                port_sd=port_sd, ema=ema)


def port_model(ref, dtype="float32"):
    cfg = VQConfig(**{**SMALL, "dtype": dtype})
    model = VQModel(cfg)
    model.load_state_dict(vq_params_from_jax(ref["params"], cfg))
    return model.eval()


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ------------------------------------------------------------------- LFQ

@pytest.mark.parametrize("bit_order", ["dataset", "reference"])
def test_bits_round_trip_matches_jax(bit_order):
    ids = np.arange(0, 2 ** 18, 12345, dtype=np.int32)
    bits = lfq.indices_to_bits(torch.from_numpy(ids), 18, bit_order)
    want = np.asarray(jax_lfq.indices_to_bits(jnp.asarray(ids), 18, bit_order))
    np.testing.assert_array_equal(bits.numpy(), want)
    back = lfq.bits_to_indices(bits, bit_order)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), ids)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jax_lfq.bits_to_indices(jnp.asarray(want), bit_order)))


def test_codebook_entry_matches_jax():
    ids = np.array([[0, 5, 63], [17, 42, 1]], np.int32)
    got = lfq.codebook_entry(torch.from_numpy(ids), 6).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jax_lfq.codebook_entry(jnp.asarray(ids), 6)))
    np.testing.assert_array_equal(got[0, 1], [1, -1, 1, -1, -1, -1])


def test_quantize_straight_through():
    cfg = VQConfig(**SMALL)
    z = torch.tensor([[0.3, -0.2, 0.1, -0.9, 0.5, 0.01]], requires_grad=True)
    res = lfq.LFQ(cfg)(z, training=False)
    np.testing.assert_array_equal(res.quantized.detach().numpy(),
                                  [[1, -1, 1, -1, 1, 1]])
    assert int(res.indices[0]) == 0b110101
    res.quantized.sum().backward()
    np.testing.assert_array_equal(z.grad.numpy(), np.ones((1, 6)))
    jres = jax_lfq.LFQ(JaxVQConfig(**SMALL))(jnp.asarray(z.detach().numpy()),
                                             training=False)
    assert int(jres.indices[0]) == int(res.indices[0])


def test_entropies_match_jax_and_full_codebook():
    D, temp = 6, 0.01
    z = np.random.default_rng(0).standard_normal((5, D)).astype(np.float32) * 0.5
    codes = lfq.codebook_entry(torch.arange(2 ** D), D).numpy()
    logits = 2 * z @ codes.T / temp
    logits -= logits.max(-1, keepdims=True)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    sample_ref = (-(probs * np.log(probs + 1e-12)).sum(-1)).mean()
    avg = probs.mean(0)
    codebook_ref = -(avg * np.log(avg + 1e-5)).sum()

    zt = torch.from_numpy(z)
    sample = float(lfq.bernoulli_entropy_sum(zt, temp).mean())
    codebook = float(lfq.codebook_entropy_chunked(zt, temp, D, chunk=16))
    np.testing.assert_allclose(sample, sample_ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(codebook, codebook_ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(sample, float(jax_lfq._bernoulli_entropy_sum(
        jnp.asarray(z), temp).mean()), rtol=1e-5)
    np.testing.assert_allclose(codebook, float(
        jax_lfq._codebook_entropy_chunked(jnp.asarray(z), temp, D, chunk=16)),
        rtol=1e-5)


def test_lfq_training_losses_match_jax():
    cfg = VQConfig(**SMALL)
    z = np.random.default_rng(1).standard_normal((2, 4, 4, 6)).astype(
        np.float32) * 0.05
    got = lfq.LFQ(cfg)(torch.from_numpy(z), training=True)
    want = jax_lfq.LFQ(JaxVQConfig(**SMALL))(jnp.asarray(z), training=True)
    for name in ("entropy_loss", "commit_loss", "per_sample_entropy",
                 "codebook_entropy"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))


def test_factorized_indices():
    ids = torch.tensor([0b110101, 0b000111, 63])
    pre, post = lfq.LFQ(VQConfig(**SMALL)).factorized_indices(ids)
    jpre, jpost = jax_lfq.LFQ(JaxVQConfig(**SMALL)).factorized_indices(
        jnp.asarray(ids.numpy()))
    np.testing.assert_array_equal(pre.numpy(), np.asarray(jpre))
    np.testing.assert_array_equal(post.numpy(), np.asarray(jpost))
    assert int(pre[0]) == 0b101 and int(post[0]) == 0b110


# ------------------------------------------------------------------- CNN

@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_depth_to_space_matches_jax_and_dcr(ref, layout):
    x = torch.from_numpy(ref["inputs"]["d2s"])
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    got = depth_to_space(x, 2).numpy()
    c, h, w = 12, 3, 5
    dcr = x.contiguous().view(-1, 2, 2, c // 4, h, w).permute(
        0, 3, 4, 1, 5, 2).reshape(2, c // 4, h * 2, w * 2).numpy()
    np.testing.assert_array_equal(got, dcr)
    np.testing.assert_array_equal(got, ref["out"]["d2s"])
    assert not np.array_equal(got, torch.nn.functional.pixel_shuffle(x, 2))


@pytest.mark.parametrize("what", ["z", "quantized", "indices", "decode",
                                  "decode_tokens"])
def test_fp32_matches_jax(ref, what):
    model = port_model(ref)
    x = torch.from_numpy(ref["inputs"]["images"])
    want = ref["out"][f"fp32/{what}"]
    with torch.no_grad():
        if what == "z":
            got = model.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        elif what in ("quantized", "indices"):
            got = getattr(model.encode(x), what)
        elif what == "decode":
            got = model.decode(torch.from_numpy(ref["out"]["fp32/quantized"]))
        else:
            got = model.decode_tokens(torch.from_numpy(ref["inputs"]["ids"]))
    assert tuple(got.shape) == want.shape
    if what in ("quantized", "indices"):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)


@pytest.mark.parametrize("what", ["z", "decode_tokens"])
def test_bf16_matches_jax(ref, what):
    model = port_model(ref, "bfloat16")
    with torch.no_grad():
        if what == "z":
            x = torch.from_numpy(ref["inputs"]["images"])
            got = model.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            got = model.decode_tokens(torch.from_numpy(ref["inputs"]["ids"]))
    assert got.dtype == torch.float32
    assert rel_l2(got.numpy(), ref["out"][f"bf16/{what}"]) <= 2e-2


def test_decode_tokens_equals_decode_of_encode(ref):
    """decode(encode(x).quantized) == decode_tokens(encode(x).indices)."""
    for dtype in ("float32", "bfloat16"):
        model = port_model(ref, dtype)
        with torch.no_grad():
            res = model.encode(torch.from_numpy(ref["inputs"]["images"]))
            assert torch.equal(model.decode(res.quantized),
                               model.decode_tokens(res.indices))


def test_vq_params_round_trip(ref):
    cfg = ref["cfg"]
    sd = vq_params_from_jax(ref["params"], cfg)
    with torch.device("meta"):
        assert set(sd) == set(VQModel(cfg).state_dict())
    back = vq_params_to_jax(sd, cfg)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            yield from (leaves(v, p) if isinstance(v, dict) else [(p, v)])
    want, got = dict(leaves(ref["params"])), dict(leaves(back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reference_checkpoint_loads_strict_with_ema(ref):
    cfg = ref["cfg"]
    sd = load_magvit2_checkpoint(ref["work"] / "magvit2.ckpt", cfg)
    for k, v in ref["ema"].items():
        assert torch.equal(sd[k], v), k
    model = VQModel(cfg)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model.decode_tokens(torch.from_numpy(ref["inputs"]["ids"]))
        ids = model.encode(torch.from_numpy(ref["inputs"]["images"])).indices
    np.testing.assert_allclose(got.numpy(), ref["out"]["lightning/decode_tokens"],
                               **FP32_TOL)
    np.testing.assert_array_equal(ids.numpy(), ref["out"]["lightning/indices"])


def test_load_tokenizer_of_the_jax_package(ref):
    sd, cfg = load_tokenizer(ref["work"] / "jax_tok")
    assert cfg == ref["cfg"]
    want = vq_params_from_jax(ref["params"], cfg)
    assert set(sd) == set(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k


def test_jax_package_reads_save_tokenizer(ref):
    cfg = ref["cfg"]
    got = unflatten({k[len("port_params/"):]: v for k, v in ref["out"].items()
                     if k.startswith("port_params/")})
    sd = vq_params_from_jax(got, cfg)
    for k, v in ref["port_sd"].items():
        assert torch.equal(sd[k], v), k
    model = VQModel(cfg)
    model.load_state_dict(ref["port_sd"])
    with torch.no_grad():
        dec = model.decode_tokens(torch.from_numpy(ref["inputs"]["ids"]))
    np.testing.assert_allclose(dec.numpy(), ref["out"]["from_port/decode_tokens"],
                               **FP32_TOL)


def test_rescale_magvit_output_truncates_like_jax():
    x = np.array([-1.5, -1.0, -0.3, 0.0, 0.00392, 0.5, 0.999, 1.0, 2.0],
                 np.float32)
    got = rescale_magvit_output(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_rescale(
        jnp.asarray(x))))


def test_vq_config_json_round_trips_between_packages(tmp_path):
    cfg = VQConfig(**{**SMALL, "token_factorization": True})
    cfg.save_pretrained(tmp_path)
    jcfg = JaxVQConfig.from_pretrained(tmp_path)
    assert json.loads((tmp_path / "vq_config.json").read_text())["ch_mult"] == [1, 2]
    jcfg.save_pretrained(tmp_path / "vq_config.json")
    assert VQConfig.from_pretrained(tmp_path) == cfg
    assert VQConfig() == VQConfig(**{
        f: getattr(JaxVQConfig(), f) for f in VQConfig.__dataclass_fields__})
    with pytest.raises(ValueError):
        VQConfig(z_channels=6, codebook_size=65)


def test_convert_lightning_checkpoint_matches_jax():
    sd = {"model.decoder.layers.0.mlp.fc1.weight": 1, "epoch": 3,
          "global_step": 10, "optimizer_states.0": 2, "callbacks.x": 4,
          "pos_embed_TSC": 5, "token_embed.mask_token_embed": 6,
          "state_dict.x": 7}
    got = convert_lightning_checkpoint(sd)
    assert got == jax_convert_lt(sd)
    assert got == {"decoder.layers.0.mlp.fc1.weight": 1,
                   "token_embed.mask_token_embed": 6}
