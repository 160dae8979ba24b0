"""The port stands alone: importing `tpu1x_torch` (every module, the
evaluation, data, training-runtime, parallel and tokenizer modules among
them) and `chip_smoke` loads neither JAX nor the JAX package, needs neither
`nvcc` nor `triton`, and a CPU rollout (block path, op by op with qk_norm
and the int8 cache, and decode="full"), policy scores, the evaluator
(cached and rows), a CPU train step (pre-LN and qk_norm), two updates of
the train CLI and the tokenizer's encode and decode through the port
launch no kernel; the train step, the evaluator, the train CLI, the
tokenizer's `encode_frames`, `decode_latents_wrapper`, `make_lpips_fn` and
the tokenize and visualize CLIs default to the card and raise without one.

Runs in a fresh interpreter, because this test process has JAX loaded.
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import importlib, pkgutil, shutil, sys
import torch
torch.set_num_threads(2)
import tpu1x_torch
for m in pkgutil.walk_packages(tpu1x_torch.__path__, "tpu1x_torch."):
    importlib.import_module(m.name)
import chip_smoke
from tpu1x_torch import kernels

def loaded(prefix):
    return sorted(m for m in sys.modules
                  if m == prefix or m.startswith(prefix + "."))

assert shutil.which("nvcc") is None, "nvcc is on the PATH of this check"
for name in ("jax", "jaxlib", "flax", "tpu1x", "triton"):
    assert not loaded(name), (name, loaded(name))
assert not kernels._libs, "a kernel library was loaded at import"
for name in ("tpu1x_torch.eval.evaluate", "tpu1x_torch.eval.generate",
             "tpu1x_torch.eval.metrics", "tpu1x_torch.data.token_store",
             "tpu1x_torch.data.native", "tpu1x_torch.train.checkpoint",
             "tpu1x_torch.train.train", "tpu1x_torch.train.prefetch",
             "tpu1x_torch.train._msgpack", "tpu1x_torch.parallel.mesh",
             "tpu1x_torch.parallel.sharding", "tpu1x_torch.ops.remat",
             "tpu1x_torch.utils.profiling", "tpu1x_torch.utils.misc",
             "tpu1x_torch.eval.visualize", "tpu1x_torch.tokenizer.cnn",
             "tpu1x_torch.tokenizer.lfq", "tpu1x_torch.tokenizer.vqmodel",
             "tpu1x_torch.tokenizer.lpips", "tpu1x_torch.tokenizer.checkpoint",
             "tpu1x_torch.tokenizer.tokenize"):
    assert name in sys.modules, name

from tpu1x_torch.model_zoo import genie_tiny
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.rollout.engine import RolloutEngine
cfg = genie_tiny(d_model=32)
model = STMaskGIT(cfg).init_weights(torch.Generator().manual_seed(0))
prompt = torch.randint(0, cfg.image_vocab_size, (2, 2, 4, 4))
out = RolloutEngine(model, cfg, device="cpu").rollout(prompt, 2)
assert tuple(out.shape) == (2, 1, 4, 4, 4), out.shape
qk_cfg = genie_tiny(d_model=32, qk_norm=True)
qk_model = STMaskGIT(qk_cfg).init_weights(torch.Generator().manual_seed(0))
out = RolloutEngine(qk_model, qk_cfg, device="cpu",
                    cache_dtype="int8").rollout(prompt, 2)
assert tuple(out.shape) == (2, 1, 4, 4, 4), out.shape
engine = RolloutEngine(model, cfg, device="cpu", decode="full")
out = engine.rollout(prompt, 2)
assert tuple(out.shape) == (2, 1, 4, 4, 4), out.shape
scores = engine.score_policies(prompt[0], torch.randint(0, 64, (3, 2, 4, 4)))
assert tuple(scores.shape) == (3,) and torch.isfinite(scores).all()

from tpu1x_torch.eval.evaluate import GenieEvaluator
tokens = torch.randint(0, cfg.image_vocab_size, (2, cfg.T * cfg.S))
_, loss, _ = GenieEvaluator(model, cfg, device="cpu").predict_metrics(tokens)
assert loss.shape == (2,)
_, logits = GenieEvaluator(model, cfg, device="cpu",
                           use_cache=False).predict_zframe_logits(tokens)
assert logits.shape[0] == 2
for use_cache in (True, False):
    try:
        GenieEvaluator(model, cfg, use_cache=use_cache)
    except RuntimeError as e:
        assert "cuda" in str(e), e
    else:
        raise AssertionError("the evaluator's default device did not raise "
                             "without a card")

from tpu1x_torch.train.optim import TrainOptimizer
from tpu1x_torch.train.step import make_eval_step, make_train_step
for name in ("tpu1x_torch.data.corruption", "tpu1x_torch.train.optim",
             "tpu1x_torch.train.step", "tpu1x_torch.ops.spatial_train_block",
             "tpu1x_torch.ops.temporal_train_block",
             "tpu1x_torch.ops.mlp_train_block",
             "tpu1x_torch.ops._train_kernels",
             "tpu1x_torch.ops.decode_attention",
             "tpu1x_torch.ops.attention"):
    assert name in sys.modules, name
cfg = genie_tiny(d_model=32, num_prompt_frames=2)
model = STMaskGIT(cfg).init_weights(torch.Generator().manual_seed(0))
optimizer = TrainOptimizer(model, cfg, learning_rate=1e-3)
for make in (lambda **kw: make_train_step(model, optimizer, cfg, **kw),
             lambda **kw: make_eval_step(model, cfg, **kw)):
    try:
        make()  # the card is the default, and there is none here
    except RuntimeError as e:
        assert "cuda" in str(e), e
    else:
        raise AssertionError("the default device did not raise without a card")
tokens = torch.randint(0, cfg.image_vocab_size, (2, 4, 4, 4))
out = make_train_step(model, optimizer, cfg, device="cpu")(tokens)
assert torch.isfinite(out["loss"]) and torch.isfinite(out["grad_norm"])
out = make_eval_step(model, cfg, device="cpu")(tokens)
assert torch.isfinite(out["loss"])
qk_cfg = genie_tiny(d_model=32, num_prompt_frames=2, qk_norm=True)
qk_model = STMaskGIT(qk_cfg).init_weights(torch.Generator().manual_seed(0))
out = make_train_step(qk_model, TrainOptimizer(qk_model, qk_cfg,
                                               learning_rate=1e-3),
                      qk_cfg, device="cpu")(tokens)
assert torch.isfinite(out["loss"]) and torch.isfinite(out["grad_norm"])

import tempfile
import numpy as np
from pathlib import Path
from tpu1x_torch.data.token_store import write_token_dataset
from tpu1x_torch.train import train
root = Path(tempfile.mkdtemp())
write_token_dataset(root / "data", np.random.RandomState(0).randint(
    0, 64, (40, 4, 4)).astype(np.uint32), vocab_size=64,
    segment_ids=np.zeros(40, np.int32))
genie_tiny(num_layers=1, d_model=16, num_prompt_frames=2).save_pretrained(
    root / "config.json")
argv = ["--train_data_dir", str(root / "data"), "--val_data_dir",
        str(root / "data"), "--genie_config", str(root / "config.json"),
        "--output_dir", str(root / "out"), "--window_size", "4", "--stride",
        "1", "--per_device_train_batch_size", "2", "--max_train_steps", "2",
        "--vis_every_n_steps", "2", "--eval_every_n_steps", "2",
        "--max_eval_steps", "1"]
try:
    train.main(argv)  # the card is the default, and there is none here
except RuntimeError as e:
    assert "cuda" in str(e), e
else:
    raise AssertionError("the train CLI's default device did not raise "
                         "without a card")
train.main(argv + ["--device", "cpu"])
assert (root / "out" / "final_checkpt_hf" / "model.safetensors").exists()
assert (root / "out" / "vis_step_2" / "video.bin").exists()

from tpu1x_torch.config import VQConfig
from tpu1x_torch.eval import visualize
from tpu1x_torch.eval.metrics import make_lpips_fn
from tpu1x_torch.tokenizer import tokenize
from tpu1x_torch.tokenizer.checkpoint import save_tokenizer
from tpu1x_torch.tokenizer.vqmodel import VQModel
vq_cfg = VQConfig(resolution=32, base_channels=32, ch_mult=(1, 2),
                  num_res_blocks=1, z_channels=6, codebook_size=64)
vq = VQModel(vq_cfg).init_weights(torch.Generator().manual_seed(0))
save_tokenizer(root / "tok", vq, vq_cfg)
frames = np.zeros((2, 32, 32, 3), np.uint8)
ids = tokenize.encode_frames(vq, frames, device="cpu")
assert ids.shape == (2, 16, 16)
with torch.no_grad():
    assert vq.decode_tokens(torch.from_numpy(ids)).shape == (2, 32, 32, 3)
np.save(root / "frames.npy", frames)
write_token_dataset(root / "tokens", ids, vocab_size=64)
for what, call in (
        ("encode_frames", lambda: tokenize.encode_frames(vq, frames)),
        ("decode_latents_wrapper", lambda: visualize.decode_latents_wrapper(
            str(root / "tok"))),
        ("make_lpips_fn", lambda: make_lpips_fn("random")),
        ("tokenize CLI", lambda: tokenize.main([
            "--frames", str(root / "frames.npy"), "--tokenizer_ckpt",
            str(root / "tok"), "--output_dir", str(root / "tokenized")])),
        ("visualize CLI", lambda: visualize.main([
            "--token_dir", str(root / "tokens"), "--tokenizer_ckpt",
            str(root / "tok")]))):
    try:
        call()  # the card is the default, and there is none here
    except RuntimeError as e:
        assert "cuda" in str(e), (what, e)
    else:
        raise AssertionError(f"{what}'s default device did not raise without "
                             f"a card")

assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
assert not kernels._libs
for name in ("jax", "tpu1x", "triton", "msgpack"):
    assert not loaded(name), (name, loaded(name))
print("isolated")
"""


def test_port_imports_no_jax_and_launches_nothing_on_cpu():
    env = dict(os.environ)
    env["PATH"] = os.path.dirname(sys.executable)  # no nvcc to be found
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("isolated")


def test_chip_smoke_refuses_without_a_card():
    """No CUDA device: the script exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
