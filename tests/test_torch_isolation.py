"""The port stands alone: importing `tpu1x_torch` (every module) and
`chip_smoke` loads neither JAX nor the JAX package, needs neither `nvcc`
nor `triton`, and a CPU rollout and a CPU train step through the port
launch no kernel; the train step defaults to the card and raises without
one.

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

from tpu1x_torch.model_zoo import genie_tiny
from tpu1x_torch.models.st_maskgit import STMaskGIT
from tpu1x_torch.rollout.engine import RolloutEngine
cfg = genie_tiny(d_model=32)
model = STMaskGIT(cfg).init_weights(torch.Generator().manual_seed(0))
prompt = torch.randint(0, cfg.image_vocab_size, (2, 2, 4, 4))
out = RolloutEngine(model, cfg, device="cpu").rollout(prompt, 2)
assert tuple(out.shape) == (2, 1, 4, 4, 4), out.shape

from tpu1x_torch.train.optim import TrainOptimizer
from tpu1x_torch.train.step import make_eval_step, make_train_step
for name in ("tpu1x_torch.data.corruption", "tpu1x_torch.train.optim",
             "tpu1x_torch.train.step", "tpu1x_torch.ops.spatial_train_block",
             "tpu1x_torch.ops.temporal_train_block",
             "tpu1x_torch.ops.mlp_train_block",
             "tpu1x_torch.ops._train_kernels"):
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

assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
assert not kernels._libs
for name in ("jax", "tpu1x", "triton"):
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
