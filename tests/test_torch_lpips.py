"""The port's LPIPS against the JAX package's, on the CPU.

The JAX side's convolutions run once, in a fresh interpreter (in-process
JAX and torch convolutions have segfaulted in this suite), from torch state
dicts that this file writes with seeded weights (the lpips package's
AlexNet and VGG layouts): the LPIPS of seeded 64 px images for both trunks,
`make_lpips_fn` on uint8 frames with leading dims and a padded tail, and
the JAX package's random weights for "random", saved in its flax msgpack
form. Held at rtol 1e-4 (fp32 on both sides, sums in another order). The
converters, `resolve_lpips_params`' cases and the vendored heads are held
in this process (no convolution).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu1x.tokenizer import lpips as jax_lpips
from tpu1x_torch.eval.metrics import make_lpips_fn
from tpu1x_torch.tokenizer import lpips

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-6)
ALEX_CONVS = [(64, 3, 11, 0), (192, 64, 5, 3), (384, 192, 3, 6),
              (256, 384, 3, 8), (256, 256, 3, 10)]
VGG_PLAN = [(64, 3), (64, 64), (128, 64), (128, 128), (256, 128), (256, 256),
            (256, 256), (512, 256), (512, 512), (512, 512), (512, 512),
            (512, 512), (512, 512)]
VGG_SLICES = [2, 2, 3, 3, 3]

CHILD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import flax.serialization
import numpy as np
import torch
from pathlib import Path
from tpu1x.eval.metrics import make_lpips_fn
from tpu1x.tokenizer.lpips import (LPIPS, load_lpips_alex_params,
                                   load_lpips_params, resolve_lpips_params)

work = Path(sys.argv[1])
inp = np.load(work / "inputs.npz")
out = {}
for net, convert in (("alex", load_lpips_alex_params),
                     ("vgg", load_lpips_params)):
    params = convert(torch.load(work / f"{net}.pth", weights_only=True))
    out[net] = np.asarray(LPIPS(net=net).apply({"params": params},
                                               inp["x"], inp["y"]))
fn = make_lpips_fn(str(work / "alex.pth"), net="alex", batch_size=4)
out["fn"] = fn(inp["frames_a"], inp["frames_b"])
rand = resolve_lpips_params(LPIPS(net="alex"), "random", "alex")
(work / "random_alex.msgpack").write_bytes(flax.serialization.to_bytes(rand))
out["random"] = np.asarray(LPIPS(net="alex").apply({"params": rand},
                                                   inp["x"], inp["y"]))
np.savez(work / "out.npz", **out)
print("child done")
"""


def alex_state_dict(seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for s, (o, i, k, idx) in enumerate(ALEX_CONVS, start=1):
        sd[f"net.slice{s}.{idx}.weight"] = torch.randn(
            (o, i, k, k), generator=g) / np.sqrt(i * k * k)
        sd[f"net.slice{s}.{idx}.bias"] = torch.randn((o,), generator=g) * 0.05
    for i, (o, *_) in enumerate(ALEX_CONVS):
        sd[f"lin{i}.model.1.weight"] = torch.rand((1, o, 1, 1), generator=g)
    return sd


def vgg_state_dict(seed=0, layout="lpips"):
    """The lpips package's `net.slice{s}.{idx}` or torchvision's
    `features.{idx}` layout."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    c = 0
    for s, n in enumerate(VGG_SLICES, start=1):
        for _ in range(n):
            o, i = VGG_PLAN[c]
            idx = lpips.VGG_TV_IDX[c]
            pre = (f"net.slice{s}.{idx}" if layout == "lpips"
                   else f"features.{idx}")
            sd[f"{pre}.weight"] = torch.randn((o, i, 3, 3), generator=g) / np.sqrt(9 * i)
            sd[f"{pre}.bias"] = torch.randn((o,), generator=g) * 0.05
            c += 1
    if layout == "lpips":
        for i, (ch, _) in enumerate(lpips.VGG_STAGES):
            sd[f"lin{i}.model.1.weight"] = torch.rand((1, ch, 1, 1), generator=g)
    return sd


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    work = tmp_path_factory.mktemp("lpips")
    torch.save(alex_state_dict(0), work / "alex.pth")
    torch.save(vgg_state_dict(1), work / "vgg.pth")
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.standard_normal(x.shape), -1, 1).astype(np.float32)
    np.savez(work / "inputs.npz", x=x, y=y,
             frames_a=rng.integers(0, 256, (2, 3, 64, 64, 3)).astype(np.uint8),
             frames_b=rng.integers(0, 256, (2, 3, 64, 64, 3)).astype(np.uint8))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", CHILD, str(work)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return dict(work=work, out=dict(np.load(work / "out.npz")),
                inputs=dict(np.load(work / "inputs.npz")))


def port_lpips(net, sd):
    model = lpips.LPIPS(net=net)
    model.load_state_dict(sd)
    return model.eval()


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax(ref, net):
    convert = (lpips.load_lpips_alex_params if net == "alex"
               else lpips.load_lpips_params)
    sd = convert(torch.load(ref["work"] / f"{net}.pth", weights_only=True))
    model = port_lpips(net, sd)
    x, y = (torch.from_numpy(ref["inputs"][k]) for k in "xy")
    with torch.no_grad():
        got = model(x, y).numpy()
        same = model(x, x).numpy()
    assert got.shape == (2,) and np.all(got > 0)
    np.testing.assert_allclose(got, ref["out"][net], **TOL)
    np.testing.assert_allclose(same, 0.0, atol=1e-6)


def test_make_lpips_fn_matches_jax(ref):
    fn = make_lpips_fn(str(ref["work"] / "alex.pth"), net="alex",
                       batch_size=4, device="cpu")
    a, b = ref["inputs"]["frames_a"], ref["inputs"]["frames_b"]
    got = fn(a, b)
    assert got.shape == (6,)
    np.testing.assert_allclose(got, ref["out"]["fn"], **TOL)
    np.testing.assert_allclose(fn(a, a), 0.0, atol=1e-6)


def test_flax_msgpack_form_matches_jax_random(ref):
    """The JAX package's random LPIPS weights, read from its msgpack."""
    model = lpips.LPIPS(net="alex")
    sd = lpips.resolve_lpips_params(
        model, str(ref["work"] / "random_alex.msgpack"), "alex")
    model.load_state_dict(sd)
    x, y = (torch.from_numpy(ref["inputs"][k]) for k in "xy")
    with torch.no_grad():
        got = model(x, y).numpy()
    np.testing.assert_allclose(got, ref["out"]["random"], **TOL)


def test_vendored_heads_equal_the_jax_package_file():
    got = lpips.load_vendored_vgg_lin_params()
    want = jax_lpips.load_vendored_vgg_lin_params()
    for i, (ch, _) in enumerate(lpips.VGG_STAGES):
        assert got[f"lin_{i}"].shape == (ch,)
        np.testing.assert_array_equal(got[f"lin_{i}"].numpy(),
                                      np.asarray(want[f"lin_{i}"]))
    assert lpips.VENDORED_LIN.read_bytes() == (
        ROOT / "tpu1x" / "tokenizer" / "weights" / "lpips_vgg_lin.npz"
    ).read_bytes()


@pytest.mark.parametrize("which", ["alex", "vgg_lpips", "vgg_torchvision"])
def test_converters_match_jax(which):
    if which == "alex":
        sd = alex_state_dict(2)
        got, want = (lpips.load_lpips_alex_params(sd),
                     jax_lpips.load_lpips_alex_params(sd))
    else:
        sd = vgg_state_dict(2, which.split("_")[1])
        got, want = lpips.load_lpips_params(sd), jax_lpips.load_lpips_params(sd)
    want = lpips.lpips_params_from_flax(want)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    net = which.split("_")[0]
    with torch.device("meta"):
        names = set(lpips.LPIPS(net).state_dict())
    assert set(got) == names if which != "vgg_torchvision" else (
        set(got) == {k for k in names if not k.startswith("lin_")})


def test_resolve_random_warns_and_is_seeded():
    model = lpips.LPIPS(net="alex")
    with pytest.warns(UserWarning, match="RANDOM"):
        a = lpips.resolve_lpips_params(model, "random", "alex")
    with pytest.warns(UserWarning, match="RANDOM"):
        b = lpips.resolve_lpips_params(model, "random", "alex")
    assert all(torch.equal(a[k], b[k]) for k in a)
    model.load_state_dict(a)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_resolve_none_raises(net):
    with pytest.raises(RuntimeError, match="backbone"):
        lpips.resolve_lpips_params(lpips.LPIPS(net=net), None, net)
    with pytest.raises(RuntimeError, match="backbone"):
        make_lpips_fn(None, net=net, device="cpu")


def test_backbone_only_vgg_takes_the_vendored_heads(tmp_path):
    torch.save(vgg_state_dict(3, "torchvision"), tmp_path / "vgg16.pth")
    model = lpips.LPIPS(net="vgg")
    sd = lpips.resolve_lpips_params(model, str(tmp_path / "vgg16.pth"), "vgg")
    vendored = lpips.load_vendored_vgg_lin_params()
    for i in range(5):
        assert torch.equal(sd[f"lin_{i}"], vendored[f"lin_{i}"])
    model.load_state_dict(sd)
    x = torch.zeros(1, 32, 32, 3)
    with torch.no_grad():
        np.testing.assert_allclose(model(x, x).numpy(), 0.0, atol=1e-6)
