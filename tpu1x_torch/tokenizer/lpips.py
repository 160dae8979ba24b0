"""LPIPS perceptual distance (a VGG16 or AlexNet trunk and learned 1x1
heads), the JAX package's `tpu1x/tokenizer/lpips.py` in PyTorch.

- The input scaling layer's fixed shift and scale.
- Five taps of the trunk: VGG16 after relu1_2, relu2_2, relu3_3, relu4_3,
  relu5_3 (its pools 2x2, stride 2); AlexNet after each of its five convs
  (conv1 11x11, stride 4, padding 2; its pools 3x3, stride 2, no padding).
- Each tap unit-normalized over channels (`+1e-10` on the norm), the
  squared difference weighted by the absolute value of the tap's head,
  summed over channels, averaged over (H, W), summed over the taps.

fp32 throughout. On the card cuDNN runs an fp32 convolution in TF32 unless
told otherwise; `eval/metrics.py:make_lpips_fn` runs the model with TF32
off. Below about 32 px the AlexNet trunk's pools leave feature maps of size
zero.

Weights: the learned VGG heads are vendored in this package
(`weights/lpips_vgg_lin.npz`, converted from the reference's `vgg.pth`); a
trunk must be supplied (the lpips package's checkpoint, a torchvision
state dict, or the JAX package's flax msgpack), or "random" asked for.

The port's state dict: `vgg.conv{stage}_{i}.{weight,bias}` (OIHW) or
`alex.conv{i}.{weight,bias}`, and `lin_0` .. `lin_4` of shape (C,).
"""

from __future__ import annotations

import math
import warnings
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# VGG16 conv plan: (channels, convs per stage)
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# AlexNet convs: (out channels, kernel, stride, padding)
ALEX_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
              (256, 3, 1, 1), (256, 3, 1, 1))
# fixed input normalization constants (the reference's ScalingLayer)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# torchvision feature indices of the convs
VGG_TV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
ALEX_TV_IDX = (0, 3, 6, 8, 10)
VENDORED_LIN = (Path(__file__).resolve().parent / "weights"
                / "lpips_vgg_lin.npz")


class VGG16Features(nn.Module):
    """The VGG16 trunk emitting the five LPIPS taps."""

    def __init__(self, device=None):
        super().__init__()
        cin = 3
        for s, (ch, n) in enumerate(VGG_STAGES):
            for i in range(n):
                self.add_module(f"conv{s + 1}_{i + 1}", nn.Conv2d(
                    cin, ch, 3, padding=1, device=device))
                cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for s, (_, n) in enumerate(VGG_STAGES):
            for i in range(n):
                x = F.relu(getattr(self, f"conv{s + 1}_{i + 1}")(x))
            taps.append(x)
            if s < len(VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps


class AlexNetFeatures(nn.Module):
    """The AlexNet trunk emitting the five LPIPS taps (the reference
    evaluator's `lpips.LPIPS(net="alex")`)."""

    def __init__(self, device=None):
        super().__init__()
        cin = 3
        for i, (ch, k, stride, pad) in enumerate(ALEX_CONVS):
            self.add_module(f"conv{i + 1}", nn.Conv2d(
                cin, ch, k, stride=stride, padding=pad, device=device))
            cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for i in range(len(ALEX_CONVS)):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
            taps.append(x)
            if i < 2:
                x = F.max_pool2d(x, 3, 2)
        return taps


class LPIPS(nn.Module):
    """Learned perceptual distance of NHWC images in [-1, 1] -> (B,)."""

    def __init__(self, net: str = "vgg", device=None):
        super().__init__()
        if net not in ("vgg", "alex"):
            raise ValueError(f"net {net!r}: 'vgg' or 'alex'")
        self.net = net
        trunk = (VGG16Features if net == "vgg" else AlexNetFeatures)(device)
        self.add_module(net, trunk)
        channels = ([ch for ch, _ in VGG_STAGES] if net == "vgg"
                    else [ch for ch, *_ in ALEX_CONVS])
        for i, c in enumerate(channels):
            self.register_parameter(f"lin_{i}", nn.Parameter(
                torch.ones(c, device=device)))
        self.register_buffer("shift", torch.tensor(SHIFT, device=device)[
            :, None, None], persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE, device=device)[
            :, None, None], persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LPIPS":
        """flax's initialisation, drawn from `generator`: conv kernels
        normal with variance 1 / fan_in, biases zero, heads one."""
        for name, p in self.named_parameters():
            if p.dim() == 4:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()),
                          generator=generator)
            elif name.startswith("lin_"):
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        trunk = getattr(self, self.net)
        fx = trunk((x.permute(0, 3, 1, 2).float() - self.shift) / self.scale)
        fy = trunk((y.permute(0, 3, 1, 2).float() - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / (a.square().sum(1, keepdim=True).sqrt() + 1e-10)
            b = b / (b.square().sum(1, keepdim=True).sqrt() + 1e-10)
            w = getattr(self, f"lin_{i}").abs()[:, None, None]
            total = total + ((a - b).square() * w).sum(1).mean((1, 2))
        return total


def load_vendored_vgg_lin_params() -> Dict[str, torch.Tensor]:
    """The learned part of VGG-LPIPS, the five heads, from this package's
    copy of the reference's weights."""
    with np.load(VENDORED_LIN) as z:
        return {f"lin_{i}": torch.from_numpy(z[f"lin_{i}"].copy())
                for i in range(5)}


def _to_tensors(sd) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).detach().cpu().float()
            for k, v in sd.items()}


def _heads(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in sd:
                out[f"lin_{i}"] = sd[key].reshape(-1)
                break
    return out


def load_lpips_alex_params(torch_state_dict) -> Dict[str, torch.Tensor]:
    """The lpips package's AlexNet checkpoint (`net.slice{1-5}.{idx}.*`,
    torchvision indices 0, 3, 6, 8, 10; heads `lin{0-4}.model.1.weight`)
    -> the port's state dict."""
    sd = _to_tensors(torch_state_dict)
    out = {}
    for i, idx in enumerate(ALEX_TV_IDX):
        for k in sd:
            if k.endswith(f".{idx}.weight") and "lin" not in k:
                out[f"alex.conv{i + 1}.weight"] = sd[k]
                out[f"alex.conv{i + 1}.bias"] = sd[k[:-len("weight")] + "bias"]
                break
    return out | _heads(sd)


def load_lpips_params(torch_state_dict) -> Dict[str, torch.Tensor]:
    """The reference's `vgg.pth` (lpips package layout, `net.slice{1-5}.
    {idx}.*`) or a torchvision VGG16 (`features.{idx}.*`) -> the port's
    state dict (heads where present)."""
    sd = _to_tensors(torch_state_dict)
    out = {}
    names = [f"conv{s + 1}_{i + 1}" for s, (_, n) in enumerate(VGG_STAGES)
             for i in range(n)]
    for name, idx in zip(names, VGG_TV_IDX):
        src = next((s for s in (f"features.{idx}", f"net.features.{idx}")
                    if f"{s}.weight" in sd), None)
        if src is None:  # the lpips package's slices, global indices
            src = next((k[:-len(".weight")] for k in sd
                        if k.endswith(f".{idx}.weight")
                        and ("slice" in k or "net" in k)), None)
        if src is not None:
            out[f"vgg.{name}.weight"] = sd[f"{src}.weight"]
            out[f"vgg.{name}.bias"] = sd[f"{src}.bias"]
    return out | _heads(sd)


def lpips_params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS params (a flax tree: `vgg`/`alex` convs with
    HWIO kernels, `lin_i`) -> the port's state dict."""
    out = {}
    for key, value in tree.items():
        if key.startswith("lin_"):
            out[key] = torch.from_numpy(np.array(value, np.float32))
            continue
        for conv, p in value.items():
            kernel = np.asarray(p["kernel"], np.float32)  # HWIO
            out[f"{key}.{conv}.weight"] = torch.from_numpy(
                np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
            out[f"{key}.{conv}.bias"] = torch.from_numpy(
                np.array(p["bias"], np.float32))
    return out


def resolve_lpips_params(model: LPIPS, lpips_ckpt, net: str
                         ) -> Dict[str, torch.Tensor]:
    """The weights of `model` from `lpips_ckpt`, the JAX package's rules:

    - "random": seeded random weights (smoke tests only), with a warning;
    - a `.msgpack` path (the JAX package's flax form) or a torch state dict
      file, converted; for net="vgg" missing heads come from the vendored
      ones, so a torchvision VGG16 backbone gives real LPIPS;
    - None: no trunk, so a RuntimeError, for both nets (vgg has only its
      vendored heads).
    A trunk missing from the checkpoint raises the same error.
    """
    if lpips_ckpt == "random":
        warnings.warn(
            "LPIPS running with RANDOMLY INITIALIZED weights — scores are "
            "meaningless outside smoke tests.", stacklevel=3)
        fresh = LPIPS(net).init_weights(torch.Generator().manual_seed(0))
        return fresh.state_dict()
    params: Dict[str, torch.Tensor] = {}
    if lpips_ckpt is not None:
        path = str(lpips_ckpt)
        if path.endswith(".msgpack"):
            from tpu1x_torch.train.checkpoint import read_flax_msgpack
            params = lpips_params_from_flax(read_flax_msgpack(path))
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            params = (load_lpips_alex_params if net == "alex"
                      else load_lpips_params)(sd)
    if net == "vgg":
        params = load_vendored_vgg_lin_params() | params
    if not any(k.startswith(net + ".") for k in params):
        raise RuntimeError(
            f"LPIPS ({net}) has no {net.upper()} backbone weights. Supply "
            "--lpips_ckpt with a full LPIPS checkpoint or a torchvision "
            "backbone state dict (the learned VGG lin heads are vendored "
            "in-package), or pass 'random' to explicitly run a smoke test "
            "with meaningless scores.")
    return params
