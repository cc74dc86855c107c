"""LPIPS perceptual distance (counterpart of `unirenderer_tpu/eval/lpips.py`):
VGG16 features at relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3, each
unit-normalised over channels, squared differences weighted by
non-negative 1x1 linear heads, the spatial mean, summed over the layers
(Zhang et al. 2018).  The input is whitened with the lpips package's
shift and scale.

The module keeps the weight files' own layouts, so they load directly:
`LPIPS.vgg` is torchvision's `vgg16().features` up to relu5_3 (keys
`{index}.weight` / `.bias`), and the heads are the lpips package's
`lin{i}.model.1.weight` (1, C, 1, 1) (`load_torch_weights`).  The repo
holds no such files: `random_lpips` gives a seeded random backbone, a
valid but uncalibrated metric for relative comparisons.
`state_dict_from_flax` carries the JAX module's flax parameters across.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

# VGG16's conv widths per block (a 2x2 max-pool between blocks)
VGG_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
              (512, 512, 512))
# the convs' indices in torchvision's `vgg16().features`
VGG_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# the lpips package's input whitening
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# the random backbones' seed
RANDOM_SEED = 0
# pairs per call of `make_lpips_fn`'s function
LPIPS_BATCH = 16


class VGG16Features(nn.Sequential):
    """torchvision's `vgg16().features[:30]` (NCHW); `taps` returns the 5
    LPIPS activations, the last ReLU of each block."""

    def __init__(self):
        layers: List[nn.Module] = []
        cin = 3
        for bi, block in enumerate(VGG_BLOCKS):
            if bi:
                layers.append(nn.MaxPool2d(2, 2))
            for ch in block:
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
                cin = ch
        super().__init__(*layers)

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        out = []
        for layer in self:
            if isinstance(layer, nn.MaxPool2d):
                out.append(x)
            x = layer(x)
        return out + [x]


class _Lin(nn.Module):
    """The lpips package's linear head: `model.1` a bias-free 1x1 conv to
    one channel (its dropout, `model.0`, is off in eval)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(),
                                   nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """(a, b) NHWC in [-1, 1] -> (B,) LPIPS distances."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, block in enumerate(VGG_BLOCKS):
            self.add_module(f"lin{i}", _Lin(block[-1]))
        for name, vals in (("shift", SHIFT), ("scale", SCALE)):
            self.register_buffer(name, torch.tensor(vals).reshape(1, 3, 1, 1),
                                 persistent=False)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = torch.cat([a, b]).permute(0, 3, 1, 2)
        taps = self.vgg.taps((x - self.shift) / self.scale)
        n = a.shape[0]
        total = 0.0
        for i, t in enumerate(taps):
            t = t / torch.sqrt(torch.sum(t * t, 1, keepdim=True) + 1e-10)
            d = (t[:n] - t[n:]) ** 2
            w = getattr(self, f"lin{i}").model[1].weight.abs()
            total = total + torch.sum(d * w, 1).mean((1, 2))
        return total

    def load_torch_weights(self, features_sd: Mapping[str, torch.Tensor],
                           lpips_sd: Mapping[str, torch.Tensor]) -> None:
        """torchvision's `vgg16().features.state_dict()` and the lpips
        package's `vgg.pth` (its `lin*` keys), strictly."""
        self.vgg.load_state_dict(dict(features_sd))
        for i in range(len(VGG_BLOCKS)):
            getattr(self, f"lin{i}").load_state_dict(
                {"model.1.weight": lpips_sd[f"lin{i}.model.1.weight"]})


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX `LPIPS` module's params ({'params': {'vgg': {'conv{i}':
    {'kernel', 'bias'}}, 'lin{i}': (C,)}}, numpy or JAX arrays) -> this
    module's state_dict (kernels (kh, kw, I, O) -> (O, I, kh, kw))."""
    p = params["params"]
    out = {}
    for ci, ti in enumerate(VGG_CONV_INDICES):
        conv = p["vgg"][f"conv{ci}"]
        out[f"vgg.{ti}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1)))
        out[f"vgg.{ti}.bias"] = torch.from_numpy(
            np.asarray(conv["bias"], np.float32).copy())
    for i in range(len(VGG_BLOCKS)):
        w = np.asarray(p[f"lin{i}"], np.float32)
        out[f"lin{i}.model.1.weight"] = torch.from_numpy(
            w.reshape(1, -1, 1, 1).copy())
    return out


@torch.no_grad()
def he_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random conv weights, N(0, 2 / fan_in) (ReLU then keeps the
    activations' scale through a deep trunk), biases 0, drawn in module
    order on the CPU; BatchNorm statistics and affine stay the
    identity."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * (2.0 / fan_in) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()


def random_lpips(device="cuda") -> LPIPS:
    """An LPIPS module with random VGG weights from a generator seeded
    RANDOM_SEED (drawn on the CPU, so every device gets the same values)
    and unit heads, in eval mode on `device`."""
    model = LPIPS()
    he_init_(model.vgg, torch.Generator().manual_seed(RANDOM_SEED))
    with torch.no_grad():
        for i in range(len(VGG_BLOCKS)):
            getattr(model, f"lin{i}").model[1].weight.fill_(1.0)
    return model.eval().requires_grad_(False).to(device)


def make_lpips_fn(model: Optional[LPIPS] = None, device="cuda"
                  ) -> Tuple[Callable[[np.ndarray, np.ndarray], np.ndarray],
                             LPIPS]:
    """(a, b) numpy NHWC in [-1, 1] -> (B,) LPIPS distances (f32 on the
    module's device, LPIPS_BATCH pairs a call), and the module
    (`random_lpips(device)` when none is given)."""
    model = model if model is not None else random_lpips(device=device)
    dev = next(model.parameters()).device

    @torch.no_grad()
    def fn(a, b):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        out = []
        for i in range(0, len(a), LPIPS_BATCH):
            j = i + LPIPS_BATCH
            out.append(model(torch.from_numpy(a[i:j]).to(dev),
                             torch.from_numpy(b[i:j]).to(dev)).cpu().numpy())
        return np.concatenate(out)

    return fn, model


def lpips_from_files(vgg_path: str, lpips_path: str, device="cuda") -> LPIPS:
    """LPIPS with calibrated weights from torchvision's VGG16 features
    state_dict and the lpips package's `vgg.pth`."""
    model = LPIPS()
    model.load_torch_weights(
        torch.load(vgg_path, map_location="cpu", weights_only=True),
        torch.load(lpips_path, map_location="cpu", weights_only=True))
    return model.eval().requires_grad_(False).to(device)

