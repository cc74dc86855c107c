"""InceptionV3 pool3 features (2048-d) for FID (counterpart of
`unirenderer_tpu/eval/inception.py`).

The module is torchvision's `inception_v3` trunk under torchvision's own
names (`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.running_mean`,
...), so its state_dict loads directly (`load_torch_inception`; the
auxiliary head and `fc` are not part of the trunk).  BatchNorm runs in
inference mode from the running statistics.  The repo holds no weight
file: `random_inception` gives a seeded random trunk, a deterministic
feature space for relative comparisons (FID against the reference needs
the real weights).  `state_dict_from_flax` carries the JAX module's flax
parameters across.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unirenderer_tpu_torch.eval.lpips import RANDOM_SEED, he_init_

FID_SIZE = 299


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _max3(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), b3, _max3(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          _max3(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avg3(x))], 1)


class InceptionV3Features(nn.Module):
    """images (B, H, W, 3) in [0, 1], H, W >= 75 -> (B, 2048) pool3
    features (the input scaled to [-1, 1], as the JAX module does)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2) * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max3(x)))
        x = _max3(x)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a",
                     "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean((2, 3))


# the trunk's entries in a full torchvision `inception_v3` state_dict that
# the feature trunk has no use for
_HEAD_PREFIXES = ("AuxLogits.", "fc.")


def load_torch_inception(model: InceptionV3Features,
                         state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a torchvision `inception_v3` state_dict: every trunk tensor
    must be there (BatchNorm's `num_batches_tracked` may be missing);
    the auxiliary head and `fc` are dropped, any other key raises."""
    sd = {k: v for k, v in state_dict.items()
          if not k.startswith(_HEAD_PREFIXES)}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"inception_v3 state_dict: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")


# the JAX module's BasicConv scope names -> torchvision's branch names
_FLAX_BRANCH = {
    "b1x1": "branch1x1", "b5x5_1": "branch5x5_1", "b5x5_2": "branch5x5_2",
    "b3x3_1": "branch3x3dbl_1", "b3x3_2": "branch3x3dbl_2",
    "b3x3_3": "branch3x3dbl_3", "bpool": "branch_pool",
    "b3x3": "branch3x3", "bd_1": "branch3x3dbl_1", "bd_2": "branch3x3dbl_2",
    "bd_3": "branch3x3dbl_3",
    "b7_1": "branch7x7_1", "b7_2": "branch7x7_2", "b7_3": "branch7x7_3",
    "b3_1": "branch3x3_1", "b3_2": "branch3x3_2",
    "b3_2a": "branch3x3_2a", "b3_2b": "branch3x3_2b",
    "bd_3a": "branch3x3dbl_3a", "bd_3b": "branch3x3dbl_3b",
}
_FLAX_STEM = {"Conv2d_1a": "Conv2d_1a_3x3", "Conv2d_2a": "Conv2d_2a_3x3",
              "Conv2d_2b": "Conv2d_2b_3x3", "Conv2d_3b": "Conv2d_3b_1x1",
              "Conv2d_4a": "Conv2d_4a_3x3"}


def torch_prefix(top: str, sub: Optional[str]) -> str:
    """The torchvision name of the JAX module's BasicConv scope (top,
    sub): InceptionC's double 7x7 branch (bd_*) is `branch7x7dbl_*` and
    InceptionD's 7x7 branch (b7_*) `branch7x7x3_*`."""
    if sub is None:
        return _FLAX_STEM[top]
    if top in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e") and \
            sub.startswith("bd_"):
        return f"{top}.{sub.replace('bd_', 'branch7x7dbl_')}"
    if top == "Mixed_7a" and sub.startswith("b7_"):
        return f"{top}.{sub.replace('b7_', 'branch7x7x3_')}"
    return f"{top}.{_FLAX_BRANCH[sub]}"


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX `InceptionV3Features` params (BatchNorm statistics among
    them, or in a `batch_stats` collection beside them) -> this module's
    state_dict."""
    flat = params["params"]
    stats = params.get("batch_stats", {})

    def leaf(scope, key):
        for tree in (flat, stats):
            node = tree
            for part in scope:
                node = node.get(part, {})
            if key in node:
                return np.asarray(node[key], np.float32)
        raise KeyError(f"{'/'.join(scope)}/{key}")

    out = {}
    scopes = []
    for top, node in flat.items():
        if "conv" in node:
            scopes.append(((top,), torch_prefix(top, None)))
        else:
            scopes += [((top, sub), torch_prefix(top, sub)) for sub in node]
    for scope, prefix in scopes:
        kernel = leaf(scope + ("conv",), "kernel")
        out[f"{prefix}.conv.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        for ours, theirs in (("bn_gamma", "bn.weight"),
                             ("bn_beta", "bn.bias"),
                             ("bn_mean", "bn.running_mean"),
                             ("bn_var", "bn.running_var")):
            out[f"{prefix}.{theirs}"] = torch.from_numpy(
                leaf(scope, ours).copy())
    return out


def random_inception(device="cuda") -> InceptionV3Features:
    """The trunk with random conv weights from a generator seeded
    RANDOM_SEED (drawn on the CPU, so every device gets the same values),
    BatchNorm the identity, in eval mode."""
    model = InceptionV3Features()
    he_init_(model, torch.Generator().manual_seed(RANDOM_SEED))
    return model.eval().requires_grad_(False).to(device)


def fid_resize(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 299, 299, C), bilinear with the triangle filter
    widened when shrinking, as `jax.image.resize(..., "bilinear")`."""
    return F.interpolate(x.permute(0, 3, 1, 2), (FID_SIZE, FID_SIZE),
                         mode="bilinear", align_corners=False,
                         antialias=True).permute(0, 2, 3, 1)


def make_feature_fn(model: Optional[InceptionV3Features] = None,
                    device="cuda", batch: int = 8
                    ) -> Callable[[np.ndarray], np.ndarray]:
    """images (B, H, W, 3) numpy in [0, 1] -> (B, 2048) numpy: resized to
    299^2 (`fid_resize`), f32 on `device`, `batch` images a call.
    `random_inception()` when no module is given."""
    model = model if model is not None else random_inception(device=device)
    dev = next(model.parameters()).device

    @torch.no_grad()
    def feature_fn(images):
        images = np.asarray(images, np.float32)
        out = []
        for i in range(0, len(images), batch):
            x = fid_resize(torch.from_numpy(images[i:i + batch]).to(dev))
            out.append(model(x).cpu().numpy())
        return np.concatenate(out, 0)

    return feature_fn


def inception_from_file(path: str, device="cuda") -> InceptionV3Features:
    """The trunk with torchvision's `inception_v3` weights from a file."""
    model = InceptionV3Features()
    load_torch_inception(model, torch.load(path, map_location="cpu",
                                           weights_only=True))
    return model.eval().requires_grad_(False).to(device)

