"""Weight porting and model surgery (counterpart of
`unirenderer_tpu/models/surgery.py`).

Three jobs:
 1. Fill the port's UNet, VAE and CLIP text encoder from diffusers-format
    state dicts of SD-v1.4 (`UNet2DConditionModel`, `AutoencoderKL`,
    transformers' `CLIPTextModel`; the files are the user's, none ships
    with the repo).  A path map takes a port state-dict key (the flax
    module names joined with `.`) to the diffusers key.  Both sides are
    torch layouts, so nothing is transposed.  The one exception: the VAE
    mid-block attention projections (`*.mid_block.attentions.0.to_q`,
    `to_k`, `to_v`, `to_out.0` weights) are linears in the port, and
    files converted from the original LDM checkpoints store them as 1x1
    convolutions, (C, C, 1, 1); those four keys take either shape.
 2. `dual_stream_from_unet`: the attribute encoder and decoder as copies
    of the UNet trunk (reference `AttributeEncoderModel.from_unet`,
    `AttributeDecoderModel.from_unet`), the zero convolutions zero.
 3. The 28-channel inflation: the encoder's conv_in tiled 7x over its
    input channels and the decoder's conv_out 7x over its output channels
    and bias, times 0.142 (reference train/train.py:976-996).

Loading is strict and shape-checked, so a naming or layout mismatch fails
loudly instead of drifting.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

PathMap = Callable[[str], Optional[str]]

INFLATE_REPEATS = 7
INFLATE_SCALE = 0.142

# the VAE attention projections some diffusers files hold as 1x1 convs
_LINEAR_AS_CONV = re.compile(
    r"(encoder|decoder)\.mid_block\.attentions\.0\."
    r"(to_q|to_k|to_v|to_out\.0)\.weight")


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _convert(key: str, src: torch.Tensor, target: torch.Tensor,
             torch_key: str) -> torch.Tensor:
    if src.dim() == 4 and target.dim() == 2 and \
            _LINEAR_AS_CONV.fullmatch(torch_key) and src.shape[2:] == (1, 1):
        src = src[:, :, 0, 0]
    if tuple(src.shape) != tuple(target.shape):
        raise ValueError(f"shape mismatch for {key} <- {torch_key}: torch "
                         f"{tuple(src.shape)} vs port {tuple(target.shape)}")
    return src


def fill_from_torch(module: nn.Module, state_dict: Mapping[str, object],
                    path_map: PathMap, strict: bool = True) -> List[str]:
    """Copy every parameter of `module` whose `path_map(name)` is a key of
    `state_dict` (cast to the parameter's type and device); a name mapped
    to None keeps its value.  Returns the mapped keys the state dict
    lacks; with `strict` any such key raises."""
    missing = []
    with torch.no_grad():
        for name, p in module.named_parameters():
            tk = path_map(name)
            if tk is None:
                continue
            if tk not in state_dict:
                missing.append(tk)
                continue
            src = _convert(name, _as_tensor(state_dict[tk]), p, tk)
            p.copy_(src.to(device=p.device, dtype=p.dtype))
    if strict and missing:
        raise KeyError(f"{len(missing)} torch keys missing, e.g. "
                       f"{missing[:5]}")
    return missing


# ---------------------------------------------------------------------------
# Path maps: port state-dict key -> diffusers key
# ---------------------------------------------------------------------------

def _tx_inner(rest: Tuple[str, ...]) -> str:
    """Transformer2D sub-path -> diffusers attention path."""
    head, leaf = rest[0], rest[-1]
    if head in ("norm", "proj_in", "proj_out"):
        return f"{head}.{leaf}"
    m = re.fullmatch(r"block_(\d+)", head)
    if m:
        base = f"transformer_blocks.{m.group(1)}."
        sub = rest[1]
        if sub in ("norm1", "norm2", "norm3"):
            return base + f"{sub}.{leaf}"
        if sub in ("attn1", "attn2"):
            proj = "to_out.0" if rest[2] == "to_out" else rest[2]
            return base + f"{sub}.{proj}.{leaf}"
        if sub == "ff":
            inner = {"proj": "net.0.proj", "out": "net.2"}[rest[2]]
            return base + f"ff.{inner}.{leaf}"
    raise KeyError(rest)


def _resnet_inner(rest: Tuple[str, ...]) -> str:
    return f"{rest[0]}.{rest[-1]}"


def unet_path_map(key: str) -> str:
    """An `ImageUNet` parameter name -> the diffusers
    `UNet2DConditionModel` key."""
    path = tuple(key.split("."))
    head, leaf = path[0], path[-1]
    if head in ("conv_in", "conv_out", "conv_norm_out"):
        return f"{head}.{leaf}"
    if head == "time_embedding":
        return f"time_embedding.{path[1]}.{leaf}"
    m = re.fullmatch(r"(down|up)_(\d+)", head)
    if m:
        kind, i = m.groups()
        sub = path[1]
        if sub in ("downsample", "upsample"):
            return f"{kind}_blocks.{i}.{sub}rs.0.conv.{leaf}"
        rm = re.fullmatch(r"resnet_(\d+)", sub)
        if rm:
            return (f"{kind}_blocks.{i}.resnets.{rm.group(1)}."
                    + _resnet_inner(path[2:]))
        am = re.fullmatch(r"attn_(\d+)", sub)
        if am:
            return (f"{kind}_blocks.{i}.attentions.{am.group(1)}."
                    + _tx_inner(path[2:]))
    if head == "mid":
        sub = path[1]
        rm = re.fullmatch(r"resnet_(\d+)", sub)
        if rm:
            return (f"mid_block.resnets.{rm.group(1)}."
                    + _resnet_inner(path[2:]))
        if sub == "attn":
            return "mid_block.attentions.0." + _tx_inner(path[2:])
    raise KeyError(key)


def vae_path_map(key: str) -> str:
    """An `AutoencoderKL` parameter name -> the diffusers `AutoencoderKL`
    key."""
    path = tuple(key.split("."))
    side, sub, leaf = path[0], path[1], path[-1]
    if sub in ("quant_conv", "post_quant_conv"):
        return f"{sub}.{leaf}"
    pre = side + "."
    if sub in ("conv_in", "conv_out", "conv_norm_out"):
        return pre + f"{sub}.{leaf}"
    m = re.fullmatch(r"(down|up)_(\d+)_res_(\d+)", sub)
    if m:
        d, i, j = m.groups()
        return pre + f"{d}_blocks.{i}.resnets.{j}." + _resnet_inner(path[2:])
    m = re.fullmatch(r"(down|up)_(\d+)_(down|up)sample", sub)
    if m:
        d, i, s = m.groups()
        return pre + f"{d}_blocks.{i}.{s}samplers.0.conv.{leaf}"
    m = re.fullmatch(r"mid_res_(\d+)", sub)
    if m:
        return pre + f"mid_block.resnets.{m.group(1)}." \
            + _resnet_inner(path[2:])
    if sub == "mid_attn":
        name = {"norm": "group_norm", "to_q": "to_q", "to_k": "to_k",
                "to_v": "to_v", "to_out": "to_out.0"}[path[2]]
        return pre + f"mid_block.attentions.0.{name}.{leaf}"
    raise KeyError(key)


def clip_path_map(key: str) -> str:
    """A `CLIPTextEncoder` parameter name -> the transformers
    `CLIPTextModel` key."""
    path = tuple(key.split("."))
    head, leaf = path[0], path[-1]
    pre = "text_model."
    if head == "token_embedding":
        return pre + "embeddings.token_embedding.weight"
    if head == "position_embedding":          # a bare parameter
        return pre + "embeddings.position_embedding.weight"
    if head == "final_ln":
        return pre + f"final_layer_norm.{leaf}"
    m = re.fullmatch(r"layer_(\d+)", head)
    if m:
        name = {"ln1": "layer_norm1", "ln2": "layer_norm2",
                "q": "self_attn.q_proj", "k": "self_attn.k_proj",
                "v": "self_attn.v_proj", "out": "self_attn.out_proj",
                "fc1": "mlp.fc1", "fc2": "mlp.fc2"}[path[1]]
        return pre + f"encoder.layers.{m.group(1)}.{name}.{leaf}"
    raise KeyError(key)


# ---------------------------------------------------------------------------
# from_unet surgery + inflation
# ---------------------------------------------------------------------------

def inflate_conv_in(weight: torch.Tensor, bias: torch.Tensor,
                    repeats: int = INFLATE_REPEATS,
                    scale: float = INFLATE_SCALE):
    """Input-channel inflation: weight (O, C, kh, kw) -> (O, C * r, kh,
    kw) * scale (tiled over the input channels), the bias copied
    (reference train/train.py:976)."""
    return weight.repeat(1, repeats, 1, 1) * scale, bias.clone()


def inflate_conv_out(weight: torch.Tensor, bias: torch.Tensor,
                     repeats: int = INFLATE_REPEATS,
                     scale: float = INFLATE_SCALE):
    """Output-channel inflation: weight (C, I, kh, kw) -> (C * r, I, kh,
    kw) * scale and the bias tiled likewise (reference
    train/train.py:988-989)."""
    return (weight.repeat(repeats, 1, 1, 1) * scale,
            bias.repeat(repeats) * scale)


def _set(p: torch.Tensor, value: torch.Tensor, what: str) -> None:
    if tuple(p.shape) != tuple(value.shape):
        raise ValueError(f"{what}: {tuple(value.shape)} into "
                         f"{tuple(p.shape)}")
    p.copy_(value)


def _copy_into(dst: nn.Module, src: nn.Module) -> None:
    """dst's parameters <- copies of src's (same names and shapes)."""
    d = dict(dst.named_parameters())
    s = dict(src.named_parameters())
    if d.keys() != s.keys():
        raise KeyError(f"{type(dst).__name__} vs {type(src).__name__}: "
                       f"{sorted(d.keys() ^ s.keys())[:5]}")
    for k, p in d.items():
        _set(p, s[k], k)


def dual_stream_from_unet(dual: nn.Module, unet: nn.Module) -> nn.Module:
    """Fill a `DualStreamModel` from a standalone `ImageUNet` (in place;
    returns `dual`):

      unet        <- copy (nothing to do when `unet` is `dual.unet`)
      controlnet  <- conv_in inflated + down / mid / time copies; its zero
                     convs zero
      controldec  <- up / conv_norm_out / time copies + conv_out inflated;
                     its zero convs zero

    Every copy owns its storage."""
    with torch.no_grad():
        if unet is not dual.unet:
            _copy_into(dual.unet, unet)
        u = dual.unet
        enc, dec = dual.controlnet, dual.controldec
        for conv, inflate, src in ((enc.conv_in, inflate_conv_in,
                                    u.conv_in),
                                   (dec.conv_out, inflate_conv_out,
                                    u.conv_out)):
            w, b = inflate(src.weight, src.bias)
            _set(conv.weight, w, "inflated weight")
            _set(conv.bias, b, "inflated bias")
        for dst in (enc, dec):
            _copy_into(dst.time_embedding, u.time_embedding)
        for name, child in u.named_children():
            if name.startswith("down_") or name == "mid":
                _copy_into(enc.get_submodule(name), child)
            elif name.startswith("up_"):
                _copy_into(dec.get_submodule(name), child)
        _copy_into(dec.conv_norm_out, u.conv_norm_out)
        for name, child in list(enc.named_children()) + list(
                dec.named_children()):
            if name.startswith(("zero_", "control_")):
                for p in child.parameters():
                    p.zero_()
    return dual


# ---------------------------------------------------------------------------
# Checkpoint files
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch .bin / .pt / .safetensors file -> {key: CPU tensor}; a
    `.safetensors` file needs the `safetensors` package."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError("safetensors not available; convert the "
                               "checkpoint to .bin with torch") from e
        return dict(load_file(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def port_sd_checkpoint(unet_sd: Mapping, vae_sd: Mapping, text_sd: Mapping,
                       cfg, device="cuda", dtype=torch.float32,
                       fast_init: bool = True):
    """Diffusers state dicts -> (DualStreamModel, AutoencoderKL,
    CLIPTextEncoder) on `device` in `dtype`, the 28-channel surgery
    applied.

    `fast_init=True` builds the modules on the meta device and fills them
    with zeros on `device` (`utils/fast_init.shape_init`) instead of
    running PyTorch's initialisers: every tensor the files back is
    overwritten and the only tensors the surgery makes are the zero
    convolutions, whose value is zero (reference `zero_module`).
    `fast_init=False` runs the initialisers and gives the same bits."""
    from unirenderer_tpu_torch.models.clip_text import CLIPTextEncoder
    from unirenderer_tpu_torch.models.dual_stream import DualStreamModel
    from unirenderer_tpu_torch.models.vae import AutoencoderKL
    from unirenderer_tpu_torch.utils.fast_init import shape_init
    from unirenderer_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)

    def build(make):
        if fast_init:
            return shape_init(make, fill="zeros", device=dev, cast=dtype)
        with torch.device(dev):
            return make().to(dtype)

    dual = build(lambda: DualStreamModel(cfg.unet))
    fill_from_torch(dual.unet, unet_sd, unet_path_map)
    dual_stream_from_unet(dual, dual.unet)
    vae = build(lambda: AutoencoderKL(cfg.vae))
    fill_from_torch(vae, vae_sd, vae_path_map)
    text = build(lambda: CLIPTextEncoder(cfg.text))
    fill_from_torch(text, text_sd, clip_path_map)
    return dual, vae, text
