"""Activation parity of the weight-port path against REAL torch forwards
(round-4 VERDICT #9): a synthetic SD-shaped state_dict is loaded into

  * a hand-built torch mirror of the diffusers UNet2DConditionModel
    geometry (NCHW, torch GroupNorm/LayerNorm/attention semantics), and
  * transformers.CLIPTextModel (the reference's actual text encoder,
    train/train.py:956),

then ported through `surgery` into the flax models; both forwards must
agree to float32 tolerance.  This pins the layout conversions
((O,I,kh,kw)->(kh,kw,I,O), (O,I)->(I,O)), the attention scaling, GEGLU
wiring, GroupNorm/LayerNorm epsilons, skip ordering and timestep
embedding against torch ground truth — so a real SD-v1.4 file is a
drop-in the day one is available (zero-egress environment).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn as tnn
import torch.nn.functional as F

from unirenderer_tpu.core import config
from unirenderer_tpu.models import surgery
from tests.test_sd_port_e2e import _templates, synthetic_state_dict

CFG = config.tiny()

from torch_port_helpers import use_one_thread  # noqa: E402

use_one_thread()


# ---------------------------------------------------------------------------
# Torch mirror of the diffusers UNet2DConditionModel at tiny geometry
# ---------------------------------------------------------------------------


class TResnet(tnn.Module):
    def __init__(self, cin, cout, temb_dim, groups):
        super().__init__()
        self.norm1 = tnn.GroupNorm(groups, cin, eps=1e-5)
        self.conv1 = tnn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = tnn.Linear(temb_dim, cout)
        self.norm2 = tnn.GroupNorm(groups, cout, eps=1e-5)
        self.conv2 = tnn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = (tnn.Conv2d(cin, cout, 1)
                              if cin != cout else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class TAttention(tnn.Module):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = tnn.Linear(dim, dim, bias=False)
        self.to_k = tnn.Linear(ctx_dim, dim, bias=False)
        self.to_v = tnn.Linear(ctx_dim, dim, bias=False)
        self.to_out = tnn.ModuleList([tnn.Linear(dim, dim)])

    def forward(self, x, ctx=None):
        src = x if ctx is None else ctx
        q, k, v = self.to_q(x), self.to_k(src), self.to_v(src)
        b, s, d = q.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, -1, self.heads, hd).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
        out = torch.softmax(scores, dim=-1) @ v
        out = out.transpose(1, 2).reshape(b, s, d)
        return self.to_out[0](out)


class TGEGLUFF(tnn.Module):
    def __init__(self, dim):
        super().__init__()
        proj = tnn.Linear(dim, dim * 8)
        out = tnn.Linear(dim * 4, dim)
        # diffusers FeedForward: net = [GEGLU(proj), Dropout, Linear]
        self.net = tnn.ModuleDict({"0": tnn.ModuleDict({"proj": proj}),
                                   "2": out})

    def forward(self, x):
        h, gate = self.net["0"]["proj"](x).chunk(2, dim=-1)
        return self.net["2"](h * F.gelu(gate))


class TBasicBlock(tnn.Module):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.norm1 = tnn.LayerNorm(dim)
        self.attn1 = TAttention(dim, dim, heads)
        self.norm2 = tnn.LayerNorm(dim)
        self.attn2 = TAttention(dim, ctx_dim, heads)
        self.norm3 = tnn.LayerNorm(dim)
        self.ff = TGEGLUFF(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class TTransformer2D(tnn.Module):
    def __init__(self, dim, ctx_dim, heads, groups, n_layers=1):
        super().__init__()
        self.norm = tnn.GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = tnn.Conv2d(dim, dim, 1)
        self.transformer_blocks = tnn.ModuleList(
            [TBasicBlock(dim, ctx_dim, heads) for _ in range(n_layers)])
        self.proj_out = tnn.Conv2d(dim, dim, 1)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        res = x
        x = self.proj_in(self.norm(x))
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            x = blk(x, ctx)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(x) + res


class TDown(tnn.Module):
    def __init__(self, cin, cout, temb, ctx_dim, heads, groups, n_layers,
                 attn, downsample):
        super().__init__()
        self.resnets = tnn.ModuleList(
            [TResnet(cin if i == 0 else cout, cout, temb, groups)
             for i in range(n_layers)])
        self.attentions = (tnn.ModuleList(
            [TTransformer2D(cout, ctx_dim, heads, groups)
             for _ in range(n_layers)]) if attn else None)
        self.downsamplers = (tnn.ModuleList(
            [tnn.ModuleDict({"conv": tnn.Conv2d(cout, cout, 3, 2, 1)})])
            if downsample else None)

    def forward(self, x, temb, ctx):
        taps = []
        for i, r in enumerate(self.resnets):
            x = r(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, ctx)
            taps.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0]["conv"](x)
            taps.append(x)
        return x, taps


class TUp(tnn.Module):
    def __init__(self, cout, skip_chans, temb, ctx_dim, heads, groups,
                 attn, upsample):
        super().__init__()
        prev = skip_chans[0]  # incoming hidden channels
        self.resnets = tnn.ModuleList()
        for i, sc in enumerate(skip_chans[1]):
            cin = (prev if i == 0 else cout) + sc
            self.resnets.append(TResnet(cin, cout, temb, groups))
        self.attentions = (tnn.ModuleList(
            [TTransformer2D(cout, ctx_dim, heads, groups)
             for _ in self.resnets]) if attn else None)
        self.upsamplers = (tnn.ModuleList(
            [tnn.ModuleDict({"conv": tnn.Conv2d(cout, cout, 3, padding=1)})])
            if upsample else None)

    def forward(self, x, skips, temb, ctx):
        skips = list(skips)
        for i, r in enumerate(self.resnets):
            x = torch.cat([x, skips.pop()], dim=1)
            x = r(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, ctx)
        if self.upsamplers is not None:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = self.upsamplers[0]["conv"](x)
        return x


def _timestep_embedding_torch(t, dim):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TUNet(tnn.Module):
    """diffusers UNet2DConditionModel at `cfg.unet` geometry, key-compatible
    with surgery.unet_path_map."""

    def __init__(self, cfg):
        super().__init__()
        u = cfg.unet
        ch = u.block_out_channels
        temb = u.time_embed_dim
        self.u = u
        self.conv_in = tnn.Conv2d(u.in_channels, ch[0], 3, padding=1)
        self.time_embedding = tnn.ModuleDict({
            "linear_1": tnn.Linear(ch[0], temb),
            "linear_2": tnn.Linear(temb, temb)})
        self.down_blocks = tnn.ModuleList()
        for i, c in enumerate(ch):
            cin = ch[0] if i == 0 else ch[i - 1]
            self.down_blocks.append(TDown(
                cin, c, temb, u.cross_attention_dim, u.num_heads,
                u.norm_num_groups, u.layers_per_block, u.down_block_attn[i],
                downsample=i < len(ch) - 1))
        self.mid_block = tnn.ModuleDict({
            "resnets": tnn.ModuleList(
                [TResnet(ch[-1], ch[-1], temb, u.norm_num_groups),
                 TResnet(ch[-1], ch[-1], temb, u.norm_num_groups)]),
            "attentions": tnn.ModuleList(
                [TTransformer2D(ch[-1], u.cross_attention_dim, u.num_heads,
                                u.norm_num_groups)])})
        # skip-channel bookkeeping identical to the flax ImageUNet
        skip_ch = [ch[0]]
        for i, c in enumerate(ch):
            skip_ch += [c] * u.layers_per_block
            if i < len(ch) - 1:
                skip_ch.append(c)
        rev = tuple(reversed(ch))
        n_skip = u.layers_per_block + 1
        self.up_blocks = tnn.ModuleList()
        prev = ch[-1]
        for i, c in enumerate(rev):
            blk_skips = skip_ch[-n_skip:]
            del skip_ch[-n_skip:]
            self.up_blocks.append(TUp(
                c, (prev, list(reversed(blk_skips))), temb,
                u.cross_attention_dim, u.num_heads, u.norm_num_groups,
                attn=tuple(reversed(u.down_block_attn))[i],
                upsample=i < len(rev) - 1))
            prev = c
        self.conv_norm_out = tnn.GroupNorm(u.norm_num_groups, ch[0],
                                           eps=1e-5)
        self.conv_out = tnn.Conv2d(ch[0], u.out_channels, 3, padding=1)

    def forward(self, x, t, ctx):
        u = self.u
        temb = _timestep_embedding_torch(t, u.block_out_channels[0])
        temb = self.time_embedding["linear_2"](
            F.silu(self.time_embedding["linear_1"](temb)))
        x = self.conv_in(x)
        skips = [x]
        for d in self.down_blocks:
            x, taps = d(x, temb, ctx)
            skips += taps
        x = self.mid_block["resnets"][0](x, temb)
        x = self.mid_block["attentions"][0](x, ctx)
        x = self.mid_block["resnets"][1](x, temb)
        n_skip = u.layers_per_block + 1
        for up in self.up_blocks:
            blk, skips = skips[-n_skip:], skips[:-n_skip]
            x = up(x, blk, temb, ctx)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


def test_unet_port_matches_torch_forward():
    unet_t, _, _ = _templates(CFG)
    sd = synthetic_state_dict(unet_t, surgery.unet_path_map, seed=21)
    # scale down: standard-normal weights explode activations through a
    # deep net; real checkpoints are small
    sd = {k: 0.2 * v for k, v in sd.items()}

    tm = TUNet(CFG)
    # strict load BOTH validates values and proves our mapped key set is
    # exactly the torch module's parameter inventory
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                       strict=True)
    tm.eval()

    from unirenderer_tpu.models.dual_stream import ImageUNet
    fm = ImageUNet(CFG.unet, jnp.float32)
    params, missing = surgery.fill_from_torch(
        jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32), unet_t),
        sd, surgery.unet_path_map)
    assert not missing

    rng = np.random.default_rng(0)
    s = CFG.unet.sample_size
    x = rng.standard_normal((2, s, s, CFG.unet.in_channels)).astype(
        np.float32)
    ctx = rng.standard_normal(
        (2, CFG.text.max_length, CFG.unet.cross_attention_dim)).astype(
        np.float32)
    for t in (0, 500, 999):
        tt = np.full((2,), t, np.int64)
        with torch.no_grad():
            ty = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(tt),
                    torch.from_numpy(ctx)).permute(0, 2, 3, 1).numpy()
        fy = np.asarray(fm.apply(params, jnp.asarray(x),
                                 jnp.asarray(tt, jnp.int32),
                                 jnp.asarray(ctx))[0])
        scale = max(1e-3, float(np.abs(ty).max()))
        np.testing.assert_allclose(fy / scale, ty / scale, atol=3e-5,
                                   err_msg=f"t={t}")


def test_clip_port_matches_transformers_forward():
    from transformers import CLIPTextConfig, CLIPTextModel

    c = CFG.text
    tc = CLIPTextConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        num_hidden_layers=c.num_layers, num_attention_heads=c.num_heads,
        max_position_embeddings=c.max_length,
        intermediate_size=c.intermediate_size, hidden_act="quick_gelu")
    torch.manual_seed(3)
    tm = CLIPTextModel(tc).eval()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}

    from unirenderer_tpu.models.clip_text import CLIPTextEncoder
    fm = CLIPTextEncoder(c, jnp.float32)
    template = jax.eval_shape(
        lambda: fm.init(jax.random.key(0),
                        jnp.zeros((1, c.max_length), jnp.int32)))
    params, missing = surgery.fill_from_torch(
        jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32), template),
        sd, surgery.clip_path_map)
    assert not missing
    # every torch weight must have been consumed (inventory, both ways)
    consumed = set()

    def walk(tree, path):
        for k, v in tree.items():
            p = path + (k,)
            (walk(v, p) if isinstance(v, dict)
             else consumed.add(surgery.clip_path_map(p)))

    walk(template["params"], ())
    assert consumed == set(sd)

    ids = np.array([[0, 5, 9, 2] + [1] * (c.max_length - 4)], np.int64)
    with torch.no_grad():
        ty = tm(input_ids=torch.from_numpy(ids)).last_hidden_state.numpy()
    fy = np.asarray(fm.apply(params, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(fy, ty, atol=2e-5)
