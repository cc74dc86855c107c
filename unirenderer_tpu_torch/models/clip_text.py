"""CLIP text encoder (counterpart of `unirenderer_tpu/models/clip_text.py`).

Pre-LN transformer with quick-GELU and a causal mask.  The pipeline only
ever encodes the constant blank prompt, once, so its attention stays plain
PyTorch (`dense_attention`), as it was XLA on the TPU.
"""

from __future__ import annotations

import torch
from torch import nn

from unirenderer_tpu_torch.core.config import TextEncoderConfig
from unirenderer_tpu_torch.models.layers import dense_attention


class CLIPLayer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.ln1 = nn.LayerNorm(d, eps=1e-5)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.ln2 = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.num_heads
        h = self.ln1(x)
        q = self.q(h).reshape(b, s, self.num_heads, hd)
        k = self.k(h).reshape(b, s, self.num_heads, hd)
        v = self.v(h).reshape(b, s, self.num_heads, hd)
        x = x + self.out(dense_attention(q, k, v, mask).reshape(b, s, d))
        h = self.fc1(self.ln2(x))
        h = h * torch.sigmoid(1.702 * h)              # quick-GELU
        return x + self.fc2(h)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg))
        self.final_ln = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.position_embedding[None, :s]
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=input_ids.device).tril()
        mask = torch.zeros(s, s, device=input_ids.device).masked_fill(
            ~causal, -1e9)[None, None]
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return self.final_ln(x)


# The constant blank prompt ' ' as the CLIP BPE tokenizer gives it:
# [startoftext] followed by [endoftext] padding.
BLANK_PROMPT_IDS = (49406,) + (49407,) * 76


def blank_ids(cfg: TextEncoderConfig, device="cpu") -> torch.Tensor:
    ids = [min(i, cfg.vocab_size - 1)
           for i in BLANK_PROMPT_IDS[:cfg.max_length]]
    return torch.tensor([ids], dtype=torch.long, device=device)
