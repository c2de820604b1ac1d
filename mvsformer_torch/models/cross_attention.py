"""Cross-view linear attention with epipolar position encodings.

Port of `mvsformer_tpu/models/cross_attention.py`: `CrossAttention`, an
ELU+1 kernelised linear attention over all V*N tokens of a sample at once
(O(V*N) in the tokens), and `CrossBlock`, which adds token-type
embeddings (reference view / source view) and, given the epipoles, the
three epipolar encodings of every source token (its direction to the
epipole, the epipole's direction and its clamped distance, as sine
embeddings) before the attention, and gates the attention and its MLP by
the scalars `alpha1` and `alpha2`, which start at zero (the block starts
as the identity). `DINOViT(cross_att=True)` runs one after every
depth // 4 blocks. Attribute names are the flax modules'.

The products and the normaliser of the attention are fp32, as the JAX
function casts them; the rest computes in the activations' dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from mvsformer_torch.models.blocks import Linear, gelu_tanh


def _inv_freq(num_feats, device):
    i = torch.arange(num_feats, dtype=torch.float32, device=device)
    return 10000.0 ** (2 * torch.div(i, 2, rounding_mode="floor") / num_feats)


def _sine(p):
    """[..., F] phases -> sin of the even ones and cos of the odd ones,
    interleaved: [..., F]."""
    return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                       dim=-1).reshape(*p.shape[:-1], -1)


def sine_position_embedding(u, v, num_feats: int, scale: float):
    """The 2D sine embedding of (u, v): [...] each -> [..., 2 num_feats],
    v's embedding then u's (PositionEmbeddingSine's layout)."""
    dim_t = _inv_freq(num_feats, u.device)
    return torch.cat([_sine((v * scale)[..., None] / dim_t),
                      _sine((u * scale)[..., None] / dim_t)], dim=-1)


def sine_position_embedding_1d(d, num_feats: int, scale: float):
    """The 1D sine embedding of d: [...] -> [..., num_feats]."""
    return _sine((d * scale)[..., None] / _inv_freq(num_feats, d.device))


class CrossAttention(nn.Module):
    """ELU+1 linear attention across the V*N tokens of each sample: qkv
    without bias, q' = elu(q) + 1, k' = elu(k) + 1, y = q' (k'^T v) / (q'
    sum k' + 1e-6) per head, then the output projection."""

    def __init__(self, dim, num_heads, nview=5):
        super().__init__()
        self.num_heads, self.nview = num_heads, nview
        self.qkv = Linear(dim, dim * 3, bias=False)
        self.proj = Linear(dim, dim)

    def forward(self, x):  # [B*V, N, C]
        BV, N, C = x.shape
        B, nh = BV // self.nview, self.num_heads
        qkv = self.qkv(x.reshape(B, self.nview * N, C)).reshape(B, -1, 3, nh, C // nh)
        f32 = torch.promote_types(x.dtype, torch.float32)
        q = (F.elu(qkv[:, :, 0]) + 1.0).to(f32)
        k = (F.elu(qkv[:, :, 1]) + 1.0).to(f32)
        v = qkv[:, :, 2].to(f32)
        kv = torch.einsum("nlhd,nlhm->nhmd", k, v)
        z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(dim=1)) + 1e-6)
        y = torch.einsum("nlhd,nhmd->nlhm", q, kv) * z[..., None]
        return self.proj(y.reshape(BV, N, C).to(x.dtype))


class CrossBlock(nn.Module):
    """x [B*V, 1 + h*w, C] (the views of a sample consecutive, the
    reference first) -> the same shape: x2 = x + alpha1 attn(x + tok_emb),
    out = x2 + alpha2 mlp(x2). Without epipoles tok_emb is the token-type
    embedding (0 for the reference view's tokens, 1 for the sources'); with
    `epipole` [B, V-1, 2] (pixels on the token grid) each source token
    takes, in place of its type, the concatenation of the epipole's
    direction (C/4), its distance / 512 clamped to [0, 1] (C/4) and the
    token's unit direction from the epipole (C/2), and each source's CLS
    token keeps type 1."""

    def __init__(self, dim, num_heads, nview=5):
        super().__init__()
        self.nview = nview
        self.tok_embeddings = nn.Embedding(2, dim)
        self.alpha1 = nn.Parameter(torch.zeros(()))
        self.alpha2 = nn.Parameter(torch.zeros(()))
        self.attn = CrossAttention(dim, num_heads, nview)
        self.fc1 = Linear(dim, 2 * dim)  # the JAX CrossBlock's mlp_ratio of 2
        self.act = gelu_tanh()
        self.fc2 = Linear(2 * dim, dim)

    def epipolar_embedding(self, epipole, height, width, C):
        """[B, V-1, h*w, C] fp32 from epipole [B, V-1, 2]."""
        B, S = epipole.shape[:2]
        epipole = epipole.float()
        y, x = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=epipole.device),
                              torch.arange(width, dtype=torch.float32, device=epipole.device),
                              indexing="ij")
        rel_u = x - epipole[..., 0, None, None]
        rel_v = y - epipole[..., 1, None, None]
        norm = torch.sqrt(rel_u ** 2 + rel_v ** 2) + 1e-6
        rel = sine_position_embedding((rel_u / norm).reshape(B, S, -1),
                                      (rel_v / norm).reshape(B, S, -1), C // 4, 32 * math.pi)
        length = torch.linalg.norm(epipole, dim=-1)
        unit = epipole / (length[..., None] + 1e-12)
        hw = height * width
        direction = sine_position_embedding(unit[..., 0:1].expand(B, S, hw),
                                            unit[..., 1:2].expand(B, S, hw), C // 8, 2 * math.pi)
        dist = (length / 512.0).clamp(0.0, 1.0)[..., None].expand(B, S, hw)
        return torch.cat([direction, sine_position_embedding_1d(dist, C // 4, 2 * math.pi), rel],
                         dim=-1)

    def forward(self, x, epipole=None, height: int = 0, width: int = 0):
        BV, N, C = x.shape
        V = self.nview
        B = BV // V
        table = self.tok_embeddings.weight.to(x.dtype)
        if epipole is None:
            types = torch.ones((B, V, N), dtype=torch.long, device=x.device)
            types[:, 0] = 0
            tok_emb = table[types.reshape(BV, N)]
        else:
            epi = self.epipolar_embedding(epipole, height, width, C).to(x.dtype)
            src = torch.cat([table[1].expand(B, V - 1, 1, C), epi], dim=2)
            tok_emb = torch.cat([table[0].expand(B, 1, N, C), src], dim=1).reshape(BV, N, C)
        x2 = x + self.alpha1.to(x.dtype) * self.attn(x + tok_emb)
        return x2 + self.alpha2.to(x.dtype) * self.fc2(self.act(self.fc1(x2)))
