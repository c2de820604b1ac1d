"""Twins-SVT (ALTGVT) pyramid vision transformer backbone, eval forward.

Port of `mvsformer_tpu/models/twins.py`. Tokens stay in [B, H, W, C]
between blocks, so window partitioning is a reshape and permute, and the
Linear layers act on the last axis. Attention is a plain matmul with an
fp32 softmax; drop-path is the identity at eval, so it has no module here.
LayerNorm eps is 1e-6 and GELU is the tanh form, as in the JAX package.
Attribute names are the reference checkpoint's (`patch_embeds`,
`pos_block`, `blocks`, `norm_list`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mvsformer_torch.models.blocks import gelu_tanh


def _ln(dim):
    return nn.LayerNorm(dim, eps=1e-6)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = gelu_tanh()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class GroupAttention(nn.Module):
    """Windowed multi-head self-attention with a padding mask."""

    def __init__(self, dim, num_heads, ws=7):
        super().__init__()
        self.num_heads = num_heads
        self.ws = ws
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):  # [B, H, W, C]
        B, H, W, C = x.shape
        ws, nh = self.ws, self.num_heads
        hd = C // nh
        pad_b = (ws - H % ws) % ws
        pad_r = (ws - W % ws) % ws
        xp = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        nwh, nww = Hp // ws, Wp // ws

        # Padded tokens neither attend nor are attended to.
        is_pad = torch.zeros(Hp, Wp, dtype=torch.float32, device=x.device)
        if pad_b:
            is_pad[-pad_b:, :] = 1.0
        if pad_r:
            is_pad[:, -pad_r:] = 1.0
        pm = is_pad.reshape(nwh, ws, nww, ws).permute(0, 2, 1, 3).reshape(nwh * nww, ws * ws)
        bias = torch.where((pm[:, None, :] - pm[:, :, None]) != 0.0, -1000.0, 0.0)

        qkv = self.qkv(xp).reshape(B, nwh, ws, nww, ws, 3, nh, hd)
        qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, B, nwh * nww, nh, ws * ws, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q, k.transpose(-1, -2)).float() * hd ** -0.5
        attn = attn + bias[None, :, None]
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v)
        out = out.reshape(B, nwh, nww, nh, ws, ws, hd)
        out = out.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Hp, Wp, C)[:, :H, :W]
        return self.proj(out)


class GlobalSubsampledAttention(nn.Module):
    """Global attention with spatially reduced keys and values."""

    def __init__(self, dim, num_heads, sr_ratio=1):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, dim * 2)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = _ln(dim)

    def forward(self, x):  # [B, H, W, C]
        B, H, W, C = x.shape
        nh = self.num_heads
        hd = C // nh
        q = self.q(x).reshape(B, H * W, nh, hd).transpose(1, 2)  # [B, nh, N, hd]
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.norm(_nhwc(self.sr(_nchw(x))))
        nk = kv_in.shape[1] * kv_in.shape[2]
        kv = self.kv(kv_in).reshape(B, nk, 2, nh, hd)
        k = kv[:, :, 0].transpose(1, 2)
        v = kv[:, :, 1].transpose(1, 2)
        attn = torch.matmul(q, k.transpose(-1, -2)).float() * hd ** -0.5
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, H, W, C)
        return self.proj(out)


class PosCNN(nn.Module):
    """Conditional positional encoding: depthwise 3x3 conv + residual."""

    def __init__(self, dim):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(dim, dim, 3, 1, 1, groups=dim))

    def forward(self, x):  # [B, H, W, C]
        return _nhwc(self.proj(_nchw(x))) + x


class TwinsBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, ws, sr_ratio):
        super().__init__()
        self.norm1 = _ln(dim)
        if ws == 1:
            self.attn = GlobalSubsampledAttention(dim, num_heads, sr_ratio)
        else:
            self.attn = GroupAttention(dim, num_heads, ws)
        self.norm2 = _ln(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cin, dim, patch):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, patch)
        self.norm = _ln(dim)

    def forward(self, x):  # NCHW -> [B, H/p, W/p, dim]
        return self.norm(_nhwc(self.proj(x)))


class ALTGVT(nn.Module):
    """Alternating local/global Twins backbone -> 4 pyramid maps (NCHW)."""

    def __init__(self, embed_dims=(64, 128, 256, 512), num_heads=(2, 4, 8, 16),
                 mlp_ratios=(4, 4, 4, 4), depths=(2, 2, 10, 4), wss=(7, 7, 7, 7),
                 sr_ratios=(8, 4, 2, 1), patch_size=4):
        super().__init__()
        self.depths = tuple(depths)
        cins = (3,) + tuple(embed_dims[:-1])
        self.patch_embeds = nn.ModuleList(
            PatchEmbed(cins[i], embed_dims[i], patch_size if i == 0 else 2)
            for i in range(len(depths)))
        self.pos_block = nn.ModuleList(PosCNN(d) for d in embed_dims)
        self.blocks = nn.ModuleList(
            nn.ModuleList(
                TwinsBlock(embed_dims[i], num_heads[i], mlp_ratios[i],
                           ws=1 if j % 2 == 1 else wss[i], sr_ratio=sr_ratios[i])
                for j in range(depths[i]))
            for i in range(len(depths)))
        self.norm_list = nn.ModuleList(_ln(d) for d in embed_dims)

    def forward(self, x):
        """x: [B, 3, H, W] -> 4 maps [B, C_i, H/4/2^i, W/4/2^i]."""
        outputs = []
        for i in range(len(self.depths)):
            x = self.patch_embeds[i](x)
            for j, blk in enumerate(self.blocks[i]):
                x = blk(x)
                if j == 0:
                    x = self.pos_block[i](x)
            x = self.norm_list[i](x)
            x = _nchw(x).contiguous()
            outputs.append(x)
        return outputs


PRESETS = {
    "alt_gvt_small": dict(embed_dims=(64, 128, 256, 512), num_heads=(2, 4, 8, 16),
                          depths=(2, 2, 10, 4)),
    "alt_gvt_base": dict(embed_dims=(96, 192, 384, 768), num_heads=(3, 6, 12, 24),
                         depths=(2, 2, 18, 2)),
    "alt_gvt_large": dict(embed_dims=(128, 256, 512, 1024), num_heads=(4, 8, 16, 32),
                          depths=(2, 2, 18, 2)),
}


def build_twins(arch: str) -> ALTGVT:
    return ALTGVT(**PRESETS[arch])
