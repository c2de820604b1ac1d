"""Twins-SVT (ALTGVT) pyramid vision transformer backbone.

Port of `mvsformer_tpu/models/twins.py`. Tokens stay in [B, H, W, C]
between blocks, so window partitioning is a reshape and permute, and the
Linear layers act on the last axis. Windowed attention is a plain matmul
with an fp32 softmax. Global sub-sampled attention is K6 `gsa_attention`
(the same maths, one kernel on the card) when the pass is deterministic;
K6 has no backward, so a training pass runs its plain version, the matmuls
and softmax autograd differentiates, as the JAX package runs its einsums.
A training pass also drops each residual branch per sample (stochastic
depth) with the rates of a linear ramp over the blocks, drawn from the
caller's `torch.Generator`.
LayerNorm eps is 1e-6 and GELU is the tanh form, as in the JAX package.
Attribute names are the reference checkpoint's (`patch_embeds`,
`pos_block`, `blocks`, `norm_list`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mvsformer_torch.models.blocks import Conv2d, LayerNorm, Linear, gelu_tanh
from mvsformer_torch.ops.gsa_attention import gsa_attention, gsa_attention_plain


def _ln(dim):
    return LayerNorm(dim, eps=1e-6)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def drop_path(x, rate: float, generator=None):
    """Zero each sample's branch with probability `rate` and scale the kept
    ones by 1 / (1 - rate); the mask is [N, 1, ...], one draw per sample."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1), dtype=x.dtype,
                       device=x.device).bernoulli_(keep, generator=generator)
    return x / keep * mask


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.act = gelu_tanh()
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class GroupAttention(nn.Module):
    """Windowed multi-head self-attention with a padding mask."""

    def __init__(self, dim, num_heads, ws=7):
        super().__init__()
        self.num_heads = num_heads
        self.ws = ws
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)

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
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, dim * 2)
        self.proj = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = _ln(dim)

    def forward(self, x, deterministic: bool = True):  # [B, H, W, C]
        B, H, W, C = x.shape
        q = self.q(x).reshape(B, H * W, C)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.norm(_nhwc(self.sr(_nchw(x))))
        kv = self.kv(kv_in).reshape(B, -1, 2 * C)  # [k | v], heads contiguous in each
        attend = gsa_attention if deterministic else gsa_attention_plain
        out = attend(q, kv[..., :C], kv[..., C:], self.num_heads)
        return self.proj(out.reshape(B, H, W, C))


class PosCNN(nn.Module):
    """Conditional positional encoding: depthwise 3x3 conv + residual."""

    def __init__(self, dim):
        super().__init__()
        self.proj = nn.Sequential(Conv2d(dim, dim, 3, 1, 1, groups=dim))

    def forward(self, x):  # [B, H, W, C]
        return _nhwc(self.proj(_nchw(x))) + x


class TwinsBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, ws, sr_ratio, drop_path_rate=0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = _ln(dim)
        if ws == 1:
            self.attn = GlobalSubsampledAttention(dim, num_heads, sr_ratio)
        else:
            self.attn = GroupAttention(dim, num_heads, ws)
        self.norm2 = _ln(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, deterministic: bool = True, generator=None):
        rate = 0.0 if deterministic else self.drop_path_rate
        if isinstance(self.attn, GlobalSubsampledAttention):
            h = self.attn(self.norm1(x), deterministic)
        else:
            h = self.attn(self.norm1(x))
        x = x + drop_path(h, rate, generator)
        return x + drop_path(self.mlp(self.norm2(x)), rate, generator)


class PatchEmbed(nn.Module):
    def __init__(self, cin, dim, patch):
        super().__init__()
        self.proj = Conv2d(cin, dim, patch, patch)
        self.norm = _ln(dim)

    def forward(self, x):  # NCHW -> [B, H/p, W/p, dim]
        return self.norm(_nhwc(self.proj(x)))


class ALTGVT(nn.Module):
    """Alternating local/global Twins backbone -> 4 pyramid maps (NCHW)."""

    def __init__(self, embed_dims=(64, 128, 256, 512), num_heads=(2, 4, 8, 16),
                 mlp_ratios=(4, 4, 4, 4), depths=(2, 2, 10, 4), wss=(7, 7, 7, 7),
                 sr_ratios=(8, 4, 2, 1), patch_size=4, drop_path_rate=0.2):
        super().__init__()
        self.depths = tuple(depths)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        starts = [sum(depths[:i]) for i in range(len(depths))]
        cins = (3,) + tuple(embed_dims[:-1])
        self.patch_embeds = nn.ModuleList(
            PatchEmbed(cins[i], embed_dims[i], patch_size if i == 0 else 2)
            for i in range(len(depths)))
        self.pos_block = nn.ModuleList(PosCNN(d) for d in embed_dims)
        self.blocks = nn.ModuleList(
            nn.ModuleList(
                TwinsBlock(embed_dims[i], num_heads[i], mlp_ratios[i],
                           ws=1 if j % 2 == 1 else wss[i], sr_ratio=sr_ratios[i],
                           drop_path_rate=dpr[starts[i] + j])
                for j in range(depths[i]))
            for i in range(len(depths)))
        self.norm_list = nn.ModuleList(_ln(d) for d in embed_dims)

    def forward(self, x, deterministic=None, generator=None):
        """x: [B, 3, H, W] -> 4 maps [B, C_i, H/4/2^i, W/4/2^i].

        `deterministic` defaults to `not self.training`; a deterministic
        pass drops no path and runs K6."""
        if deterministic is None:
            deterministic = not self.training
        outputs = []
        for i in range(len(self.depths)):
            x = self.patch_embeds[i](x)
            for j, blk in enumerate(self.blocks[i]):
                x = blk(x, deterministic, generator)
                if j == 0:
                    x = self.pos_block[i](x)
            x = self.norm_list[i](x)
            x = _nchw(x).contiguous()
            outputs.append(x)
        return outputs


PRESETS = {
    "alt_gvt_small": dict(embed_dims=(64, 128, 256, 512), num_heads=(2, 4, 8, 16),
                          depths=(2, 2, 10, 4), drop_path_rate=0.2),
    "alt_gvt_base": dict(embed_dims=(96, 192, 384, 768), num_heads=(3, 6, 12, 24),
                         depths=(2, 2, 18, 2), drop_path_rate=0.2),
    "alt_gvt_large": dict(embed_dims=(128, 256, 512, 1024), num_heads=(4, 8, 16, 32),
                          depths=(2, 2, 18, 2), drop_path_rate=0.3),
}


def build_twins(arch: str, drop_path_rate: float | None = None) -> ALTGVT:
    """The preset `arch`, with its own drop-path rate unless one is given."""
    kwargs = dict(PRESETS[arch])
    if drop_path_rate is not None:
        kwargs["drop_path_rate"] = drop_path_rate
    return ALTGVT(**kwargs)
