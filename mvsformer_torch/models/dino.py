"""The DINO ViT backbone and DINOMVSNet (MVSFormer-P).

Port of `mvsformer_tpu/models/dino.py`. `DINOViT` is the reference's DINO
ViT: a 16x16 patch conv (stride 16, no padding), a CLS token, a position
embedding learnt on the 14x14 grid of a 224x224 image and resized
bicubically (torch's align_corners=False, no antialias) to the actual
grid, pre-norm blocks of multi-head attention and a tanh-GELU MLP, and a
final LayerNorm. It returns the tokens beside the last block's attention
map. Attention is a plain matmul with an fp32 softmax: the JAX package has
no kernel for it. Its `drop_path_rate` is never applied there, so the port
has no drop path. LayerNorm eps is 1e-6, as flax's.

With `cross_att` a `CrossBlock` (`models/cross_attention.py`) runs after
every depth // 4 blocks (`cross_block0`, ...), mixing the views of each
sample, the views of a sample consecutive in the batch (`nview` of them);
`forward` takes the epipoles for their encodings.

`DINOMVSNet` runs the ViT on the images rescaled by `vit_args.rescale` and
decodes its tokens as the JAX model chooses (dino.py:194-213): without
`att_fusion`, `VITDecoderStage4NoAtt`; under `multi_scale`,
`VITDecoderStage4`, whose three maps `FPNDecoderV2` fuses; else
`VITDecoderStage4Single`, which gates the tokens by the last block's
CLS-to-patch attention. A single map is added to the FPN encoder's 1/8-res
map. The cascade is the shared one. Its final confidence is the stages'
mean for every depth type, as the JAX DINOMVSNet computes it. With
`cfg.fix` the ViT runs under `no_grad` in training, as the JAX model
stops its gradient; with `remat_backbone` (training, not `fix`) it is
recomputed in the backward. The JAX DINOMVSNet builds its ViT without
`cross_att` whatever the config says, and so does this one (ROADMAP E9).
Attribute names are the reference checkpoint's (`cls_token`, `pos_embed`,
`patch_embed.proj`, `blocks.{i}`, `norm`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from mvsformer_torch.config import ModelConfig
from mvsformer_torch.models.blocks import Conv2d, LayerNorm, Linear
from mvsformer_torch.models.cross_attention import CrossBlock
from mvsformer_torch.models.decoders import (VITDecoderStage4, VITDecoderStage4NoAtt,
                                             VITDecoderStage4Single)
from mvsformer_torch.models.mvsformer import CascadeMVSNet, remat
from mvsformer_torch.models.twins import Mlp
from mvsformer_torch.ops.resize import resize_bicubic

PRESETS = {
    "vit_small": dict(embed_dim=384, depth=12, num_heads=6),
    "vit_base": dict(embed_dim=768, depth=12, num_heads=12),
}


def _ln(dim):
    return LayerNorm(dim, eps=1e-6)


class ViTAttention(nn.Module):
    def __init__(self, dim, num_heads, qk_scale="default"):
        super().__init__()
        self.num_heads = num_heads
        self.qk_scale = qk_scale
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        """x [B, N, C] -> (out [B, N, C], attention [B, heads, N, N] in fp32).
        The scale is hd^-0.5, times log_{qk_scale^2 + 1}(N) with a numeric
        `qk_scale` (N counts the CLS token)."""
        B, N, C = x.shape
        nh = self.num_heads
        hd = C // nh
        qkv = self.qkv(x).reshape(B, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        scale = hd ** -0.5
        if self.qk_scale != "default":
            scale = math.log(N, float(self.qk_scale) ** 2 + 1) * scale
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)).float() * scale, dim=-1)
        out = torch.matmul(attn.to(x.dtype), v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out), attn


class ViTBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, qk_scale="default"):
        super().__init__()
        self.norm1 = _ln(dim)
        self.attn = ViTAttention(dim, num_heads, qk_scale)
        self.norm2 = _ln(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        h, attn = self.attn(self.norm1(x))
        x = x + h
        return x + self.mlp(self.norm2(x)), attn


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, patch)

    def forward(self, x):  # [B, 3, H, W] -> [B, gh * gw, dim]
        return self.proj(x).flatten(2).transpose(1, 2)


CROSS_NUM = 4  # cross blocks a ViT with cross_att: one after every depth // 4 blocks


class DINOViT(nn.Module):
    def __init__(self, embed_dim=384, depth=12, num_heads=6, patch_size=16,
                 qk_scale="default", pretrain_grid=14, cross_att=False, nview=5):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.patch_size, self.pretrain_grid = patch_size, pretrain_grid
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid ** 2 + 1, embed_dim))
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, num_heads, qk_scale=qk_scale)
                                    for _ in range(depth))
        self.norm = _ln(embed_dim)
        self.cross_inter = depth // CROSS_NUM if cross_att else 0
        for k in range(depth // self.cross_inter if cross_att else 0):
            setattr(self, f"cross_block{k}", CrossBlock(embed_dim, num_heads, nview=nview))

    def pos_encoding(self, gh, gw, dtype):
        """[1, 1 + gh * gw, C]: the CLS position and the patch grid's,
        resized bicubically in fp32 unless the grid is the pretrain grid."""
        g, c = self.pretrain_grid, self.embed_dim
        patch_pos = self.pos_embed[:, 1:]
        if (gh, gw) != (g, g):
            grid = patch_pos.float().reshape(1, g, g, c).permute(0, 3, 1, 2)
            patch_pos = resize_bicubic(grid, (gh, gw)).permute(0, 2, 3, 1).reshape(1, gh * gw, c)
        return torch.cat([self.pos_embed[:, :1], patch_pos.to(self.pos_embed.dtype)],
                         dim=1).to(dtype)

    def forward(self, x, epipoles=None):
        """x [B, 3, H, W] -> (tokens [B, 1 + gh * gw, C] after the final
        norm, the last block's attention [B, heads, 1 + N, 1 + N] in fp32).
        With cross blocks, B is samples x `nview` and `epipoles` [samples,
        nview - 1, 2] (or None) feeds their encodings."""
        B, _, H, W = x.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        tokens = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, self.embed_dim),
                            self.patch_embed(x)], dim=1)
        tokens = tokens + self.pos_encoding(gh, gw, x.dtype)
        attn = None
        for i, blk in enumerate(self.blocks):
            tokens, attn = blk(tokens)
            if self.cross_inter and (i + 1) % self.cross_inter == 0:
                cross = getattr(self, f"cross_block{(i + 1) // self.cross_inter - 1}")
                tokens = cross(tokens, epipoles, gh, gw)
        return self.norm(tokens), attn


def build_vit(arch: str, patch_size=16, qk_scale="default", cross_att=False,
              nview=5) -> DINOViT:
    """`vit_small` or `vit_base`, with the cross-view blocks for `nview`
    views a sample under `cross_att`."""
    return DINOViT(**PRESETS[arch], patch_size=patch_size, qk_scale=qk_scale,
                   cross_att=cross_att, nview=nview)


class DINOMVSNet(CascadeMVSNet):
    always_average = True

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, layout=None):
        super().__init__(cfg, dtype)
        va = cfg.vit_args
        self.vit = build_vit(va.vit_arch, va.patch_size, va.qk_scale)
        vit_ch = va.vit_ch if isinstance(va.vit_ch, int) else 384
        dims = (self.vit.embed_dim, self.vit.num_heads, vit_ch, va.out_ch, cfg.norm_type)
        if not va.att_fusion:
            self.decoder_vit = VITDecoderStage4NoAtt(self.vit.embed_dim, va.out_ch,
                                                     cfg.norm_type)
        elif cfg.multi_scale:
            self.decoder_vit = VITDecoderStage4(*dims)
        else:
            self.decoder_vit = VITDecoderStage4Single(*dims)
        self.use_layout(layout)

    def extract_features(self, imgs, generator=None):
        """imgs [N, 3, H, W] -> per-stage maps (stage1..4 at 1/8..1/1), in
        the compute dtype. The ViT has no drop path, so `generator` is not
        used."""
        conv01, conv11, conv21, conv31 = self.encoder(imgs.to(self.compute_dtype))
        vit_imgs = self.vit_input(imgs)
        if self.training and self.cfg.fix:
            with torch.no_grad():
                tokens, attn = self.vit(vit_imgs)
        elif self.training and self.cfg.remat_backbone:
            tokens, attn = remat(self.vit, vit_imgs)
        else:
            tokens, attn = self.vit(vit_imgs)
        n, c = tokens.shape[0], tokens.shape[2]
        gh, gw = vit_imgs.shape[2] // self.vit.patch_size, vit_imgs.shape[3] // self.vit.patch_size
        vit_feat = tokens[:, 1:].transpose(1, 2).reshape(n, c, gh, gw)
        cls_att = attn[:, :, 0, 1:].reshape(n, -1, gh, gw).to(tokens.dtype)
        if self.cfg.multi_scale:
            return self.decoder(conv01, conv11, conv21, conv31,
                                *self.decoder_vit(vit_feat, cls_att))
        conv31 = conv31 + self.decoder_vit(vit_feat, cls_att)
        return self.decoder(conv01, conv11, conv21, conv31)
