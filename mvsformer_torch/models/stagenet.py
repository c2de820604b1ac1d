"""One cascade stage, eval forward: plane-sweep cost volume, visibility-weighted
view fusion, 3D regularisation and depth decode.

Port of `mvsformer_tpu/models/stagenet.py` for `fusion_type="cnn"`. Per
stage, one K1 launch covers every source view (warp, correlation and
entropy), one K2 launch runs the visibility CNN over all B*Vs entropy maps,
and one K3 launch decodes the depth. The epipole fusions, the training
forward and the similarity diagnostic come with later slices.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mvsformer_torch.models.blocks import ConvBnReLU
from mvsformer_torch.models.costreg import CostRegNet, CostRegNet3D
from mvsformer_torch.ops import geometry
from mvsformer_torch.ops.stage_tail import depth_decode
from mvsformer_torch.ops.vis_net import visibility_net
from mvsformer_torch.ops.warp_corr import warp_group_corr


class VisibilityNet(nn.Sequential):
    """Entropy -> per-pixel visibility weight CNN (reference keys vis.0-3)."""

    def __init__(self):
        super().__init__(ConvBnReLU(1, 16), ConvBnReLU(16, 16), ConvBnReLU(16, 8),
                         nn.Conv2d(8, 1, 1))

    def forward(self, ent):
        """ent [N, H, W] -> weight [N, H, W] (eval BN, through K2)."""
        folds = [self[i].bn.folded() for i in range(3)]
        return visibility_net(ent, self[0].conv.weight, self[1].conv.weight,
                              self[2].conv.weight, self[3].weight, self[3].bias, folds)


class StageNet(nn.Module):
    def __init__(self, ndepth: int, base_ch: int = 8, model_th: int = 8):
        super().__init__()
        self.ndepth = ndepth
        self.base_ch = base_ch
        self.vis = VisibilityNet()
        if ndepth <= model_th:
            self.cost_reg = CostRegNet3D(base_ch, base_ch)
        else:
            self.cost_reg = CostRegNet(base_ch, base_ch)

    def forward(self, ref_feat, src_feats, ref_proj, src_projs, depth_values, tmp: float):
        """ref_feat [B,C,H,W]; src_feats [B,Vs,C,H,W]; ref_proj [B,2,4,4];
        src_projs [B,Vs,2,4,4]; depth_values [B,D,H,W] -> stage outputs."""
        B, C, H, W = ref_feat.shape
        Vs = src_feats.shape[1]
        G = self.base_ch
        dv = depth_values.float().contiguous()
        ref_full = geometry.compose_projection(ref_proj.float())
        src_full = geometry.compose_projection(src_projs.float())
        # K1 reads channels-last features: each bilinear tap is one C-vector.
        ref_cl = ref_feat.float().permute(0, 2, 3, 1).contiguous()
        src_cl = src_feats.float().permute(0, 1, 3, 4, 2).contiguous()
        corr, ent = warp_group_corr(ref_cl, src_cl, src_full, ref_full, dv, groups=G)
        w = self.vis(ent.reshape(B * Vs, H, W)).reshape(B, Vs, H, W)

        # Weighted view mean, accumulated view by view in the reference's order.
        volume_sum = corr[:, 0] * w[:, 0, None, None]
        for v in range(1, Vs):
            volume_sum.addcmul_(corr[:, v], w[:, v, None, None])
        del corr
        vis_sum = w.sum(dim=1)[:, None, None]  # [B, 1, 1, H, W]
        volume_mean = volume_sum / (vis_sum + 1e-6)

        logits = self.cost_reg(volume_mean)[:, 0].float().contiguous()  # [B, D, H, W]
        # The ce/was eval decode; build_model rejects the other depth types.
        depth, conf = depth_decode(logits, dv, tmp)
        return {"depth": depth, "photometric_confidence": conf,
                "prob_volume_pre": logits, "depth_values": dv}
