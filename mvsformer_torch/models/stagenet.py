"""One cascade stage: plane-sweep cost volume, visibility-weighted view
fusion, 3D regularisation and depth decode.

Port of `mvsformer_tpu/models/stagenet.py` for `fusion_type="cnn"`.

Eval: per stage, one K1 launch covers every source view (warp, correlation
and entropy), one K2 launch runs the visibility CNN over all B*Vs entropy
maps, and one K3 launch decodes the depth.

Training, as the JAX training forward runs it: one K7 launch for the
correlation of every view and K8 for its backward (`WarpCorrTrain`); the
entropy in torch ops on the correlation; the visibility CNN as its modules
with batch-statistics BN, once per view as the JAX view loop calls it (so
its running statistics take one update per view); then the softmax and the
argmax decode. K1-K3 take folded BN or have no backward and run in eval
only. The epipole fusions and the similarity diagnostic come with later
slices.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mvsformer_torch.models.blocks import ConvBnReLU
from mvsformer_torch.models.costreg import CostRegNet, CostRegNet3D
from mvsformer_torch.ops import geometry, regression
from mvsformer_torch.ops.correlation import entropy_over_depth
from mvsformer_torch.ops.stage_tail import depth_decode
from mvsformer_torch.ops.vis_net import visibility_net
from mvsformer_torch.ops.warp_corr import warp_group_corr
from mvsformer_torch.ops.warp_corr_train import WarpCorrTrain


class VisibilityNet(nn.Sequential):
    """Entropy -> per-pixel visibility weight CNN (reference keys vis.0-3)."""

    def __init__(self):
        super().__init__(ConvBnReLU(1, 16), ConvBnReLU(16, 16), ConvBnReLU(16, 8),
                         nn.Conv2d(8, 1, 1))

    def forward(self, ent):
        """ent [N, H, W] -> weight [N, H, W]: K2 with folded BN in eval, the
        layers with batch-statistics BN in training."""
        if self.training:
            x = ent[:, None].to(self[3].weight.dtype)
            for i in range(3):
                x = self[i](x)
            return torch.sigmoid(self[3](x).float())[:, 0]
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
        # K1 and K7 read channels-last features: each bilinear tap is one C-vector.
        ref_cl = ref_feat.float().permute(0, 2, 3, 1).contiguous()
        src_cl = src_feats.float().permute(0, 1, 3, 4, 2).contiguous()
        if self.training:
            corr = WarpCorrTrain.apply(ref_cl, src_cl, src_full, ref_full, dv, G)
            w = torch.stack([self.vis(entropy_over_depth(corr[:, v].permute(0, 2, 3, 4, 1))[..., 0])
                             for v in range(Vs)], 1)
        else:
            corr, ent = warp_group_corr(ref_cl, src_cl, src_full, ref_full, dv, groups=G)
            w = self.vis(ent.reshape(B * Vs, H, W)).reshape(B, Vs, H, W)

        # Weighted view mean, accumulated view by view in the reference's order.
        volume_sum = corr[:, 0] * w[:, 0, None, None]
        for v in range(1, Vs):
            volume_sum.addcmul_(corr[:, v], w[:, v, None, None])
        del corr
        vis_sum = w.sum(dim=1)[:, None, None]  # [B, 1, 1, H, W]
        volume_mean = volume_sum / (vis_sum + 1e-6)

        logits = self.cost_reg(volume_mean.to(ref_feat.dtype))[:, 0].float().contiguous()
        # The ce/was decodes; build_model rejects the other depth types.
        if self.training:
            depth, conf = regression.decode_depth(logits, dv, "ce", tmp, training=True)
        else:
            depth, conf = depth_decode(logits, dv, tmp)
        return {"depth": depth, "photometric_confidence": conf,
                "prob_volume_pre": logits, "depth_values": dv}
