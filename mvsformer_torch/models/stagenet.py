"""One cascade stage: plane-sweep cost volume, view fusion, 3D
regularisation and depth decode.

Port of `mvsformer_tpu/models/stagenet.py` for its three fusion types:
- `cnn`: one weight per view and pixel, from the visibility CNN on the
  entropy of the view's correlation over depth;
- `epipole`: one weight per view, depth and pixel, a softmax over depth of
  the correlation at the fixed temperature `attn_temp`, and the
  (1, 3, 3)-kernel `CostRegNet2D`;
- `epipoleV2`: the same softmax at a learned temperature (`attn_temp`,
  initialised to 1), with the bins whose projection leaves the source
  frustum masked out, and `CostRegNet3D` at every stage. The mask comes
  from `geometry.plane_sweep_coords`, the unclipped warp the kernels
  compute.

Eval: per stage, one K1 launch covers every source view (warp,
correlation and entropy; the entropy is read by cnn fusion only); under
cnn fusion with BN one K2 launch runs the visibility CNN over all B*Vs
entropy maps (under GN, IN or no norm its modules run, as the JAX package
gates its kernel on BN); for ce and was one K3 launch decodes the depth,
and `regression.decode_depth` the other depth types.

Training, as the JAX training forward runs it: one K7 launch for the
correlation of every view and K8 for its backward (`WarpCorrTrain`); under
cnn fusion the entropy in torch ops on the correlation and the visibility
CNN as its modules with batch-statistics BN, once per view as the JAX view
loop calls it (so its running statistics take one update per view); then
`regression.decode_depth`. K1-K3 take folded BN or have no backward and
run in eval only.

The similarity diagnostic (eval, `want_similarity`): each source view is
warped again through the plain `geometry.homo_warp` (K1 computes the
correlation, not the warped volume), the views' cosine-similarity volumes
(`correlation.cosine_similarity_volume`) are summed, and `sim_depth` is
the hypothesis at their argmax over depth, as the JAX StageNet computes
it off the TPU. Under a view split the sum joins the view all-reduce.

Under a view split (the model's layout, `parallel/mesh.py`) a stage gets
the reference view and this rank's sources; `volume_sum` and the sum of
the weights, both fp32, are completed by a differentiable all-reduce over
the view group before the division (the JAX StageNet's psum over "view",
stagenet.py:328-332), so every view rank regularises and decodes the
same volume. The weights are each fusion's own (cnn, epipole and
epipoleV2 alike).

Under a depth split (eval only) every rank of the depth group computes the
whole volume as above, regularises its slab of the D axis with the halo
exchange (`parallel/depth.DepthSlabs`; the JAX package's constraint on
`volume_mean`, stagenet.py:334-336) and gathers the logits, so the decode
runs over all D hypotheses on every rank.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mvsformer_torch.models.blocks import Conv2d, ConvBnReLU, like
from mvsformer_torch.models.costreg import CostRegNet, CostRegNet2D, CostRegNet3D
from mvsformer_torch.ops import geometry, regression
from mvsformer_torch.ops.correlation import (cosine_similarity_volume, entropy_over_depth,
                                             epipole_v2_weight, epipole_weight)
from mvsformer_torch.ops.stage_tail import depth_decode
from mvsformer_torch.ops.vis_net import visibility_net
from mvsformer_torch.ops.warp_corr import warp_group_corr
from mvsformer_torch.ops.warp_corr_train import WarpCorrTrain
from mvsformer_torch.parallel.mesh import TRAIN_DEPTH_REFUSAL, all_sum

FUSION_TYPES = ("cnn", "epipole", "epipoleV2")


class VisibilityNet(nn.Sequential):
    """Entropy -> per-pixel visibility weight CNN (reference keys vis.0-3)."""

    def __init__(self, norm="BN"):
        super().__init__(ConvBnReLU(1, 16, norm=norm), ConvBnReLU(16, 16, norm=norm),
                         ConvBnReLU(16, 8, norm=norm), Conv2d(8, 1, 1))
        self.kernel = norm == "BN"  # K2 runs the eval forward

    def forward(self, ent):
        """ent [N, H, W] in the compute dtype -> weight [N, H, W] in fp32 (the
        sigmoid is an fp32 island): K2 with folded BN in eval, the layers
        (batch-statistics BN in training) otherwise."""
        if self.training or not self.kernel:
            x = ent[:, None]
            for i in range(3):
                x = self[i](x)
            return torch.sigmoid(self[3](x).float())[:, 0]
        folds = [self[i].bn.folded() for i in range(3)]
        return visibility_net(ent, *(like(w, ent) for w in (
            self[0].conv.weight, self[1].conv.weight, self[2].conv.weight, self[3].weight,
            self[3].bias)), folds)


class StageNet(nn.Module):
    view_group = None  # the ranks that split the source views (parallel/mesh.py)
    depth_slabs = None  # this rank's part of the depth axis (parallel/depth.py)

    def __init__(self, ndepth: int, base_ch: int = 8, model_th: int = 8,
                 fusion_type: str = "cnn", depth_type: str = "ce", norm: str = "BN",
                 attn_temp: float = 2.0):
        super().__init__()
        if fusion_type not in FUSION_TYPES:
            raise ValueError(f"unknown fusion_type {fusion_type!r}; one of {FUSION_TYPES}")
        self.ndepth = ndepth
        self.base_ch = base_ch
        self.fusion_type = fusion_type
        self.depth_type = depth_type
        self.fixed_temp = attn_temp  # epipole's
        if fusion_type == "cnn":
            self.vis = VisibilityNet(norm)
        elif fusion_type == "epipoleV2":
            self.attn_temp = nn.Parameter(torch.tensor(1.0))
        if fusion_type == "epipole":
            self.cost_reg = CostRegNet2D(base_ch, norm)
        elif fusion_type == "epipoleV2" or ndepth <= model_th:
            self.cost_reg = CostRegNet3D(base_ch, base_ch, norm)
        else:
            self.cost_reg = CostRegNet(base_ch, base_ch, norm=norm)

    def view_weights(self, corr, ent, channels, src_full, ref_full, dv, dt):
        """corr [B, Vs, G, D, H, W] (ent [B, Vs, H, W], read by cnn fusion
        in eval; `channels` the features', read by epipole) -> fp32 weights
        [B, Vs, 1, 1 or D, H, W] that broadcast over a view's
        correlation. The visibility CNN reads the entropy in the compute
        dtype `dt`."""
        B, Vs, G, D, H, W = corr.shape
        if self.fusion_type == "cnn":
            if self.training:
                w = torch.stack([self.vis(entropy_over_depth(corr[:, v].permute(0, 2, 3, 4, 1))
                                          [..., 0].to(dt)) for v in range(Vs)], 1)
            else:
                w = self.vis(ent.reshape(B * Vs, H, W).to(dt)).reshape(B, Vs, H, W)
            return w[:, :, None, None]
        views = [corr[:, v].permute(0, 2, 3, 4, 1) for v in range(Vs)]  # [B, D, H, W, G]
        if self.fusion_type == "epipole":
            w = [epipole_weight(c, self.fixed_temp, channels) for c in views]
        else:
            with torch.no_grad():
                invalid = [geometry.plane_sweep_coords(src_full[:, v], ref_full, dv, H, W)[2]
                           for v in range(Vs)]
            w = [epipole_v2_weight(c, self.attn_temp, m, G) for c, m in zip(views, invalid)]
        return torch.stack(w, 1)[:, :, None]

    def similarity(self, ref_cl, src_cl, src_full, ref_full, dv):
        """The sum over this rank's source views of the cosine-similarity
        volumes [B, D, H, W] of the reference features and each view warped
        by the plain `geometry.homo_warp` (fp32, channels-last inputs)."""
        sim = None
        for v in range(src_cl.shape[1]):
            warped, _ = geometry.homo_warp(src_cl[:, v], src_full[:, v], ref_full, dv)
            s = cosine_similarity_volume(ref_cl, warped, self.base_ch)
            sim = s if sim is None else sim + s
        return sim

    def forward(self, ref_feat, src_feats, ref_proj, src_projs, depth_values, tmp: float,
                want_similarity: bool = False):
        """ref_feat [B,C,H,W]; src_feats [B,Vs,C,H,W] in the compute dtype;
        ref_proj [B,2,4,4]; src_projs [B,Vs,2,4,4]; depth_values [B,D,H,W]
        -> stage outputs; with `want_similarity` (eval) also `sim_depth`
        [B, H, W].

        The fp32 islands of the bf16 mode, as the JAX StageNet keeps them:
        the projections, the hypotheses and the features the warp reads
        (K1, K7/K8), the correlation and the entropy, the view weights and
        the weighted view sum, and from the cost regulariser's logits on
        the decode. The visibility CNN and the cost regulariser compute in
        the features' dtype."""
        if self.training and self.depth_slabs is not None:
            raise NotImplementedError(TRAIN_DEPTH_REFUSAL)
        B, C, H, W = ref_feat.shape
        G = self.base_ch
        dt = ref_feat.dtype
        dv = depth_values.float().contiguous()
        ref_full = geometry.compose_projection(ref_proj.float())
        src_full = geometry.compose_projection(src_projs.float())
        # K1 and K7 read channels-last features: each bilinear tap is one C-vector.
        ref_cl = ref_feat.float().permute(0, 2, 3, 1).contiguous()
        src_cl = src_feats.float().permute(0, 1, 3, 4, 2).contiguous()
        if self.training:
            corr, ent = WarpCorrTrain.apply(ref_cl, src_cl, src_full, ref_full, dv, G), None
        else:
            corr, ent = warp_group_corr(ref_cl, src_cl, src_full, ref_full, dv, groups=G)
        w = self.view_weights(corr, ent, C, src_full, ref_full, dv, dt)
        sim = (self.similarity(ref_cl, src_cl, src_full, ref_full, dv) if want_similarity
               else None)

        # Weighted view mean, accumulated view by view in the reference's order;
        # under a view split each rank sums its own sources, and one
        # all-reduce over the view group completes both sums.
        volume_sum = corr[:, 0] * w[:, 0]
        for v in range(1, corr.shape[1]):
            volume_sum.addcmul_(corr[:, v], w[:, v])
        del corr
        w_sum = w.sum(dim=1)
        if self.view_group is not None:
            volume_sum = all_sum(volume_sum, self.view_group)
            w_sum = all_sum(w_sum, self.view_group)
            if sim is not None:
                sim = all_sum(sim, self.view_group)
        volume_mean = volume_sum / (w_sum + 1e-6)

        if self.depth_slabs is None:
            logits = self.cost_reg(volume_mean.to(dt))
        else:
            logits = self.depth_slabs.regularise(self.cost_reg, volume_mean.to(dt))
        logits = logits[:, 0].float().contiguous()
        if self.training or self.depth_type not in ("ce", "was"):
            depth, conf = regression.decode_depth(logits, dv, self.depth_type, tmp,
                                                  training=self.training)
        else:
            depth, conf = depth_decode(logits, dv, tmp)
        out = {"depth": depth, "photometric_confidence": conf,
               "prob_volume_pre": logits, "depth_values": dv}
        if sim is not None:
            out["sim_depth"] = torch.gather(dv, 1, sim.argmax(dim=1, keepdim=True))[:, 0]
        return out
