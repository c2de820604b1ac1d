"""Multi-view depth-map fusion: geometric consistency filtering.

Port of `mvsformer_tpu/ops/fusion.py`. For each reference pixel p with depth
d_ref: back-project to the world, project into a source view, bilinearly
sample the source depth there, back-project that estimate and re-project it
into the reference view, giving (x', y', d'). A source view confirms p when
|(x', y') - p| < dist_thresh and |d' - d_ref| / d_ref < rel_diff_thresh.
`pcd` takes fixed thresholds and at least thres_view confirmations, `dpcd`
dynamic per-count thresholds k / dist_base and k / rel_diff_base, and
`gipuma` a disparity-space check. The fused depth is the visibility average.
Pixel centres sit at integer + 0.5.

Where the JAX functions `vmap` over source views, these broadcast: every
function takes any leading batch axes, and the source views are one more of
them. Every small matrix product is written out as multiply-adds, so the
geometry is fp32 whatever TF32 is set to; `fuse.py` runs it under
`fp32_math` for the matrix inverses as well.
"""

from __future__ import annotations

import torch

from mvsformer_torch.ops.geometry import bilinear_sample


def _cam_parts(cam: torch.Tensor):
    """cam [..., 2, 4, 4] -> (extrinsic [..., 4, 4], K [..., 3, 3])."""
    return cam[..., 0, :, :], cam[..., 1, :3, :3]


def _inv(m: torch.Tensor) -> torch.Tensor:
    """Inverse of small matrices; like `jnp.linalg.inv`, no check for singular
    ones (which on a CUDA tensor would wait for the device)."""
    return torch.linalg.inv_ex(m).inverse


def _transform(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """m [..., n, k] applied to points p [..., H, W, k] -> [..., H, W, n]."""
    m = m[..., None, None, :, :]
    out = m[..., 0] * p[..., 0:1]
    for j in range(1, p.shape[-1]):
        out = out + m[..., j] * p[..., j:j + 1]
    return out


def _pixel_grid(h: int, w: int, device) -> torch.Tensor:
    """[H, W, 2] pixel centres (x, y)."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device) + 0.5,
                          torch.arange(w, dtype=torch.float32, device=device) + 0.5,
                          indexing="ij")
    return torch.stack([x, y], dim=-1)


def _lift(xy, depth, cam):
    """Pixels xy [..., H, W, 2] at depths [..., H, W] -> world [..., H, W, 3]."""
    ext, K = _cam_parts(cam)
    pix = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    cam_pts = _transform(_inv(K), pix)
    cam_pts = cam_pts / (cam_pts[..., 2:3] + 1e-9) * depth[..., None]
    cam_h = torch.cat([cam_pts, torch.ones_like(cam_pts[..., :1])], dim=-1)
    world_h = _transform(_inv(ext), cam_h)
    return world_h[..., :3] / (world_h[..., 3:4] + 1e-9)


def back_project(depth: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Lift reference pixels to world points: depth [..., H, W], cam [..., 2,
    4, 4] -> [..., H, W, 3] (pixel centres at +0.5)."""
    h, w = depth.shape[-2:]
    return _lift(_pixel_grid(h, w, depth.device), depth, cam)


def back_project_at(xy: torch.Tensor, depth: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Back-project arbitrary pixel positions xy [..., H, W, 2] at depths."""
    return _lift(xy, depth, cam)


def project(world: torch.Tensor, cam: torch.Tensor):
    """World points [..., H, W, 3] into a camera [..., 2, 4, 4] -> (xy [...,
    H, W, 2] pixel coordinates with +0.5 centres, z [..., H, W] depth)."""
    ext, K = _cam_parts(cam)
    world_h = torch.cat([world, torch.ones_like(world[..., :1])], dim=-1)
    cam_h = _transform(ext, world_h)
    cam_pts = cam_h[..., :3] / (cam_h[..., 3:4] + 1e-9)
    img = _transform(K, cam_pts)
    return img[..., :2] / (img[..., 2:3] + 1e-9), cam_pts[..., 2]


def _sample_depth(src_depth: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """src_depth [..., H, W] at pixel positions xy [..., H', W', 2] (+0.5
    centres; zero outside) -> [..., H', W']."""
    h, w = src_depth.shape[-2:]
    n = xy.shape[:-3].numel()
    out_hw = xy.shape[-3:-1]
    px = xy[..., 0].reshape(n, -1) - 0.5
    py = xy[..., 1].reshape(n, -1) - 0.5
    src = src_depth.expand(*xy.shape[:-3], h, w).reshape(n, h, w, 1)
    return bilinear_sample(src, px, py).reshape(*xy.shape[:-3], *out_hw)


def _reproject(world, ref_cam, src_depth, src_cam):
    """Reference world points [..., H, W, 3] through one or more source views
    and back: (xy' [..., H, W, 2], d' [..., H, W])."""
    src_xy, _ = project(world, src_cam)
    d_src = _sample_depth(src_depth, src_xy)
    return project(back_project_at(src_xy, d_src, src_cam), ref_cam)


def reproject(ref_depth, src_depth, ref_cam, src_cam):
    """One source view's reprojection of every reference pixel: (xy' [B, H,
    W, 2], d' [B, H, W]), where the source's geometry puts each reference
    pixel back in the reference view."""
    return _reproject(back_project(ref_depth, ref_cam), ref_cam, src_depth, src_cam)


def reproject_all(ref_depth, src_depths, ref_cam, src_cams):
    """Every source view at once: src_depths [B, V, H, W], src_cams [B, V, 2,
    4, 4] -> (xy [B, V, H, W, 2], d [B, V, H, W])."""
    world = back_project(ref_depth, ref_cam)[:, None]
    return _reproject(world, ref_cam[:, None], src_depths, src_cams)


def _reproj_distance(reproj_xy):
    h, w = reproj_xy.shape[-3:-1]
    return torch.linalg.vector_norm(reproj_xy - _pixel_grid(h, w, reproj_xy.device), dim=-1)


def vis_filter(ref_depth, reproj_xy, reproj_d, dist_thresh: float, rel_diff_thresh: float,
               thres_view: int):
    """Static consistency: (per-view masks [B, V, H, W], combined [B, H, W])."""
    dist = _reproj_distance(reproj_xy)
    ref = ref_depth[:, None]
    depth_ok = (ref - reproj_d).abs() < torch.maximum(ref, reproj_d) * rel_diff_thresh
    masks = (dist < dist_thresh) & depth_ok & (reproj_d > 0)
    return masks, masks.sum(dim=1) >= (thres_view - 1.1)


def ave_fusion(ref_depth, reproj_d, masks):
    """Visibility-averaged fused depth."""
    m = masks.to(ref_depth.dtype)
    return ((reproj_d * m).sum(dim=1) + ref_depth) / (m.sum(dim=1) + 1.0)


def vis_filter_dynamic(ref_depth, reproj_xy, reproj_d, dist_base: float = 4.0,
                       rel_diff_base: float = 1300.0):
    """Dynamic consistency: a pixel passes if at least k views agree at
    tolerance (k / dist_base px, k / rel_diff_base relative) for some k in
    [2, V + 1]. Returns (per-view masks at the loosest k [B, V, H, W], the
    combined mask [B, H, W])."""
    v = reproj_d.shape[1]
    dist = _reproj_distance(reproj_xy)
    rel = (ref_depth[:, None] - reproj_d).abs() / (ref_depth[:, None] + 1e-9)
    levels = torch.arange(2, v + 2, device=ref_depth.device)[:, None, None]
    ks = levels.float()
    masks_k = (dist[:, :, None] < ks / dist_base) & (rel[:, :, None] < ks / rel_diff_base)
    counts = masks_k.sum(dim=1)  # [B, levels, H, W]
    return masks_k[:, :, -1], (counts >= levels).any(dim=1)


def prob_mask(ref_conf, prob_threshold):
    """Confidence pre-filter: [B, H, W] against the first threshold, or a
    per-stage stack [B, S, H, W] against one threshold per stage."""
    if ref_conf.dim() == 4:
        mask = torch.ones_like(ref_conf[:, 0], dtype=torch.bool)
        for i, th in enumerate(prob_threshold):
            mask = mask & (ref_conf[:, i] > th)
        return mask
    th = prob_threshold[0] if isinstance(prob_threshold, (list, tuple)) else prob_threshold
    return ref_conf > th


def fuse_pcd(ref_depth, src_depths, ref_cam, src_cams, ref_conf, prob_threshold,
             dist_thresh=1.0, rel_diff_thresh=0.01, thres_view=5):
    """Static fusion of one reference view: (mask [B, H, W] bool, fused depth
    [B, H, W], world points [B, H, W, 3])."""
    xy, d = reproject_all(ref_depth, src_depths, ref_cam, src_cams)
    masks, vis_mask = vis_filter(ref_depth, xy, d, dist_thresh, rel_diff_thresh, thres_view)
    fused = ave_fusion(ref_depth, d, masks)
    return prob_mask(ref_conf, prob_threshold) & vis_mask, fused, back_project(fused, ref_cam)


def fuse_dpcd(ref_depth, src_depths, ref_cam, src_cams, ref_conf, prob_threshold,
              dist_base=4.0, rel_diff_base=1300.0):
    """Dynamic fusion of one reference view; returns as `fuse_pcd`."""
    xy, d = reproject_all(ref_depth, src_depths, ref_cam, src_cams)
    loosest, geo_mask = vis_filter_dynamic(ref_depth, xy, d, dist_base, rel_diff_base)
    fused = ((torch.where(loosest, d, 0.0).sum(dim=1) + ref_depth)
             / (loosest.sum(dim=1).to(ref_depth.dtype) + 1.0))
    return prob_mask(ref_conf, prob_threshold) & geo_mask, fused, back_project(fused, ref_cam)


def vis_filter_disparity(ref_depth, src_depths, ref_cam, src_cams, disp_thresh: float,
                         num_consistent: int, want_reproj_depth: bool = False):
    """Consistency in disparity space (fusibile's --disp_thresh and
    --num_consistent): project each reference point into source view v at
    depth z_v, sample that view's depth d_v there, and let v confirm it when
    f_v * b_v * |1/z_v - 1/d_v| < disp_thresh, with b_v the baseline between
    camera centres and f_v the source focal length.

    Returns (per-view masks [B, V, H, W], combined [B, H, W]) and, with
    want_reproj_depth, the sources' reprojected depths d' [B, V, H, W]."""
    h, w = ref_depth.shape[-2:]
    world = back_project(ref_depth, ref_cam)[:, None]
    ref_center = _inv(ref_cam[:, 0])[:, None, :3, 3]  # [B, 1, 3]
    xy, z = project(world, src_cams)
    d_v = _sample_depth(src_depths, xy)
    ext, K = _cam_parts(src_cams)
    baseline = torch.linalg.vector_norm(_inv(ext)[..., :3, 3] - ref_center, dim=-1)
    fb = (K[..., 0, 0] * baseline)[..., None, None]
    disp_diff = fb * (1.0 / z.clamp_min(1e-6) - 1.0 / d_v.clamp_min(1e-6)).abs()
    x, y = xy[..., 0], xy[..., 1]
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    masks = (disp_diff < disp_thresh) & (d_v > 0) & (z > 0) & inside
    combined = masks.sum(dim=1) >= num_consistent
    if want_reproj_depth:
        _, back_z = project(back_project_at(xy, d_v, src_cams), ref_cam[:, None])
        return masks, combined, back_z
    return masks, combined


def fuse_gipuma(ref_depth, src_depths, ref_cam, src_cams, ref_conf, prob_threshold,
                disp_thresh=0.1, num_consistent=2):
    """Fusibile-equivalent fusion of one reference view: the confidence
    pre-filter, disparity-space consistency and the visibility-averaged
    depth; returns as `fuse_pcd`."""
    masks, vis_mask, d = vis_filter_disparity(ref_depth, src_depths, ref_cam, src_cams,
                                              disp_thresh, num_consistent,
                                              want_reproj_depth=True)
    fused = ave_fusion(ref_depth, d, masks & (d > 0))
    return prob_mask(ref_conf, prob_threshold) & vis_mask, fused, back_project(fused, ref_cam)
