"""The DTU training and validation dataset (multi-scale and fixed-scale).

Port of `mvsformer_tpu/data/dtu.py`, sample for sample: the same metas
(scan, light, reference view, source views), the same crop-size barrels,
and the same draws from the dataset's numpy `Generator` in the same order
(the source shuffle, `JitterParams.draw`, the enlarge factor, then one
`integers` pair per crop try). Images are decoded by the port's own codecs
and resized by `utils/image.resize_area_u8` (OpenCV's INTER_AREA, bit for
bit in the tests) and `resize_nearest` (INTER_NEAREST); nothing here needs
OpenCV. Samples are numpy, channels last, as the JAX dataset gives them:

    {imgs [V, H, W, 3] float32 (normalised), proj_matrices {stageK: [V, 2, 4, 4]},
     depth {stageK: [H/s, W/s]}, mask {stageK}, depth_values [D], filename}

The mask is the reference view's grey `depth_visual` PNG > 10. Images are
JPEG (decoded bit for bit as cv2 decodes it), PNG, PPM or PGM, by content.
"""

from __future__ import annotations

import os

import numpy as np

from mvsformer_torch.data.augment import JitterParams, apply_jitter, normalize
from mvsformer_torch.utils.cams import read_cam_file, read_pair_file
from mvsformer_torch.utils.image import read_image, resize_area_u8, resize_nearest
from mvsformer_torch.utils.pfm import read_pfm

STAGE_SCALES = {"stage1": 8, "stage2": 4, "stage3": 2, "stage4": 1}
CROP_TRIES = 64  # crops tried until the reference's stage-1 mask has a valid pixel


def stage_pyramid(arr: np.ndarray) -> dict:
    """Nearest-resize pyramid: stageK at 1/8, 1/4, 1/2 and 1 of `arr`."""
    h, w = arr.shape[:2]
    return {key: arr if s == 1 else resize_nearest(arr, (h // s, w // s)).numpy()
            for key, s in STAGE_SCALES.items()}


def stage_proj_matrices(proj: np.ndarray) -> dict:
    """proj [V, 2, 4, 4] at full resolution -> {stageK}: the intrinsics'
    rows 0-1 divided by 8, 4, 2, 1."""
    out = {}
    for key, s in STAGE_SCALES.items():
        p = proj.copy()
        p[:, 1, :2, :] = proj[:, 1, :2, :] / s
        out[key] = p
    return out


class DTUMVSDataset:
    """Map-style dataset over the DTU training layout:
    Cameras/pair.txt and Cameras/<vid>_cam.txt,
    DTU_origin/Rectified/<scan>/rect_<vid+1>_<light>_r5000.png and
    Depths_raw/<scan>/depth_map_<vid>.pfm, depth_visual_<vid>.png.

    In training (mode "train") each sample shuffles its source views, may
    draw a colour jitter, enlarges its barrel's crop size by a random factor
    in `resize_range`, resizes the images by the scale that covers it
    (clipped to [MIN_RESIZE, 1] of BASE_H x BASE_W) and crops at a random
    offset; otherwise it resizes by `resize_scale` and takes the centre
    crop of height x width."""

    BASE_H, BASE_W = 1200, 1600  # DTU's rectified resolution
    MIN_RESIZE = 0.45

    def __init__(self, datapath, listfile, mode, nviews, ndepths=192,
                 interval_scale=1.06, crop=False, augment=False, aug_args=None,
                 height=512, width=640, multi_scale=False, multi_scale_args=None,
                 resize_scale=0.5, consist_crop=False, batch_size=4, seed=123):
        self.datapath = datapath
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.height, self.width = height, width
        self.crop = crop if mode == "train" else False
        self.augment = augment if mode == "train" else False
        self.aug_args = aug_args or {}
        self.multi_scale = multi_scale
        msa = multi_scale_args or {}
        self.scales = list(msa.get("scales", [[height, width]]))[::-1]
        self.resize_range = msa.get("resize_range", [1.0, 1.2])
        self.resize_scale = resize_scale
        self.consist_crop = consist_crop
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.idx_map = None

        if isinstance(listfile, (list, tuple)):
            scans = list(listfile)
        else:
            with open(listfile) as f:
                scans = [line.rstrip() for line in f if line.strip()]
        self.metas = self._build_list(scans)

    def _build_list(self, scans):
        """(scan, light, ref, srcs) for every view of pair.txt and 7 lights."""
        pairs = read_pair_file(os.path.join(self.datapath, "Cameras/pair.txt"))
        return [(scan, light, ref, list(srcs))
                for scan in scans for ref, srcs in pairs for light in range(7)]

    def __len__(self):
        return len(self.metas)

    def reset_dataset(self, shuffled_idx):
        """Barrels: each run of batch_size consecutive samples of the
        shuffled order shares one crop size."""
        self.idx_map = {int(sid): n // self.batch_size
                        for n, sid in enumerate(np.asarray(shuffled_idx).tolist())}

    def crop_size_for(self, idx: int):
        if self.mode == "train" and self.multi_scale and self.idx_map is not None:
            return self.scales[self.idx_map[idx] % len(self.scales)]
        return [self.height, self.width]

    # -- files ---------------------------------------------------------------

    def file_paths(self, scan, vid, light):
        return {
            "img": os.path.join(
                self.datapath, f"DTU_origin/Rectified/{scan}/rect_{vid + 1:0>3}_{light}_r5000.png"),
            "mask": os.path.join(self.datapath, f"Depths_raw/{scan}/depth_visual_{vid:0>4}.png"),
            "depth": os.path.join(self.datapath, f"Depths_raw/{scan}/depth_map_{vid:0>4}.pfm"),
            "cam": os.path.join(self.datapath, f"Cameras/{vid:0>8}_cam.txt"),
        }

    def _read_cam(self, path):
        """-> (intrinsics [3, 3], extrinsics [4, 4], depth_min, depth_interval)."""
        cam = read_cam_file(path, self.interval_scale)
        return cam.intrinsic, cam.extrinsic, cam.depth_min, cam.depth_interval

    def _read_mask(self, paths, depth):
        return (read_image(paths["mask"], gray=True).astype(np.float32) > 10).astype(np.float32)

    def _source_views(self, src_views):
        src_views = list(src_views)
        if self.mode == "train":
            self.rng.shuffle(src_views)
        return src_views

    # -- geometry-preserving resize and crop ---------------------------------

    @staticmethod
    def pre_resize(img, depth, intrinsics, mask, scale):
        h, w = img.shape[:2]
        nh, nw = int(h * scale), int(w * scale)
        img = resize_area_u8(img, (nh, nw))
        intrinsics = intrinsics.copy()
        intrinsics[0, :] *= scale
        intrinsics[1, :] *= scale
        if depth is not None:
            depth = resize_nearest(depth, (nh, nw)).numpy()
        if mask is not None:
            mask = resize_nearest(mask, (nh, nw)).numpy()
        return img, depth, intrinsics, mask

    def final_crop(self, img, depth, intrinsics, mask, ch, cw, oy=None, ox=None):
        h, w = img.shape[:2]
        if oy is None or ox is None:
            if self.crop:
                oy = int(self.rng.integers(0, h - ch + 1))
                ox = int(self.rng.integers(0, w - cw + 1))
            else:
                oy = (h - ch) // 2
                ox = (w - cw) // 2
        img = img[oy:oy + ch, ox:ox + cw]
        intrinsics = intrinsics.copy()
        intrinsics[0, 2] -= ox
        intrinsics[1, 2] -= oy
        depth = depth[oy:oy + ch, ox:ox + cw] if depth is not None else None
        mask = mask[oy:oy + ch, ox:ox + cw] if mask is not None else None
        return img, depth, intrinsics, mask, oy, ox

    # -- the sample ----------------------------------------------------------

    def __getitem__(self, idx):
        scan, light, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + self._source_views(src_views)[: self.nviews - 1]

        jitter = JitterParams.draw(self.rng, **self.aug_args) if self.augment else None

        crop_h, crop_w = self.crop_size_for(idx)
        if self.mode == "train":
            enlarge = self.resize_range[0] + self.rng.random() * (
                self.resize_range[1] - self.resize_range[0])
            rs_h = np.clip((crop_h * enlarge) / self.BASE_H, self.MIN_RESIZE, 1.0)
            rs_w = np.clip((crop_w * enlarge) / self.BASE_W, self.MIN_RESIZE, 1.0)
            resize_scale = float(max(rs_h, rs_w))
        else:
            resize_scale = self.resize_scale

        imgs, projs = [], []
        depth_ms = mask_ms = depth_values = None
        oy = ox = None
        for i, vid in enumerate(view_ids):
            paths = self.file_paths(scan, vid, light)
            img = read_image(paths["img"])
            intrinsics, extrinsics, depth_min, depth_interval = self._read_cam(paths["cam"])
            depth_hr = mask_hr = None
            if i == 0:
                depth_hr = read_pfm(paths["depth"])[0]
                mask_hr = self._read_mask(paths, depth_hr)

            if resize_scale != 1.0:
                img, depth_hr, intrinsics, mask_hr = self.pre_resize(
                    img, depth_hr, intrinsics, mask_hr, resize_scale)

            if i == 0:
                for _ in range(CROP_TRIES):
                    img_, depth_, intr_, mask_, oy, ox = self.final_crop(
                        img, depth_hr, intrinsics, mask_hr, crop_h, crop_w)
                    m_ms = stage_pyramid(mask_)
                    if self.mode != "train" or np.any(m_ms["stage1"] > 0.0):
                        break
                depth_ms = stage_pyramid(depth_)
                mask_ms = m_ms
                img, intrinsics = img_, intr_
                depth_max = depth_interval * self.ndepths + depth_min
                depth_values = np.arange(depth_min, depth_max, depth_interval, dtype=np.float32)
            else:
                use_oy, use_ox = (oy, ox) if self.consist_crop else (None, None)
                img, _, intrinsics, _, _, _ = self.final_crop(
                    img, None, intrinsics, None, crop_h, crop_w, use_oy, use_ox)

            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = extrinsics
            proj[1, :3, :3] = intrinsics
            projs.append(proj)

            imgf = img.astype(np.float32) / 255.0
            if jitter is not None:
                imgf = apply_jitter(imgf, jitter)
            imgs.append(normalize(imgf))

        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": stage_proj_matrices(np.stack(projs)),
            "depth": depth_ms,
            "mask": mask_ms,
            "depth_values": depth_values[: self.ndepths],
            "filename": scan + "/{}/" + f"{view_ids[0]:0>8}" + "{}",
        }
