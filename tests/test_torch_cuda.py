"""The port's hand-written kernels against their plain versions, on the GPU.

Every test here needs an NVIDIA GPU with the CUDA toolkit and Triton, and
skips without one. This file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.stage_tail import depth_decode, depth_decode_plain
from mvsformer_torch.ops.vis_net import visibility_net, visibility_net_plain
from mvsformer_torch.ops.warp_corr import warp_group_corr, warp_group_corr_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def cams(rng, B, V, H, W):
    K = np.array([[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]], np.float32)

    def full(tx, ang):
        c, s = np.cos(ang), np.sin(ang)
        P = np.eye(4, dtype=np.float32)
        P[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        P[0, 3] = tx
        out = np.eye(4, dtype=np.float32)
        out[:3] = K @ P[:3]
        return out

    ref = np.stack([full(0.0, 0.0)] * B)
    src = np.stack([np.stack([full(rng.uniform(-4, 4), rng.uniform(-0.05, 0.05))
                              for _ in range(V)]) for _ in range(B)])
    return src, ref


@pytest.mark.parametrize("B,V,H,W,C,D", [(1, 4, 36, 48, 64, 32), (2, 1, 37, 45, 8, 4),
                                         (1, 2, 72, 96, 16, 8)])
def test_warp_group_corr_matches_plain(dev, B, V, H, W, C, D):
    rng = np.random.default_rng(0)
    src_p, ref_p = cams(rng, B, V, H, W)
    dv = np.sort(rng.uniform(425, 900, (B, D, H, W)).astype(np.float32), axis=1)
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.standard_normal((B, H, W, C)).astype(np.float32),
        rng.standard_normal((B, V, H, W, C)).astype(np.float32), src_p, ref_p, dv)]
    before = cuda_build.LAUNCHES["warp_group_corr"]
    corr, ent = warp_group_corr(*args, groups=8)
    assert cuda_build.LAUNCHES["warp_group_corr"] == before + 1
    want_corr, want_ent = warp_group_corr_plain(*args, groups=8)
    # Same products summed in another order; coordinates differ in the last bit.
    torch.testing.assert_close(corr, want_corr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ent, want_ent, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("N,H,W", [(4, 144, 192), (3, 17, 50)])
def test_visibility_net_matches_plain(dev, N, H, W):
    rng = np.random.default_rng(1)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    ks = [t(rng.standard_normal(s) * f) for s, f in
          (((16, 1, 3, 3), 9 ** -0.5), ((16, 16, 3, 3), 144 ** -0.5), ((8, 16, 3, 3), 144 ** -0.5))]
    folds = [(t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c)))
             for c in (16, 16, 8)]
    k3, b3 = t(rng.standard_normal((1, 8, 1, 1)) * 0.35), t(rng.standard_normal(1) * 0.1)
    ent = t(rng.uniform(0, 3.5, (N, H, W)))
    got = visibility_net(ent, *ks, k3, b3, folds)
    want = visibility_net_plain(ent, *ks, k3, b3, folds)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)  # fp32, sum order


@pytest.mark.parametrize("shape", [(1, 32, 144, 192), (2, 4, 37, 45)])
def test_depth_decode_matches_plain(dev, shape):
    rng = np.random.default_rng(2)
    logits = torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32)).to(dev)
    dv = torch.from_numpy(np.sort(rng.uniform(425, 900, shape).astype(np.float32), 1)).to(dev)
    depth, conf = depth_decode(logits, dv, 5.0)
    want_d, want_c = depth_decode_plain(logits, dv, 5.0)
    # exp(tmp*(l-m)) against softmax(tmp*l): ~1e-6 relative in each weight.
    torch.testing.assert_close(depth, want_d, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(conf, want_c, rtol=1e-5, atol=1e-6)


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros((1, 8, 8, 8), device=dev)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA tensors
        warp_group_corr(x, x[:, None], torch.eye(4)[None, None], torch.eye(4, device=dev)[None],
                        torch.ones((1, 4, 8, 8), device=dev))
    with pytest.raises(TypeError):  # float64 is not taken
        depth_decode(torch.zeros((1, 4, 8, 8), device=dev, dtype=torch.float64),
                     torch.zeros((1, 4, 8, 8), device=dev, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError):  # D > 32
        eye = torch.eye(4, device=dev)
        warp_group_corr(x, x[:, None], eye[None, None], eye[None],
                        torch.ones((1, 33, 8, 8), device=dev))
