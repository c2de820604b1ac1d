"""The PyTorch port's TwinMVSNet eval forward against the JAX model (CPU).

Both sides run fp32 on the same weights (the JAX init with randomised BN
affine and running stats, carried across by the weight bridge) and the same
batch: tests/test_model.py's tiny_cfg / make_batch shape, B=1, V=3, 64x64,
ndepths 8/4/4/2, full-width alt_gvt_small, stage temperatures 5,5,5,1.
The port runs its plain kernel versions here (CPU tensors).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.config import ModelConfig as JaxModelConfig
from mvsformer_tpu.models.mvsformer import build_model as jax_build_model
from mvsformer_tpu.utils.convert_weights import convert_full_twin

from mvsformer_torch.config import ModelConfig
from mvsformer_torch.infer import make_infer_fn
from mvsformer_torch.models.mvsformer import build_model
from mvsformer_torch.utils.convert_weights import load_flax_twin

torch.set_num_threads(2)

CFG = dict(ndepths=[8, 4, 4, 2], depth_interals_ratio=[4.0, 2.67, 1.5, 1.0],
           feat_chs=[8, 16, 32, 64], base_ch=8, depth_type="ce",
           inverse_depth=True, fusion_type="cnn")
TMPS = [5.0, 5.0, 5.0, 1.0]


def make_batch(rng, B=1, V=3, H=64, W=64, ndepth_full=48):
    """numpy copy of tests/test_model.py make_batch."""
    imgs = rng.standard_normal((B, V, H, W, 3), dtype=np.float32)
    K = np.array([[80.0, 0, W / 4], [0, 80.0, H / 4], [0, 0, 1]], np.float32)
    projs = {}
    for s, scale in zip(range(1, 5), (1 / 8, 1 / 4, 1 / 2, 1.0)):
        cams = np.zeros((B, V, 2, 4, 4), np.float32)
        for v in range(V):
            ext = np.eye(4, dtype=np.float32)
            ext[0, 3] = v * 2.0
            cams[:, v, 0] = ext
            cams[:, v, 1, :3, :3] = K * scale
            cams[:, v, 1, 2, 2] = 1.0
            cams[:, v, 1, 3, 3] = 1.0
        projs[f"stage{s}"] = cams
    dv = np.broadcast_to(
        np.linspace(425, 900, ndepth_full, dtype=np.float32)[None], (B, ndepth_full)).copy()
    return imgs, projs, dv


def to_numpy(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def randomise_bn(params, stats, rng):
    """Non-trivial BN affine and running stats, so the folding is exercised."""
    def walk(p, s):
        for k in p:
            if k == "BatchNorm_0":
                c = p[k]["scale"].shape
                p[k]["scale"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
                p[k]["bias"] = (0.05 * rng.standard_normal(c)).astype(np.float32)
                s[k]["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
                s[k]["var"] = (1 + 0.2 * np.abs(rng.standard_normal(c))).astype(np.float32)
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])
    walk(params, stats)


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(0)
    imgs, projs, dv = make_batch(rng)
    # The slice's configuration: the FPN encoder head and levels 2-3 as plain
    # convolutions (exact rewrites of the fused kernels, same weights).
    jcfg = JaxModelConfig(**CFG, fused_enc_head=False, fused_fpn_final=False,
                          fused_fpn_l2=False)
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    jimgs, jprojs, jdv = jnp.asarray(imgs), jax.tree.map(jnp.asarray, projs), jnp.asarray(dv)
    variables = jax.jit(
        lambda k: jmodel.init(k, jimgs, jprojs, jdv, training=False)
    )(jax.random.PRNGKey(0))
    params = to_numpy(variables["params"])
    stats = to_numpy(variables["batch_stats"])
    randomise_bn(params, stats, np.random.default_rng(1))
    jout = jax.jit(
        lambda v: jmodel.apply(v, jimgs, jprojs, jdv, training=False, tmp=TMPS)
    )({"params": params, "batch_stats": stats})
    jout = jax.tree.map(np.asarray, jout)

    model = build_model(ModelConfig(**CFG), device="cpu")
    load_flax_twin(model, params, stats)
    with torch.inference_mode():
        tout = model(torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
                     torch.from_numpy(dv), tmp=TMPS)
    return dict(params=params, stats=stats, model=model, jout=jout, tout=tout,
                batch=(imgs, projs, dv))


# fp32 on both sides. The depth bound is in depth units over the 425-900
# range: XLA and torch sum convolutions and attention in different orders,
# and those last-bit differences pass through four stages of softmax
# decode (each a weighted mean of depths ~500 apart).
DEPTH_ATOL = 1e-2
CONF_ATOL = 1e-4


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_stage_depth_and_confidence_match_jax(both, stage):
    j, t = both["jout"][f"stage{stage}"], both["tout"][f"stage{stage}"]
    np.testing.assert_allclose(t["depth_values"].numpy(), j["depth_values"],
                               rtol=1e-5, atol=DEPTH_ATOL)
    np.testing.assert_allclose(t["depth"].numpy(), j["depth"], rtol=0, atol=DEPTH_ATOL)
    np.testing.assert_allclose(t["photometric_confidence"].numpy(),
                               j["photometric_confidence"], rtol=0, atol=CONF_ATOL)


def test_refined_depth_and_combined_confidence_match_jax(both):
    imgs, projs, dv = both["batch"]
    depth, conf, stage_confs = make_infer_fn(both["model"], TMPS)(imgs, projs, dv)
    np.testing.assert_allclose(depth.numpy(), both["jout"]["refined_depth"],
                               rtol=0, atol=DEPTH_ATOL)
    np.testing.assert_allclose(conf.numpy(), both["jout"]["photometric_confidence"],
                               rtol=0, atol=CONF_ATOL)
    for i, c in enumerate(stage_confs):
        np.testing.assert_allclose(
            c.numpy(), both["jout"][f"stage{i + 1}"]["photometric_confidence"],
            rtol=0, atol=CONF_ATOL)
    assert np.isfinite(depth.numpy()).all()
    assert ((conf.numpy() > 0) & (conf.numpy() <= 1)).all()


def test_bridge_round_trip_gives_back_the_flax_tree(both):
    """convert_full_twin(port.state_dict()) is exactly the tree the bridge
    started from: the port's key names are the reference checkpoint's."""
    sd = {k: v.numpy() for k, v in both["model"].state_dict().items()}
    params, stats = convert_full_twin(sd, ndepths=tuple(CFG["ndepths"]), model_th=8)
    want_p = jax.tree_util.tree_flatten_with_path(both["params"])[0]
    want_s = jax.tree_util.tree_flatten_with_path(both["stats"])[0]
    got_p = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got_s = dict(jax.tree_util.tree_flatten_with_path(stats)[0])
    assert len(got_p) == len(want_p) and len(got_s) == len(want_s)
    for path, leaf in want_p:
        np.testing.assert_array_equal(got_p[path], leaf, err_msg=str(path))
    for path, leaf in want_s:
        np.testing.assert_array_equal(got_s[path], leaf, err_msg=str(path))
