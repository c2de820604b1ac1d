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
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

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
    # The JAX flags of the fused FPN kernels forced off: the encoder head and
    # levels 2-3 as plain convolutions (exact rewrites of the kernels, same
    # weights). jax_default below runs the default configuration.
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


@pytest.fixture(scope="module")
def jax_default(both):
    """The JAX model built from the default ModelConfig (fused encoder head,
    fused FPN level 2 and final level on), applied to the same variables: the
    configuration the port runs. On the CPU its kernel gates stay closed and
    it runs the XLA path; tests/test_torch_fpn_kernels.py holds that path's
    FPN to the Pallas kernels in interpret mode. fused_ok is not patched:
    v4's edges differ from the XLA warp (ROADMAP C.1)."""
    jcfg = JaxModelConfig(**CFG)
    assert jcfg.fused_enc_head and jcfg.fused_fpn_final and jcfg.fused_fpn_l2
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    imgs, projs, dv = both["batch"]
    out = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, training=False, tmp=TMPS))(
        {"params": both["params"], "batch_stats": both["stats"]},
        jnp.asarray(imgs), jax.tree.map(jnp.asarray, projs), jnp.asarray(dv))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("stage", [1, 2, 3, 4, "refined"])
def test_port_matches_jax_default_config(both, jax_default, stage):
    t = both["tout"]
    if stage == "refined":
        np.testing.assert_allclose(t["refined_depth"].numpy(), jax_default["refined_depth"],
                                   rtol=0, atol=DEPTH_ATOL)
        np.testing.assert_allclose(t["photometric_confidence"].numpy(),
                                   jax_default["photometric_confidence"], rtol=0,
                                   atol=CONF_ATOL)
        return
    j, t = jax_default[f"stage{stage}"], t[f"stage{stage}"]
    np.testing.assert_allclose(t["depth"].numpy(), j["depth"], rtol=0, atol=DEPTH_ATOL)
    np.testing.assert_allclose(t["photometric_confidence"].numpy(),
                               j["photometric_confidence"], rtol=0, atol=CONF_ATOL)


@pytest.fixture(scope="module")
def was_outputs(both):
    """depth_type="was" on both sides: the port's model with the weights of
    `both`, and the JAX model on the tree convert_full_twin makes of the
    port's state_dict; one forward each. Each stage decodes as for ce, but
    the final confidence is the last stage's, not the stages' mean."""
    cfg = dict(CFG, depth_type="was")
    model = build_model(ModelConfig(**cfg), device="cpu")
    model.load_state_dict(both["model"].state_dict())
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_full_twin(sd, ndepths=tuple(CFG["ndepths"]), model_th=8)
    jmodel = jax_build_model(JaxModelConfig(**cfg, fused_enc_head=False, fused_fpn_final=False,
                                            fused_fpn_l2=False), dtype=jnp.float32)
    imgs, projs, dv = both["batch"]
    jout = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, training=False, tmp=TMPS))(
        {"params": params, "batch_stats": stats},
        jnp.asarray(imgs), jax.tree.map(jnp.asarray, projs), jnp.asarray(dv))
    depth, conf, stage_confs = make_infer_fn(model, TMPS)(imgs, projs, dv)
    return dict(jout=jax.tree.map(np.asarray, jout), refined_depth=depth.numpy(),
                photometric_confidence=conf.numpy(), last_stage=stage_confs[-1].numpy())


@pytest.mark.parametrize("output,atol", [("refined_depth", DEPTH_ATOL),
                                         ("photometric_confidence", CONF_ATOL)])
def test_was_model_matches_jax(was_outputs, output, atol):
    np.testing.assert_allclose(was_outputs[output], was_outputs["jout"][output], rtol=0,
                               atol=atol)
    if output == "photometric_confidence":
        np.testing.assert_array_equal(was_outputs[output], was_outputs["last_stage"])


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


def make_batch_of_two(rng):
    """make_batch at B = 2, the second sample with cameras and a depth range
    of its own: views 1.5 units apart along x and 0.5 along y, focal 90, and
    depths 500-1000."""
    imgs, projs, dv = make_batch(rng, B=2)
    for s, scale in zip(range(1, 5), (1 / 8, 1 / 4, 1 / 2, 1.0)):
        cams = projs[f"stage{s}"]
        for v in range(cams.shape[1]):
            cams[1, v, 0, 0, 3] = v * 1.5
            cams[1, v, 0, 1, 3] = v * 0.5
            cams[1, v, 1, 0, 0] = cams[1, v, 1, 1, 1] = 90.0 * scale
    dv[1] = np.linspace(500, 1000, dv.shape[1], dtype=np.float32)
    return imgs, projs, dv


@pytest.fixture(scope="module")
def batch_of_two(both):
    """The eval forward at B = 2 on both sides (one JAX forward), with the
    weights of `both`; the first sample is `both`'s batch."""
    imgs, projs, dv = make_batch_of_two(np.random.default_rng(0))
    np.testing.assert_array_equal(imgs[:1], both["batch"][0])
    jmodel = jax_build_model(JaxModelConfig(**CFG, fused_enc_head=False, fused_fpn_final=False,
                                            fused_fpn_l2=False), dtype=jnp.float32)
    jout = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, training=False, tmp=TMPS))(
        {"params": both["params"], "batch_stats": both["stats"]},
        jnp.asarray(imgs), jax.tree.map(jnp.asarray, projs), jnp.asarray(dv))
    with torch.inference_mode():
        tout = both["model"](torch.from_numpy(imgs),
                             {k: torch.from_numpy(v) for k, v in projs.items()},
                             torch.from_numpy(dv), tmp=TMPS)
    return dict(jout=jax.tree.map(np.asarray, jout), tout=tout)


@pytest.mark.parametrize("stage", [1, 2, 3, 4, "refined"])
def test_batch_of_two_matches_jax(batch_of_two, stage):
    """Each sample is warped with its own cameras and depth hypotheses."""
    j, t = batch_of_two["jout"], batch_of_two["tout"]
    if stage == "refined":
        pairs = [("refined_depth", DEPTH_ATOL), ("photometric_confidence", CONF_ATOL)]
    else:
        j, t = j[f"stage{stage}"], t[f"stage{stage}"]
        pairs = [("depth", DEPTH_ATOL), ("photometric_confidence", CONF_ATOL)]
        assert float(t["depth_values"][1].min()) > float(t["depth_values"][0].min())
    for key, atol in pairs:
        np.testing.assert_allclose(t[key].numpy(), j[key], rtol=0, atol=atol, err_msg=key)


def test_batch_of_two_keeps_the_first_sample(both, batch_of_two):
    """The first sample of the B = 2 forward is the B = 1 forward."""
    for key, atol in (("refined_depth", DEPTH_ATOL), ("photometric_confidence", CONF_ATOL)):
        np.testing.assert_allclose(batch_of_two["tout"][key][:1].numpy(),
                                   both["tout"][key].numpy(), rtol=0, atol=atol, err_msg=key)
