"""The port's bf16 mode against the JAX package's (CPU).

The JAX side is `build_model(cfg, dtype=jnp.bfloat16)` (and its modules
with `dtype=jnp.bfloat16`) on its XLA path, as the other port tests run
it; the port's side is `build_model(cfg, dtype=torch.bfloat16)` (its
modules given bf16 activations), with K2/K4/K5/K6 as fp32 islands that run
their plain versions here (CPU tensors). Both take the same weights through
the bridge and the same inputs, made from a seed with numpy.

bf16 rounding makes bit parity impossible, so every comparison first
measures the JAX package's own gap, its bf16 output against its fp32 output
on the same inputs, and holds the port's bf16 output to the JAX bf16 output
within MULT times that gap plus a floor: in the mean of the absolute
differences and in their maximum. The floors are the fp32 parity bounds of
tests/test_torch_model.py (depth 1e-2, confidence 1e-4) and, for modules,
1e-4 of the output's scale (tests/test_torch_modules.py). Measured
(`PYTHONPATH=.:tests python -m tests.test_torch_bf16` prints it per
output): the port's error is 0.46-1.30 times the JAX gap in the mean and 0.46-1.60 at the maximum
(CostRegNet alone gives the JAX bits). The port rounds in other places than
XLA (its islands keep fp32 where the JAX modules round to bf16, and torch
rounds after every op where XLA's fusions may keep fp32), so the two bf16
results lie about as far from each other as each from fp32. No stage-1
argmax flip shows at these inputs: the depth bounds cover every pixel.

- Modules: the Twins backbone, the FPN (K4's and K5's plain versions as the
  islands run them), one StageNet stage at fixed hypotheses, CostRegNet and
  the DINO ViT.
- The whole eval forward of TwinMVSNet at the toy config of
  tests/test_torch_model.py.
- The island guard: in the port's bf16 forward, the projections, the
  hypotheses, the features the warp reads, the view weights and their sum,
  the logits, the decode, every softmax, norm and bicubic resize take fp32,
  while the cost regulariser and the visibility CNN run in bf16.
- The kernel wrappers with bf16 inputs on the CPU: their plain versions on
  the inputs cast up, the result in the caller's dtype (K2's in fp32).

tests/test_torch_bf16_models.py holds DINOMVSNet's and GN + re's eval
forwards to the same bounds, tests/test_torch_bf16_step.py the bf16
training step: three files, so that each takes at most about two minutes
on one worker (the JAX compiles dominate).
"""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from mvsformer_tpu.config import ModelConfig as JaxModelConfig
from mvsformer_tpu.models import costreg as jcostreg
from mvsformer_tpu.models import fpn as jfpn
from mvsformer_tpu.models import twins as jtwins
from mvsformer_tpu.models.dino import DINOViT as JaxDINOViT
from mvsformer_tpu.models.mvsformer import build_model as jax_build_model
from mvsformer_tpu.models.stagenet import StageNet as JaxStageNet
from mvsformer_tpu.utils.convert_weights import convert_full_twin

from mvsformer_torch.config import ModelConfig
from mvsformer_torch.infer import make_infer_fn
from mvsformer_torch.models import costreg, fpn, stagenet, twins
from mvsformer_torch.models.blocks import FoldedBatchNorm
from mvsformer_torch.models.dino import DINOViT
from mvsformer_torch.models.mvsformer import build_model, random_init_
from mvsformer_torch.ops import encoder_head as k4, fpn_level as k5
from mvsformer_torch.ops import gsa_attention as k6, regression, vis_net as k2
from mvsformer_torch.ops.cuda_build import up_cast
from mvsformer_torch.utils import convert_weights as cw

from test_torch_model import CFG, TMPS, make_batch
from test_torch_modules import init, nchw, run_jax
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

MULT = 2.0                       # the port's error, in JAX's bf16-vs-fp32 gaps
DEPTH_FLOOR, CONF_FLOOR = 1e-2, 1e-4
MODULE_FLOOR = 1e-4              # of max(1, max |JAX fp32 output|)
JAX_FLAGS = dict(fused_enc_head=False, fused_fpn_final=False, fused_fpn_l2=False)
STAGES = ("stage1", "stage2", "stage3", "stage4")
RATIOS = []  # (what, mean error / mean gap, max error / max gap), as `held` finds them


def held(got, j16, j32, floor, what=""):
    """The port's bf16 output `got` against the JAX bf16 output `j16`,
    within MULT times the JAX gap |j16 - j32| plus `floor`, in the mean and
    the maximum; notes the ratios in RATIOS."""
    got, j16, j32 = (np.asarray(a, np.float64) for a in (got, j16, j32))
    assert got.shape == j16.shape == j32.shape, what
    err, gap = np.abs(got - j16), np.abs(j16 - j32)
    assert gap.max() > 0, f"{what}: JAX's bf16 output equals its fp32 output"
    assert err.mean() <= MULT * gap.mean() + floor, \
        f"{what}: mean error {err.mean():.4g}, JAX gap {gap.mean():.4g}"
    assert err.max() <= MULT * gap.max() + floor, \
        f"{what}: max error {err.max():.4g}, JAX gap {gap.max():.4g}"
    RATIOS.append((what, err.mean() / gap.mean(), err.max() / gap.max()))


def module_floor(j32):
    return MODULE_FLOOR * max(1.0, float(np.abs(np.asarray(j32)).max()))


def both_dtypes(module_of_dtype, variables, *inputs, lowered=None, **kw):
    """The JAX module's outputs in fp32 and in bf16 on the same variables,
    as float32 numpy. In bf16 the inputs at the indices `lowered` (all by
    default) enter as bf16, as the bf16 model feeds the module."""
    outs = []
    for dt in (jnp.float32, jnp.bfloat16):
        xs = [jnp.asarray(x, dt) if dt == jnp.bfloat16 and (lowered is None or i in lowered)
              else x for i, x in enumerate(inputs)]
        outs.append(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                 run_jax(module_of_dtype(dt), variables, *xs, **kw)))
    return outs


def bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16()


def f32np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------------ modules

def test_twins_backbone_in_bf16(rng):
    """Full-width alt_gvt_small on a 32x48 input: K6 (global attention) is
    an fp32 island; windowed attention takes fp32 logits and softmax."""
    x = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    v = init(jtwins.alt_gvt_small(dtype=jnp.float32), rng, x)
    j32, j16 = both_dtypes(lambda dt: jtwins.alt_gvt_small(dtype=dt), v, x)
    mod = twins.build_twins("alt_gvt_small")
    mod.load_state_dict(cw.to_torch(cw.twins_state(v["params"])), strict=True)
    with torch.no_grad():
        got = mod.eval()(nchw(x).bfloat16())
    for i, (g, a, b) in enumerate(zip(got, j16, j32)):
        assert g.dtype == torch.bfloat16
        held(np.moveaxis(f32np(g), 1, -1), a, b, module_floor(b), f"level {i}")


def test_fpn_in_bf16(rng):
    """The FPN encoder (its head is K4's plain version) and decoder (each
    level K5's), eval with BN: bf16 maps in and out."""
    x = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    v = init(jfpn.FPNEncoder(dtype=jnp.float32), rng, x, training=False)
    j32, j16 = both_dtypes(lambda dt: jfpn.FPNEncoder(dtype=dt), v, x, training=False)
    enc = fpn.FPNEncoder()
    enc.load_state_dict(cw.to_torch(cw.encoder_state(v["params"], v["batch_stats"])))
    with torch.no_grad():
        got = enc.eval()(nchw(x).bfloat16())
    for i, (g, a, b) in enumerate(zip(got, j16, j32)):
        assert g.dtype == torch.bfloat16
        held(np.moveaxis(f32np(g), 1, -1), a, b, module_floor(b), f"encoder {i}")

    feats = [np.asarray(f, np.float32) for f in j32]
    v = init(jfpn.FPNDecoder(dtype=jnp.float32), rng, *feats, training=False)
    j32, j16 = both_dtypes(lambda dt: jfpn.FPNDecoder(dtype=dt), v, *feats, training=False)
    dec = fpn.FPNDecoder()
    dec.load_state_dict(cw.to_torch(cw.fpn_decoder_state(v["params"], v["batch_stats"])))
    with torch.no_grad():
        got = dec.eval()(*[nchw(f).bfloat16() for f in feats])
    for i, (g, a, b) in enumerate(zip(got, j16, j32)):
        assert g.dtype == torch.bfloat16
        held(np.moveaxis(f32np(g), 1, -1), a, b, module_floor(b), f"decoder {i}")


def stage_inputs(rng, B=1, Vs=2, H=16, W=24, C=16, D=8):
    ref = rng.standard_normal((B, H, W, C)).astype(np.float32)
    src = rng.standard_normal((B, Vs, H, W, C)).astype(np.float32)
    K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
    cams = np.zeros((B, Vs + 1, 2, 4, 4), np.float32)
    for v in range(Vs + 1):
        cams[:, v, 0] = np.eye(4)
        cams[:, v, 0, 0, 3] = 1.5 * v
        cams[:, v, 1, :3, :3] = K
        cams[:, v, 1, 3, 3] = 1.0
    dv = np.broadcast_to(np.linspace(425, 900, D, dtype=np.float32)[None, :, None, None],
                         (B, D, H, W)).copy()
    return ref, src, cams[:, 0], cams[:, 1:], dv


def test_stagenet_in_bf16(rng):
    """One stage (cnn fusion, BN, ce) at fixed hypotheses, D = 8 (so its
    regulariser is CostRegNet3D): bf16 features in; depth, confidence and
    logits out in fp32."""
    ndepth = 8
    ref, src, ref_proj, src_projs, dv = stage_inputs(rng, D=ndepth)
    args = (ref, src, ref_proj, src_projs, dv)

    def jstage(dt):
        return JaxStageNet(ndepth=ndepth, stage_idx=0, dtype=dt)

    v = init(jstage(jnp.float32), rng, *args, training=False)
    j32, j16 = both_dtypes(jstage, v, *args, lowered=(0, 1), training=False, tmp=5.0)
    p, s = v["params"], v["batch_stats"]
    sd = cw.vis_state(p["vis"], s["vis"], "vis.")
    sd.update(cw.cost_reg_state(p["cost_reg"], s["cost_reg"], ndepth <= 8, "cost_reg."))
    stage = stagenet.StageNet(ndepth)
    stage.load_state_dict(cw.to_torch(sd), strict=True)
    with torch.no_grad():
        out = stage.eval()(nchw(ref).bfloat16(), bf16(np.moveaxis(src, -1, 2)),
                           torch.from_numpy(ref_proj), torch.from_numpy(src_projs),
                           torch.from_numpy(dv), 5.0)
    for key, floor in (("depth", DEPTH_FLOOR), ("photometric_confidence", CONF_FLOOR),
                       ("prob_volume_pre", module_floor(j32["prob_volume_pre"]))):
        assert out[key].dtype == torch.float32, key
        held(out[key].numpy(), j16[key], j32[key], floor, key)


@pytest.mark.parametrize("three_d", [False, True])
def test_cost_regularisers_in_bf16(rng, three_d):
    D = 4 if three_d else 16
    x = rng.standard_normal((1, D, 8, 16, 8)).astype(np.float32)
    jcls = jcostreg.CostRegNet3D if three_d else jcostreg.CostRegNet
    v = init(jcls(dtype=jnp.float32), rng, x, training=False)
    j32, j16 = both_dtypes(lambda dt: jcls(dtype=dt), v, x, training=False)
    mod = (costreg.CostRegNet3D if three_d else costreg.CostRegNet)(8, 8)
    mod.load_state_dict(cw.to_torch(cw.cost_reg_state(v["params"], v["batch_stats"], three_d)))
    with torch.no_grad():
        got = mod.eval()(bf16(np.moveaxis(x, -1, 1)))
    assert got.dtype == torch.bfloat16
    held(np.moveaxis(f32np(got), 1, -1), j16, j32, module_floor(j32),
         "CostRegNet3D" if three_d else "CostRegNet")


def test_dino_vit_in_bf16(rng):
    """vit_small at full width on a 48x80 image (a 3x5 grid, so the
    position embedding is resized bicubically, in fp32): tokens in bf16, the
    last block's attention (fp32 logits and softmax) in fp32."""
    x = rng.standard_normal((2, 48, 80, 3)).astype(np.float32)
    dims = dict(embed_dim=384, depth=12, num_heads=6)
    v = init(JaxDINOViT(**dims, dtype=jnp.float32), rng, x)
    (t32, a32), (t16, a16) = both_dtypes(lambda dt: JaxDINOViT(**dims, dtype=dt), v, x)
    vit = DINOViT(**dims)
    vit.load_state_dict(cw.to_torch(cw.dino_vit_state(v["params"], 12)), strict=True)
    with torch.no_grad():
        tok, att = vit(nchw(x).bfloat16())
    assert tok.dtype == torch.bfloat16 and att.dtype == torch.float32
    held(f32np(tok), t16, t32, module_floor(t32), "tokens")
    held(att.numpy(), a16, a32, module_floor(a32), "attention")


# ------------------------------------------------------------------ the island guard

# aten ops whose first input must be fp32 in the bf16 forward, under the
# names they reach a dispatch mode by (with or without their
# decompositions): every softmax (attention, depth), every norm's
# statistics, the bicubic resizes, the plain warp's sampling and the
# weighted view sum. The convolutions are watched to show that bf16 ones ran.
FP32_OPS = {name: name.lstrip("_").removeprefix("native_") for name in (
    "softmax", "_softmax", "log_softmax", "_log_softmax", "layer_norm", "native_layer_norm",
    "group_norm", "native_group_norm", "batch_norm", "native_batch_norm",
    "_native_batch_norm_legit", "upsample_bicubic2d", "grid_sampler", "grid_sampler_2d",
    "addcmul", "addcmul_")}
CONV_OPS = ("conv2d", "conv3d", "conv_transpose2d", "conv_transpose3d", "convolution")


class OpDtypes(TorchDispatchMode):
    """The dtypes of the first tensor input of every watched aten op."""

    def __init__(self):
        super().__init__()
        self.seen = collections.defaultdict(set)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        key = FP32_OPS.get(name, "conv" if name in CONV_OPS else None)
        first = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if key is not None and first is not None:
            self.seen[key].add(first.dtype)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def island_guard(model, monkeypatch):
    """Record the dtypes at each island of the port's forward: {site: set
    of dtypes}, with the aten ops' under "op:<name>"."""
    seen = collections.defaultdict(set)

    def note(site, *tensors):
        for t in tensors:
            if isinstance(t, torch.Tensor):
                seen[site].add(t.dtype)

    def spy(module, name, inputs, output):
        original = getattr(module, name)

        def wrapped(*args, **kwargs):
            for site, i in inputs.items():
                note(site, args[i])
            out = original(*args, **kwargs)
            note(output, *(out if isinstance(out, tuple) else (out,)))
            return out
        monkeypatch.setattr(module, name, wrapped)

    decode_in = {"decode logits": 0, "decode depths": 1}
    spy(stagenet.geometry, "compose_projection", {}, "projections")
    spy(stagenet, "warp_group_corr", {"warp ref": 0, "warp src": 1, "warp cams": 2,
                                      "warp depths": 4}, "correlation")
    spy(stagenet, "depth_decode", decode_in, "decode")
    spy(regression, "decode_depth", decode_in, "decode")
    def watch(mod, site_in, site_out, pick_in=lambda a: a[:1], pick_out=lambda o: (o,)):
        hooks.append(mod.register_forward_pre_hook(lambda m, a: note(site_in, *pick_in(a))))
        hooks.append(mod.register_forward_hook(lambda m, a, o: note(site_out, *pick_out(o))))

    hooks = []
    for mod in model.fusions:
        watch(mod, "stage features", "stage outputs", lambda a: a[:2],
              lambda o: (o["depth"], o["photometric_confidence"], o["prob_volume_pre"]))
        hooks.append(mod.register_forward_pre_hook(lambda m, a: note("hypotheses", a[4])))
        watch(mod.cost_reg, "cost_reg in", "cost_reg out")
        if hasattr(mod, "vis"):
            watch(mod.vis, "vis in", "vis out")
    for mod in model.modules():
        if isinstance(mod, FoldedBatchNorm):
            note("BN folds", *mod.folded())
            note("BN running stats", mod.running_mean, mod.running_var)
            watch(mod, "BN in", "BN out")
    ops = OpDtypes()
    try:
        with ops:
            yield seen
    finally:
        for h in hooks:
            h.remove()
    for name, dtypes in ops.seen.items():
        seen[f"op:{name}"] = dtypes


F32, BF16 = {torch.float32}, {torch.bfloat16}
ISLANDS = {  # site -> the dtypes it may see in the bf16 forward
    "projections": F32, "hypotheses": F32, "warp ref": F32, "warp src": F32,
    "warp cams": F32, "warp depths": F32, "correlation": F32, "decode logits": F32,
    "decode depths": F32, "decode": F32, "stage outputs": F32, "vis out": F32,
    "BN folds": F32, "BN running stats": F32,
    "stage features": BF16, "cost_reg in": BF16, "cost_reg out": BF16, "vis in": BF16,
    "BN in": BF16, "BN out": BF16,
}


def assert_islands(seen, must_see=("projections", "hypotheses", "warp ref", "decode",
                                   "stage outputs", "cost_reg in")):
    for site in must_see:
        assert site in seen, f"{site}: not reached"
    for site, dtypes in seen.items():
        if site.startswith("op:"):
            want = {torch.float32, torch.bfloat16} if site == "op:conv" else F32
        else:
            want = ISLANDS[site]
        assert dtypes <= want, f"{site}: {dtypes}"
    assert torch.bfloat16 in seen["op:conv"]  # the bf16 convolutions did run
    for op in ("softmax", "layer_norm", "upsample_bicubic2d", "addcmul_"):
        assert f"op:{op}" in seen, op


# ------------------------------------------------------------------ whole forwards

def forwards(port_model, jcfg, params, stats, batch, monkeypatch):
    """JAX fp32 and bf16 forwards on (params, stats); the port's bf16 model
    (the weights of `port_model`) under the island guard. Returns (j32, j16,
    port outputs as float32 numpy, the guard's record)."""
    imgs, projs, dv = batch
    jouts = []
    for dt in (jnp.float32, jnp.bfloat16):
        jm = jax_build_model(jcfg, dtype=dt)
        out = jax.jit(lambda v, i, p, d: jm.apply(v, i, p, d, training=False, tmp=TMPS))(
            {"params": params, "batch_stats": stats}, jnp.asarray(imgs),
            jax.tree.map(jnp.asarray, projs), jnp.asarray(dv))
        jouts.append(jax.tree.map(lambda a: np.asarray(a, np.float32), out))
    model = build_model(port_model.cfg, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(port_model.state_dict())
    with island_guard(model, monkeypatch) as seen, torch.inference_mode():
        tout = model(torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
                     torch.from_numpy(dv), tmp=TMPS)
    assert tout["refined_depth"].dtype == tout["photometric_confidence"].dtype == torch.float32
    tout = {k: ({kk: f32np(vv) for kk, vv in v.items()} if isinstance(v, dict) else f32np(v))
            for k, v in tout.items()}
    return jouts[0], jouts[1], tout, dict(seen), model


def hold_forward(case):
    j32, j16, tout = case["j32"], case["j16"], case["tout"]
    for s in STAGES:
        for key, floor in (("depth", DEPTH_FLOOR), ("photometric_confidence", CONF_FLOOR)):
            held(tout[s][key], j16[s][key], j32[s][key], floor, f"{case['name']} {s} {key}")
    for key, floor in (("refined_depth", DEPTH_FLOOR), ("photometric_confidence", CONF_FLOOR)):
        held(tout[key], j16[key], j32[key], floor, f"{case['name']} {key}")


def twin_case():
    """TwinMVSNet at tests/test_torch_model.py's toy config and batch (B=1,
    V=3, 64x64, ndepths 8/4/4/2, full-width alt_gvt_small), random weights
    with non-trivial BN stats."""
    batch = make_batch(np.random.default_rng(0))
    model = random_init_(build_model(ModelConfig(**CFG), device="cpu"),
                         torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_full_twin(sd, ndepths=tuple(CFG["ndepths"]), model_th=8)
    with pytest.MonkeyPatch.context() as mp:
        j32, j16, tout, seen, bmodel = forwards(model, JaxModelConfig(**CFG, **JAX_FLAGS),
                                                params, stats, batch, mp)
    return dict(name="twin", j32=j32, j16=j16, tout=tout, seen=seen, model=bmodel,
                batch=batch)


@pytest.fixture(scope="module")
def twin():
    return twin_case()


def test_twin_forward_in_bf16(twin):
    hold_forward(twin)


def test_twin_islands_are_fp32(twin):
    assert_islands(twin["seen"])
    assert twin["seen"]["vis in"] == BF16 and twin["seen"]["BN out"] == BF16


def test_make_infer_fn_serves_the_bf16_model(twin):
    """make_infer_fn runs the model at its own compute dtype: the same
    outputs as the forward, in fp32."""
    assert twin["model"].compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in twin["model"].parameters())
    depth, conf, stage_confs = make_infer_fn(twin["model"], TMPS)(*twin["batch"])
    assert depth.dtype == conf.dtype == torch.float32
    np.testing.assert_array_equal(depth.numpy(), twin["tout"]["refined_depth"])
    np.testing.assert_array_equal(conf.numpy(), twin["tout"]["photometric_confidence"])
    assert ((conf > 0) & (conf <= 1)).all() and len(stage_confs) == 4


# ------------------------------------------------------------------ the wrappers

def wrapper_cases(rng):
    """(name, wrapper, plain, args, kwargs) with bf16 activations and
    weights, and the folded BN in fp32, as the model passes them."""
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    fold = lambda c: (1 + 0.1 * t(c), 0.05 * t(c))
    b = lambda x: x.bfloat16()
    return [
        ("visibility_net", k2.visibility_net, k2.visibility_net_plain,
         (b(t(2, 8, 12)), b(t(16, 1, 3, 3) / 3), b(t(16, 16, 3, 3) / 12),
          b(t(8, 16, 3, 3) / 12), b(t(1, 8, 1, 1) / 3), b(t(1)), [fold(16), fold(16), fold(8)]),
         {}),
        ("encoder_head", k4.encoder_head, k4.encoder_head_plain,
         (b(t(1, 3, 16, 20)), b(t(8, 3, 7, 7) / 12), fold(8), b(t(8, 8, 5, 5) / 14), fold(8),
          b(t(16, 8, 5, 5) / 14), fold(16)), {}),
        ("fpn_level", k5.fpn_level, k5.fpn_level_plain,
         (b(t(1, 64, 4, 6)), b(t(1, 8, 8, 12)), b(t(64, 8, 1, 1) / 3), b(t(64)),
          b(t(8, 64, 3, 3) / 24), b(t(8)), fold(8)), {"emit_intra": True}),
        ("gsa_attention", k6.gsa_attention, k6.gsa_attention_plain,
         (b(t(2, 12, 64)), b(t(2, 5, 64)), b(t(2, 5, 64)), 2), {}),
    ]


@pytest.mark.parametrize("case", range(4), ids=["K2", "K4", "K5", "K6"])
def test_island_wrappers_take_bf16_on_the_cpu(rng, case):
    """Each of K2, K4, K5 and K6 takes bf16 tensors: its plain version runs
    on them cast up to fp32, and the result comes back in bf16 (K2's, a
    sigmoid, in fp32), rounded from the fp32 result."""
    name, wrapper, plain, args, kwargs = wrapper_cases(rng)[case]
    got = wrapper(*args, **kwargs)
    want = plain(*up_cast(args), **kwargs)
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    for g, w in zip(got, want):
        assert g.dtype == (torch.float32 if name == "visibility_net" else torch.bfloat16)
        assert torch.equal(g, w.to(g.dtype)), name
    # fp32 inputs take the wrapper as it was: no cast on the way in or out
    f32_out = wrapper(*up_cast(args), **kwargs)
    for g, w in zip(f32_out if isinstance(f32_out, tuple) else (f32_out,), want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def test_build_model_takes_fp32_or_bf16_only():
    cfg = ModelConfig(**CFG)
    assert build_model(cfg, device="cpu").compute_dtype == torch.float32
    with pytest.raises(ValueError, match="compute dtype"):
        build_model(cfg, device="cpu", dtype=torch.float16)


if __name__ == "__main__":
    # PYTHONPATH=.:tests python -m tests.test_torch_bf16: the port's error in JAX gaps, per
    # output (the numbers the docstring and PERF.md quote).
    jax.config.update("jax_platforms", "cpu")
    for test in (test_twins_backbone_in_bf16, test_fpn_in_bf16, test_stagenet_in_bf16,
                 test_dino_vit_in_bf16):
        test(np.random.default_rng(0))
    for three_d in (False, True):
        test_cost_regularisers_in_bf16(np.random.default_rng(0), three_d)
    from test_torch_bf16_models import dino_case, gn_re_case

    for case in (twin_case, dino_case, gn_re_case):
        hold_forward(case())
    for what, mean, worst in RATIOS:
        print(f"{what}: error / JAX gap {mean:.3f} in the mean, {worst:.3f} at the max")
    rest = [r for r in RATIOS if r[1] > 0]  # CostRegNet gives the JAX bits
    means, maxes = [r[1] for r in rest], [r[2] for r in rest]
    print(f"over the other {len(rest)} outputs: {min(means):.3f}-{max(means):.3f} in the mean, "
          f"{min(maxes):.3f}-{max(maxes):.3f} at the max (bound {MULT:g})")
