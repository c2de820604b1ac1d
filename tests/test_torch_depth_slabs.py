"""The depth axis of the process grid on the CPU: the cost regularisers
over slabs of the depth hypotheses (`mvsformer_torch/parallel/depth.py`),
in gloo ranks as subprocesses (tests/test_torch_parallel_ranks.py's
`run_ranks`, this file as the ranks' script).

- Modules: `CostRegNet` (stride 2 in depth), `CostRegNet3D` and
  `CostRegNet2D` over 2, 3 and 4 depth ranks, under folded BN, GN, IN and
  no norm, at depths that split evenly at every level, that gather a
  level (`CostRegNet` at D = 8 over 2 ranks gathers its bottleneck of 1,
  at D = 16 over 4 its bottleneck of 2) and that do not split at all; in
  float64, within 1e-12 of the output's scale of the serial module.
- The eval forward (`make_infer_fn` of a model built on the grid): at
  depth 2 (world 2) and at view 2 x depth 2 (world 4), for TwinMVSNet and
  DINOMVSNet under BN and GN, for `CostRegNet` at D = 16 (every level
  split) and at D = 8 with `model_th` 4 (the bottleneck gathered), and for
  the epipole fusion's `CostRegNet2D` under IN: every rank's depth and
  confidence against the port's serial forward on the same weights, and
  at tests/test_parallel.py:137's config (Twins, GN, ndepths 8/4/4/2)
  against the JAX package's serial eval, within tests/test_torch_model.py's
  bounds (depth 1e-2, confidence 1e-4; measured up to 5.9e-3 and 2.1e-6
  from the serial forward, 6.2e-3 and 1.4e-6 from JAX). All ranks return
  the same bits.
- `python -m mvsformer_torch.test --depth_parallel 2` writes the serial
  CLI's files, within the same bounds.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from mvsformer_torch.config import ModelConfig, ViTConfig

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_model import make_batch  # noqa: E402
from test_torch_parallel_ranks import run_ranks  # noqa: E402
from test_torch_watchdog import watchdog  # noqa: E402

torch.set_num_threads(2)
hang_watchdog = watchdog()

TMPS = [5.0, 5.0, 5.0, 1.0]
DINO_VIT = dict(twin=False, vit_arch="vit_small", vit_ch=384, out_ch=64, att_fusion=True)
# The cascade of tests/test_parallel.py's depth-slab test (ndepths 8/4/4/2).
CASCADE = dict(ndepths=[8, 4, 4, 2], depth_interals_ratio=[4.0, 2.67, 1.5, 1.0],
               feat_chs=[8, 16, 32, 64], base_ch=8, depth_type="ce", inverse_depth=True)
DEPTH_ATOL, CONF_ATOL = 1e-2, 1e-4  # tests/test_torch_model.py's bounds
MODULE_RTOL = 1e-12
# name -> (ModelConfig overrides, image size)
MODELS = {
    "twin-GN-8442": (dict(norm_type="GN"), (64, 64)),
    "twin-BN-16842": (dict(norm_type="BN", ndepths=[16, 8, 4, 2]), (64, 64)),
    "twin-GN-th4": (dict(norm_type="GN", model_th=4), (64, 64)),
    "twin-IN-epipole": (dict(norm_type="IN", fusion_type="epipole"), (64, 64)),
    "dino-BN": (dict(norm_type="BN", model_type="dino", vit_args=DINO_VIT), (64, 128)),
    "dino-GN": (dict(norm_type="GN", model_type="dino", vit_args=DINO_VIT), (64, 128)),
}
# (world, view, depth) -> the models it serves
GRIDS = {(2, 1, 2): sorted(MODELS), (4, 2, 2): ["twin-GN-8442", "dino-BN"]}
JAX_MODEL = "twin-GN-8442"
# (regulariser, norm, depth) of the module test
MODULES = [("CostRegNet", "BN", 16), ("CostRegNet", "GN", 8), ("CostRegNet", "IN", 24),
           ("CostRegNet3D", "GN", 4), ("CostRegNet3D", "BN", 6), ("CostRegNet3D", "none", 3),
           ("CostRegNet2D", "IN", 8), ("CostRegNet2D", "none", 3)]


def model_config(name):
    over, _ = MODELS[name]
    over = dict(CASCADE, **over)
    if "vit_args" in over:
        over["vit_args"] = ViTConfig(**over["vit_args"])
    cfg = ModelConfig(**over)
    cfg.vit_args.drop_path_rate = 0.0
    return cfg


def build(name, weights, layout=None):
    """The model `name` on `layout`, its weights from the file `weights[name]`."""
    from mvsformer_torch.models.mvsformer import build_model

    model = build_model(model_config(name), device="cpu", layout=layout)
    model.load_state_dict(torch.load(weights[name], weights_only=False))
    return model


def request(name, views=5):
    h, w = MODELS[name][1]
    return make_batch(np.random.default_rng(0), V=views, H=h, W=w)


# ------------------------------------------------------------------ the ranks

def module(kind, norm):
    from mvsformer_torch.models import costreg

    cls = getattr(costreg, kind)
    return cls(8, norm=norm) if kind == "CostRegNet2D" else cls(8, 8, norm=norm)


def job_modules(job, layout):
    """Each regulariser of MODULES over this rank's slabs, float64."""
    from mvsformer_torch.models.mvsformer import random_init_
    from mvsformer_torch.parallel.depth import DepthSlabs

    slabs = DepthSlabs(layout.depth_group, layout.depth, layout.depth_index)
    out = {}
    for kind, norm, depth in MODULES:
        m = random_init_(module(kind, norm), torch.Generator().manual_seed(depth)).double()
        x = torch.randn((2, 8, depth, 8, 16), generator=torch.Generator().manual_seed(1),
                        dtype=torch.float64)
        with torch.inference_mode():
            out[f"{kind}-{norm}-{depth}"] = slabs.regularise(m.eval(), x)
    return out


def job_evals(job, layout):
    """The eval forward of each model of the job on this rank."""
    from mvsformer_torch.infer import make_infer_fn

    out = {}
    for name in job["models"]:
        depth, conf, _ = make_infer_fn(build(name, job["weights"], layout), TMPS)(
            *request(name))
        out[name] = {"depth": depth, "conf": conf}
    return out


def rank_main(path):
    import torch.distributed as dist

    from mvsformer_torch.parallel import mesh

    torch.set_num_threads(1)
    with open(path) as f:
        job = json.load(f)
    dist.init_process_group("gloo", init_method="file://" + job["store"],
                            world_size=job["world"], rank=int(os.environ["RANK"]))
    layout = mesh.make_layout(job["data"], job["view"], job["depth"])
    result = {"modules": job_modules, "evals": job_evals}[job["kind"]](job, layout)
    dist.destroy_process_group()
    torch.save(result, os.path.join(job["out"], f"rank{layout.rank}.pt"))


# ------------------------------------------------------------------ the modules

@pytest.fixture(scope="module")
def module_ranks(tmp_path_factory):
    out = {}
    for world in (2, 3, 4):
        tmp = tmp_path_factory.mktemp(f"modules{world}")
        out[world] = run_ranks(tmp, world, dict(kind="modules", data=1, view=1, depth=world),
                               script=__file__)
    return out


@pytest.mark.parametrize("kind,norm,depth", MODULES)
@pytest.mark.parametrize("world", [2, 3, 4])
def test_a_regulariser_over_depth_slabs_is_the_serial_one(module_ranks, world, kind, norm,
                                                          depth):
    m = module(kind, norm)
    from mvsformer_torch.models.mvsformer import random_init_

    m = random_init_(m, torch.Generator().manual_seed(depth)).double().eval()
    x = torch.randn((2, 8, depth, 8, 16), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    with torch.no_grad():
        want = m(x)
    scale = float(want.abs().max())
    for r in module_ranks[world]:
        got = r[f"{kind}-{norm}-{depth}"]
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= MODULE_RTOL * scale


def test_a_level_that_does_not_split_is_gathered():
    """The slab bounds: a level splits where its depth divides by the
    ranks, and is whole on every rank where it does not."""
    from mvsformer_torch.parallel.depth import DepthSlabs

    assert [DepthSlabs(None, 4, z).bounds(16) for z in range(4)] == [
        (0, 4), (4, 8), (8, 12), (12, 16)]
    assert [DepthSlabs(None, 4, z).bounds(2) for z in range(4)] == [(0, 2)] * 4
    assert DepthSlabs(None, 2, 1).bounds(3) == (0, 3)


@pytest.mark.parametrize("kind,norm", [("conv", "BN"), ("conv", "GN"), ("deconv", "BN"),
                                       ("deconv", "IN")])
def test_a_norm_act_block_is_its_layers_in_order(kind, norm):
    """Conv3dNormAct and Deconv3dNormAct run their `layers()` (the conv,
    the norm, ReLU) as their forward, relu(norm(conv(x))), and the depth
    slabs run the same layers: one definition of each block."""
    import torch.nn.functional as F

    from mvsformer_torch.models.blocks import Conv3dNormAct, Deconv3dNormAct
    from mvsformer_torch.parallel.depth import _layers

    torch.manual_seed(0)
    block = (Conv3dNormAct(4, 8, norm=norm) if kind == "conv"
             else Deconv3dNormAct(4, 8, norm=norm)).eval()
    layers = block.layers()
    assert layers == (block.conv, block.bn, F.relu) and _layers(block) == layers
    x = torch.randn(1, 4, 4, 6, 6)
    assert torch.equal(block(x), F.relu(block.bn(block.conv(x))))


# ------------------------------------------------------------------ the forward

def jax_model():
    import jax.numpy as jnp

    from mvsformer_tpu.config import ModelConfig as JaxModelConfig
    from mvsformer_tpu.models.mvsformer import build_model as jax_build_model

    return jax_build_model(JaxModelConfig(**dict(CASCADE, norm_type="GN"),
                                          fused_enc_head=False, fused_fpn_final=False,
                                          fused_fpn_l2=False), dtype=jnp.float32)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Each model's weights in a file: JAX_MODEL's drawn on the JAX
    variables' tree (tests/test_torch_variants.py's `random_variables`) and
    carried to the port by its bridge, the others the port's
    `random_init_`. -> ({name: path}, JAX_MODEL's JAX variables)."""
    import jax
    import jax.numpy as jnp

    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.utils.convert_weights import convert_flax
    from test_torch_variants import random_variables

    tmp = tmp_path_factory.mktemp("weights")
    paths, variables = {}, None
    for name in MODELS:
        model = build_model(model_config(name), device="cpu")
        if name == JAX_MODEL:
            imgs, projs, dv = (jax.tree.map(jnp.asarray, x) for x in request(name))
            shapes = jax.eval_shape(lambda k: jax_model().init(k, imgs, projs, dv,
                                                               training=False),
                                    jax.random.PRNGKey(0))
            variables = random_variables(shapes, np.random.default_rng(4))
            cfg = model_config(name)
            model.load_state_dict(convert_flax(
                variables["params"], variables.get("batch_stats", {}), tuple(cfg.ndepths),
                cfg.model_th, tuple(len(b) for b in model.vit.blocks)), strict=True)
        else:
            random_init_(model, torch.Generator().manual_seed(len(name)))
        paths[name] = str(tmp / f"{name}.pt")
        torch.save(model.state_dict(), paths[name])
    return paths, variables


@pytest.fixture(scope="module")
def serial(weights):
    """The port's serial forward of each model, and the JAX serial eval of
    JAX_MODEL on the same weights."""
    import jax
    import jax.numpy as jnp

    from mvsformer_torch.infer import make_infer_fn

    paths, variables = weights
    out = {}
    for name in MODELS:
        depth, conf, _ = make_infer_fn(build(name, paths), TMPS)(*request(name))
        out[name] = {"depth": depth, "conf": conf}
    imgs, projs, dv = request(JAX_MODEL)
    jmodel = jax_model()
    jout = jax.jit(lambda v: jmodel.apply(v, jnp.asarray(imgs), jax.tree.map(jnp.asarray, projs),
                                          jnp.asarray(dv), training=False, tmp=TMPS))(variables)
    out["jax"] = {"depth": torch.from_numpy(np.array(jout["refined_depth"])),
                  "conf": torch.from_numpy(np.array(jout["photometric_confidence"]))}
    return out


@pytest.fixture(scope="module")
def grid_ranks(tmp_path_factory, weights):
    out = {}
    for (world, view, depth), models in GRIDS.items():
        tmp = tmp_path_factory.mktemp(f"grid{world}")
        out[world] = run_ranks(tmp, world, dict(kind="evals", data=1, view=view, depth=depth,
                                                models=models, weights=weights[0]),
                               script=__file__)
    return out


CASES = [(world, name) for (world, _, _), models in GRIDS.items() for name in models]


@pytest.mark.parametrize("world,name", CASES, ids=[f"world{w}-{n}" for w, n in CASES])
def test_the_depth_slab_forward_is_the_serial_forward(grid_ranks, serial, world, name):
    want = serial[name]
    for r in grid_ranks[world]:
        got = r[name]
        assert got["depth"].shape == want["depth"].shape
        assert float((got["depth"] - want["depth"]).abs().max()) <= DEPTH_ATOL
        assert float((got["conf"] - want["conf"]).abs().max()) <= CONF_ATOL
    for r in grid_ranks[world][1:]:
        for key in ("depth", "conf"):
            assert torch.equal(r[name][key], grid_ranks[world][0][name][key])


@pytest.mark.parametrize("world", sorted(w for w, _, _ in GRIDS))
def test_the_depth_slab_forward_is_the_jax_serial_eval(grid_ranks, serial, world):
    """tests/test_parallel.py:137's config: every rank against the JAX
    package's serial eval (the port's own forward is within 1e-2 of it,
    tests/test_torch_variants.py)."""
    want = serial["jax"]
    for r in grid_ranks[world]:
        got = r[JAX_MODEL]
        assert float((got["depth"] - want["depth"]).abs().max()) <= DEPTH_ATOL
        assert float((got["conf"] - want["conf"]).abs().max()) <= CONF_ATOL


def test_the_test_cli_serves_over_depth_slabs(tmp_path, weights):
    """`python -m mvsformer_torch.test --depth_parallel 2` on two gloo ranks
    against the serial CLI: the same files, written once, depth and
    confidence within the same bounds."""
    import dataclasses

    import chip_smoke
    from mvsformer_torch import test as test_cli
    from mvsformer_torch.utils.pfm import read_pfm

    chip_smoke.write_dtu_scan(str(tmp_path), views=3, img_hw=(150, 225))
    (tmp_path / "list.txt").write_text("scan1\n")
    cfg = model_config("twin-BN-16842")
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"arch": dataclasses.asdict(cfg)}, f)
    torch.save({"state_dict": torch.load(weights[0]["twin-BN-16842"], weights_only=False)},
               tmp_path / "model.pth")

    def argv(out):
        return ["--testpath", str(tmp_path / "dtu"), "--testlist", str(tmp_path / "list.txt"),
                "--ckpt_dir", str(tmp_path), "--torch_ckpt", str(tmp_path / "model.pth"),
                "--outdir", str(tmp_path / out), "--max_h", "64", "--max_w", "64",
                "--ndepths", "48", "--num_view", "3", "--device", "cpu", "--skip_fusion",
                "--dtype", "fp32"]

    test_cli.main(argv("serial"))
    run = tmp_path / "ranks"
    run.mkdir()
    run_ranks(run, 2, dict(kind="cli", module="mvsformer_torch.test",
                           argv=argv("slabs") + ["--depth_parallel", "2", "--dist_backend",
                                                 "gloo", "--dist_url",
                                                 "file://" + str(run / "cli_store")]))

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    one, two = files(tmp_path / "serial"), files(tmp_path / "slabs")
    assert one == two and len(one) == 4 * 3 + 1  # depth, confidence, cams, image; the metrics
    for f in one:
        a, b = (tmp_path / d / f for d in ("serial", "slabs"))
        if f.endswith(".pfm"):
            assert np.abs(read_pfm(str(a))[0] - read_pfm(str(b))[0]).max() <= DEPTH_ATOL
        elif f.endswith(".npy"):
            assert np.abs(np.load(a) - np.load(b)).max() <= CONF_ATOL


if __name__ == "__main__":  # a rank of run_ranks
    rank_main(sys.argv[1])
