"""Serving over the port's process grid on the CPU (gloo ranks as
subprocesses, tests/test_torch_parallel_ranks.py's `run_ranks`):

- (c) the eval forward at view 2 (two ranks, 2 of the 4 source views
  each; `make_infer_fn` of a model built with the layout) against the JAX
  package's serial forward on the same weights (the port's random weights
  carried to JAX by its converter), for TwinMVSNet and for DINOMVSNet,
  within tests/test_torch_model.py's bounds (depth 1e-2, confidence 1e-4);
  both ranks return the same bits;
- (d) `save_depth` at data 2 against world 1 on a scan of 5 reference
  views (an odd count: the ranks serve 3 and 2): the same files, each
  byte for byte (every view's forward is the same computation on one
  thread), none written twice, and the same `depth_metric.txt`.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.config import ModelConfig as JaxModelConfig
from mvsformer_tpu.config import ViTConfig as JaxViTConfig
from mvsformer_tpu.models.mvsformer import build_model as jax_build_model
from mvsformer_tpu.utils.convert_weights import convert_full_dino, convert_full_twin

from mvsformer_torch.config import ViTConfig
from mvsformer_torch.models.mvsformer import build_model, random_init_

from test_torch_model import make_batch
from test_torch_parallel_ranks import CFG, run_ranks, train_config
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

TMPS = [5.0, 5.0, 5.0, 1.0]
DEPTH_ATOL, CONF_ATOL = 1e-2, 1e-4  # tests/test_torch_model.py's bounds
JAX_FLAGS = dict(fused_enc_head=False, fused_fpn_final=False, fused_fpn_l2=False)
DINO_VIT = dict(twin=False, vit_arch="vit_small", vit_ch=384, out_ch=64, att_fusion=True)
MODELS = {"twin": ({}, (64, 64)),
          "dino": ({"model_type": "dino", "vit_args": DINO_VIT}, (64, 128))}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_view_split_forward_matches_the_jax_forward(tmp_path, name):
    over, (h, w) = MODELS[name]
    cfg = train_config("BN", dict(over, vit_args=ViTConfig(**over["vit_args"]))
                       if "vit_args" in over else over).arch
    model = random_init_(build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    if name == "dino":
        params, stats = convert_full_dino(sd, ndepths=tuple(cfg.ndepths), model_th=cfg.model_th)
        jcfg = JaxModelConfig(**dict(CFG, model_type="dino"), **JAX_FLAGS,
                              vit_args=JaxViTConfig(**DINO_VIT))
    else:
        params, stats = convert_full_twin(sd, ndepths=tuple(cfg.ndepths),
                                          model_th=cfg.model_th,
                                          vit_depths=tuple(len(b) for b in model.vit.blocks))
        jcfg = JaxModelConfig(**CFG, **JAX_FLAGS)
    imgs, projs, dv = make_batch(np.random.default_rng(0), V=5, H=h, W=w)
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    jout = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, training=False, tmp=TMPS))(
        {"params": params, "batch_stats": stats}, jnp.asarray(imgs),
        jax.tree.map(jnp.asarray, projs), jnp.asarray(dv))

    torch.save(model.state_dict(), tmp_path / "weights.pt")
    torch.save((torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
                torch.from_numpy(dv)), tmp_path / "request.pt")
    ranks = run_ranks(tmp_path, 2, dict(kind="eval", data=1, view=2, cfg=over,
                                        weights=str(tmp_path / "weights.pt"),
                                        request=str(tmp_path / "request.pt"), tmps=TMPS))
    for r in ranks:
        np.testing.assert_allclose(r["depth"].numpy(), np.asarray(jout["refined_depth"]),
                                   rtol=0, atol=DEPTH_ATOL)
        np.testing.assert_allclose(r["conf"].numpy(),
                                   np.asarray(jout["photometric_confidence"]), rtol=0,
                                   atol=CONF_ATOL)
        for i, c in enumerate(r["stage_confs"]):
            np.testing.assert_allclose(c.numpy(), np.asarray(
                jout[f"stage{i + 1}"]["photometric_confidence"]), rtol=0, atol=CONF_ATOL)
    for key in ("depth", "conf"):
        assert torch.equal(ranks[0][key], ranks[1][key])


def test_save_depth_over_two_data_ranks_writes_the_single_process_files(tmp_path):
    import chip_smoke

    views = 5
    chip_smoke.write_dtu_scan(str(tmp_path), views=views, img_hw=(150, 225))
    (tmp_path / "list.txt").write_text("scan1\n")
    model = random_init_(build_model(train_config("BN").arch, device="cpu"),
                         torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    outs = {}
    for world in (1, 2):
        out = tmp_path / f"world{world}"
        kw = dict(testlist=["scan1"], datapath=str(tmp_path / "dtu"), outdir=str(out),
                  num_view=3, ndepths=48, max_h=128, max_w=192)
        run = tmp_path / f"run{world}"
        run.mkdir()
        outs[world] = run_ranks(run, world, dict(kind="save_depth", data=world, view=1,
                                                 save_depth=kw,
                                                 weights=str(tmp_path / "weights.pt")))

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    one, two = files(tmp_path / "world1"), files(tmp_path / "world2")
    assert one == two
    assert len(one) == 4 * views + 1  # depth, confidence, cams, image a view; the metrics
    for f in one:
        assert (tmp_path / "world1" / f).read_bytes() == (tmp_path / "world2" / f).read_bytes(), f
    metrics = outs[1][0]["metrics"]
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    assert outs[2][0]["metrics"] == metrics and outs[2][1]["metrics"] == metrics
