"""DINOMVSNet's and TwinMVSNet's GN + re eval forwards in bf16 against the
JAX package's (CPU), to tests/test_torch_bf16.py's bounds and island guard:
the port's bf16 output within MULT times the JAX package's own bf16-vs-fp32
gap plus the fp32 parity bounds, in the mean and the maximum.

- DINOMVSNet at configs/config_mvsformer-p.json's arch (vit_small at full
  width, the CLS-attention decoder; ndepths 8/4/4/2), B=1, V=3, 64x128, as
  tests/test_torch_dino.py runs it.
- TwinMVSNet with GN (the encoder head, the FPN levels and the visibility
  CNN run as their modules, no K2/K4/K5) and the `re` depth type (decoded
  in torch), from tests/test_torch_variants.py's random variables.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.config import ModelConfig as JaxModelConfig
from mvsformer_tpu.models.mvsformer import build_model as jax_build_model

from mvsformer_torch.config import ModelConfig
from mvsformer_torch.models.mvsformer import build_model
from mvsformer_torch.utils.convert_weights import load_flax_twin

from test_torch_bf16 import F32, JAX_FLAGS, assert_islands, forwards, hold_forward
from test_torch_dino import jax_cfg as dino_jax_cfg
from test_torch_dino import port_cfg as dino_port_cfg
from test_torch_dino import random_variables as dino_variables
from test_torch_model import CFG, make_batch
from test_torch_variants import jax_variables as variant_variables
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()


def dino_case():
    """DINOMVSNet at configs/config_mvsformer-p.json's arch (vit_small at
    full width, the CLS-attention decoder) with ndepths 8/4/4/2, B=1, V=3,
    64x128 (a 2x4 token grid), as tests/test_torch_dino.py runs it."""
    model, params, stats = dino_variables(dino_port_cfg(), 0)
    batch = make_batch(np.random.default_rng(0), H=64, W=128)
    with pytest.MonkeyPatch.context() as mp:
        j32, j16, tout, seen, _ = forwards(model, dino_jax_cfg(), params, stats, batch, mp)
    return dict(name="dino", j32=j32, j16=j16, tout=tout, seen=seen)


@pytest.fixture(scope="module")
def dino():
    return dino_case()


def test_dino_forward_in_bf16(dino):
    hold_forward(dino)


def test_dino_islands_are_fp32(dino):
    assert_islands(dino["seen"])


def gn_re_case():
    """TwinMVSNet with GN (the encoder head, FPN levels and visibility CNN
    run as their modules, no K2/K4/K5) and the `re` depth type (its decode
    in torch): tests/test_torch_bf16.py's toy config and batch."""
    cfg = dict(CFG, norm_type="GN", depth_type="re")
    batch = make_batch(np.random.default_rng(0))
    jcfg = JaxModelConfig(**cfg, **JAX_FLAGS)
    imgs, projs, dv = batch
    params, stats = variant_variables(jax_build_model(jcfg, dtype=jnp.float32),
                                      jnp.asarray(imgs), jax.tree.map(jnp.asarray, projs),
                                      jnp.asarray(dv), seed=1)
    model = build_model(ModelConfig(**cfg), device="cpu")
    load_flax_twin(model, params, stats)
    with pytest.MonkeyPatch.context() as mp:
        j32, j16, tout, seen, _ = forwards(model, jcfg, params, stats, batch, mp)
    return dict(name="GN + re", j32=j32, j16=j16, tout=tout, seen=seen)


@pytest.fixture(scope="module")
def gn_re():
    return gn_re_case()


def test_gn_re_forward_in_bf16(gn_re):
    hold_forward(gn_re)


def test_gn_re_islands_are_fp32(gn_re):
    assert_islands(gn_re["seen"])
    assert gn_re["seen"]["op:group_norm"] == F32
