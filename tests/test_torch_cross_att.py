"""The cross-view attention blocks, `remat_backbone`, and DINOMVSNet's
`cross_att` (CPU).

- `sine_position_embedding` and `sine_position_embedding_1d` against the
  JAX functions.
- `DINOViT(cross_att=True, nview=3)` (vit_small: a CrossBlock after blocks
  3, 6, 9 and 12) against the JAX `vit_small(cross_att=True, nview=3)` in
  fp32, on 2 samples x 3 views at 64x64, with and without epipoles, the
  flax variables carried by the port's bridge. The gates `alpha1` and
  `alpha2` and the token-type table are set to random non-zero values
  first: with the zero-initialised gates every cross block is the
  identity and the test would hold nothing. Tokens and the last block's
  attention within 1e-5 of their scale.
- DINOMVSNet with `cross_att=True` builds the JAX model: no cross block,
  the same `state_dict` keys and the same output as with `cross_att=False`
  (the JAX DINOMVSNet never passes the flag to its ViT).
- `remat_backbone` (port only): a multi-scale TwinMVSNet's training
  forward and backward over two micro-batches that share one generator,
  drop path 0.2, under `torch.use_deterministic_algorithms(True)`: the
  gradients and the generator's state after the step bit-equal with remat
  on and off, the backbone checkpointed when on; another seed gives other
  gradients (the drop path is live). DINOMVSNet's ViT likewise, without a
  generator (it has no drop path). Neither checkpoints in eval or under
  `fix`.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.models import cross_attention as jca
from mvsformer_tpu.models.dino import vit_small as jax_vit_small

from mvsformer_torch.config import ModelConfig, ViTConfig
from mvsformer_torch.models import cross_attention, mvsformer
from mvsformer_torch.models.dino import build_vit
from mvsformer_torch.models.mvsformer import build_model, random_init_
from mvsformer_torch.ops.losses import total_loss
from mvsformer_torch.utils.convert_weights import dino_vit_state, to_torch

from test_torch_model import CFG, TMPS, make_batch
from test_torch_train_step import make_train_batch
from test_torch_watchdog import watchdog

torch.set_num_threads(4)
hang_watchdog = watchdog()

MODULE_ATOL = 1e-5  # of max(1, max |JAX output|)
VIEWS, SAMPLES = 3, 2
DINO_VIT = dict(twin=False, vit_arch="vit_small", vit_ch=384, out_ch=64)


def test_sine_embeddings_match_jax():
    rng = np.random.default_rng(0)
    u, v = (rng.uniform(-1, 1, (2, 3, 16)).astype(np.float32) for _ in range(2))
    d = rng.uniform(0, 1, (2, 3, 16)).astype(np.float32)
    got = cross_attention.sine_position_embedding(torch.from_numpy(u), torch.from_numpy(v),
                                                  24, 32 * np.pi).numpy()
    want = np.asarray(jca.sine_position_embedding(jnp.asarray(u), jnp.asarray(v), 24,
                                                  32 * np.pi))
    assert got.shape == want.shape == (2, 3, 16, 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got = cross_attention.sine_position_embedding_1d(torch.from_numpy(d), 24, 2 * np.pi).numpy()
    want = np.asarray(jca.sine_position_embedding_1d(jnp.asarray(d), 24, 2 * np.pi))
    assert got.shape == want.shape == (2, 3, 16, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def cross_vit():
    """The JAX cross-view ViT's variables with random gates and token types,
    its outputs with and without epipoles, and the port's ViT on them."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((SAMPLES * VIEWS, 64, 64, 3)).astype(np.float32)
    epipoles = (rng.standard_normal((SAMPLES, VIEWS - 1, 2)) * 100).astype(np.float32)
    jvit = jax_vit_small(dtype=jnp.float32, cross_att=True, nview=VIEWS)
    params = jax.tree.map(lambda a: np.array(a, np.float32), jax.jit(
        lambda k: jvit.init(k, jnp.asarray(x)))(jax.random.PRNGKey(1))["params"])
    crosses = sorted(k for k in params if k.startswith("cross_block"))
    assert crosses == [f"cross_block{k}" for k in range(4)]
    for k in crosses:
        p = params[k]
        p["alpha1"] = np.float32(rng.uniform(0.5, 1.5))
        p["alpha2"] = np.float32(-rng.uniform(0.5, 1.5))
        p["tok_embeddings"]["embedding"] = rng.standard_normal(
            p["tok_embeddings"]["embedding"].shape).astype(np.float32)
    apply = jax.jit(lambda p, x, e: jvit.apply({"params": p}, x, epipoles=e))
    plain = jax.jit(lambda p, x: jvit.apply({"params": p}, x))
    want = {"none": plain(params, jnp.asarray(x)),
            "epipoles": apply(params, jnp.asarray(x), jnp.asarray(epipoles))}
    zero = jax.tree.map(lambda a: a, params)
    for k in crosses:
        zero[k]["alpha1"] = zero[k]["alpha2"] = np.float32(0.0)
    want["gates 0"] = plain(zero, jnp.asarray(x))
    vit = build_vit("vit_small", cross_att=True, nview=VIEWS)
    vit.load_state_dict(to_torch(dino_vit_state(params, 12)), strict=True)
    return dict(vit=vit, x=torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                epipoles=torch.from_numpy(epipoles), want=want)


@pytest.mark.parametrize("kind", ["none", "epipoles"])
def test_cross_view_vit_matches_jax(cross_vit, kind):
    with torch.no_grad():
        tok, att = cross_vit["vit"](cross_vit["x"],
                                    cross_vit["epipoles"] if kind == "epipoles" else None)
    jtok, jatt = (np.asarray(a) for a in cross_vit["want"][kind])
    assert tok.shape == jtok.shape == (SAMPLES * VIEWS, 17, 384)
    for got, want in ((tok.numpy(), jtok), (att.numpy(), jatt)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=MODULE_ATOL * max(1.0, float(np.abs(want).max())))
    # the cross blocks are live: without them (gates 0) the tokens move
    gap = np.abs(jtok - np.asarray(cross_vit["want"]["gates 0"][0])).max()
    assert gap > 100 * MODULE_ATOL * max(1.0, float(np.abs(jtok).max())), gap


def test_cross_blocks_are_the_flax_modules(cross_vit):
    vit = cross_vit["vit"]
    names = {n.split(".")[0] for n, _ in vit.named_parameters() if n.startswith("cross_block")}
    assert names == {f"cross_block{k}" for k in range(4)}
    assert vit.cross_block0.attn.qkv.bias is None and vit.cross_block0.alpha1.shape == ()
    fresh = build_vit("vit_small", cross_att=True, nview=VIEWS)
    assert all(float(getattr(fresh, f"cross_block{k}").alpha1.detach()) == 0.0
               for k in range(4))


def test_dino_with_cross_att_builds_the_jax_model():
    """The JAX DINOMVSNet builds its ViT without `cross_att`: so does the
    port's, with the same keys and the same output."""
    models = {}
    for flag in (False, True):
        cfg = ModelConfig(**CFG, model_type="dino",
                          vit_args=ViTConfig(**DINO_VIT, cross_att=flag))
        models[flag] = build_model(cfg, device="cpu")
    assert models[True].state_dict().keys() == models[False].state_dict().keys()
    assert not any("cross" in n for n in models[True].state_dict())
    random_init_(models[False], torch.Generator().manual_seed(0))
    models[True].load_state_dict(models[False].state_dict(), strict=True)
    imgs, projs, dv = make_batch(np.random.default_rng(0))
    outs = []
    for flag in (False, True):
        with torch.inference_mode():
            out = models[flag](torch.from_numpy(imgs),
                               {k: torch.from_numpy(v) for k, v in projs.items()},
                               torch.from_numpy(dv), tmp=TMPS)
        outs.append(out)
    for key in ("refined_depth", "photometric_confidence"):
        assert torch.equal(outs[0][key], outs[1][key]), key


# ------------------------------------------------------------------ remat_backbone

@contextlib.contextmanager
def deterministic():
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved)


def counting_checkpoint(monkeypatch):
    calls = []
    original = mvsformer.checkpoint

    def counted(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(mvsformer, "checkpoint", counted)
    return calls


def two_micro_batches(cfg, state, batch, seed, together=False):
    """The training forward and backward of each sample in turn, both
    drawing drop path from one generator (`together`: both forwards, then
    one backward of the summed losses, so that the backward's runs of the
    backbone come after both forwards' draws). -> (gradients, the
    generator's state after)."""
    model = build_model(cfg, device="cpu", train=True)
    model.load_state_dict(state)
    generator = torch.Generator().manual_seed(seed)
    keys = tuple(f"stage{i}" for i in range(1, 5))
    total = 0.0
    for i in range(batch["imgs"].shape[0]):
        take = lambda a: torch.from_numpy(a[i:i + 1])  # noqa: E731
        out = model(take(batch["imgs"]), {k: take(v) for k, v in batch["proj_matrices"].items()},
                    take(batch["depth_values"]), generator=generator)
        dv = take(batch["depth_values"])
        loss, _ = total_loss(out, {k: take(batch["depth_gt"][k]) for k in keys},
                             {k: take(batch["mask"][k]) for k in keys}, dv[:, 1] - dv[:, 0],
                             stage_keys=keys)
        if together:
            total = total + loss
        else:
            loss.backward()
    if together:
        total.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}, generator.get_state()


@pytest.fixture(scope="module")
def twin_remat():
    batch = make_train_batch(np.random.default_rng(0))
    cfgs = {flag: ModelConfig(**CFG, multi_scale=True, remat_backbone=flag) for flag in (0, 1)}
    for cfg in cfgs.values():
        cfg.vit_args.drop_path_rate = 0.2
    state = random_init_(build_model(cfgs[0], device="cpu"),
                         torch.Generator().manual_seed(1)).state_dict()
    runs, calls = {}, {}
    with pytest.MonkeyPatch.context() as mp, deterministic():
        counted = counting_checkpoint(mp)
        for flag, seed, together in ((0, 7, 0), (1, 7, 0), (0, 8, 0), (0, 7, 1), (1, 7, 1)):
            n = len(counted)
            runs[(flag, seed, together)] = two_micro_batches(cfgs[flag], state, batch, seed,
                                                             together)
            calls[(flag, seed, together)] = len(counted) - n
    return runs, calls


@pytest.mark.parametrize("together", [0, 1])
def test_remat_gives_the_same_gradients_and_generator_state(twin_remat, together):
    runs, calls = twin_remat
    assert calls[(0, 7, together)] == 0 and calls[(1, 7, together)] == 2  # one a micro-batch
    (g0, s0), (g1, s1) = runs[(0, 7, together)], runs[(1, 7, together)]
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert torch.equal(s0, s1)


def test_remat_test_sees_the_drop_path(twin_remat):
    """Another seed draws other masks: other backbone gradients."""
    runs, _ = twin_remat
    g7, s7 = runs[(0, 7, 0)]
    g8, s8 = runs[(0, 8, 0)]
    assert not torch.equal(s7, s8)
    assert any(not torch.equal(g7[n], g8[n]) for n in g7 if n.startswith("vit."))


def test_remat_of_the_dino_vit_gives_the_same_gradients(monkeypatch):
    batch = make_train_batch(np.random.default_rng(1))
    cfgs = {flag: ModelConfig(**CFG, model_type="dino", remat_backbone=flag,
                              vit_args=ViTConfig(**DINO_VIT)) for flag in (0, 1)}
    state = random_init_(build_model(cfgs[0], device="cpu"),
                         torch.Generator().manual_seed(2)).state_dict()
    calls = counting_checkpoint(monkeypatch)
    with deterministic():
        g0, _ = two_micro_batches(cfgs[0], state, batch, 0)
        assert not calls
        g1, _ = two_micro_batches(cfgs[1], state, batch, 0)
    assert len(calls) == 2
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


@pytest.mark.parametrize("fix", [False, True])
def test_remat_applies_in_training_without_fix_only(monkeypatch, fix):
    calls = counting_checkpoint(monkeypatch)
    cfg = ModelConfig(**CFG, remat_backbone=True, fix=fix)
    model = build_model(cfg, device="cpu")
    imgs, projs, dv = make_batch(np.random.default_rng(0))
    args = (torch.from_numpy(imgs), {k: torch.from_numpy(v) for k, v in projs.items()},
            torch.from_numpy(dv))
    with torch.no_grad():
        model(*args, tmp=TMPS)
    assert not calls  # eval
    model.train()
    model(*args, generator=torch.Generator().manual_seed(0))
    assert len(calls) == (0 if fix else 1)
