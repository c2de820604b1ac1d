"""The port's data- and view-parallel training step against the JAX
package's serial step (CPU, gloo ranks as subprocesses).

As tests/test_parallel.py holds the JAX mesh's step to the serial one: the
loss is the data-parallel one, each data shard's masked mean and then
their mean (tests/test_parallel.py:60-76), and the serial JAX step takes
its gradient on the whole batch in one training forward, so its BN
statistics are the whole batch's, which SyncBN gives every data rank.
The port's ranks run `TrainStep` on their share (one sample, one
micro-batch) from the same weights (the JAX init with randomised BN
affine and running statistics, carried by the weight bridge); each rank's
averaged gradients, losses and running statistics are compared, through
the bridge's names, at tests/test_parallel.py's bounds (loss rtol 2e-4 /
atol 2e-5, every gradient rtol 5e-3 / atol 5e-4):
- (a) data 2 with BN (SyncBN over the data ranks), and its running
  statistics;
- (b) data 2 x view 2 (world 4) with GN, as tests/test_parallel.py runs
  its mesh (BN's FPN statistics over a view rank's own views would make
  another function).
The batch: B=2, 3 views (one source view a view rank), 64x64, the toy
cascade (ndepths 8/4/4/2) at the default widths, no drop path.

Both sides run in float64 (JAX with x64 on inside the fixture only, the
port's model in double) around the same fp32 parts, as
tests/test_torch_train_step.py does: in fp32 this tiny random network's
gradients move by up to 5.3e-2 of a tensor's largest entry when the
images move by 1e-6 of their value, past these bounds whatever the
parallelism.

And the grid's layout against `make_mesh`'s: rank r sits where the JAX
mesh puts device r.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.config import ModelConfig as JaxModelConfig
from mvsformer_tpu.models.mvsformer import build_model as jax_build_model
from mvsformer_tpu.ops import losses as jlosses
from mvsformer_tpu.parallel import mesh as jax_mesh

from mvsformer_torch.models.mvsformer import build_model
from mvsformer_torch.parallel import mesh
from mvsformer_torch.utils.convert_weights import convert_flax_grads, load_flax_twin

from test_torch_model import randomise_bn, to_numpy
from test_torch_parallel_ranks import CFG, KEYS, make_train_batch, run_ranks, train_config
from test_torch_train_step import jax_x64, to_numpy64
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5      # tests/test_parallel.py's
GRAD_RTOL, GRAD_ATOL = 5e-3, 5e-4      # tests/test_parallel.py's
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6    # tests/test_torch_train_step.py's (fp32 BN moments)


def jax_serial_ddp_step(norm, batch, shards):
    """The JAX model's float64 step on the whole batch with the DDP loss
    over `shards` equal shards. -> (numpy fp32 params and stats it starts
    from, loss, stage losses, float64 grads, running stats after it)."""
    with jax_x64(True):
        jcfg = JaxModelConfig(**CFG, norm_type=norm)
        jcfg.vit_args.drop_path_rate = 0.0
        jmodel = jax_build_model(jcfg, dtype=jnp.float64)
        jb = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), batch)
        variables = jax.jit(lambda k: jmodel.init(
            k, jb["imgs"][:1], jax.tree.map(lambda x: x[:1], jb["proj_matrices"]),
            jb["depth_values"][:1], training=False))(jax.random.PRNGKey(0))
        params = to_numpy(variables["params"])
        stats = to_numpy(variables.get("batch_stats", {}))
        randomise_bn(params, stats, np.random.default_rng(1))
        n = batch["imgs"].shape[0] // shards

        def loss_fn(p):
            out, upd = jmodel.apply({"params": p, "batch_stats": stats}, jb["imgs"],
                                    jb["proj_matrices"], jb["depth_values"], training=True,
                                    mutable=["batch_stats"],
                                    rngs={"droppath": jax.random.PRNGKey(0)})
            total, stages = 0.0, {k: 0.0 for k in KEYS}
            for i in range(shards):
                sub = lambda x: x[i * n:(i + 1) * n]  # noqa: E731
                o = {k: jax.tree.map(sub, out[k]) for k in KEYS}
                dv = sub(jb["depth_values"])
                loss, ld = jlosses.total_loss(
                    o, jax.tree.map(sub, jb["depth_gt"]), jax.tree.map(sub, jb["mask"]),
                    dv[:, 1] - dv[:, 0], depth_type="ce", stage_keys=KEYS)
                total = total + loss / shards
                stages = {k: stages[k] + ld[k] / shards for k in KEYS}
            return total, (stages, upd.get("batch_stats", {}))

        (loss, (stages, new_stats)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params))
        return (params, stats, float(loss), {k: float(v) for k, v in stages.items()},
                to_numpy64(grads), to_numpy64(new_stats))


@pytest.mark.parametrize("norm,data,view", [("BN", 2, 1), ("GN", 2, 2)])
def test_grid_step_matches_the_jax_serial_step(tmp_path, norm, data, view):
    batch = make_train_batch(np.random.default_rng(0), V=3)
    params, stats, loss, stages, grads, new_stats = jax_serial_ddp_step(norm, batch, data)
    model = build_model(train_config(norm).arch, device="cpu", train=True).double()
    load_flax_twin(model, params, stats)
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    torch.save(batch, tmp_path / "batch.pt")
    ranks = run_ranks(tmp_path, data * view, dict(
        kind="step", data=data, view=view, norm=norm, dtype="float64",
        weights=str(tmp_path / "weights.pt"), batch=str(tmp_path / "batch.pt")))

    vit_depths = tuple(len(b) for b in model.vit.blocks)
    want_grads, want_stats = convert_flax_grads(grads, new_stats, tuple(CFG["ndepths"]), 8,
                                                vit_depths)
    assert (norm == "BN") == bool(want_stats)
    for r in ranks:
        m = r["metrics"]
        np.testing.assert_allclose(m["loss"], loss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
        for k in KEYS:
            np.testing.assert_allclose(m[f"loss_{k}"], stages[k], rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL)
        assert set(r["grads"]) == set(want_grads)
        for name, want in want_grads.items():
            np.testing.assert_allclose(r["grads"][name].numpy(), want.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=name)
        for name, want in want_stats.items():
            np.testing.assert_allclose(r["buffers"][name].numpy(), want.numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=name)


@pytest.mark.parametrize("data,view", [(1, 2), (2, 1), (2, 2), (4, 2), (2, 4), (-1, 2)])
def test_the_grid_is_make_meshs_device_layout(monkeypatch, data, view):
    """`make_mesh` run on integer stand-ins for the devices (its `Mesh`
    replaced by the array it would wrap) puts device r where the port
    puts rank r, and sizes a data axis of -1 as the port does."""
    monkeypatch.setattr(jax_mesh, "Mesh", lambda arr, axes: arr)
    world = 8 if data == -1 else data * view
    grid = jax_mesh.make_mesh(data, view, 1, devices=list(range(world)))
    assert grid.shape[:2] == mesh.grid_shape(world, data, view)[:2]
    for r in range(world):
        assert grid[mesh.grid_position(r, *grid.shape)] == r
