"""K6 `gsa_attention` and the port's GlobalSubsampledAttention against the
JAX package (CPU).

The plain version (what the wrapper runs for CPU tensors; the CUDA kernel
is held against it by tests/test_torch_cuda.py and chip_smoke.py on the
GPU) against the fp32 einsum path of the JAX module, and against the Pallas
kernel in interpret mode, as tests/test_gsa_attention.py runs it. The
Pallas kernel rounds the probabilities to bf16 (a JAX-side difference; the
port keeps them fp32), hence that comparison's 3e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mvsformer_tpu.models import twins as jtwins
from mvsformer_tpu.ops.pallas.gsa_attention import gsa_attention as pallas_gsa_attention

from mvsformer_torch.models import twins
from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.gsa_attention import gsa_attention, gsa_attention_plain
from mvsformer_torch.utils import convert_weights as cw

torch.set_num_threads(2)

T = torch.from_numpy


def einsum_attention(q, k, v, nh):
    """GlobalSubsampledAttention's einsum path (models/twins.py), fp32."""
    B, N, C = q.shape
    hd = C // nh
    qh, kh, vh = (jnp.asarray(a).reshape(B, -1, nh, hd) for a in (q, k, v))
    attn = jnp.einsum("bqnd,bknd->bnqk", qh, kh).astype(jnp.float32) * hd ** -0.5
    attn = jax.nn.softmax(attn, axis=-1)
    return np.asarray(jnp.einsum("bnqk,bknd->bqnd", attn, vh).reshape(B, N, C))


def qkv(rng, B, N, Nk, C):
    return [rng.standard_normal(s).astype(np.float32) for s in ((B, N, C), (B, Nk, C), (B, Nk, C))]


# Nk = 70 and 100 are above the kernel's 64-key chunk and not multiples of
# it; N = 300 and 130 are not multiples of its 128-row block.
@pytest.mark.parametrize("B,N,Nk,C,nh", [(2, 300, 24, 64, 2), (1, 130, 100, 128, 4),
                                         (2, 64, 70, 96, 3)])
def test_gsa_plain_matches_fp32_einsum(B, N, Nk, C, nh):
    q, k, v = qkv(np.random.default_rng(0), B, N, Nk, C)
    before = dict(cuda_build.LAUNCHES)
    got = gsa_attention(T(q), T(k), T(v), nh)
    assert dict(cuda_build.LAUNCHES) == before
    torch.testing.assert_close(got, gsa_attention_plain(T(q), T(k), T(v), nh), rtol=0, atol=0)
    # fp32 both sides, products summed in another order.
    np.testing.assert_allclose(got.numpy(), einsum_attention(q, k, v, nh), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,Nk,C,nh", [(300, 70, 64, 2), (256, 10, 64, 4)])
def test_gsa_plain_matches_pallas_interpret(N, Nk, C, nh):
    q, k, v = qkv(np.random.default_rng(1), 2, N, Nk, C)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_gsa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), nh)
    got = gsa_attention_plain(T(q), T(k), T(v), nh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-2, atol=3e-2)


def test_gsa_module_matches_flax_module_fused_and_not():
    """The port's module (sr conv + LayerNorm + q/kv + K6's plain version +
    proj) against the flax module's einsum path (fp32, 1e-4) and its fused
    path with the Pallas kernel in interpret mode (3e-2)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 24, 64)).astype(np.float32)
    jmod = jtwins.GlobalSubsampledAttention(64, 2, sr_ratio=4, dtype=jnp.float32)
    v = jax.tree.map(np.array, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    jfused = jtwins.GlobalSubsampledAttention(64, 2, sr_ratio=4, dtype=jnp.float32, fused=True)
    with pltpu.force_tpu_interpret_mode():
        want_fused = np.asarray(jfused.apply(v, jnp.asarray(x), fused_ok=True))

    p, sd = v["params"], {}
    for name in ("q", "kv", "proj"):
        cw._plain(sd, name, p[name], np.transpose)
    cw._plain(sd, "sr", p["sr"])
    cw._ln(sd, "norm", p["norm"])
    mod = twins.GlobalSubsampledAttention(64, 2, sr_ratio=4).eval()
    mod.load_state_dict(cw.to_torch(sd))
    with torch.no_grad():
        got = mod(T(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_fused, rtol=3e-2, atol=3e-2)
