"""`cuda_build.eval_outputs`: a gradient through an eval kernel fails loudly.

The eval kernels (K1-K6) write their outputs through ctypes, out of
autograd's sight. Their wrappers return them through `eval_outputs`, which
the GPU tests exercise through each kernel (tests/test_torch_cuda.py
`test_eval_kernel_backward_raises`); here the helper itself, on the CPU.
"""

import pytest
import torch

from mvsformer_torch.ops import cuda_build

torch.set_num_threads(2)


def kernel_like(*shapes):
    """Outputs as a kernel leaves them: tensors with no autograd history."""
    return tuple(torch.randn(s) for s in shapes)


def test_backward_through_an_eval_output_raises_naming_the_kernel():
    w = torch.randn(3, requires_grad=True)
    (out,) = kernel_like((2, 3))
    got = cuda_build.eval_outputs("some_kernel", out, w)
    assert got.grad_fn is not None
    assert torch.equal(got, out) and got.data_ptr() == out.data_ptr()  # the identity
    with pytest.raises(RuntimeError, match=r"some_kernel: .*torch\.no_grad\(\)"):
        (got * w).sum().backward()


def test_every_output_of_a_tuple_is_tracked():
    w = torch.randn(3, requires_grad=True)
    outs = kernel_like((2, 3), (4,))
    got = cuda_build.eval_outputs("pair_kernel", outs, torch.randn(3), w)
    assert isinstance(got, tuple) and len(got) == 2
    assert all(g.grad_fn is not None and torch.equal(g, o) for g, o in zip(got, outs))
    with pytest.raises(RuntimeError, match="pair_kernel"):
        got[1].sum().backward()


@pytest.mark.parametrize("quiet", [torch.no_grad, torch.inference_mode])
def test_under_no_grad_the_outputs_come_back_untouched(quiet):
    w = torch.randn(3, requires_grad=True)
    out, other = kernel_like((2, 3), (4,))
    with quiet():
        assert cuda_build.eval_outputs("some_kernel", out, w) is out
        pair = (out, other)
        assert cuda_build.eval_outputs("some_kernel", pair, w) is pair
    assert out.grad_fn is None and not out.requires_grad


def test_without_an_input_that_requires_grad_nothing_is_added():
    (out,) = kernel_like((2, 3))
    assert cuda_build.eval_outputs("some_kernel", out, torch.randn(3)) is out
