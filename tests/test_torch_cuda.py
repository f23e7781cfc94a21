"""The CUDA deform kernels against their plain versions, on a card.

These tests skip without a CUDA card: the kernels have no CPU mode. They
import no JAX, so they run where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which such a machine may
not have.)
"""

import numpy as np
import pytest
import torch

from test_torch_common import cuda_device, deform_case  # noqa: F401

from codenet_torch.ops import deform_cuda as DC

SHAPES = [(8, 8, 1024), (16, 16, 256), (32, 32, 128), (12, 12, 58),
          (16, 16, 2153), (24, 24, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(shape, dtype, cuda_device):
    """The CUDA kernel vs its plain version on the card: same coordinates,
    another sum order (1e-4 f32; 3e-2 bf16, one output rounding)."""
    x, s, w = deform_case(shape, seed=9)
    xt = torch.from_numpy(x).to(cuda_device, dtype)
    st = torch.from_numpy(s).to(cuda_device)
    wt = torch.from_numpy(w).to(cuda_device, dtype)
    before = DC.LAUNCHES
    out = DC.codesign_deform_conv_fast(xt, st, wt)
    torch.cuda.synchronize()
    assert DC.LAUNCHES == before + 1
    ref = DC.codesign_deform_conv_plain(xt, st, wt)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) <= tol


# the forward's shapes at batch 2; KITTI's 48x160 map (slices of 4
# channels: several positions per warp); one image alone
BWD_CASES = [(shape, 2) for shape in SHAPES] + [((48, 160, 64), 2),
                                                ((16, 16, 256), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backward_matches_plain_on_card(shape, n, dtype, cuda_device):
    """Autograd through the op on the card runs the backward kernel once;
    dx, ds and dw agree with the plain backward within 1e-4 (f32, atomics
    sum in another order) or 3e-2 (bf16) of each output's max. s mixes
    fractional values, integers and the exact bounds -7 and 8 (where ds
    must be 0)."""
    x, s, w = deform_case(shape, seed=10, n=n)
    r = np.random.RandomState(11)
    pick = r.randint(0, 4, s.shape)
    s = np.where(pick == 0, np.round(s), s)
    s = np.where(pick == 1, r.choice([-7.0, 8.0], s.shape), s)
    s = s.astype(np.float32)
    g = r.randn(*x.shape).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda_device, dtype).requires_grad_()
    st = torch.from_numpy(s).to(cuda_device).requires_grad_()
    wt = torch.from_numpy(w).to(cuda_device, dtype).requires_grad_()
    gt = torch.from_numpy(g).to(cuda_device, dtype)
    before = DC.BWD_LAUNCHES
    DC.codesign_deform_conv_fast(xt, st, wt).backward(gt)
    torch.cuda.synchronize()
    assert DC.BWD_LAUNCHES == before + 1
    refs = DC.codesign_deform_conv_bwd_plain(xt.detach(), st.detach(),
                                             wt.detach(), gt)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for name, got, ref in zip(("dx", "ds", "dw"),
                              (xt.grad, st.grad, wt.grad), refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        scale = float(ref.float().abs().max())
        err = float((got.float() - ref.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)
    bounds = torch.from_numpy((s == -7.0) | (s == 8.0)).to(cuda_device)
    assert float(st.grad[bounds].abs().max()) == 0.0
