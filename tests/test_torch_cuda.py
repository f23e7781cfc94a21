"""The CUDA deform kernel against its plain version, on a card.

These tests skip without a CUDA card: the kernel has no CPU mode. They
import no JAX, so they run where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which such a machine may
not have.)
"""

import pytest
import torch

from test_torch_common import cuda_device, deform_case  # noqa: F401

from codenet_torch.ops import deform_cuda as DC


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8, 1024), (16, 16, 256),
                                   (32, 32, 128), (12, 12, 58),
                                   (16, 16, 2153), (24, 24, 32)])
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


@pytest.mark.cuda
def test_kernel_refuses_grad_on_card(cuda_device):
    x, s, w = (torch.from_numpy(a).to(cuda_device)
               for a in deform_case((8, 8, 16)))
    with pytest.raises(NotImplementedError, match="training slice"):
        DC.codesign_deform_conv_fast(x.requires_grad_(), s, w)
