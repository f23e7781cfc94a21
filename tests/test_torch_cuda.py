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
    _fwd_check(torch.from_numpy(x).to(cuda_device, dtype),
               torch.from_numpy(s).to(cuda_device),
               torch.from_numpy(w).to(cuda_device, dtype))


def _fwd_check(x, s, w):
    """The forward kernel (one launch) vs its plain version on the card:
    same coordinates, another sum order (1e-4 f32; 3e-2 bf16, one output
    rounding)."""
    before = DC.LAUNCHES
    out = DC.codesign_deform_conv_fast(x, s, w)
    torch.cuda.synchronize()
    assert DC.LAUNCHES == before + 1
    ref = DC.codesign_deform_conv_plain(x, s, w)
    tol = 1e-4 if x.dtype == torch.float32 else 3e-2
    assert out.dtype == x.dtype and out.shape == x.shape
    assert float((out.float() - ref.float()).abs().max()) <= tol


def _mixed_s(s, seed):
    """s with a quarter rounded to integers and a quarter exactly at the
    clamp bounds -7 and 8 (where a tap's upper corner has weight 0 and
    lies on the band's last row or off the map)."""
    r = np.random.RandomState(seed)
    pick = r.randint(0, 4, s.shape)
    s = np.where(pick == 0, np.round(s), s)
    s = np.where(pick == 1, r.choice([-7.0, 8.0], s.shape), s)
    return s.astype(np.float32)


# one image alone; the served batch; the train batch; KITTI's 48x160 map,
# whose bands clip at row 0 and at row H - 1
FWD_CASES = [((32, 32, 128), 1), ((16, 16, 256), 2), ((8, 8, 1024), 32),
             ((32, 32, 128), 32), ((12, 12, 58), 32), ((48, 160, 64), 2),
             ((48, 160, 64), 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", FWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_forward_cases_on_card(shape, n, dtype, cuda_device):
    """The forward kernel at batch 1, 2 and 32 and on a map taller than
    its band (several bands per image), with s fractional, integer and
    exactly -7 and 8; 1e-4 f32, 3e-2 bf16."""
    x, s, w = deform_case(shape, seed=12, n=n)
    if shape == (48, 160, 64):
        assert DC.fwd_plan(n, *shape, dtype)["bands"] > 1
    _fwd_check(torch.from_numpy(x).to(cuda_device, dtype),
               torch.from_numpy(_mixed_s(s, 13)).to(cuda_device),
               torch.from_numpy(w).to(cuda_device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset,vec", [
    (torch.float32, 1, 1), (torch.float32, 2, 2), (torch.bfloat16, 1, 1),
    (torch.bfloat16, 2, 2), (torch.bfloat16, 4, 4)])
def test_kernel_forward_misaligned_x_on_card(dtype, offset, vec,
                                             cuda_device):
    """x a view `offset` elements into its buffer (4 or 8 bytes past a
    16-byte boundary, or 2): the plan narrows the kernel's vectors to what
    the address allows, and the output agrees with the plain version."""
    shape = (16, 16, 256)
    x, s, w = deform_case(shape, seed=14)
    buf = torch.zeros(x.size + offset, dtype=dtype, device=cuda_device)
    xt = buf[offset:].view(x.shape)
    xt.copy_(torch.from_numpy(x))
    assert DC.fwd_plan(2, *shape, dtype,
                       align=DC._alignment(xt))["vec"] == vec
    _fwd_check(xt, torch.from_numpy(_mixed_s(s, 15)).to(cuda_device),
               torch.from_numpy(w).to(cuda_device, dtype))


@pytest.mark.cuda
def test_kernel_forward_permuted_weight_on_card(cuda_device):
    """The deform block's weight view (OIHW permuted to HWIO, strides
    (1, 9) over (tap, channel)) gives exactly the output of the same
    weight made contiguous."""
    x, s, w = deform_case((32, 32, 128), seed=16)
    xt = torch.from_numpy(x).to(cuda_device)
    st = torch.from_numpy(s).to(cuda_device)
    oihw = torch.from_numpy(w).to(cuda_device).permute(3, 2, 0, 1) \
        .contiguous()
    view = oihw.permute(2, 3, 1, 0)
    assert not view.is_contiguous()
    a = DC.codesign_deform_conv_fast(xt, st, view)
    b = DC.codesign_deform_conv_fast(xt, st, view.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_forward_refuses_a_bad_plan(cuda_device, monkeypatch):
    """The C side checks the plan against its layout: shared bytes that do
    not match, or a slice that is no multiple of the vector, make the
    wrapper raise, and nothing is counted."""
    x, s, w = (torch.from_numpy(a).to(cuda_device)
               for a in deform_case((8, 8, 64), seed=17))
    good = DC.fwd_plan(2, 8, 8, 64, torch.float32)
    for bad in (dict(good, smem_bytes=good["smem_bytes"] + 16),
                dict(good, cb=2), dict(good, threads=good["threads"] + 16)):
        monkeypatch.setattr(DC, "fwd_plan", lambda *a, bad=bad, **k: bad)
        before = DC.LAUNCHES
        with pytest.raises(RuntimeError):
            DC.codesign_deform_conv_fast(x, s, w)
        assert DC.LAUNCHES == before


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
