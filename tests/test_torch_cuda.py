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

from test_torch_common import (HEADS, calibrate_bn,  # noqa: F401
                               cuda_device, deform_case)

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
# whose bands clip at row 0 and at row H - 1; the 2x network's deconv0
# map (configs d and e at 512^2: 2153 channels, a multiple of neither 4
# nor 8) at the train batch
FWD_CASES = [((32, 32, 128), 1), ((16, 16, 256), 2), ((8, 8, 1024), 32),
             ((32, 32, 128), 32), ((12, 12, 58), 32), ((48, 160, 64), 2),
             ((48, 160, 64), 32), ((16, 16, 2153), 32)]


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
# the deform backbone's stride-1 maps (channels no multiple of 16)
BACKBONE_SHAPES = [(32, 32, 58), (16, 16, 116), (8, 8, 232)]
BWD_CASES = [(shape, 2) for shape in SHAPES] + [((48, 160, 64), 2),
                                                ((16, 16, 256), 1)] \
    + [(shape, 32) for shape in BACKBONE_SHAPES] \
    + [(shape, 32) for shape in SHAPES[:3]]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BACKBONE_SHAPES)
@pytest.mark.parametrize("n", [2, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_forward_backbone_shapes_on_card(shape, n, dtype,
                                                cuda_device):
    """The forward kernel at the deform backbone's maps, at the served and
    trained batches, s fractional, integer and exactly -7 and 8 (58
    channels take 8-byte f32 and 4-byte bf16 vectors)."""
    x, s, w = deform_case(shape, seed=30, n=n)
    _fwd_check(torch.from_numpy(x).to(cuda_device, dtype),
               torch.from_numpy(_mixed_s(s, 31)).to(cuda_device),
               torch.from_numpy(w).to(cuda_device, dtype))


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


# the three deform maps of --keep_res requests: a 500x375 frame at scales
# 0.5 and 1.5, a 375x500 one at 1.5 (non-square, several bands per image)
KEEP_RES_SHAPES = [(6, 8, 1024), (18, 24, 1024), (36, 48, 256),
                   (72, 96, 128), (96, 72, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KEEP_RES_SHAPES)
def test_kernel_forward_keep_res_shapes_on_card(shape, cuda_device):
    """The forward kernel at --keep_res maps, flip-test batch 2, f32,
    with s fractional, integer and exactly -7 and 8: within 1e-4."""
    x, s, w = deform_case(shape, seed=22)
    _fwd_check(torch.from_numpy(x).to(cuda_device),
               torch.from_numpy(_mixed_s(s, 23)).to(cuda_device),
               torch.from_numpy(w).to(cuda_device))


# -- device warp and image cache -------------------------------------------------

def _warp_case():
    """A (4, 90, 120, 3) uint8 stack, five rows of it (one twice) and a
    letterbox or crop affine each, every other one with the flip folded
    in."""
    from codenet_torch.data.affine import get_affine_transform
    from codenet_torch.data.device_cache import flip_compose
    r = np.random.RandomState(20)
    stack = r.randint(0, 256, (4, 90, 120, 3)).astype(np.uint8)
    rows = np.array([3, 0, 3, 1, 2])
    tis = []
    for i in range(len(rows)):
        c = np.array([50.0 + 7 * i, 40.0 - 3 * i], np.float32)
        ti = get_affine_transform(c, 100.0 + 13 * i, 0, [64, 48], inv=1)
        tis.append(flip_compose(ti, 120) if i % 2 else ti)
    return stack, rows, np.stack(tis).astype(np.float32)


@pytest.mark.cuda
def test_batched_warp_on_card_matches_cpu(cuda_device):
    """warp_affine_batch on the card (one gather per corner over the
    batch) against the same call on the CPU: within 1e-4 of a level."""
    from codenet_torch.data.affine import warp_affine_batch
    stack, rows, tis = _warp_case()
    cpu = warp_affine_batch(torch.from_numpy(stack), tis, 48, 64, rows=rows)
    card = warp_affine_batch(torch.from_numpy(stack).to(cuda_device),
                             torch.from_numpy(tis).to(cuda_device), 48, 64,
                             rows=torch.from_numpy(rows).to(cuda_device))
    assert card.device.type == "cuda" and card.shape == (5, 48, 64, 3)
    assert float((card.cpu() - cpu).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_process_batch_cached_equals_raw_on_card(cuda_device):
    """Three ragged frames served batched on the card, flip-test at 64^2:
    from zero-padded raw frames (process_batch_raw), from rows of a
    device stack (process_batch_cached) and as K = 2 batches in one call
    (process_batches_cached). The warped pixels are the same, so the
    detections agree within rtol 1e-5, atol 1e-4; 3 forward launches per
    batch."""
    from codenet_torch import config as cfg
    from codenet_torch.engine.detector import CtdetDetector
    from codenet_torch.models import create_model
    opt = cfg.update_dataset_info_and_set_heads(
        cfg.parse(["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
                   "--input_res", "64", "--flip_test"]),
        cfg.DATASET_SPECS["pascal"])
    model = create_model("shufflenetv2", HEADS, 64, device="cpu")
    calibrate_bn(model, np.random.RandomState(21).randn(4, 64, 64, 3)
                 .astype(np.float32))
    det = CtdetDetector(opt, state_dict=model.state_dict(),
                        device=cuda_device)
    opt._device_warp_hw = (128, 128)
    r = np.random.RandomState(24)
    frames = [r.randint(0, 256, hw + (3,)).astype(np.uint8)
              for hw in ((90, 120), (120, 90), (64, 100))]
    stack = np.zeros((3, 120, 120, 3), np.uint8)
    for i, f in enumerate(frames):
        stack[i, :f.shape[0], :f.shape[1]] = f
    raw, wti, ti = (np.stack(c) for c in
                    zip(*(det.pre_process_raw(f) for f in frames)))
    cache = torch.from_numpy(stack).to(cuda_device)
    idx = np.arange(3, dtype=np.int32)
    before = DC.LAUNCHES
    a = det.process_batch_raw(raw, wti, ti)
    b = det.process_batch_cached(cache, idx, wti, ti)
    c = det.process_batches_cached(cache, np.stack([idx, idx[::-1]]),
                                   np.stack([wti, wti[::-1]]),
                                   np.stack([ti, ti[::-1]]))
    torch.cuda.synchronize()
    assert DC.LAUNCHES == before + 3 * 4
    assert a.shape == b.shape == (3, 100, 6) and c.shape == (2, 3, 100, 6)
    for got in (b, c[0], c[1].flip(0)):
        torch.testing.assert_close(got, a, rtol=1e-5, atol=1e-4)


# -- real-int8 eval --------------------------------------------------------------

def _int8_model(device):
    """Config a (1x, VOC heads) with int8_infer on `device`, its ranges
    from two fake-quant update passes on a random 256^2 batch."""
    from codenet_torch.models import create_model
    from codenet_torch.models.layers import QuantSpec
    heads = {"hm": 20, "wh": 2, "reg": 2}
    fake = create_model("shufflenetv2", heads, 64, qspec=QuantSpec(),
                        device=device)
    images = torch.randn(2, 256, 256, 3,
                         generator=torch.Generator().manual_seed(18))
    with torch.no_grad():
        for _ in range(2):
            fake(images.to(device), update_stats=True)
    model = create_model("shufflenetv2", heads, 64,
                         qspec=QuantSpec(int8_infer=True), device=device)
    model.load_state_dict(fake.state_dict())
    return model, images


@pytest.mark.cuda
def test_int8_conv_route_bit_exact_on_card(cuda_device, monkeypatch):
    """Every int8 conv of one config-a forward (batch 2, 256^2): the
    card's accumulator and zero-point factor equal the exact f64 ones of
    the same integers, and the requantized output equals the CPU's bit
    for bit."""
    from codenet_torch.ops import quant as Q
    model, images = _int8_model(cuda_device)
    calls = []
    conv = Q.int8_conv

    def record(qx, q_w, w_scale, bias, *args):
        calls.append((qx, q_w, w_scale, bias, args))
        return conv(qx, q_w, w_scale, bias, *args)
    monkeypatch.setattr(Q, "int8_conv", record)
    with torch.no_grad():
        model(images.to(cuda_device))
    assert len(calls) == 73 - 3  # every int8 conv; the deform kernels aside
    for qx, q_w, w_scale, bias, args in calls:
        acc, wsum = Q.int8_conv_terms(qx.values, q_w, *args)
        ref_acc, ref_wsum = Q.int8_conv_terms(qx.values.cpu().double(),
                                              q_w.cpu().double(), *args)
        assert torch.equal(acc.cpu().double(), ref_acc), q_w.shape
        assert torch.equal(wsum.cpu().double(), ref_wsum), q_w.shape
        cpu = conv(Q.QTensor(*(t.cpu() for t in qx)), q_w.cpu(),
                   w_scale.cpu(), None if bias is None else bias.cpu(),
                   *args)
        assert torch.equal(conv(qx, q_w, w_scale, bias, *args).cpu(), cpu)


@pytest.mark.cuda
def test_int8_deform_block_launches_bf16_kernel(cuda_device, monkeypatch):
    """deconv0's block in int8 (8x8x1024 -> 256, batch 2) on a QTensor:
    one forward-kernel launch, in bf16 with the bf16 weight; its samples
    agree with the plain version's on the CPU within 3e-2 (one bf16
    rounding) and the block's output within 1e-2 relative L2 (a sample
    that rounds the other way moves one level of deform_act)."""
    from codenet_torch.models.layers import CodesignDeformBlock, QuantSpec
    from codenet_torch.ops import deform_cuda as DC
    from codenet_torch.ops import quant as Q
    gen = torch.Generator().manual_seed(19)
    block = CodesignDeformBlock(1024, 256, qspec=QuantSpec(int8_infer=True))
    block.reset_parameters(gen)
    bn = torch.nn.BatchNorm2d(256).eval()
    with torch.no_grad():
        block.conv_scale.weight.normal_(0.0, 3.0 / 32, generator=gen)
        block.conv_scale.bias.fill_(0.5)
        block.scale_act.x_min.fill_(-7.0)
        block.scale_act.x_max.fill_(8.0)
        block.deform_act.x_min.fill_(-0.5)
        block.deform_act.x_max.fill_(0.5)
    values = torch.randint(-128, 128, (2, 1024, 8, 8), generator=gen,
                           dtype=torch.int8)
    qx = Q.QTensor(values.contiguous(memory_format=torch.channels_last),
                   torch.tensor([40.0]), torch.tensor([3.0]))
    samples = {}
    fast = DC.codesign_deform_conv_fast
    launch = DC._launch
    dtypes = []

    def record(x, s, w):
        dtypes.append((x.dtype, w.dtype))
        return launch(x, s, w)

    def deform(x, s, w):
        y = fast(x, s, w)
        samples[x.device.type] = (x, s, w, y)
        return y
    monkeypatch.setattr(DC, "_launch", record)
    import codenet_torch.models.layers as L
    monkeypatch.setattr(L, "codesign_deform_conv_fast", deform)
    with torch.no_grad():
        cpu = block(qx, bn)
        block.to(cuda_device)
        bn.to(cuda_device)
        before = DC.LAUNCHES
        card = block(Q.QTensor(*(t.to(cuda_device) for t in qx)), bn)
        torch.cuda.synchronize()
    assert DC.LAUNCHES == before + 1
    assert dtypes == [(torch.bfloat16, torch.bfloat16)]
    x, s, w, y = samples["cuda"]
    ref = DC.codesign_deform_conv_plain(x.cpu(), s.cpu(), w.cpu())
    assert float((y.cpu().float() - ref.float()).abs().max()) <= 3e-2
    assert torch.equal(x.cpu(), samples["cpu"][0])
    err = float((card.cpu() - cpu).norm() / cpu.norm())
    assert err <= 1e-2, err


# -- bf16 conv operands and the deform backbone ----------------------------

@pytest.mark.cuda
def test_bf16_detector_request_on_card(cuda_device):
    """One flip-test request with --dtype bfloat16 at 64^2: the forward
    kernel launches in bf16 three times, and the heads agree with the
    CPU port's bf16 heads within 3e-2 of each head's max."""
    from codenet_torch import config as cfg
    from codenet_torch.engine.detector import CtdetDetector, eval_input
    from codenet_torch.models import create_model
    opt = cfg.update_dataset_info_and_set_heads(
        cfg.parse(["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
                   "--input_res", "64", "--flip_test", "--dtype",
                   "bfloat16"]), cfg.DATASET_SPECS["pascal"])
    model = create_model("shufflenetv2", HEADS, 64, device="cpu")
    calibrate_bn(model, np.random.RandomState(32).randn(4, 64, 64, 3)
                 .astype(np.float32))
    card = CtdetDetector(opt, state_dict=model.state_dict(),
                         device=cuda_device)
    cpu = CtdetDetector(opt, state_dict=model.state_dict(), device="cpu")
    frame = np.random.RandomState(33).randint(0, 256, (90, 120, 3)) \
        .astype(np.uint8)
    dtypes = []
    launch = DC._launch

    def record(x, s, w):
        dtypes.append(x.dtype)
        return launch(x, s, w)
    DC._launch = record
    try:
        ret = card.run(frame)
    finally:
        DC._launch = launch
    assert dtypes == [torch.bfloat16] * 3
    dets = np.concatenate(list(ret["results"].values()))
    assert 0 < len(dets) <= 100 and np.isfinite(dets).all()
    images, _ = card.pre_process(frame, 1)
    x = eval_input(torch.from_numpy(images), card.mean, card.std)
    with torch.no_grad():
        got = card.model(x.to(cuda_device))
        ref = cpu.model(x)
    for name in ref:
        scale = float(ref[name].abs().max())
        err = float((got[name].cpu() - ref[name]).abs().max())
        assert err <= 3e-2 * scale, (name, err, scale)


@pytest.mark.cuda
def test_deform_backbone_step_on_card(cuda_device):
    """A deform-backbone model (64^2, batch 2, train-mode BN) forward and
    backward on the card: 16 forward and 16 backward launches (13
    backbone blocks, 3 deconv), f32 and with bf16 conv operands, finite
    gradients for every parameter."""
    from codenet_torch.models import create_model
    for dtype in (None, "bfloat16"):
        model = create_model("shufflenetv2", HEADS, 64, dtype=dtype,
                             deform_backbone=True, device=cuda_device)
        model.train()
        x = torch.randn(2, 64, 64, 3,
                        generator=torch.Generator().manual_seed(34))
        before = (DC.LAUNCHES, DC.BWD_LAUNCHES)
        out = model(x.to(cuda_device))
        sum(v.sum() for v in out.values()).backward()
        torch.cuda.synchronize()
        assert (DC.LAUNCHES - before[0], DC.BWD_LAUNCHES - before[1]) == \
            (16, 16)
        for name, p in model.named_parameters():
            assert torch.isfinite(p.grad).all(), name


# -- the COCO family at 512^2 ------------------------------------------------

# the deconv stage's three stride-1 deform maps at 512^2 input, 1x
COCO_SHAPES = [(16, 16, 1024), (32, 32, 256), (64, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", COCO_SHAPES)
@pytest.mark.parametrize("n", [2, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_forward_512_maps_on_card(shape, n, dtype, cuda_device):
    """The forward kernel at the 512^2 maps, at the served (flip-test) and
    trained batches; s fractional, integer and exactly -7 and 8."""
    x, s, w = deform_case(shape, seed=40, n=n)
    _fwd_check(torch.from_numpy(x).to(cuda_device, dtype),
               torch.from_numpy(_mixed_s(s, 41)).to(cuda_device),
               torch.from_numpy(w).to(cuda_device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", COCO_SHAPES)
def test_kernel_backward_512_maps_on_card(shape, cuda_device):
    """The backward kernel (one launch) at the 512^2 maps, batch 32, f32:
    dx, ds and dw within 1e-4 of each output's max of the plain backward,
    ds exactly 0 where s sits on a clamp bound."""
    x, s, w = deform_case(shape, seed=42, n=32)
    s = _mixed_s(s, 43)
    g = np.random.RandomState(44).randn(*x.shape).astype(np.float32)
    xt, st, wt, gt = (torch.from_numpy(a).to(cuda_device)
                      for a in (x, s, w, g))
    before = DC.BWD_LAUNCHES
    got = DC.codesign_deform_conv_bwd(xt, st, wt, gt)
    torch.cuda.synchronize()
    assert DC.BWD_LAUNCHES == before + 1
    refs = DC.codesign_deform_conv_bwd_plain(xt, st, wt, gt)
    for name, a, b in zip(("dx", "ds", "dw"), got, refs):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale, name
    bounds = (st == -7.0) | (st == 8.0)
    assert float(got[1][bounds].abs().max()) == 0.0


@pytest.mark.cuda
def test_multi_pose_decode_on_card_matches_cpu(cuda_device):
    """multi_pose_decode of seeded heads at the 512^2 output map (128^2,
    batch 2, K 100, hm_hp, hp_offset and reg): the card's detections equal
    the CPU's within 1e-5 (no ties among the selected peaks)."""
    from codenet_torch.models.decode import multi_pose_decode
    r = np.random.RandomState(45)
    shape = (2, 128, 128)
    heads = {"heat": r.rand(*shape, 1), "wh": r.uniform(2, 40, shape + (2,)),
             "kps": r.randn(*shape, 34) * 8, "reg": r.rand(*shape, 2),
             "hm_hp": r.rand(*shape, 17) ** 3,
             "hp_offset": r.rand(*shape, 2)}
    heads = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in heads.items()}
    ref = multi_pose_decode(**heads, k=100)
    got = multi_pose_decode(**{k: v.to(cuda_device)
                               for k, v in heads.items()}, k=100)
    assert got.device.type == "cuda" and got.shape == (2, 100, 40)
    assert float((got.cpu() - ref).abs().max()) <= 1e-5


# -- ddd on KITTI (384x1280) and exdet ------------------------------------------

# the deconv stage's three stride-1 deform maps at KITTI's 384x1280, 1x
KITTI_SHAPES = [(12, 40, 1024), (24, 80, 256), (48, 160, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KITTI_SHAPES)
@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_forward_kitti_maps_on_card(shape, n, dtype, cuda_device):
    """The forward kernel at KITTI's maps, at the served batch (1: ddd has
    no flip test) and the trained one (16)."""
    x, s, w = deform_case(shape, seed=50, n=n)
    _fwd_check(torch.from_numpy(x).to(cuda_device, dtype),
               torch.from_numpy(_mixed_s(s, 51)).to(cuda_device),
               torch.from_numpy(w).to(cuda_device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KITTI_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backward_kitti_maps_on_card(shape, dtype, cuda_device):
    """The backward kernel (one launch) at KITTI's maps, batch 16: dx, ds
    and dw within 1e-4 (f32) or 3e-2 (bf16) of each output's max of the
    plain backward, ds exactly 0 where s sits on a clamp bound."""
    x, s, w = deform_case(shape, seed=52, n=16)
    s = _mixed_s(s, 53)
    g = np.random.RandomState(54).randn(*x.shape).astype(np.float32)
    xt, wt, gt = (torch.from_numpy(a).to(cuda_device, dtype)
                  for a in (x, w, g))
    st = torch.from_numpy(s).to(cuda_device)
    before = DC.BWD_LAUNCHES
    got = DC.codesign_deform_conv_bwd(xt, st, wt, gt)
    torch.cuda.synchronize()
    assert DC.BWD_LAUNCHES == before + 1
    refs = DC.codesign_deform_conv_bwd_plain(xt, st, wt, gt)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for name, a, b in zip(("dx", "ds", "dw"), got, refs):
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol * scale, \
            name
    bounds = (st == -7.0) | (st == 8.0)
    assert float(got[1][bounds].abs().max()) == 0.0


def _distinct(r, shape):
    """Values in [0, 1) that are all distinct in f32 (a shuffled ramp), so
    that no two peaks tie and every top-k selects and orders alike."""
    count = int(np.prod(shape))
    return (r.permutation(count) / count).reshape(shape)


@pytest.mark.cuda
def test_ddd_decode_on_card_matches_cpu(cuda_device):
    """ddd_decode of seeded heads at KITTI's output map (96x320, batch 1,
    K 100, wh and reg): the card's rows equal the CPU's within 1e-5 (the
    heatmap's values distinct: no ties among the peaks)."""
    from codenet_torch.models.decode import ddd_decode
    r = np.random.RandomState(55)
    shape = (1, 96, 320)
    heads = {"heat": _distinct(r, shape + (3,)), "rot": r.randn(*shape, 8),
             "depth": r.uniform(1, 60, shape + (1,)),
             "dim": r.uniform(0.5, 4, shape + (3,)),
             "wh": r.uniform(2, 60, shape + (2,)), "reg": r.rand(*shape, 2)}
    heads = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in heads.items()}
    ref = ddd_decode(**heads, k=100)
    got = ddd_decode(**{k: v.to(cuda_device) for k, v in heads.items()},
                     k=100)
    assert got.device.type == "cuda" and got.shape == (1, 100, 18)
    assert float((got.cpu() - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("agnostic", [False, True])
def test_exct_decode_on_card_matches_cpu(agnostic, cuda_device):
    """exct_decode of seeded heats at the 512^2 output map (128^2, 80
    classes, a flip-test batch of 2, K 40, offsets; the extreme-point
    heats' values distinct, so that both top-k's pick the same points):
    the 1000 kept scores equal the CPU's within 1e-6, and the rows above
    the last kept score equal as a set (lattice cells tied at the cut may
    be kept either way), within 1e-5."""
    from codenet_torch.models.decode import exct_decode
    r = np.random.RandomState(56 + agnostic)
    num_hm = 1 if agnostic else 80
    heats = [torch.from_numpy(_distinct(r, (2, 128, 128, num_hm)).astype(
        np.float32)) for _ in range(4)]
    heats.append(torch.from_numpy(r.rand(2, 128, 128, 80).astype(
        np.float32)))
    regrs = [torch.from_numpy(r.rand(2, 128, 128, 2).astype(np.float32))
             for _ in range(4)]
    ref = exct_decode(*heats, *regrs, k=40, agnostic=agnostic)
    got = exct_decode(*(h.to(cuda_device) for h in heats),
                      *(g.to(cuda_device) for g in regrs), k=40,
                      agnostic=agnostic).cpu()
    assert got.shape == (2, 1000, 14)
    assert float((got[..., 4] - ref[..., 4]).abs().max()) <= 1e-6
    for i in range(2):
        cut = float(ref[i, -1, 4])
        a = got[i][got[i, :, 4] > cut].numpy()
        b = ref[i][ref[i, :, 4] > cut].numpy()
        assert len(a) == len(b) > 0
        a, b = a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])]
        assert np.abs(a - b).max() <= 1e-5
    if agnostic:
        assert bool((ref[..., 4] > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["ddd", "exdet"])
def test_task_forward_on_card_matches_cpu(task, cuda_device):
    """A ddd (3 classes, six heads, 96x320) and an exdet (nine heads, 80
    classes, 128^2) model forward, batch 2: 3 forward launches on the
    card, every head within 1e-3 of its max of the CPU's forward."""
    from codenet_torch.models import create_model
    if task == "ddd":
        heads, hw = {"hm": 3, "dep": 1, "rot": 8, "dim": 3, "wh": 2,
                     "reg": 2}, (96, 320)
    else:
        heads = {"hm_" + p: 80 for p in "tlbrc"}
        heads.update({"reg_" + p: 2 for p in "tlbr"})
        hw = (128, 128)
    gen = torch.Generator().manual_seed(57)
    cpu = create_model("shufflenetv2", heads, 64, device="cpu",
                       generator=gen)
    x = torch.randn(2, *hw, 3, generator=gen)
    calibrate_bn(cpu, x.numpy())
    card = create_model("shufflenetv2", heads, 64, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    card.eval()
    before = DC.LAUNCHES
    with torch.no_grad():
        got = card(x.to(cuda_device))
        torch.cuda.synchronize()
        ref = cpu(x)
    assert DC.LAUNCHES == before + 3
    assert set(got) == set(heads)
    for name in ref:
        scale = float(ref[name].abs().max())
        err = float((got[name].cpu() - ref[name]).abs().max())
        assert err <= 1e-3 * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("groups,dg,masked", [(1, 1, True), (2, 2, True),
                                              (1, 2, False)])
def test_deform_conv2d_on_card_matches_cpu(groups, dg, masked, cuda_device):
    """The general deformable conv (plain PyTorch, no kernel of ours) on
    the card against the CPU, forward and gradients of x, offset, weight
    and mask, 1e-4 of each one's max; it launches no deform kernel."""
    from codenet_torch.ops.deform_conv import deform_conv2d
    r = np.random.RandomState(60 + groups + dg)
    ins = [r.randn(2, 16, 16, 32), r.uniform(-3, 3, (2, 16, 16, dg * 18)),
           r.randn(3, 3, 32 // groups, 24) * 0.1]
    if masked:
        ins.append(r.rand(2, 16, 16, dg * 9))
    cot = torch.from_numpy(r.randn(2, 16, 16, 24).astype(np.float32))
    res = []
    before = (DC.LAUNCHES, DC.BWD_LAUNCHES)
    for dev in (cuda_device, "cpu"):
        t = [torch.from_numpy(a.astype(np.float32)).to(dev).requires_grad_()
             for a in ins]
        y = deform_conv2d(t[0], t[1], t[2], groups=groups,
                          deformable_groups=dg,
                          mask=t[3] if masked else None)
        (y * cot.to(dev)).sum().backward()
        res.append([y.detach().cpu()] + [a.grad.cpu() for a in t])
    assert (DC.LAUNCHES, DC.BWD_LAUNCHES) == before
    for got, ref in zip(*res):
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["res_18", "resdcn_18", "dlav0_34",
                                  "dla_34", "hourglass"])
def test_arch_heads_on_card_match_cpu(arch, cuda_device):
    """Each other backbone (COCO's 80 classes) at 128^2, batch 2: every
    head (both hourglass stacks) within 2e-3 of its max of the CPU's
    forward from the same weights (BN calibrated, DCNv2 offsets of about
    a pixel), and no deform kernel launched."""
    from test_torch_common import randomize_dcn_offsets
    from codenet_torch.models import create_model
    heads = {"hm": 80, "wh": 2, "reg": 2}
    head_conv = 256 if "dla" in arch else 64
    gen = torch.Generator().manual_seed(61)
    cpu = create_model(arch, heads, head_conv, device="cpu", generator=gen)
    randomize_dcn_offsets(cpu, 62)
    x = torch.randn(2, 128, 128, 3, generator=gen)
    calibrate_bn(cpu, x.numpy())
    card = create_model(arch, heads, head_conv, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    card.eval()
    before = (DC.LAUNCHES, DC.BWD_LAUNCHES)
    with torch.no_grad():
        got = card(x.to(cuda_device))
        torch.cuda.synchronize()
        ref = cpu(x)
    assert (DC.LAUNCHES, DC.BWD_LAUNCHES) == before
    got = got if isinstance(got, list) else [got]
    ref = ref if isinstance(ref, list) else [ref]
    assert len(got) == len(ref) == (2 if arch == "hourglass" else 1)
    for g, r in zip(got, ref):
        for name in r:
            scale = float(r[name].abs().max())
            err = float((g[name].cpu() - r[name]).abs().max())
            assert err <= 2e-3 * scale, (arch, name, err, scale)


# -- the synthetic regression's 128^2 maps ---------------------------------------

# the deconv stage's three stride-1 deform maps at 128^2, 1x: on the 4x4
# map most taps at s up to 8 fall off the image, and the map is shorter
# than some of fwd_plan's row bands
SYNTH_SHAPES = [(4, 4, 1024), (8, 8, 256), (16, 16, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SYNTH_SHAPES)
@pytest.mark.parametrize("n", [2, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_forward_128_maps_on_card(shape, n, dtype, cuda_device):
    """The forward kernel at the 128^2 maps, at the flip-test eval's batch
    (2) and the regression's train batch (16)."""
    x, s, w = deform_case(shape, seed=60, n=n)
    _fwd_check(torch.from_numpy(x).to(cuda_device, dtype),
               torch.from_numpy(_mixed_s(s, 61)).to(cuda_device),
               torch.from_numpy(w).to(cuda_device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SYNTH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backward_128_maps_on_card(shape, dtype, cuda_device):
    """The backward kernel (one launch) at the 128^2 maps, batch 16: dx,
    ds and dw within 1e-4 (f32) or 3e-2 (bf16) of each output's max of
    the plain backward, ds exactly 0 where s sits on a clamp bound."""
    x, s, w = deform_case(shape, seed=62, n=16)
    s = _mixed_s(s, 63)
    g = np.random.RandomState(64).randn(*x.shape).astype(np.float32)
    xt, wt, gt = (torch.from_numpy(a).to(cuda_device, dtype)
                  for a in (x, w, g))
    st = torch.from_numpy(s).to(cuda_device)
    before = DC.BWD_LAUNCHES
    got = DC.codesign_deform_conv_bwd(xt, st, wt, gt)
    torch.cuda.synchronize()
    assert DC.BWD_LAUNCHES == before + 1
    refs = DC.codesign_deform_conv_bwd_plain(xt, st, wt, gt)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for name, a, b in zip(("dx", "ds", "dw"), got, refs):
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol * scale, \
            name
    bounds = (st == -7.0) | (st == 8.0)
    assert float(got[1][bounds].abs().max()) == 0.0


# -- data parallelism on the card (codenet_torch/parallel/) -----------------

def _ranks(fn, devices, backend, tmp_path):
    from codenet_torch.parallel import launch
    launch(fn, devices, backend=backend, args=(str(tmp_path),))
    return [torch.load(tmp_path / "rank{}.pt".format(k))
            for k in range(len(devices))]


@pytest.mark.cuda
def test_synced_bn_two_gloo_ranks_share_a_card(cuda_device, tmp_path):
    """Two gloo ranks on cuda:0, each on its half of the batch, against
    plain BatchNorm2d on the concatenated batch there: output and dx of
    the rows, the summed weight and bias gradients and the running
    statistics (bit-equal on both ranks), f32 within 1e-5 of each max."""
    import torch_parallel_worker as W
    ranks = _ranks(W.card_bn_rank, ["cuda:0", "cuda:0"], "gloo", tmp_path)
    x, g = W.bn_case()
    m = torch.nn.BatchNorm2d(x.shape[1]).to(cuda_device)
    xt = torch.from_numpy(x).float().to(cuda_device).requires_grad_()
    y = m(xt)
    (y * torch.from_numpy(g).float().to(cuda_device)).sum().backward()
    ref = {"y": y, "dx": xt.grad, "dweight": m.weight.grad,
           "dbias": m.bias.grad, "running_mean": m.running_mean,
           "running_var": m.running_var}
    for k, v in ref.items():
        v = v.detach().cpu()
        if k in ("y", "dx"):
            got = torch.cat([r[k] for r in ranks])
        elif k.startswith("running"):
            assert torch.equal(ranks[0][k], ranks[1][k]), k
            got = ranks[0][k]
        else:
            got = ranks[0][k] + ranks[1][k]
        err = float((got - v).abs().max())
        assert err <= 1e-5 * float(v.abs().max()), (k, err)


@pytest.mark.cuda
def test_cache_shard_on_card(cuda_device):
    """to_device(shard=True) puts each rank's rows on the card (the tail
    shard zero-padded)."""
    from codenet_torch.data.device_cache import ImageCache
    from codenet_torch.parallel import DataParallel
    images = np.random.RandomState(4).randint(
        0, 256, (7, 5, 6, 3)).astype(np.uint8)
    for rank, (lo, hi) in enumerate([(0, 4), (4, 7)]):
        cache = ImageCache(images.copy(), np.full((7, 2), 5, np.int32))
        rows = cache.to_device(cuda_device, shard=True, dp=DataParallel(
            rank, 2, cuda_device, "gloo"))
        assert rows.is_cuda and rows.shape == (4, 5, 6, 3)
        assert cache.shard_rows == 4 and cache.shard_ranges == [(0, 4),
                                                                (4, 7)]
        want = np.zeros((4, 5, 6, 3), np.uint8)
        want[:hi - lo] = images[lo:hi]
        np.testing.assert_array_equal(rows.cpu().numpy(), want)


@pytest.mark.cuda
def test_kernels_launch_on_each_ranks_card(cuda_device, tmp_path):
    """One NCCL rank per visible card: both deform kernels launch on
    cuda:LOCAL_RANK (one forward and one backward launch, counted in the
    rank's process) and agree with their plain versions there (f32:
    1e-4 of each output's max)."""
    import torch_parallel_worker as W
    n = torch.cuda.device_count()
    ranks = _ranks(W.card_kernel_rank, ["cuda:{}".format(k)
                                        for k in range(n)], None, tmp_path)
    for k, r in enumerate(ranks):
        assert r["device"] == "cuda:{}".format(k)
        assert r["launches"] == [1, 1]
        assert max(r["rel_errs"]) <= 1e-4, r["rel_errs"]
