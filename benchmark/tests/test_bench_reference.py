"""The plain reference agrees with the program at a tiny size on the CPU:
the deform op and its gradient, every architecture module's state and
its forward in eval and train mode, ShuffleNetV2's quantized, and the
letterbox geometry."""

import numpy as np
import pytest
import torch

from benchmark.harness import compare, weights
from benchmark.reference import arch, geometry, ops

from . import tiny

QUANT = {"w_bit": 4, "a_bit": 8, "wt_percentile": True, "act_clamp": True}
# every architecture module present: the benchmark's and the fixture's
FAMILIES = sorted({p.stem for p in (tiny.BENCH / "reference" / "arch")
                   .glob("*.py") if p.stem != "__init__"}
                  | {p.stem for p in tiny.fixture_archs()})
SHUFFLENET = arch.load("shufflenetv2")
CFG = dict(tiny.configs()["tiny_a"], input_hw=[64, 64])


@pytest.fixture(scope="module")
def archs(tmp_path_factory):
    return tiny.arch_configs(tiny.make(tmp_path_factory.mktemp("bench")))


def _state(mod=SHUFFLENET, cfg=CFG, quant=False, seed=3):
    params, buffers = weights.make(mod, cfg, seed, "cpu", quant)
    frames = torch.randint(0, 256, (4, 60, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(seed))
    buffers = weights.calibrated(mod, cfg, params, buffers, frames,
                                 np.array([[60, 64]] * 4),
                                 QUANT if quant else None)
    return params, buffers


def _program(quant, params, buffers, mod=SHUFFLENET, cfg=CFG):
    """The program's model of the configuration, as its CLIs build it."""
    from codenet_torch import config as C
    from codenet_torch.models import create_model
    from codenet_torch.models.layers import QuantSpec
    opt = C.parse(["ctdet", "--arch", cfg["arch"], "--head_conv",
                   str(cfg["head_conv"]), *mod.program_args(cfg)])
    model = create_model(opt.arch, cfg["heads"], opt.head_conv, w2=opt.w2,
                         maxpool=opt.maxpool,
                         qspec=QuantSpec(**quant) if quant else None,
                         device="cpu")
    compare.load_state(model, weights.state_dict(params, buffers))
    return model


def test_every_architecture_module_has_a_tiny_configuration(archs):
    assert sorted(archs) == FAMILIES


@pytest.mark.parametrize("family,quant", [(f, False) for f in FAMILIES]
                         + [("shufflenetv2", True)])
def test_state_names_and_shapes_are_the_programs(archs, family, quant):
    mod, cfg = archs[family]
    model = _program(QUANT if quant else None,
                     *_state(mod, cfg, quant), mod, cfg)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == mod.state_shapes(cfg, quant)


def test_deform_op_and_gradient():
    from codenet_torch.ops.deform_cuda import codesign_deform_conv_fast
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 7, 5, 6, generator=g, requires_grad=True)
    s = (torch.rand(2, 1, 5, 6, generator=g) * 6 - 2).requires_grad_()
    w = torch.randn(7, 1, 3, 3, generator=g, requires_grad=True)
    ref = ops.deform(x, s, w)
    prog = codesign_deform_conv_fast(
        x.permute(0, 2, 3, 1), s.permute(0, 2, 3, 1),
        w.permute(2, 3, 1, 0)).permute(0, 3, 1, 2)
    torch.testing.assert_close(prog, ref, rtol=1e-5, atol=1e-5)
    cot = torch.randn(ref.shape, generator=g)
    a = torch.autograd.grad(ref, (x, s, w), cot)
    b = torch.autograd.grad(prog, (x, s, w), cot)
    for u, v in zip(a, b):
        torch.testing.assert_close(v, u, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("train", [False, True])
def test_fp32_forward(archs, family, train):
    mod, cfg = archs[family]
    params, buffers = _state(mod, cfg)
    model = _program(None, params, buffers, mod, cfg).train(train)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        prog = model(x)
        ref = mod.Net(cfg).forward(x.permute(0, 3, 1, 2).contiguous(),
                                   params, dict(buffers), train=train)
    assert set(prog) == set(ref)
    for k in ref:
        torch.testing.assert_close(prog[k].permute(0, 3, 1, 2), ref[k],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("a_bit", [8, 16])
def test_quantized_forward_and_ranges(a_bit):
    """Fake-quant: the first quantizer's updated range to rounding; the
    heads within 1e-3 of L2 with 16-bit activations, where a rounding flip
    moves an activation by 1/65535 of its range (at 8 bits a flip moves it by
    1/255, and the flips that f32 rounding sets off spread through every
    later quantizer: only the range is compared)."""
    quant = dict(QUANT, a_bit=a_bit)
    params, buffers = _state(quant=True)
    model = _program(quant, params, buffers)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    ref_buffers = dict(buffers)
    with torch.no_grad():
        prog = model(x, update_stats=True)
        ref = SHUFFLENET.Net(CFG, quant=quant).forward(
            x.permute(0, 3, 1, 2).contiguous(), params, ref_buffers,
            update=True)
    state = model.state_dict()
    for k in ("layer0_act.x_min", "layer0_act.x_max"):
        torch.testing.assert_close(state[k], ref_buffers[k], rtol=1e-5,
                                   atol=1e-6)
    for k in ref if a_bit == 16 else ():
        got = prog[k].permute(0, 3, 1, 2)
        assert float((got - ref[k]).norm() / ref[k].norm()) < 1e-3


def test_letterbox_is_the_programs():
    from codenet_torch.data.affine import get_affine_transform
    for h, w in ((375, 500), (500, 333), (61, 80)):
        warp_ti, back = geometry.letterbox(h, w, (512, 512))
        c = np.array([w / 2.0, h / 2.0], np.float32)
        s = max(h, w) * 1.0
        np.testing.assert_allclose(
            warp_ti, get_affine_transform(c, s, 0, [512, 512], inv=1),
            rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(
            back, get_affine_transform(c, s, 0, [128, 128], inv=1),
            rtol=1e-6, atol=1e-4)


def _dense(k, scores=None, h=16, w=16, c=3, seed=0):
    """Dense maps of random scores (or of `scores`, (N, H*W, C)), every
    position's box apart."""
    import torch.nn.functional as F

    from benchmark.reference.serve import Dense, block_peaks, neighbour_max
    if scores is None:
        scores = torch.rand(2, h * w, c, generator=torch.Generator()
                            .manual_seed(seed))
    n = scores.shape[0]
    maps = scores.permute(0, 2, 1).reshape(n, c, h, w)

    def flat(m):
        return m.reshape(n, c, h * w).permute(0, 2, 1)
    corner = torch.arange(h * w).float()[:, None] * 10
    boxes = (corner + torch.tensor([0.0, 0.0, 5.0, 5.0]))[None].expand(
        n, -1, -1)
    dense = Dense(boxes, scores, flat(F.max_pool2d(maps, 3, 1, 1)),
                  torch.zeros(n), (h, w), flat(neighbour_max(maps)))
    kth = torch.stack([torch.topk(block_peaks(dense, i)[0],
                                  k + k // 10).values[-1] for i in range(n)])
    return dense._replace(kth=kth)


def test_served_numbers_hold_the_served_set_both_ways():
    """The reference's own top K reads 0 on every number; fewer than K, a
    repeated peak, and a set that skipped the best peak each read above
    the limit of 0 of the number that catches them."""
    from benchmark.reference.serve import top_detections
    k = 20
    dense = _dense(k)
    top = top_detections(dense, k)
    sound = compare.served_numbers(top, dense, k)
    assert all(v < 1e-6 for v in sound.values()), sound
    half = compare.served_numbers([d[:k // 2] for d in top], dense, k)
    assert half["count_gap"] == k // 2
    repeated = compare.served_numbers([d[:1].expand(k, -1) for d in top],
                                      dense, k)
    assert repeated["duplicates"] == k - 1
    skipped = compare.served_numbers(
        [d[1:] for d in top_detections(dense, k + 1)], dense, k)
    assert skipped["count_gap"] == 0 and skipped["duplicates"] == 0
    assert skipped["select_gap"] == 0 and skipped["miss_gap"] > 1e-3
    empty = compare.served_numbers([d[:0] for d in top], dense, k)
    assert empty["count_gap"] == k and empty["miss_gap"] > 0.5


def test_a_peak_that_rounding_decides_is_not_missed():
    """A reference peak tied with a neighbour (the two a rounding apart
    in a program, which may then keep neither) is not held against a
    served set without it; sure of its neighbours, it is."""
    from benchmark.reference.serve import top_detections
    k = 20

    def at_of(dense, row):
        return int(torch.nonzero((dense.boxes[0] == row[:4]).all(1))[0])
    dense = _dense(k)
    top = top_detections(dense, k + 1)[0]
    j = next(j for j, row in enumerate(top)
             if float(row[4] - dense.rival[0, at_of(dense, row),
                                          int(row[5])]) > compare.TIE)
    at, cls = at_of(dense, top[j]), int(top[j][5])

    def left_out(dense):
        first = top_detections(dense, k + 1)[0]
        keep = [r for r in first if not (at_of(dense, r) == at
                                         and int(r[5]) == cls)]
        return [torch.stack(keep[:k]), top_detections(dense, k)[1]]
    assert compare.served_numbers(left_out(dense), dense,
                                  k)["miss_gap"] > 1e-3
    scores = dense.scores.clone()
    y, x = divmod(at, 16)
    nx = x + 1 if x < 15 else x - 1
    scores[0, y * 16 + nx, cls] = scores[0, at, cls]
    tied = _dense(k, scores)
    assert compare.served_numbers(left_out(tied), tied, k)["miss_gap"] == 0
