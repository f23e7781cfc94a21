"""The large hourglass (`models/hourglass.py`, two stacks) of the port
against the JAX package, on the CPU.

- `Residual` (stride 2 with its projected skip, and stride 1) and a small
  `KpModule` (n=2, dims (8, 8, 16)) eval forwards, 2e-3 of the output's
  max;
- the whole network at 128^2 (its smallest input: five stride-2 levels
  below the stride-4 stem), both stacks' heads within 2e-3 of each
  head's max, the weights carried by the JAX package's own converter
  (engine/torch_import.py::convert_hourglass);
- the weights' round trip port state_dict -> convert_hourglass ->
  `from_jax_variables` exact, `to_jax_variables` equal to the converter,
  a JAX `.ckpt` loaded exactly;
- the two-stack ctdet loss against the JAX one (each stack's parts
  averaged): loss parts and gradients 1e-5;
- the train and val steps hand a two-stack model's list to the loss, and
  the detector serves its last stack.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from test_torch_common import (HEADS, assert_heads_close, calibrate_bn,
                               flax_vars, nchw_to_nhwc, nhwc_to_nchw,
                               perturb_bns, qat_batch, rng, to_np)

from codenet_tpu.engine import torch_import as TI
from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.models import hourglass as JH
from codenet_tpu.models import losses as JL
from codenet_torch import config as tcfg
from codenet_torch.data.device_aug import model_input, resolve_targets
from codenet_torch.engine import checkpoint
from codenet_torch.engine import detector as TDET
from codenet_torch.engine import trainer as TT
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)
from codenet_torch.models import create_model
from codenet_torch.models import hourglass as TH
from codenet_torch.models import losses as TL


def _residual_vars(res):
    mods = {"Conv_0": res.conv1, "bn1": res.bn1, "Conv_1": res.conv2,
            "bn2": res.bn2}
    if res.skip is not None:
        mods.update(skip_conv=res.skip[0], skip_bn=res.skip[1])
    return mods


def _chain_vars(seq):
    return {"res{}".format(j): _residual_vars(r) for j, r in enumerate(seq)}


def _kp_vars(kp):
    low2 = _kp_vars(kp.low2) if isinstance(kp.low2, TH.KpModule) \
        else _chain_vars(kp.low2)
    return {"up1": _chain_vars(kp.up1), "low1": _chain_vars(kp.low1),
            "low2": low2, "low3": _chain_vars(kp.low3)}


def _nhwc(module, x):
    with torch.no_grad():
        return nchw_to_nhwc(to_np(module(torch.from_numpy(nhwc_to_nchw(x)))))


@pytest.mark.parametrize("stride,cin", [(2, 6), (1, 8)])
def test_residual_matches_jax(stride, cin):
    torch.manual_seed(1)
    res = TH.Residual(cin, 8, stride).eval()
    perturb_bns(res, 2)
    x = rng(3).randn(2, 8, 8, cin).astype(np.float32)
    ref = JH.Residual(8, stride).apply(flax_vars(_residual_vars(res)),
                                       jnp.asarray(x))
    assert_heads_close({"y": np.asarray(ref)}, {"y": _nhwc(res, x)},
                       rel=2e-3)


def test_kp_module_matches_jax():
    torch.manual_seed(4)
    kp = TH.KpModule(2, (8, 8, 16), (2, 2, 2)).eval()
    perturb_bns(kp, 5)
    x = rng(6).randn(2, 8, 8, 8).astype(np.float32)
    ref = JH.KpModule(2, (8, 8, 16), (2, 2, 2)).apply(
        flax_vars(_kp_vars(kp)), jnp.asarray(x))
    assert_heads_close({"y": np.asarray(ref)}, {"y": _nhwc(kp, x)},
                       rel=2e-3)


@pytest.fixture(scope="module")
def hourglass():
    """The full-width two-stack network, BNs redrawn and calibrated at
    128^2, with its converted JAX variables."""
    model = create_model("hourglass", HEADS, 64, device="cpu",
                         generator=torch.Generator().manual_seed(7))
    perturb_bns(model, 7)
    calibrate_bn(model, rng(7).randn(2, 128, 128, 3).astype(np.float32))
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    return model, sd, TI.convert_hourglass(sd, heads=tuple(sorted(HEADS)))


def test_whole_hourglass_matches_jax(hourglass):
    model, _, variables = hourglass
    x = rng(8).randn(2, 128, 128, 3).astype(np.float32)
    ref = jax_create_model("hourglass", HEADS, 64).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert isinstance(out, list) and len(out) == len(ref) == 2
    for r, o in zip(ref, out):
        assert o["hm"].shape == (2, 32, 32, 20)
        assert_heads_close({k: np.asarray(v) for k, v in r.items()},
                           {k: to_np(v) for k, v in o.items()}, rel=2e-3)


def test_weights_round_trip(hourglass, tmp_path):
    from codenet_tpu.engine.checkpoint import save_model
    model, sd, variables = hourglass
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    ref = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(
        to_jax_variables(model.state_dict()))[0])
    assert set(map(str, ref)) == set(map(str, got))
    for path, v in ref.items():
        np.testing.assert_array_equal(got[path], v)
    path = str(tmp_path / "model_last.ckpt")
    save_model(path, 1, variables)
    fresh = create_model("hourglass", HEADS, 64, device="cpu")
    _, epoch = checkpoint.load_model(path, fresh, strict=True)
    assert epoch == 1
    for k, v in fresh.state_dict().items():
        if k in sd:
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def _loss_opt():
    opt = tcfg.update_dataset_info_and_set_heads(tcfg.parse(
        ["ctdet", "--dataset", "pascal", "--arch", "hourglass",
         "--input_res", "64", "--gpus", "-1"]), tcfg.DATASET_SPECS["pascal"])
    return opt


def test_two_stack_loss_matches_jax():
    opt = _loss_opt()
    assert opt.num_stacks == 2
    r = rng(9)
    outs = [{k: (r.randn(2, 8, 8, c) * (3 if k == "wh" else 1)).astype(
        np.float32) for k, c in HEADS.items()} for _ in range(2)]
    hm = (r.rand(2, 8, 8, 20) * 0.9).astype(np.float32)
    hm[0, 2, 3, 4] = hm[1, 5, 1, 7] = 1.0
    m = 5
    batch = {"hm": hm,
             "reg_mask": (np.arange(m) < 3).astype(np.uint8)[None]
             .repeat(2, 0),
             "ind": r.randint(0, 64, (2, m)).astype(np.int64),
             "wh": r.uniform(1, 9, (2, m, 2)).astype(np.float32),
             "reg": r.rand(2, m, 2).astype(np.float32)}
    lopt = TT.LossOpts(opt)

    def jloss(o):
        return JL.ctdet_loss(o, {k: jnp.asarray(v) for k, v in batch.items()},
                             lopt)

    (ref, rstats), rgrad = jax.value_and_grad(jloss, has_aux=True)(
        [{k: jnp.asarray(v) for k, v in o.items()} for o in outs])
    touts = [{k: torch.from_numpy(v).requires_grad_() for k, v in o.items()}
             for o in outs]
    loss, stats = TL.ctdet_loss(touts, {k: torch.from_numpy(v)
                                        for k, v in batch.items()}, lopt)
    loss.backward()
    assert set(stats) == set(rstats)
    for k in rstats:
        np.testing.assert_allclose(float(torch.as_tensor(stats[k]).detach()),
                                   float(rstats[k]), rtol=1e-5, err_msg=k)
    for s in range(2):
        for k in HEADS:
            np.testing.assert_allclose(to_np(touts[s][k].grad),
                                       np.asarray(rgrad[s][k]), rtol=1e-5,
                                       atol=1e-7, err_msg=(s, k))


class TwoStacks(nn.Module):
    """A stand-in two-stack network at 64^2: one conv per stack and head,
    stride 4, returning a list of head dicts as HourglassNet does."""

    def __init__(self):
        super().__init__()
        self.stacks = nn.ModuleList(nn.ModuleDict({
            k: nn.Conv2d(3, c, 4, 4) for k, c in HEADS.items()})
            for _ in range(2))

    def forward(self, images, update_stats=False):
        x = images.permute(0, 3, 1, 2)
        return [{k: conv(x).permute(0, 2, 3, 1) for k, conv in s.items()}
                for s in self.stacks]


def test_steps_and_detector_read_the_stacks():
    """The train and val steps' loss is the JAX ctdet_loss of both stacks'
    outputs; the detector's forward is the last stack's."""
    opt = _loss_opt()
    torch.manual_seed(10)
    model = TwoStacks()
    ref_model = copy.deepcopy(model)
    batch = {k: torch.from_numpy(v) for k, v in qat_batch().items()}
    mean, std = np.asarray(opt.mean, np.float32), np.asarray(opt.std,
                                                              np.float32)
    inp = model_input(batch, mean, std, (64, 64))
    targets = resolve_targets(dict(batch), inp, 4, 20)
    with torch.no_grad():
        outs = ref_model(inp)
    ref, _ = JL.ctdet_loss(
        [{k: jnp.asarray(to_np(v)) for k, v in o.items()} for o in outs],
        {k: jnp.asarray(v.numpy()) for k, v in targets.items()},
        TT.LossOpts(opt))
    lopts = TT.LossOpts(opt)
    val = TT.make_val_step(model, TL.ctdet_loss, lopts, mean, std, 4, 20,
                           (64, 64))(dict(batch))
    step = TT.make_train_step(model, TL.ctdet_loss, lopts,
                              torch.optim.Adam(model.parameters(), lr=1e-4),
                              False, mean, std, 4, 20, (64, 64))
    stats = step(dict(batch))
    for got in (val["loss"], stats["loss"]):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    det = TDET.CtdetDetector(opt, device="cpu")
    det.model = ref_model
    with torch.no_grad():
        got = det._forward(inp)
    for k in HEADS:
        assert torch.equal(got[k], outs[1][k]), k
