"""The port's deform-backbone variant against the JAX package.

`create_model(..., deform_backbone=True)` puts a co-designed deform block
in place of every backbone depthwise 3x3 (the JAX package's
`get_shufflenetv2_dcn(..., deform_backbone=True)`, BaseNode._dw): 13
stride-1 blocks on the kernels' path and 3 stride-2 ones on the plain op,
at 58/116/232 channels. Held against the JAX model at 64^2, batch 2, from
one JAX init shared by the module: the FP32 forward (2e-3 of each head's
max; the JAX side in Pallas interpret mode), one FP32 train step from the
conditioned init (5e-3), the W4A8 fake-quant forward with its range
updates (1e-6) and one QAT step (gradients 1e-5) in f64 (quantized f32
drifts by whole levels, tests/test_torch_quant.py), `module_table` both
ways, forward and backward in bf16 and in QAT, and the int8 refusal
beside the JAX model's own failure.
"""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import (HEADS, adam_first_moment, assert_heads_close,
                               assert_train_step_matches_jax,
                               perturb_variables, qat_batch,
                               raise_bn_biases, rng, to_np)

from codenet_tpu import config as jcfg
from codenet_tpu.engine import trainer as JT
from codenet_tpu.models.layers import QuantSpec as JaxQuantSpec
from codenet_tpu.models.shufflenetv2 import get_shufflenetv2_dcn
from codenet_torch import config as tcfg
from codenet_torch.engine import trainer as TT
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              layout_of_state_dict,
                                              module_table,
                                              quant_stats_name,
                                              to_jax_variables)
from codenet_torch.models import create_model
from codenet_torch.models.layers import CodesignDeformBlock, QuantSpec

LR = 1.25e-4


def _jax_model(**kw):
    return get_shufflenetv2_dcn(0, HEADS, 64, deform_backbone=True, **kw)


def _port_model(**kw):
    return create_model("shufflenetv2", HEADS, 64, device="cpu",
                        deform_backbone=True, **kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def jax_qat_variables():
    """One init of the JAX quantized deform-backbone model: params and
    batch_stats (shared with the FP32 model, whose trees they are) and
    quant_stats."""
    variables = jax.jit(_jax_model(qspec=JaxQuantSpec()).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return _np_tree(variables)


def test_deform_backbone_layout(monkeypatch):
    """b1.0 and b2.3 are deform blocks (stride 2 and the node's stride),
    their BNs b1.1 and b2.4; quant mode adds each block's scale_act and
    deform_act (55 + 2 x 19 quantizers); 16 forward kernel calls a
    forward (13 backbone + 3 deconv)."""
    model = _port_model()
    blocks = {n: m for n, m in model.named_modules()
              if isinstance(m, CodesignDeformBlock)}
    assert len(blocks) == 3 + 16 + 3
    assert blocks["layer1.0.b1.0"].stride == 2
    assert blocks["layer1.0.b2.3"].stride == 2
    assert blocks["layer2.3.b2.3"].stride == 1
    assert blocks["layer3.1.b2.3"].conv.weight.shape == (232, 1, 3, 3)
    assert blocks["layer1.0.b2.3"].conv_channel is None
    assert isinstance(model.layer1[0].b2[4], torch.nn.BatchNorm2d)
    quant = _port_model(qspec=QuantSpec())
    assert sum(k.endswith("x_min") for k in quant.state_dict()) == 93
    from codenet_torch.models import layers as TL
    calls = []
    fast = TL.codesign_deform_conv_fast

    def spy(x, s, w):
        calls.append(tuple(x.shape[1:]))
        return fast(x, s, w)
    monkeypatch.setattr(TL, "codesign_deform_conv_fast", spy)
    with torch.no_grad():
        model(torch.zeros(1, 256, 256, 3))
    assert sorted(set(calls)) == [(8, 8, 232), (8, 8, 1024), (16, 16, 116),
                                  (16, 16, 256), (32, 32, 58),
                                  (32, 32, 128)]
    assert len(calls) == 16


def test_module_table_round_trip(jax_qat_variables):
    """The JAX quantized deform-backbone variables -> from_jax_variables ->
    the port's state_dict (every key, strict) -> to_jax_variables: the
    same trees, leaf for leaf; the deform nodes are the table's rows."""
    model = _port_model(qspec=QuantSpec())
    sd = from_jax_variables(jax_qat_variables)
    model.load_state_dict(sd, strict=False)
    missing = set(model.state_dict()) - set(sd)
    assert all(k.endswith("num_batches_tracked") for k in missing)
    back = to_jax_variables(model.state_dict())
    assert set(back) == set(jax_qat_variables)
    for col, tree in jax_qat_variables.items():
        ref = jax.tree_util.tree_leaves_with_path(tree)
        got = jax.tree_util.tree_leaves_with_path(back[col])
        assert [p for p, _ in ref] == [p for p, _ in got], col
        for (path, a), (_, b) in zip(ref, got):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
    layout = layout_of_state_dict(model.state_dict())
    assert layout.deform
    rows = {r.path: r for r in module_table(layout)}
    assert rows[("layer2", "node3", "b2_conv2")].port == "layer2.3.b2.3.conv"
    assert rows[("layer2", "node3", "b2_conv2", "bn")].port == \
        "layer2.3.b2.4"
    assert rows[("layer1", "node0", "b1_conv1", "conv_scale")].port == \
        "layer1.0.b1.0.conv_scale"
    assert quant_stats_name(("layer3", "node0", "b1_conv1", "deform_act")) \
        == "layer3.0.b1.0.deform_act"


def test_forward_matches_jax(jax_qat_variables, monkeypatch):
    """FP32 heads, BN calibrated and every scale predictor redrawn
    (perturb_variables): within 2e-3 of each head's max."""
    monkeypatch.setenv("CODENET_PALLAS_INTERPRET", "1")
    variables = perturb_variables(
        {k: jax_qat_variables[k] for k in ("params", "batch_stats")},
        seed=10, deform_backbone=True)
    x = rng(11).randn(2, 64, 64, 3).astype(np.float32)
    jmodel = _jax_model()
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    model = _port_model()
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert_heads_close({k: np.asarray(v) for k, v in ref.items()},
                       {k: to_np(v) for k, v in out.items()}, rel=2e-3)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    from synthetic import make_voc_dataset
    root = tmp_path_factory.mktemp("torch_deform_backbone_voc")
    make_voc_dataset(str(root), num_images=4, img_w=160, img_h=120)
    return str(root)


def _opts(voc_root=None):
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--batch_size", "2", "--gpus", "-1"]
    if voc_root:
        args += ["--data_dir", voc_root]
    return tuple(cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS["pascal"]) for cfg in (jcfg,
                                                                   tcfg))


def _deform_trainers(monkeypatch, voc_root=None, qspec=False):
    """The JAX and port Trainers of the deform-backbone model (their
    factories patched: neither CLI exposes the variant)."""
    monkeypatch.setattr(JT, "create_model", lambda *a, **k: _jax_model(
        qspec=k.get("qspec"), dtype=k.get("dtype")))
    monkeypatch.setattr(TT, "create_model", functools.partial(
        TT.create_model, deform_backbone=True))
    jopt, topt = _opts(voc_root)
    jtr = JT.Trainer(jopt, qspec=JaxQuantSpec() if qspec else None)
    tr = TT.Trainer(topt, qspec=QuantSpec() if qspec else None,
                    device="cpu")
    return jtr, tr


def test_train_step_matches_jax(voc_root, monkeypatch):
    """One FP32 Adam step from the port's seeded init with the BN biases
    raised (test_torch_train.py::test_train_step_matches_jax says why),
    on a sampler batch: loss parts 2e-3, every gradient 5e-3 of its max,
    parameters 2 lr, running statistics 1e-3."""
    from codenet_torch.data.datasets import get_dataset
    from codenet_torch.data.loader import DataLoader
    jtr, tr = _deform_trainers(monkeypatch, voc_root)
    tds = get_dataset("pascal", "ctdet")(tr.opt, "train")
    batch = next(iter(DataLoader(tds, 2, shuffle=True, num_workers=1,
                                 seed=3)))
    tr.init()
    raise_bn_biases(tr.model, HEADS)
    jtr.init()
    assert_train_step_matches_jax(tr, jtr, batch, LR)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  tree)


def test_qat_forward_and_step_match_jax(jax_qat_variables, monkeypatch):
    """W4A8 fake-quant, in f64: the heads of one forward with
    update_stats and the ranges it moves (1e-6), then one QAT step from
    those ranges (train=False, update_stats=True: BN folded and frozen):
    loss, every gradient through the folded BNs, the straight-through
    quantizers and both deform paths (stride 1 and 2), the moved ranges
    and the updated parameters. As in the JAX model, the backbone deform
    blocks' quantizers do not move."""
    from codenet_torch.data.device_aug import model_input, resolve_targets
    from codenet_torch.engine.trainer import batch_to_device, \
        make_train_step
    variables = perturb_variables(
        {k: jax_qat_variables[k] for k in ("params", "batch_stats")},
        seed=72, deform_backbone=True)
    variables["quant_stats"] = jax_qat_variables["quant_stats"]
    jtr, tr = _deform_trainers(monkeypatch, qspec=True)
    model = copy.deepcopy(tr.model)
    model.load_state_dict(from_jax_variables(variables))
    model.double()

    x = rng(71).randn(2, 64, 64, 3)
    jmodel = jtr.model
    with jax.enable_x64(True):
        ref, new = jax.jit(lambda v, a: jmodel.apply(
            v, a, train=False, update_stats=True,
            mutable=["quant_stats"]))(_f64(variables), jnp.asarray(x))
        ref = {k: np.asarray(v) for k, v in ref.items()}
        variables["quant_stats"] = _np_tree(new["quant_stats"])
    with torch.no_grad():
        out = model(torch.from_numpy(x), update_stats=True)
    for name in ref:
        a, b = ref[name], out[name].double().numpy()
        assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max(), name
    got = to_jax_variables(model.state_dict())["quant_stats"]
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(variables["quant_stats"]),
            jax.tree_util.tree_leaves_with_path(got)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9,
                                   err_msg=str(path))
    # the backbone blocks' quantizers keep their empty ranges (the JAX
    # BaseNode._dw calls them without update_stats); the other 55 move
    ranges = {k: v for k, v in model.state_dict().items()
              if k.endswith("x_max")}
    frozen = [k for k in ranges if ".b1.0." in k or ".b2.3." in k]
    assert len(frozen) == 38 and all(float(ranges[k]) == 0 for k in frozen)
    assert sum(float(v) != 0 for v in ranges.values()) == 55

    b = batch_to_device(qat_batch(), "cpu")
    inp = model_input(b, tr.mean, tr.std)
    b = resolve_targets(b, inp, 4, 20)
    b64 = {k: b[k].double() for k in ("hm", "wh", "reg")}
    b64.update(input=inp.double(), ind=b["ind"], reg_mask=b["reg_mask"])
    stats = make_train_step(
        model, tr.loss_fn, tr.loss_opts,
        torch.optim.Adam(model.parameters(), lr=LR), True, tr.mean, tr.std,
        4, 20)(b64)
    with jax.enable_x64(True):
        jvars = _f64(variables)
        jvars, jstate, jstats = jtr.train_step(
            jvars, jtr.tx.init(jvars["params"]),
            {k: jnp.asarray(v.numpy()) for k, v in b64.items()})
        grads = jax.tree_util.tree_map(lambda g: np.asarray(g) / 0.1,
                                       adam_first_moment(jstate))
        after = _np_tree(jvars)
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]),
                               rtol=1e-6)
    ref_grads = from_jax_variables({"params": grads,
                                    "batch_stats": variables["batch_stats"]})
    after = from_jax_variables(after)
    params = dict(model.named_parameters())
    gmax = max(float(ref_grads[n].abs().max()) for n in params)
    errs = {}
    for name, p in params.items():
        ref = ref_grads[name].double().numpy()
        scale = max(float(np.abs(ref).max()), 1e-5 * gmax)
        err = float(np.abs(p.grad.numpy() - ref).max())
        errs[name] = err / scale
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   rtol=0, atol=2 * LR, err_msg=name)
    # each backbone block's two frozen quantizers cast to f32 and back in
    # both packages, so its gradients arrive rounded to f32; the scale
    # predictors sum them over positions with cancellation (measured: at
    # most 2.4e-6 of their max, layer2.0's stride-2 block; every other
    # tensor under 1e-6)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])
    for key, value in model.state_dict().items():
        if key.endswith(("x_min", "x_max")):
            np.testing.assert_allclose(value.numpy(), after[key].numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
def test_forward_and_backward_run(dtype, quant):
    """FP32 (train-mode BN) and QAT fake-quant (update_stats), in f32 and
    with bf16 convs: finite heads, and a gradient for every parameter."""
    model = _port_model(dtype=dtype, qspec=QuantSpec() if quant else None)
    model.train(not quant)
    x = torch.from_numpy(rng(12).randn(2, 64, 64, 3).astype(np.float32))
    out = model(x, update_stats=quant)
    assert all(torch.isfinite(v).all() for v in out.values())
    sum(v.sum() for v in out.values()).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_int8_refused_as_jax_fails():
    """int8 eval of the deform backbone: the JAX model fails inside its
    first deform block (the closing BatchNorm gets a QTensor), so the port
    refuses to build it, and the W4A8 export (an int8 deployment) with
    it."""
    jmodel = _jax_model(qspec=JaxQuantSpec(int8_infer=True))
    with pytest.raises(TypeError):
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    with pytest.raises(NotImplementedError, match="QTensor"):
        _port_model(qspec=QuantSpec(int8_infer=True))
