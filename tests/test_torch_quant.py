"""The port's W4A8 fake-quant (QAT) path against the JAX package.

Held against the JAX functions on the same seeded numpy inputs: the quant
math (symmetric / asymmetric quantizers and their straight-through
gradients, per-channel and percentile weight ranges with the 0.95x
fallback, the EMA with its first-batch case, the BN fold), `QuantAct`'s
EMA over several batches, the quantized full 1x model's forward and its
`quant_stats` after `update_stats`, and one QAT step (BN frozen and
folded, activation ranges moving). Last, `python -m
codenet_torch.cli.quant_main` fine-tunes a port FP32 checkpoint on the CPU
and the fake-quant eval adopts the recipe the checkpoint records.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import (HEADS, adam_first_moment, hwio_to_oihw,
                               oihw_to_hwio, perturb_variables, qat_batch,
                               rng, to_np)

from codenet_tpu import config as jcfg
from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.models.layers import QuantAct as JaxQuantAct
from codenet_tpu.models.layers import QuantSpec as JaxQuantSpec
from codenet_tpu.ops import quant as JQ
from codenet_torch import config as tcfg
from codenet_torch.engine import checkpoint
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              quant_stats_name)
from codenet_torch.engine.trainer import Trainer, batch_to_device
from codenet_torch.models import create_model
from codenet_torch.models.layers import QuantAct, QuantSpec
from codenet_torch.ops import quant as TQ

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1.25e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- quant math ---------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 8])
def test_symmetric_quant_and_ste_match_jax(k):
    r = rng(60)
    x = r.randn(6, 40).astype(np.float32) * 2
    lo = -np.abs(r.randn(6, 1)).astype(np.float32)
    hi = np.abs(r.randn(6, 1)).astype(np.float32)
    ref = JQ.symmetric_quant(jnp.asarray(x), k, jnp.asarray(lo),
                             jnp.asarray(hi))
    xt = _t(x).requires_grad_()
    out = TQ.symmetric_quant(xt, k, _t(lo), _t(hi))
    np.testing.assert_array_equal(to_np(out), np.asarray(ref))
    out.sum().backward()
    np.testing.assert_array_equal(to_np(xt.grad), np.ones_like(x))


@pytest.mark.parametrize("clamp,k", [(False, 8), (True, 8), (True, 4)])
def test_asymmetric_quant_matches_jax(clamp, k):
    """Unclamped (the reference quirk) and clamped to the signed window;
    the range leaves part of x outside it."""
    r = rng(61)
    x = r.uniform(-1.5, 3.0, (5, 31)).astype(np.float32)
    lo, hi = np.array([-1.0], np.float32), np.array([2.5], np.float32)
    ref = JQ.asymmetric_quant(jnp.asarray(x), k, jnp.asarray(lo),
                              jnp.asarray(hi), clamp=clamp,
                              signed_window=clamp)
    out = TQ.asymmetric_quant(_t(x), k, _t(lo), _t(hi), clamp=clamp)
    np.testing.assert_array_equal(to_np(out), np.asarray(ref))


@pytest.mark.parametrize("shape", [(3, 3, 1, 24), (1, 1, 40, 16),
                                   (3, 3, 8, 12)])
@pytest.mark.parametrize("percentile", [False, True])
def test_fake_quant_weight_matches_jax(shape, percentile):
    """Per-output-channel ranges; with percentile a channel of fewer than
    10 elements (every 3x3 depthwise kernel) takes 0.95x its min/max."""
    w = rng(62).randn(*shape).astype(np.float32)
    ref = JQ.fake_quant_weight(jnp.asarray(w), 4, "symmetric", True,
                               percentile)
    out = TQ.fake_quant_weight(_t(hwio_to_oihw(w)), 4, percentile)
    np.testing.assert_array_equal(oihw_to_hwio(to_np(out)), np.asarray(ref))


def test_percentile_ema_and_fold_match_jax():
    r = rng(63)
    flat = r.randn(5000).astype(np.float32)
    for a, b in zip(JQ.percentile_min_max(jnp.asarray(flat)),
                    TQ.percentile_min_max(_t(flat))):
        assert float(a) == float(b)
    state_j = (jnp.zeros(1), jnp.zeros(1))
    state_t = (torch.zeros(1), torch.zeros(1))
    for lo, hi in ((-0.5, 2.0), (-0.7, 1.5), (0.1, 3.0)):
        state_j = JQ.ema_update(*state_j, jnp.float32(lo), jnp.float32(hi))
        state_t = TQ.ema_update(*state_t, torch.tensor(lo), torch.tensor(hi))
        for a, b in zip(state_j, state_t):
            np.testing.assert_array_equal(np.asarray(a), to_np(b))
    w = r.randn(3, 3, 4, 6).astype(np.float32)
    g, bta, mu = (r.randn(6).astype(np.float32) for _ in range(3))
    var = r.uniform(0.5, 2.0, 6).astype(np.float32)
    rw, rb = JQ.fold_bn(jnp.asarray(w), None, *(jnp.asarray(a)
                                                for a in (g, bta, mu, var)))
    tw, tb = TQ.fold_bn(_t(hwio_to_oihw(w)), None,
                        *(_t(a) for a in (g, bta, mu, var)))
    np.testing.assert_allclose(oihw_to_hwio(to_np(tw)), np.asarray(rw),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(to_np(tb), np.asarray(rb), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("kw", [dict(), dict(act_clamp=True),
                                dict(act_percentile=True)])
def test_quant_act_ema_matches_jax(kw):
    """Three updates (the first takes the batch range as is), then one
    forward without an update; outputs and ranges equal."""
    jq = JaxQuantAct(JaxQuantSpec(**kw))
    tq = QuantAct(QuantSpec(**kw))
    r = rng(64)
    x0 = r.randn(2, 5, 5, 3).astype(np.float32)
    variables = jq.init(jax.random.PRNGKey(0), jnp.asarray(x0))
    for i, update in enumerate((True, True, True, False)):
        x = (r.randn(2, 5, 5, 3) * (1 + i)).astype(np.float32)
        ref, new = jq.apply(variables, jnp.asarray(x), update=update,
                            mutable=["quant_stats"])
        variables = {"quant_stats": new["quant_stats"]}
        out = tq(_t(x), update=update)
        np.testing.assert_array_equal(to_np(out), np.asarray(ref))
        qs = variables["quant_stats"]
        np.testing.assert_array_equal(to_np(tq.x_min), np.asarray(
            qs["x_min"]))
        np.testing.assert_array_equal(to_np(tq.x_max), np.asarray(
            qs["x_max"]))


# -- the quantized full model -------------------------------------------------

def _quant_variables(seed):
    """JAX quantized PoseShuffleNetV2 variables: the port's seeded init
    carried across, BN calibrated and perturbed (perturb_variables, so
    the folded BN is not degenerate), and the deconv1 scale predictor put
    back to its init (s == 1 there: the EMA's x_min == x_max case)."""
    model = create_model("shufflenetv2", HEADS, 64, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = perturb_variables(convert_shufflenetv2(sd), seed=seed)
    cs = variables["params"]["deconv1"]["conv_scale"]
    cs["kernel"] = np.zeros_like(cs["kernel"])
    cs["bias"] = np.ones_like(cs["bias"])
    return variables


def _quant_stats_of(model):
    return {k: to_np(v) for k, v in model.state_dict().items()
            if k.endswith(("x_min", "x_max"))}


def _jax_quant_stats(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = tuple(p.key for p in path)
        out[quant_stats_name(keys[:-1]) + "." + keys[-1]] = np.asarray(leaf)
    return out


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def test_quant_model_forward_and_stats_match_jax():
    """Every QuantAct of the port sits where the JAX model has one (55 of
    them, named after its quant_stats tree), and one forward with
    update_stats gives the same heads and the same ranges.

    In f32 the two packages' convolutions sum in different orders, and
    one activation that lands on the other side of a rounding boundary of
    its quantizer moves everything after it by a quantization level: the
    quantized networks drift apart (measured: from layer1.1's second
    quantizer on). In f64 both QuantActs quantize the same f32 values
    (they cast their input to f32), so the comparison runs in f64, within
    1e-6."""
    variables = _quant_variables(70)
    jmodel = jax_create_model("shufflenetv2", HEADS, 64,
                              qspec=JaxQuantSpec())
    x = rng(71).randn(2, 64, 64, 3)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.asarray(x, jnp.float32))
    variables["quant_stats"] = jax.tree_util.tree_map(
        np.asarray, init["quant_stats"])
    with jax.enable_x64(True):
        ref, new = jax.jit(lambda v, a: jmodel.apply(
            v, a, train=False, update_stats=True,
            mutable=["quant_stats"]))(_f64(variables), jnp.asarray(x))
        ref = {k: np.asarray(v) for k, v in ref.items()}
        want = _jax_quant_stats(new["quant_stats"])

    model = create_model("shufflenetv2", HEADS, 64, device="cpu",
                         qspec=QuantSpec())
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model.double()
    with torch.no_grad():
        out = model(_t(x), update_stats=True)
    for name in ref:
        a, b = ref[name], out[name].double().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max(), name
    got = _quant_stats_of(model)
    assert set(got) == set(want) and len(got) == 2 * 55
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   atol=1e-9, err_msg=key)
    # deconv1's s is 1 everywhere: x_min == x_max after the first update
    assert got["deconv_layers.4.scale_act.x_min"] == \
        got["deconv_layers.4.scale_act.x_max"] == 1.0


def _qat_opts():
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--batch_size", "2", "--gpus", "-1"]
    return (jcfg.update_dataset_info_and_set_heads(
                jcfg.parse(args), jcfg.DATASET_SPECS["pascal"]),
            tcfg.update_dataset_info_and_set_heads(
                tcfg.parse(args), tcfg.DATASET_SPECS["pascal"]))


def test_qat_step_matches_jax():
    """One QAT step (JAX: make_train_step with a QuantSpec, train=False,
    update_stats=True), in f64 for the reason given above, on the same
    input and dense targets: loss, every gradient through the folded BN
    and the straight-through quantizers (read from the JAX side's first
    Adam moment, mu = 0.1 g), the moved activation ranges and the
    Adam-updated parameters within 1e-6; BN running statistics stay as
    they were. Then the port's own f32 QAT step on the uint8 batch runs:
    finite loss and gradients, BN frozen, ranges moved."""
    import copy
    from codenet_torch.data.device_aug import model_input, resolve_targets
    from codenet_torch.engine.trainer import make_train_step

    variables = _quant_variables(72)
    jopt, topt = _qat_opts()
    batch = qat_batch()
    trainer = Trainer(topt, qspec=QuantSpec(), device="cpu")
    trainer.init()
    jtr = JaxTrainer(jopt, qspec=JaxQuantSpec())
    jtr.init()
    variables["quant_stats"] = jax.tree_util.tree_map(
        np.asarray, jtr.variables["quant_stats"])
    trainer.model.load_state_dict(from_jax_variables(variables))

    b = batch_to_device(batch, "cpu")
    inp = model_input(b, trainer.mean, trainer.std)
    b = resolve_targets(b, inp, 4, 20)
    b64 = {k: b[k].double() for k in ("hm", "wh", "reg")}
    b64.update(input=inp.double(), ind=b["ind"], reg_mask=b["reg_mask"])

    model64 = copy.deepcopy(trainer.model).double()
    stats64 = make_train_step(
        model64, trainer.loss_fn, trainer.loss_opts,
        torch.optim.Adam(model64.parameters(), lr=LR), True, trainer.mean,
        trainer.std, 4, 20)(b64)
    with jax.enable_x64(True):
        jvars = _f64(variables)
        jvars, jstate, jstats = jtr.train_step(
            jvars, jtr.tx.init(jvars["params"]),
            {k: jnp.asarray(v.numpy()) for k, v in b64.items()})
        grads = jax.tree_util.tree_map(lambda g: np.asarray(g) / 0.1,
                                       adam_first_moment(jstate))
        after = jax.tree_util.tree_map(np.asarray, dict(jvars))
        jstats = {k: float(v) for k, v in jstats.items()}
    for k in ("loss", "hm_loss", "wh_loss", "off_loss"):
        np.testing.assert_allclose(float(stats64[k]), jstats[k], rtol=1e-6,
                                   err_msg=k)
    ref_grads = from_jax_variables({"params": grads,
                                    "batch_stats": variables["batch_stats"]})
    after = from_jax_variables(after)
    params = dict(model64.named_parameters())
    gmax = max(float(ref_grads[n].abs().max()) for n in params)
    for name, p in params.items():
        ref = ref_grads[name].double().numpy()
        scale = max(float(np.abs(ref).max()), 1e-5 * gmax)
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-6 * scale, (name, err, scale)
        # Adam moves an element by lr * g / (|g| + 1e-8): where g is at
        # rounding level its sign is noise, so every element is held at
        # 2 lr and all but 0.1% at f32 resolution (from_jax_variables
        # hands the JAX values over in f32)
        a, b = p.detach().numpy(), after[name].numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR, err_msg=name)
        far = np.abs(a - b) > 2e-7 * np.abs(b) + 1e-6 * LR
        assert far.mean() <= 1e-3, (name, far.sum())
    for key, value in _quant_stats_of(model64).items():
        np.testing.assert_allclose(value, after[key].numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=key)

    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    stats = trainer.train_step(batch_to_device(batch, "cpu"))
    assert all(np.isfinite(float(v)) for v in stats.values())
    assert all(torch.isfinite(p.grad).all()
               for p in trainer.model.parameters())
    state = trainer.model.state_dict()
    for key in state:
        if key.endswith(("running_mean", "running_var")):
            assert torch.equal(state[key], before[key]), key
    # every range moved off its empty init (a ReLU'd input keeps x_min 0)
    moved = [k for k in state if k.endswith("x_max")
             and not torch.equal(state[k], before[k])]
    assert len(moved) == 55


# -- the QAT CLI and the fake-quant eval ---------------------------------------

@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    from synthetic import make_voc_dataset
    root = tmp_path_factory.mktemp("torch_quant_voc")
    make_voc_dataset(str(root), num_images=4, img_w=160, img_h=120)
    return str(root)


def test_cli_quant_main_from_fp32_checkpoint(voc_root, capsys):
    """quant_main loads a port FP32 .pth into the quantized model (the
    activation ranges start empty), fine-tunes, saves the recipe, and its
    final eval runs fake-quant; cli.test --resume-quantize adopts the
    recorded recipe over its own flags."""
    from codenet_torch.cli.quant_main import main as quant_main
    from codenet_torch.cli.test import main as test_main
    fp32 = os.path.join(REPO, "exp", "ctdet", "torch_quant_fp32",
                        "model_last.pth")
    checkpoint.save_model(fp32, 3, create_model(
        "shufflenetv2", HEADS, 64, device="cpu",
        generator=torch.Generator().manual_seed(5)))
    common = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
              "--input_res", "64", "--gpus", "-1", "--num_workers", "1",
              "--data_dir", voc_root]
    quant_main(common + ["--batch_size", "2", "--num_epochs", "1",
                         "--num_iters", "2", "--val_intervals", "-1",
                         "--print_iter", "1", "--wt-percentile",
                         "--act_clamp", "--load_model", fp32,
                         "--exp_id", "torch_quant_cli"])
    out = capsys.readouterr().out
    assert "No param layer0_act.x_min." in out
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("train epoch")]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert "Mean AP" in out
    path = os.path.join(REPO, "exp", "ctdet", "torch_quant_cli",
                        "model_last.pth")
    payload = torch.load(path, weights_only=True)
    assert payload["quant"] == {"w_bit": 4, "a_bit": 8,
                                "wt_percentile": True,
                                "act_percentile": False, "act_clamp": True}
    ranges = [v for k, v in payload["state_dict"].items()
              if k.endswith(("x_min", "x_max"))]
    assert len(ranges) == 110
    assert all(torch.isfinite(v).all() for v in ranges)
    assert any(float(v.abs().max()) > 0 for v in ranges)

    test_main(common + ["--resume-quantize", "--load_model", path,
                        "--exp_id", "torch_quant_eval"])
    out = capsys.readouterr().out
    assert "wt_percentile = True" in out and "act_clamp = True" in out
    assert "Mean AP" in out
