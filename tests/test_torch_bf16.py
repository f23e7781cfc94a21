"""The port's bf16 model path (`--dtype bfloat16`) against the JAX package.

bf16 rounds where the JAX layers round once XLA has compiled them
(models/layers.py says where): the conv operands and the deform op's x
and weight are bf16, the rest f32. The JAX side runs its deform blocks in
Pallas interpret mode here, as on a TPU: its XLA path would sample in
f32. Held at 64^2,
batch 2, from one JAX init shared by the module: the heads (3e-2 of each
head's max), one FP32-recipe train step from the conditioned init (loss
3e-2, the relative L2 of all gradients together 5e-2), int8 eval with a
bf16 stem (test_torch_int8.py's tolerances), the port's bf16 QAT against
its f32 QAT (the JAX test_qat_bf16_matches_f32_numerics), and the dtypes
of the deform op's gradients.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import (HEADS, adam_first_moment, assert_heads_close,
                               perturb_variables, qat_batch,
                               raise_bn_biases, rng, to_np)

from codenet_tpu import config as jcfg
from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.models.layers import QuantSpec as JaxQuantSpec
from codenet_torch import config as tcfg
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)
from codenet_torch.engine.trainer import Trainer, batch_to_device
from codenet_torch.models import create_model
from codenet_torch.models.layers import QuantSpec
from codenet_torch.ops import deform_cuda as DC

BF16 = jnp.bfloat16
HEAD_TOL = 3e-2
# int8 heads (test_torch_int8.py::HEAD_TOL says why)
INT8_TOL = {"hm": 2e-2, "reg": 1e-1, "wh": 1e-1}


@pytest.fixture(scope="module")
def variables():
    """The JAX model's init (params and batch_stats), made a fair test by
    perturb_variables: BN calibrated, scale predictors redrawn."""
    jmodel = jax_create_model("shufflenetv2", HEADS, 64)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3)))
    return perturb_variables(dict(init), seed=30)


def _x(seed=31, scale=1.0):
    return (rng(seed).randn(2, 64, 64, 3) * scale).astype(np.float32)


def _errs(ref, out):
    return {k: float(np.abs(np.asarray(ref[k]) - to_np(out[k])).max())
            / float(np.abs(np.asarray(ref[k])).max()) for k in ref}


def test_bf16_forward_matches_jax(variables, monkeypatch):
    """bf16 heads against the JAX bf16 model's (jitted), within 3e-2 of
    each head's max; the heads come out f32. Measured on the CPU: hm
    0.15%, wh 1.9%, reg 2.8%. Sums taken in another order round to bf16
    the other way now and then, and the random network carries that
    noise to the heads: the JAX package's own bf16 heads, jitted and op
    by op, differ by up to 5.6% of reg's max (op by op, XLA rounds every
    bf16 result that its compiled program keeps in f32)."""
    monkeypatch.setenv("CODENET_PALLAS_INTERPRET", "1")
    x = _x()
    jmodel = jax_create_model("shufflenetv2", HEADS, 64, dtype=BF16)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    model = create_model("shufflenetv2", HEADS, 64, dtype="bfloat16",
                         device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert all(v.dtype == torch.float32 for v in out.values())
    assert_heads_close({k: np.asarray(v) for k, v in ref.items()},
                       {k: to_np(v) for k, v in out.items()}, rel=HEAD_TOL)


def _opts(*extra):
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", "64", "--batch_size", "2", "--gpus", "-1",
            *extra]
    return tuple(cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS["pascal"]) for cfg in (jcfg,
                                                                   tcfg))


def test_bf16_train_step_matches_jax(monkeypatch):
    """One FP32-recipe Adam step with bf16 convs from the conditioned init
    (the port's seeded init, BN biases raised), on the same uint8 batch:
    the loss within 3e-2, all gradients together within 5e-2 (relative
    L2; the JAX gradients read from its first Adam moment, mu = 0.1 g),
    the worst tensor reported. The train-mode BNs normalise f32 conv
    outputs; the deform blocks sample and differentiate in bf16. Measured
    on the CPU: loss 0.1%, gradients 4.5% (the JAX package's own bf16
    gradients lie 4.0% from its f32 ones)."""
    monkeypatch.setenv("CODENET_PALLAS_INTERPRET", "1")
    jopt, topt = _opts("--dtype", "bfloat16")
    trainer = Trainer(topt, device="cpu")
    trainer.init()
    raise_bn_biases(trainer.model, HEADS)
    sd = {k: v.numpy().copy() for k, v in trainer.model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    variables = convert_shufflenetv2(sd, heads=tuple(sorted(HEADS)))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jtr = JaxTrainer(jopt)
    batch = qat_batch()
    _, jstate, jstats = jtr.train_step(
        jvars, jtr.tx.init(jvars["params"]),
        {k: jnp.asarray(v) for k, v in batch.items()})
    stats = trainer.train_step(batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]),
                               rtol=3e-2)
    grads = from_jax_variables({
        "params": jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                         adam_first_moment(jstate)),
        "batch_stats": variables["batch_stats"]})
    num = den = 0.0
    per = {}
    for name, p in trainer.model.named_parameters():
        ref = grads[name].double()
        diff = p.grad.double() - ref
        num += float((diff ** 2).sum())
        den += float((ref ** 2).sum())
        per[name] = float(diff.norm() / max(float(ref.norm()), 1e-30))
    worst = max(per, key=per.get)
    rel = (num / den) ** 0.5
    assert rel <= 5e-2, (rel, worst, per[worst])


def _qat_steps(dtype):
    """Three QAT steps of the port from one quantized init (the JAX
    test_qat_bf16_matches_f32_numerics, at its batch): losses and the
    EMA ranges."""
    _, topt = _opts(*(["--dtype", dtype] if dtype else []))
    trainer = Trainer(topt, qspec=QuantSpec(), device="cpu")
    trainer.init()
    r = rng(0)
    m = 50
    batch = {"input": r.randn(2, 64, 64, 3).astype(np.float32) * 0.3,
             "hm": np.zeros((2, 16, 16, 20), np.float32),
             "wh": r.rand(2, m, 2).astype(np.float32),
             "reg": r.rand(2, m, 2).astype(np.float32),
             "ind": r.randint(0, 256, (2, m)).astype(np.int64),
             "reg_mask": np.ones((2, m), np.uint8)}
    batch["hm"][:, 8, 8, 0] = 1.0
    losses = [float(trainer.train_step(batch_to_device(batch, "cpu"))[
        "loss"]) for _ in range(3)]
    ranges = {k: to_np(v) for k, v in trainer.model.state_dict().items()
              if k.endswith(("x_min", "x_max"))}
    return np.asarray(losses), ranges


def test_qat_bf16_matches_f32_numerics():
    """The quantizers compute in f32 whatever the conv dtype, so three
    bf16 QAT steps track the f32 ones: losses within 5%, every EMA range
    within 5e-2."""
    l32, q32 = _qat_steps(None)
    l16, q16 = _qat_steps("bfloat16")
    assert np.all(np.isfinite(l16))
    np.testing.assert_allclose(l16, l32, rtol=0.05)
    assert set(q16) == set(q32) and len(q32) == 110
    for key in q32:
        np.testing.assert_allclose(q16[key], q32[key], rtol=0.05,
                                   atol=0.05, err_msg=key)


def test_int8_bf16_matches_jax(monkeypatch):
    """--int8_infer with --dtype bfloat16: the stem conv, which takes the
    float image, with bf16 operands; the rest integer convs and bf16
    deform sampling, as without it. Against the JAX int8 bf16 model on
    test_torch_int8.py's model (seeded port weights, BN calibrated and
    perturbed, ranges from two fake-quant update passes, the same input)
    at its tolerances: a random quantized network passes every flipped
    level on, and the bf16 stem flips some of layer0's levels (the JAX
    package's own int8 heads with and without it differ by 5-8% of reg's
    and wh's max on such models, measured on the CPU)."""
    monkeypatch.setenv("CODENET_PALLAS_INTERPRET", "1")
    base = create_model("shufflenetv2", HEADS, 64, device="cpu")
    variables = perturb_variables(convert_shufflenetv2(
        {k: v.numpy() for k, v in base.state_dict().items()}), seed=80)
    x = _x(81, 0.5)
    fake = create_model("shufflenetv2", HEADS, 64, qspec=QuantSpec(),
                        device="cpu")
    fake.load_state_dict(from_jax_variables(variables), strict=False)
    with torch.no_grad():
        for _ in range(2):
            fake(torch.from_numpy(x), update_stats=True)
    model = create_model("shufflenetv2", HEADS, 64, dtype="bfloat16",
                         qspec=QuantSpec(int8_infer=True), device="cpu")
    model.load_state_dict(fake.state_dict())
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    jvars = dict(variables, quant_stats=to_jax_variables(
        fake.state_dict())["quant_stats"])
    jmodel = jax_create_model("shufflenetv2", HEADS, 64, dtype=BF16,
                              qspec=JaxQuantSpec(int8_infer=True))
    ref = jax.jit(jmodel.apply)(jvars, jnp.asarray(x))
    errs = _errs(ref, out)
    assert all(errs[k] <= INT8_TOL[k] for k in errs), errs


def test_deform_gradient_dtypes():
    """The deform op's gradients in the dtypes of the JAX custom_vjp
    (deform_pallas.py:877-897): dx in x's type, ds in s's (0 outside
    (-7, 8)), dw in the weight's; in the bf16 block the weight's gradient
    reaches the f32 parameter rounded to bf16, and x's its f32 input."""
    x = torch.from_numpy(rng(32).randn(2, 16, 16, 8).astype(np.float32)) \
        .to(torch.bfloat16)
    s = torch.from_numpy(rng(33).uniform(-9, 10, (2, 16, 16, 1))
                         .astype(np.float32))
    w = torch.from_numpy(rng(34).randn(3, 3, 1, 8).astype(np.float32)) \
        .to(torch.bfloat16)
    for t in (x, s, w):
        t.requires_grad_()
    DC.codesign_deform_conv_fast(x, s, w).float().square().sum().backward()
    assert (x.grad.dtype, s.grad.dtype, w.grad.dtype) == \
        (torch.bfloat16, torch.float32, torch.bfloat16)
    outside = (s <= -7) | (s >= 8)
    assert bool(outside.any()) and float(s.grad[outside].abs().max()) == 0

    model = create_model("shufflenetv2", HEADS, 64, dtype="bfloat16",
                         device="cpu")
    block = model.deconv_layers[0]
    seen = []
    fast = DC._CodesignDeformConv.backward

    def spy(ctx, g):
        grads = fast(ctx, g)
        seen.append(tuple(t.dtype for t in grads))
        return grads
    DC._CodesignDeformConv.backward = staticmethod(spy)
    try:
        xin = torch.randn(2, 1024, 4, 4).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        block.conv_scale.bias.data.fill_(1.5)
        block(xin, model.deconv_layers[1]).sum().backward()
    finally:
        DC._CodesignDeformConv.backward = staticmethod(fast)
    assert seen == [(torch.bfloat16, torch.float32, torch.bfloat16)]
    dw = block.conv.weight.grad
    assert dw.dtype == torch.float32
    assert torch.equal(dw, dw.bfloat16().float())
    assert block.conv_scale.weight.grad.dtype == torch.float32
    assert xin.grad.dtype == torch.float32
