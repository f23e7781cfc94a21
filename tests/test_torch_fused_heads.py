"""The port's fused heads (codenet_torch/models/fused_heads.py) against the
JAX package's models/fused_heads.py and against the port's own per-head
path.

The heads' weights come from the port model (BN perturbed so that every
BN is a real affine), go across through the JAX package's converter, and
both packages run their fused heads on the same seeded neck: the eval
form (f32 2e-3, bf16 3e-2 of each head's max), `eval_forward` of the
whole model (its deform blocks in Pallas interpret mode on the JAX side)
and the train form (outputs, running statistics and gradients at 5e-3).
Against the port's per-head path (on the CPU): eval outputs, train
outputs and running statistics bit for bit; the heads' gradients and the
neck's within 1e-6 of each tensor's max (the fused backward sums the
three heads' contributions to the neck in one conv, the per-head one in
three).
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import (HEADS, assert_heads_close, perturb_bns,
                               perturb_variables, rng, to_np)

from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.models import fused_heads as JF
from codenet_torch.engine.jax_weights import from_jax_variables
from codenet_torch.models import create_model
from codenet_torch.models import fused_heads as TF
from codenet_torch.models.layers import QuantSpec, nchw, nhwc


def _model(dtype=None, seed=40):
    model = create_model("shufflenetv2", HEADS, 64, dtype=dtype,
                         device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    perturb_bns(model, seed + 1)
    return model


def _jax_vars(model):
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    variables = convert_shufflenetv2(sd, heads=tuple(sorted(HEADS)))
    return jax.tree_util.tree_map(jnp.asarray, variables)


def _neck(seed=42, n=2, hw=16):
    return rng(seed).randn(n, hw, hw, 64).astype(np.float32)


def _port_neck(neck):
    """(N, H, W, 64) numpy -> the (N, 64, H, W) channels_last neck."""
    return nchw(torch.from_numpy(neck)).contiguous(
        memory_format=torch.channels_last)


def _per_head(model, neck):
    return {name: nhwc(getattr(model, name)(neck)).float()
            for name, _ in model.heads}


@pytest.mark.parametrize("bf16,tol", [(False, 2e-3), (True, 3e-2)],
                         ids=["f32", "bf16"])
def test_apply_fused_heads_matches_jax(bf16, tol):
    model = _model(torch.bfloat16 if bf16 else None)
    neck = _neck()
    ref = JF.apply_fused_heads(_jax_vars(model), jnp.asarray(neck),
                               tuple(sorted(HEADS.items())),
                               dtype=jnp.bfloat16 if bf16 else None)
    with torch.no_grad():
        out = TF.apply_fused_heads(model, _port_neck(neck))
    assert_heads_close({k: np.asarray(v) for k, v in ref.items()},
                       {k: to_np(v) for k, v in out.items()}, rel=tol)


def test_eval_forward_matches_jax(monkeypatch):
    """The whole model's eval forward through the fused heads, on carried
    JAX weights (the JAX side in Pallas interpret mode), and the port's
    neck (return_neck) against the JAX model's."""
    monkeypatch.setenv("CODENET_PALLAS_INTERPRET", "1")
    jmodel = jax_create_model("shufflenetv2", HEADS, 64)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 64, 3)))
    variables = perturb_variables(dict(variables), seed=43)
    x = rng(44).randn(2, 64, 64, 3).astype(np.float32)
    ref, ref_neck = jax.jit(lambda v, x: (
        JF.eval_forward(jmodel, v, x),
        jmodel.apply(v, x, train=False, return_neck=True)))(
            variables, jnp.asarray(x))
    model = create_model("shufflenetv2", HEADS, 64, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        out = TF.eval_forward(model, torch.from_numpy(x))
        neck = model(torch.from_numpy(x), return_neck=True)
    assert tuple(neck.shape) == (2, 64, 16, 16)
    assert neck.is_contiguous(memory_format=torch.channels_last)
    assert_heads_close({"neck": np.asarray(ref_neck)},
                       {"neck": to_np(nhwc(neck))})
    assert_heads_close({k: np.asarray(v) for k, v in ref.items()},
                       {k: to_np(v) for k, v in out.items()})


def test_apply_fused_heads_train_matches_jax():
    """Batch-statistics BN: outputs, the running statistics written back
    into each head's BN buffers, and the gradients of a loss (the mean
    square of every head) over the heads' parameters and the neck."""
    model = _model(seed=45)
    variables = _jax_vars(model)
    neck = _neck(46)
    heads = tuple(sorted(HEADS.items()))

    def loss(params, x):
        v = dict(variables, params=params)
        out, updates = JF.apply_fused_heads_train(v, x, heads)
        return sum(jnp.mean(jnp.square(o)) for o in out.values()), \
            (out, updates)
    (jloss, (jout, jupd)), (jgrads, jdneck) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(neck))

    model.train()
    x = _port_neck(neck).requires_grad_()
    out = TF.apply_fused_heads_train(model, x)
    tloss = sum(v.square().mean() for v in out.values())
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=5e-3)
    assert_heads_close({k: np.asarray(v) for k, v in jout.items()},
                       {k: to_np(v) for k, v in out.items()}, rel=5e-3)

    stats = dict(variables["batch_stats"])
    stats.update(jax.tree_util.tree_map(np.asarray, jupd))
    after = from_jax_variables({"params": variables["params"],
                                "batch_stats": stats})
    ref_grads = from_jax_variables({"params": jgrads,
                                    "batch_stats": variables["batch_stats"]})
    for name, _ in model.heads:
        for key in ("1.running_mean", "1.running_var", "4.running_mean",
                    "4.running_var"):
            k = "{}.{}".format(name, key)
            np.testing.assert_allclose(
                to_np(model.state_dict()[k]), after[k].numpy(), rtol=5e-3,
                atol=1e-6, err_msg=k)
        for k, p in getattr(model, name).named_parameters():
            k = "{}.{}".format(name, k)
            ref = ref_grads[k].numpy()
            err = float(np.abs(to_np(p.grad) - ref).max())
            assert err <= 5e-3 * float(np.abs(ref).max()), (k, err)
    ref = np.asarray(jdneck)
    err = float(np.abs(to_np(nhwc(x.grad)) - ref).max())
    assert err <= 5e-3 * float(np.abs(ref).max()), err


def test_fused_eval_heads_equal_per_head():
    """f32 on the CPU: bit for bit."""
    model = _model(seed=47)
    neck = _port_neck(_neck(48))
    with torch.no_grad():
        ref = _per_head(model, neck)
        out = TF.apply_fused_heads(model, neck)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape
        assert torch.equal(out[k], ref[k]), k


def test_fused_train_heads_equal_per_head():
    """Train form against the per-head Head modules in train mode, from
    one model copied: outputs and every running statistic and batch
    count bit for bit; gradients within 1e-6 of each tensor's max."""
    model = _model(seed=49)
    twin = copy.deepcopy(model)
    model.train()
    twin.train()
    neck = _port_neck(_neck(50))
    a = neck.clone().requires_grad_()
    b = neck.clone().requires_grad_()
    ref = _per_head(model, a)
    out = TF.apply_fused_heads_train(twin, b)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
    sum(v.square().mean() for v in ref.values()).backward()
    sum(v.square().mean() for v in out.values()).backward()
    for (k, u), v in zip(model.named_buffers(), twin.buffers()):
        assert torch.equal(u, v), k
    pairs = [("neck", a.grad, b.grad)] + [
        (k, p.grad, q.grad) for (k, p), q in zip(model.named_parameters(),
                                                  twin.parameters())
        if k.split(".")[0] in HEADS]
    assert len(pairs) == 1 + 3 * 8
    for k, g_ref, g in pairs:
        scale = float(g_ref.abs().max())
        assert float((g - g_ref).abs().max()) <= 1e-6 * scale, k


def test_can_fuse_heads():
    assert TF.can_fuse_heads(_model())
    assert not TF.can_fuse_heads(_model(), QuantSpec())
    qmodel = create_model("shufflenetv2", HEADS, 64, qspec=QuantSpec(),
                          device="cpu")
    assert not TF.can_fuse_heads(qmodel)
    assert not TF.can_fuse_heads(create_model("res_18", HEADS, 64,
                                              device="cpu"))


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "per_head"])
def test_train_step_fuse_argument(monkeypatch, fuse):
    """make_train_step's `fuse` picks the train step's heads: fused
    (apply_fused_heads_train, the default) or one by one; one step from
    one model either way gives the same loss bit for bit."""
    from codenet_torch.engine import trainer as T
    calls = []
    real = T.apply_fused_heads_train
    monkeypatch.setattr(T, "apply_fused_heads_train",
                        lambda *a: calls.append(1) or real(*a))

    def loss_fn(outs, batch, opts):
        loss = sum(v.square().mean() for v in outs[0].values())
        return loss, {"loss": loss}
    x = torch.from_numpy(rng(51).randn(2, 32, 32, 3).astype(np.float32))
    losses = {}
    for f in (fuse, not fuse):
        model = _model(seed=52)
        step = T.make_train_step(
            model, loss_fn, None, torch.optim.Adam(model.parameters()),
            False, np.zeros(3, np.float32), np.ones(3, np.float32), fuse=f)
        losses[f] = float(step({"input": x})["loss"])
        assert len(calls) == int(f)
        calls.clear()
    assert losses[True] == losses[False]
