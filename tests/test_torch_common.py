"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages.
Importing this module fixes the torch numerics the comparisons assume:
no TF32 (cuDNN convolutions would otherwise run in TF32 on a card) and two
CPU threads, so that parallel test workers do not oversubscribe the CPU.
It holds no tests.
"""

import numpy as np
import pytest
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

HEADS = {"hm": 20, "wh": 2, "reg": 2}


def rng(seed):
    return np.random.RandomState(seed)


def nhwc_to_nchw(a):
    return np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))


def nchw_to_nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


def hwio_to_oihw(w):
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def oihw_to_hwio(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def to_np(t):
    return t.detach().float().cpu().numpy()


def deform_case(shape, seed=0, n=2, s_range=(-9.0, 10.0), dtype=np.float32):
    """x (n, H, W, C), s (n, H, W, 1) f32 and weight HWIO (3, 3, 1, C);
    the default s range crosses the [-7, 8] clamp and leaves the map."""
    h, w, c = shape
    r = rng(seed)
    x = r.randn(n, h, w, c).astype(dtype)
    s = r.uniform(*s_range, (n, h, w, 1)).astype(np.float32)
    wt = (r.randn(3, 3, 1, c) * 0.2).astype(dtype)
    return x, s, wt


def perturb_variables(variables, seed, res=64, deform_backbone=False,
                      w2=False, maxpool=False):
    """Numpy copy of JAX PoseShuffleNetV2 {'params', 'batch_stats'} trees
    that makes a random-weight model a fair test of the port (with
    `deform_backbone`, of that variant, whose trees only the port's
    `to_jax_variables` writes; with `w2` / `maxpool`, of the 2x network /
    the pooled stem):

    - every deform block's conv_scale is redrawn, so that s is fractional
      and partly out of the map (at init s == 1 and every tap lands on a
      pixel);
    - every BN's scale/bias is perturbed and its running mean/var set to
      the statistics of a seeded random batch at `res`^2 (computed by the
      port model in train mode). With the init's running stats the
      activations shrink layer by layer, the heads come out nearly
      constant and their top scores tie.
    """
    from codenet_tpu.engine.torch_import import convert_shufflenetv2
    from codenet_torch.engine.jax_weights import (from_jax_variables,
                                                  to_jax_variables)
    from codenet_torch.models import create_model

    r = rng(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            a = np.array(v, np.float32)
            if "conv_scale" in path and k == "kernel":
                cin = a.shape[2]
                a = r.randn(*a.shape).astype(np.float32) * 3.0 / np.sqrt(cin)
            elif "conv_scale" in path and k == "bias":
                a = r.uniform(-2.0, 3.0, a.shape).astype(np.float32)
            elif k == "scale":
                a = a * r.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k == "bias":
                a = a + r.randn(*a.shape).astype(np.float32) * 0.1
            out[k] = a
        return out

    variables = {col: walk(tree, ()) for col, tree in variables.items()}
    heads = {k[5:]: v["out"]["bias"].shape[0]
             for k, v in variables["params"].items() if k.startswith("head_")}
    model = create_model("shufflenetv2", heads, 64, device="cpu",
                         deform_backbone=deform_backbone, w2=w2,
                         maxpool=maxpool)
    model.load_state_dict(from_jax_variables(variables))
    calibrate_bn(model, r.randn(4, res, res, 3).astype(np.float32))
    if deform_backbone:
        variables["batch_stats"] = to_jax_variables(
            model.state_dict())["batch_stats"]
        return variables
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables["batch_stats"] = convert_shufflenetv2(
        sd, heads=tuple(sorted(heads)))["batch_stats"]
    return variables


@torch.no_grad()
def calibrate_bn(model, images):
    """Set every BN's running mean/var to the batch statistics of
    `images` (N, H, W, 3), each channel's variance raised to at least
    twice its layer's mean, then return the model to eval mode.

    The floor keeps the random network out of the chaotic regime, where
    near-dead channels normalised to unit variance make f32 rounding
    differences between two frameworks grow layer by layer (to ~1e-3 of
    the heads without it, ~1e-6 with it)."""
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # cumulative average: one batch -> its stats
    model.train()
    model(torch.from_numpy(images))
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 0.1
            m.running_var.clamp_(min=2.0 * float(m.running_var.mean()))
    model.eval()


def assert_heads_close(ref, out, rel=1e-3):
    """Each head within `rel` of that head's max |value|."""
    assert set(ref) == set(out)
    for name in ref:
        a = np.asarray(ref[name], np.float32)
        b = np.asarray(out[name], np.float32)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = float(np.abs(a).max())
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, (name, err, scale)


def adam_first_moment(state):
    """Adam's first moment (mu) in an optax state tree: after one step it
    is 0.1 * the gradient, which is how the parity tests read the JAX
    train step's gradients."""
    if hasattr(state, "mu"):
        return state.mu
    for child in (state if isinstance(state, tuple) else
                  getattr(state, "inner_state", ())):
        if hasattr(child, "mu") or isinstance(child, tuple):
            found = adam_first_moment(child)
            if found is not None:
                return found
    return None


def qat_batch():
    """A 64^2 batch of 2 for the QAT step tests: uint8 images with their
    colour-aug draws and sparse targets (4 objects each)."""
    r = rng(73)
    m = 50
    batch = {"input_u8": r.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
             "aug_perm": np.array([2, 5], np.int32),
             "aug_alphas": r.uniform(-0.4, 0.4, (2, 3)).astype(np.float32),
             "aug_light": (r.randn(2, 3) * 0.02).astype(np.float32),
             "hm_ct": r.randint(0, 16, (2, m, 2)).astype(np.int32),
             "hm_radius": r.randint(0, 3, (2, m)).astype(np.int32),
             "hm_cls": r.randint(0, 20, (2, m)).astype(np.int32),
             "reg_mask": (np.arange(m) < 4).astype(np.uint8)[None]
             .repeat(2, 0),
             "wh": r.uniform(1, 9, (2, m, 2)).astype(np.float32),
             "reg": r.rand(2, m, 2).astype(np.float32)}
    batch["ind"] = (batch["hm_ct"][..., 1] * 16
                    + batch["hm_ct"][..., 0]).astype(np.int64)
    return batch


def raise_bn_biases(model, heads, shift=3.0, keep=()):
    """Raise every BN bias by `shift` but those before the heads' last
    convs (and the BNs named in `keep`): the conditioned start of the
    train-step parity tests (test_torch_train.py::
    test_train_step_matches_jax says why)."""
    keep = {h + ".4" for h in heads} | set(keep)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.BatchNorm2d) and name not in keep:
                m.bias.add_(shift)


def assert_train_step_matches_jax(trainer, jax_trainer, batch, lr,
                                  cache=None, to_jax=None, per_tensor=True):
    """One Adam step of the port's `trainer` (initialised, on the CPU) and
    of the JAX package's `jax_trainer` from the port's weights, on the
    numpy `batch` (with `cache`, the (N, H, W, 3) uint8 image stack its
    img_idx rows index): every loss part within 2e-3, each gradient (read
    from the JAX side's first Adam moment, mu = 0.1 g) within 5e-3 of its
    max, the updated parameters within 2 lr, the BN running statistics
    within 1e-3. The weights go across through the JAX package's own
    converter, or, for the deform backbone, which it does not know,
    through the port's `to_jax_variables`; `to_jax` (the port's numpy
    ``state_dict`` -> JAX variables) overrides both, for the other
    arches. per_tensor=False holds the gradients as chip_smoke.py does:
    all of them together (relative L2) and the median tensor within 5e-3,
    for a network where a few tensors' gradients are rounding noise
    beyond the floor below (dla_34: test_torch_dla.py says which)."""
    import jax
    import jax.numpy as jnp
    from codenet_tpu.engine.torch_import import convert_shufflenetv2
    from codenet_torch.engine.jax_weights import (from_jax_variables,
                                                  layout_of_state_dict,
                                                  to_jax_variables)
    from codenet_torch.engine.trainer import batch_to_device

    sd = {k: v.numpy().copy() for k, v in trainer.model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    if to_jax is not None:
        variables = to_jax(sd)
    elif layout_of_state_dict(sd).deform:
        variables = to_jax_variables(trainer.model.state_dict())
    else:
        variables = convert_shufflenetv2(
            sd, heads=tuple(sorted(trainer.opt.heads)))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "meta"}
    tbatch = batch_to_device(batch, "cpu")
    if cache is not None:
        jbatch["cache_images"] = jnp.asarray(cache)
        tbatch["cache_images"] = torch.from_numpy(cache)
    jvars, jstate, jstats = jax_trainer.train_step(
        jvars, jax_trainer.tx.init(jvars["params"]), jbatch)

    stats = trainer.train_step(tbatch)
    assert set(stats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=2e-3, err_msg=k)

    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                   adam_first_moment(jstate))
    ref_grads = from_jax_variables({"params": grads,
                                    "batch_stats": variables["batch_stats"]})
    after = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                      dict(jvars)))
    params = dict(trainer.model.named_parameters())
    assert set(params) <= set(ref_grads)
    gmax = max(float(ref_grads[n].abs().max()) for n in params)
    rel, num, den = {}, 0.0, 0.0
    for name, p in params.items():
        ref = ref_grads[name].numpy()
        # a parameter whose output nothing reads (a DLA tree's projection
        # above its subtrees) has no gradient, where JAX's is 0
        got = np.zeros_like(ref) if p.grad is None else to_np(p.grad)
        # a BN bias feeding another train-mode BN has a gradient of 0 in
        # exact arithmetic (rounding noise only): scales floor at 1e-5 of
        # the largest gradient
        scale = max(float(np.abs(ref).max()), 1e-5 * gmax)
        err = float(np.abs(got - ref).max())
        rel[name] = err / scale
        num += float(((got - ref).astype(np.float64) ** 2).sum())
        den += float((ref.astype(np.float64) ** 2).sum())
        if per_tensor:
            assert err <= 5e-3 * scale, (name, err, scale)
        np.testing.assert_allclose(to_np(p), after[name].numpy(), rtol=0,
                                   atol=2 * lr + 1e-6, err_msg=name)
    if not per_tensor:
        assert (num / den) ** 0.5 <= 5e-3, (num / den) ** 0.5
        assert float(np.median(list(rel.values()))) <= 5e-3
    for name, buf in trainer.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(to_np(buf), after[name].numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=name)


def flax_vars(modules):
    """{'params', 'batch_stats'} numpy trees of {flax name: port module}
    (nested dicts allowed): an nn.Conv2d gives its HWIO kernel (and bias),
    an nn.BatchNorm2d its scale / bias and mean / var, a DCNv2 its
    weight, bias and conv_offset_mask. Builds the JAX
    side of a block-level parity test."""
    params, stats = {}, {}
    for name, m in modules.items():
        if isinstance(m, dict):
            sub = flax_vars(m)
            params[name] = sub["params"]
            if sub["batch_stats"]:
                stats[name] = sub["batch_stats"]
        elif hasattr(m, "conv_offset_mask"):  # DCNv2
            params[name] = {"weight": oihw_to_hwio(to_np(m.weight)),
                            "bias": to_np(m.bias), "conv_offset_mask":
                            flax_vars({"c": m.conv_offset_mask})
                            ["params"]["c"]}
        elif isinstance(m, torch.nn.BatchNorm2d):
            params[name] = {"scale": to_np(m.weight), "bias": to_np(m.bias)}
            stats[name] = {"mean": to_np(m.running_mean),
                           "var": to_np(m.running_var)}
        else:
            params[name] = {"kernel": oihw_to_hwio(to_np(m.weight))}
            if m.bias is not None:
                params[name]["bias"] = to_np(m.bias)
    return {"params": params, "batch_stats": stats}


@torch.no_grad()
def perturb_bns(model, seed):
    """Seeded BN scales, biases and running statistics (a fair eval-mode
    test of a block at init, whose BNs are the identity)."""
    r = rng(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.weight.copy_(torch.from_numpy(r.uniform(0.5, 1.5, c).astype(
                np.float32)))
            m.bias.copy_(torch.from_numpy((r.randn(c) * 0.1).astype(
                np.float32)))
            m.running_mean.copy_(torch.from_numpy((r.randn(c) * 0.1).astype(
                np.float32)))
            m.running_var.copy_(torch.from_numpy(r.uniform(0.5, 1.5, c)
                                                 .astype(np.float32)))


@torch.no_grad()
def randomize_dcn_offsets(model, seed, px=1.0):
    """Every DCNv2's conv_offset_mask redrawn so that its offsets are
    about `px` pixels (weights std px / sqrt(fan_in), biases std px) and
    its mask away from 0.5: at init both are constant (offsets 0, mask
    0.5) and the bilinear sampling is never exercised."""
    r = rng(seed)
    for m in model.modules():
        if hasattr(m, "conv_offset_mask"):
            w = m.conv_offset_mask.weight
            fan_in = w[0].numel()
            w.copy_(torch.from_numpy((r.randn(*w.shape) * px
                                      / np.sqrt(fan_in)).astype(np.float32)))
            b = m.conv_offset_mask.bias
            b.copy_(torch.from_numpy((r.randn(*b.shape) * px).astype(
                np.float32)))


@pytest.fixture
def cuda_device():
    """The CUDA card, or skip: the kernel has no CPU interpret mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")
