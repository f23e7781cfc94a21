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


def perturb_variables(variables, seed, res=64):
    """Numpy copy of JAX PoseShuffleNetV2 {'params', 'batch_stats'} trees
    that makes a random-weight model a fair test of the port:

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
    from codenet_torch.engine.jax_weights import from_jax_variables
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
    model = create_model("shufflenetv2", heads, 64, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    calibrate_bn(model, r.randn(4, res, res, 3).astype(np.float32))
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


@pytest.fixture
def cuda_device():
    """The CUDA card, or skip: the kernel has no CPU interpret mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")
