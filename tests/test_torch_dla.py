"""dlav0 and dla (DLA-34 with DCNv2 aggregation, the CLIs' default arch)
of the port against the JAX package, on the CPU at small sizes.

- the shared up kernel (`SharedUp`, the JAX `depthwise_up`) on a
  non-symmetric kernel: forward, and the kernel's gradient summed over
  the channels;
- a two-level `Tree` (level root, projection, `Root`), `IDAUp` and
  `IDAUpDCN` (DCNv2 offsets redrawn to about a pixel) at narrow widths,
  eval forwards 2e-3 of each output's max;
- dlav0_34 whole at 64^2 with the weights carried by the JAX package's
  engine/torch_import.py::convert_dlav0, and dla_34 from JAX variables
  through `from_jax_variables` (the JAX package has no converter for
  it): every head within 2e-3 of its max;
- the weights' round trip: port state_dict -> convert_dlav0 ->
  `from_jax_variables` exact for dlav0, JAX variables ->
  `from_jax_variables` -> `to_jax_variables` exact for dla, and a JAX
  `.ckpt` of dla_34 loaded exactly;
- one FP32 train step of dla_34 at 64^2, batch 2, from the conditioned
  init against the JAX trainer (loss 2e-3, gradients 5e-3);
- `cli.main ctdet` with no --arch (dla_34, the default) on a synthetic
  VOC set: two steps, then its final eval.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_common import (HEADS, assert_heads_close,
                               assert_train_step_matches_jax, calibrate_bn,
                               flax_vars, nchw_to_nhwc, nhwc_to_nchw,
                               perturb_bns, qat_batch, raise_bn_biases,
                               randomize_dcn_offsets, rng, to_np)

from codenet_tpu import config as jcfg
from codenet_tpu.engine import torch_import as TI
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_tpu.models import create_model as jax_create_model
from codenet_tpu.models import dla_dcn as JDD
from codenet_tpu.models import dlav0 as JD0
from codenet_torch import config as tcfg
from codenet_torch.engine import checkpoint
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)
from codenet_torch.engine.trainer import Trainer
from codenet_torch.models import create_model
from codenet_torch.models import dla_dcn as TDD
from codenet_torch.models import dlav0 as TD0

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1.25e-4


def _nhwc(module, x):
    with torch.no_grad():
        out = module(torch.from_numpy(nhwc_to_nchw(x)))
    return nchw_to_nhwc(to_np(out))


def test_shared_up_matches_jax():
    up = TD0.SharedUp(3, 4)
    kernel = rng(1).randn(8, 8).astype(np.float32)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(kernel)[None, None])
    x = rng(2).randn(2, 5, 6, 3).astype(np.float32)
    cot = rng(3).randn(2, 20, 24, 3).astype(np.float32)
    ref, grad = jax.value_and_grad(
        lambda k: jnp.sum(JD0.depthwise_up(jnp.asarray(x), 4, k) * cot))(
            jnp.asarray(kernel))
    y = up(torch.from_numpy(nhwc_to_nchw(x)))
    (y * torch.from_numpy(nhwc_to_nchw(cot))).sum().backward()
    np.testing.assert_allclose(float((y * torch.from_numpy(
        nhwc_to_nchw(cot))).sum()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(to_np(up.weight.grad)[0, 0], np.asarray(grad),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        TD0.bilinear_up_kernel(2), JD0.bilinear_up_kernel(2))


def _tree_vars(tree):
    mods = {}
    if tree.project is not None:
        mods.update(project_conv=tree.project[0], project_bn=tree.project[1])
    if tree.levels == 1:
        for name in ("tree1", "tree2"):
            b = getattr(tree, name)
            mods[name] = {"Conv_0": b.conv1, "bn1": b.bn1,
                          "Conv_1": b.conv2, "bn2": b.bn2}
        mods["root"] = {"Conv_0": tree.root.conv, "bn": tree.root.bn}
        return mods
    mods["tree1"] = _tree_vars(tree.tree1)
    mods["tree2"] = _tree_vars(tree.tree2)
    return mods


def test_tree_matches_jax():
    torch.manual_seed(4)
    tree = TD0.Tree(2, 6, 8, 2, level_root=True).eval()
    perturb_bns(tree, 5)
    x = rng(6).randn(2, 12, 12, 6).astype(np.float32)
    ref = JD0.Tree(2, 8, 2, level_root=True).apply(
        flax_vars(_tree_vars(tree)), jnp.asarray(x))
    assert_heads_close({"y": np.asarray(ref)}, {"y": _nhwc(tree, x)},
                       rel=2e-3)


def _ida_inputs(seed, chans=(8, 12, 16), sizes=(16, 8, 4)):
    r = rng(seed)
    return [r.randn(2, s, s, c).astype(np.float32)
            for c, s in zip(chans, sizes)]


def _run_ida(ida, xs):
    with torch.no_grad():
        out = ida([torch.from_numpy(nhwc_to_nchw(x)) for x in xs])
    return out


def test_ida_up_matches_jax():
    torch.manual_seed(7)
    ida = TD0.IDAUp(8, [8, 12, 16], [1, 2, 4]).eval()
    perturb_bns(ida, 8)
    mods = {"node_{}".format(i): {"Conv_0": getattr(ida, "node_{}".format(
        i))[0], "bn": getattr(ida, "node_{}".format(i))[1]} for i in (1, 2)}
    for i in (1, 2):
        proj = getattr(ida, "proj_{}".format(i))
        mods.update({"proj_{}_conv".format(i): proj[0],
                     "proj_{}_bn".format(i): proj[1]})
    variables = flax_vars(mods)
    for i in (1, 2):
        variables["params"]["up_{}_kernel".format(i)] = to_np(getattr(
            ida, "up_{}".format(i)).weight)[0, 0]
    xs = _ida_inputs(9)
    x, ys = JD0.IDAUp(8, (1, 2, 4)).apply(
        variables, [jnp.asarray(a) for a in xs])
    gx, gys = _run_ida(ida, xs)
    assert len(gys) == 2
    assert_heads_close({"x": np.asarray(x), "y0": np.asarray(ys[0])},
                       {"x": nchw_to_nhwc(to_np(gx)),
                        "y0": nchw_to_nhwc(to_np(gys[0]))}, rel=2e-3)


def test_ida_up_dcn_matches_jax():
    torch.manual_seed(10)
    ida = TDD.IDAUpDCN(8, [8, 12, 16], [1, 2, 4]).eval()
    ida.apply(lambda m: m.reset_parameters(torch.Generator().manual_seed(1))
              if hasattr(m, "conv_offset_mask") else None)
    perturb_bns(ida, 11)
    randomize_dcn_offsets(ida, 12)
    mods = {}
    for part in ("proj", "node"):
        for i in (1, 2):
            blk = getattr(ida, "{}_{}".format(part, i))
            mods["{}_{}".format(part, i)] = {"conv": blk.conv,
                                              "bn": blk.actf[0]}
    variables = flax_vars(mods)
    for i in (1, 2):
        variables["params"]["up_{}_kernel".format(i)] = to_np(getattr(
            ida, "up_{}".format(i)).weight)[0, 0]
    xs = _ida_inputs(13)
    ref = JDD.IDAUpDCN(8, (1, 2, 4)).apply(
        variables, [jnp.asarray(a) for a in xs])
    got = _run_ida(ida, xs)
    assert_heads_close({str(i): np.asarray(r) for i, r in enumerate(ref)},
                       {str(i): nchw_to_nhwc(to_np(g))
                        for i, g in enumerate(got)}, rel=2e-3)


def _model(arch, seed):
    model = create_model(arch, HEADS, 256, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    perturb_bns(model, seed)
    randomize_dcn_offsets(model, seed)
    calibrate_bn(model, rng(seed).randn(4, 64, 64, 3).astype(np.float32))
    return model


def _heads_match(arch, variables, model):
    x = rng(30).randn(2, 64, 64, 3).astype(np.float32)
    ref = jax_create_model(arch, HEADS, 256).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out["hm"].shape == (2, 16, 16, 20)
    assert_heads_close({k: np.asarray(v) for k, v in ref.items()},
                       {k: to_np(v) for k, v in out.items()}, rel=2e-3)


def test_dlav0_matches_jax():
    model = _model("dlav0_34", 31)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _heads_match("dlav0_34", TI.convert_dlav0(sd, heads=tuple(sorted(HEADS))),
                 model)


@pytest.fixture(scope="module")
def dla_variables():
    """JAX dla_34 variables: the flax model's tree (`jax.eval_shape` of
    its init) filled with seeded values (kernels U(+-1/sqrt(fan_in)),
    DCNv2 offset predictors for offsets of about a pixel, BN scales and
    biases near (1, 0), up kernels bilinear plus noise), then BN
    statistics calibrated on a random 64^2 batch."""
    r = rng(3)
    shapes = jax.eval_shape(jax_create_model("dla_34", HEADS, 256).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))

    def fill(path, leaf):
        keys = [getattr(k, "key", "") for k in path]
        shape = leaf.shape
        if keys[-1] == "kernel" or keys[-1] == "weight":
            fan_in = int(np.prod(shape[:-1]))
            std = 1.0 if "conv_offset_mask" in keys else 0.5
            return (r.uniform(-1, 1, shape) * std / np.sqrt(fan_in)) \
                .astype(np.float32)
        if keys[-1].startswith("up_"):
            return (TD0.bilinear_up_kernel(shape[0] // 2)
                    + r.randn(*shape) * 0.05).astype(np.float32)
        if keys[-1] == "scale":
            return r.uniform(0.5, 1.5, shape).astype(np.float32)
        if keys[-1] == "var":
            return np.ones(shape, np.float32)
        return (r.randn(*shape) * 0.1).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    model = create_model("dla_34", HEADS, 256, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    calibrate_bn(model, r.randn(4, 64, 64, 3).astype(np.float32))
    variables["batch_stats"] = to_jax_variables(
        model.state_dict())["batch_stats"]
    return variables


def test_dla_matches_jax(dla_variables):
    model = create_model("dla_34", HEADS, 256, device="cpu")
    model.load_state_dict(from_jax_variables(dla_variables))
    _heads_match("dla_34", dla_variables, model)


def _leaves(tree):
    return {str(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_dlav0_weights_round_trip():
    model = _model("dlav0_34", 33)
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    variables = TI.convert_dlav0(sd, heads=tuple(sorted(HEADS)))
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    ref, got = _leaves(variables), _leaves(to_jax_variables(
        model.state_dict()))
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_dla_weights_round_trip_and_ckpt(dla_variables, tmp_path):
    from codenet_tpu.engine.checkpoint import save_model
    sd = from_jax_variables(dla_variables)
    ref, got = _leaves(dla_variables), _leaves(to_jax_variables(sd))
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    path = str(tmp_path / "model_last.ckpt")
    save_model(path, 2, dla_variables)
    model = create_model("dla_34", HEADS, 256, device="cpu")
    _, epoch = checkpoint.load_model(path, model, strict=True)
    assert epoch == 2
    state = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(state[k], v), k


def test_reference_pth_up_kernels_load_as_one_plane(tmp_path):
    """A reference-layout dlav0 .pth whose up kernels are grouped (C, 1,
    2f, 2f), as DLA's ConvTranspose2d stores them, loads with channel 0's
    plane, as the JAX package's convert_dlav0 reads it."""
    model = create_model("dlav0_34", HEADS, 256, device="cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    r = rng(34)
    grouped = {}
    for k, v in list(sd.items()):
        if ".up_" in k:
            planes = torch.from_numpy(r.randn(64, 1, *v.shape[2:]).astype(
                np.float32))
            sd[k] = grouped[k] = planes
    assert len(grouped) == 6
    path = str(tmp_path / "ref.pth")
    torch.save({"epoch": 7, "state_dict": sd}, path)
    fresh = create_model("dlav0_34", HEADS, 256, device="cpu")
    _, epoch = checkpoint.load_model(path, fresh, strict=True)
    assert epoch == 7
    for k, v in grouped.items():
        assert torch.equal(fresh.state_dict()[k], v[:1]), k


def _opt(cfg, arch):
    args = ["ctdet", "--dataset", "pascal", "--arch", arch, "--input_res",
            "64", "--batch_size", "2", "--gpus", "-1"]
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS["pascal"])


def test_dla_train_step_matches_jax():
    """One Adam step of dla_34 from the conditioned init, the weights
    carried to the JAX trainer by `to_jax_variables`. The init is
    chip_smoke.py's for this arch: every BN bias +6 (ARCH_BN_SHIFT) but
    the one whose ReLU feeds the heads (these heads have no BN; raised
    there, the heatmap logits reach the loss's clamp).

    The DCNv2 biases feed train-mode BNs, so their exact gradient is 0
    and what is computed is rounding noise; `python tools_torch/
    step_conditioning.py --arch dla_34 --res 64 --batch 2` puts f32
    8.4e-7 from f64 over all gradients (relative L2) and the median
    tensor 3.7e-6, but ida_up.node_2.conv.bias 1.9e-3 of its own max.
    So the gradients are held together and by the median tensor (5e-3),
    as chip_smoke.py holds the card's."""
    trainer = Trainer(_opt(tcfg, "dla_34"), device="cpu")
    trainer.init()
    raise_bn_biases(trainer.model, HEADS, shift=6.0,
                    keep={"ida_up.node_2.actf.0"})
    jtr = JaxTrainer(_opt(jcfg, "dla_34"))
    jtr.init()
    assert_train_step_matches_jax(
        trainer, jtr, qat_batch(), LR, per_tensor=False,
        to_jax=lambda sd: to_jax_variables(
            {k: torch.from_numpy(v) for k, v in sd.items()}))


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    from synthetic import make_voc_dataset
    root = str(tmp_path_factory.mktemp("torch_dla_voc"))
    make_voc_dataset(root, num_images=4, img_w=160, img_h=120)
    return root


def test_cli_main_default_arch_trains_and_scores(voc_root, capsys):
    """`cli.main ctdet` with no --arch builds dla_34 (head_conv 256),
    takes two steps and runs its final eval (VOC AP)."""
    from codenet_torch.cli.main import main
    trainer = main(["ctdet", "--dataset", "pascal", "--input_res", "64",
                    "--batch_size", "2", "--num_epochs", "1", "--num_iters",
                    "2", "--val_intervals", "-1", "--num_workers", "1",
                    "--print_iter", "1", "--gpus", "-1", "--data_dir",
                    voc_root, "--exp_id", "torch_dla_cli"])
    out = capsys.readouterr().out
    assert trainer.opt.arch == "dla_34" and trainer.opt.head_conv == 256
    assert isinstance(trainer.model, TDD.DLASegDCN)
    losses = [float(ln.split(" loss ")[1].split()[0])
              for ln in out.splitlines() if ln.startswith("train epoch")]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert "Running final eval" in out and "Mean AP" in out
    assert os.path.exists(os.path.join(REPO, "exp", "ctdet", "torch_dla_cli",
                                       "model_last.pth"))
