"""res and resdcn (`models/resnet.py`) of the port against the JAX
package, on the CPU at small sizes.

- `BasicBlock` and `Bottleneck` (stride 2, projected residual) eval
  forwards against the JAX blocks, 2e-3 of the output's max;
- `conv_transpose_4x4_s2` against the JAX one on a non-symmetric kernel;
- res_18 and resdcn_18 (DCNv2 offsets redrawn to about a pixel) whole at
  64^2: every head within 2e-3 of its max, the weights carried by the
  JAX package's own converter (engine/torch_import.py::convert_resnet);
- the weights' round trip port state_dict -> convert_resnet ->
  `from_jax_variables` exact, `to_jax_variables` equal to the converter,
  a JAX `.ckpt` of each loaded exactly (and of res_50, whose Bottleneck
  stages `from_jax_variables` tells from the tree);
- one FP32 train step of resdcn_18 at 64^2, batch 2, from the
  conditioned init (BN biases +3) against the JAX trainer:
  test_torch_common.assert_train_step_matches_jax (loss 2e-3, gradients
  5e-3 of each one's max);
- create_model builds every depth's spec, and a QuantSpec only warns
  (the model stays FP32), as in the JAX package.
"""

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
from codenet_tpu.models import resnet as JR
from codenet_torch import config as tcfg
from codenet_torch.engine import checkpoint
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)
from codenet_torch.engine.trainer import Trainer
from codenet_torch.models import create_model
from codenet_torch.models import resnet as TR
from codenet_torch.models.layers import QuantSpec

LR = 1.25e-4


def _block_vars(block):
    mods = {"Conv_0": block.conv1, "bn1": block.bn1, "Conv_1": block.conv2,
            "bn2": block.bn2}
    if isinstance(block, TR.Bottleneck):
        mods.update(Conv_2=block.conv3, bn3=block.bn3)
    if block.downsample is not None:
        mods.update(down_conv=block.downsample[0],
                    down_bn=block.downsample[1])
    return flax_vars(mods)


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
def test_blocks_match_jax(kind):
    port_cls, jax_cls = {"basic": (TR.BasicBlock, JR.BasicBlock),
                         "bottleneck": (TR.Bottleneck, JR.Bottleneck)}[kind]
    torch.manual_seed(0)
    block = port_cls(8, 6, stride=2, downsample=True).eval()
    perturb_bns(block, 1)
    x = rng(2).randn(2, 9, 9, 8).astype(np.float32)
    ref = jax_cls(6, 2, True).apply(_block_vars(block), jnp.asarray(x))
    with torch.no_grad():
        got = nchw_to_nhwc(to_np(block(torch.from_numpy(nhwc_to_nchw(x)))))
    assert_heads_close({"y": np.asarray(ref)}, {"y": got}, rel=2e-3)


def test_conv_transpose_matches_jax():
    up = TR.conv_transpose_4x4_s2(5, 3)
    torch.nn.init.normal_(up.weight)
    x = rng(3).randn(2, 6, 7, 5).astype(np.float32)
    kernel = np.transpose(to_np(up.weight), (2, 3, 0, 1))
    ref = JR.conv_transpose_4x4_s2(jnp.asarray(x), jnp.asarray(kernel))
    with torch.no_grad():
        got = nchw_to_nhwc(to_np(up(torch.from_numpy(nhwc_to_nchw(x)))))
    assert got.shape == (2, 12, 14, 3)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-4)


def _converter(arch):
    return lambda sd: TI.convert_resnet(sd, heads=tuple(sorted(HEADS)),
                                        head_conv=64,
                                        dcn=arch.startswith("resdcn"))


def _model(arch, seed):
    model = create_model(arch, HEADS, 64, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    perturb_bns(model, seed)
    randomize_dcn_offsets(model, seed)
    calibrate_bn(model, rng(seed).randn(4, 64, 64, 3).astype(np.float32))
    return model


@pytest.mark.parametrize("arch", ["res_18", "resdcn_18"])
def test_whole_arch_matches_jax(arch):
    model = _model(arch, 20)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = _converter(arch)(sd)
    x = rng(21).randn(2, 64, 64, 3).astype(np.float32)
    ref = jax_create_model(arch, HEADS, 64).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out["hm"].shape == (2, 16, 16, 20)
    assert_heads_close({k: np.asarray(v) for k, v in ref.items()},
                       {k: to_np(v) for k, v in out.items()}, rel=2e-3)


@pytest.mark.parametrize("arch", ["res_18", "resdcn_18", "res_50"])
def test_weights_round_trip(arch, tmp_path):
    from codenet_tpu.engine.checkpoint import save_model
    model = _model(arch, 22)
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    variables = _converter(arch)(sd)
    back = from_jax_variables(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    mine = to_jax_variables(model.state_dict())
    ref_leaves = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    assert set(map(str, ref_leaves)) == set(map(str, got_leaves))
    for path, v in ref_leaves.items():
        np.testing.assert_array_equal(got_leaves[path], v)
    path = str(tmp_path / "model_last.ckpt")
    save_model(path, 5, variables)
    fresh = create_model(arch, HEADS, 64, device="cpu")
    _, epoch = checkpoint.load_model(path, fresh, strict=True)
    assert epoch == 5
    for k, v in fresh.state_dict().items():
        if k in sd:
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def _opt(cfg, arch):
    args = ["ctdet", "--dataset", "pascal", "--arch", arch, "--input_res",
            "64", "--batch_size", "2", "--gpus", "-1"]
    return cfg.update_dataset_info_and_set_heads(
        cfg.parse(args), cfg.DATASET_SPECS["pascal"])


def test_resdcn_train_step_matches_jax():
    """One Adam step of resdcn_18 from the conditioned init: every BN bias
    raised by 3 (these heads have no BN), as the shufflenetv2 step tests
    start (test_torch_train.py::test_train_step_matches_jax says why)."""
    trainer = Trainer(_opt(tcfg, "resdcn_18"), device="cpu")
    trainer.init()
    raise_bn_biases(trainer.model, HEADS)
    jtr = JaxTrainer(_opt(jcfg, "resdcn_18"))
    jtr.init()
    assert_train_step_matches_jax(trainer, jtr, qat_batch(), LR,
                                  to_jax=_converter("resdcn_18"))


@pytest.mark.parametrize("depth", [18, 34, 50, 101, 152])
def test_create_model_builds_every_depth(depth):
    with torch.device("meta"):
        model = TR.get_pose_net(depth, HEADS)
    block, layers = TR.RESNET_SPEC[depth]
    assert [len(getattr(model, "layer{}".format(s))) for s in range(1, 5)] \
        == layers
    assert model.deconv_layers[0].in_channels == 512 * block.expansion


@pytest.mark.parametrize("arch", ["res_18", "resdcn_18", "dlav0_34",
                                  "dla_34"])
def test_quant_spec_only_warns(arch, capsys):
    """As in the JAX package: a QuantSpec prints a warning and the model
    runs in FP32 (the same weights give the same heads), and `dtype` is
    not read (f32 convs)."""
    gen = torch.Generator
    plain = create_model(arch, HEADS, 64, device="cpu",
                         generator=gen().manual_seed(1))
    quant = create_model(arch, HEADS, 64, qspec=QuantSpec(),
                         dtype="bfloat16", device="cpu",
                         generator=gen().manual_seed(1))
    assert "running" in capsys.readouterr().out
    x = torch.from_numpy(rng(9).randn(1, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        a, b = plain(x), quant(x)
    for k in a:
        assert torch.equal(a[k], b[k]), k
