"""The port's state_dict names, the weights carried from the JAX package,
and checkpoint loading."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_convert_ckpt import _synth_reference_state_dict
from test_torch_common import HEADS

from codenet_tpu.engine.torch_import import convert_shufflenetv2
from codenet_tpu.models import create_model as jax_create_model
from codenet_torch.engine import checkpoint
from codenet_torch.engine.jax_weights import from_jax_variables
from codenet_torch.models import create_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(seed=0):
    return create_model("shufflenetv2", HEADS, 64, device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def _learned(sd):
    """state_dict without BN's step counter (no JAX counterpart)."""
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def test_state_dict_keys_are_the_reference_layout():
    model = _model()
    ref = _synth_reference_state_dict()
    assert set(_learned(model.state_dict())) == set(ref)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ref.items()},
                          strict=True)
    np.testing.assert_array_equal(model.layer0[0].weight.detach().numpy(),
                                  ref["layer0.0.weight"])


def test_convert_then_from_jax_round_trips_exactly():
    sd = {k: v.numpy() for k, v in _learned(_model(1).state_dict()).items()}
    back = from_jax_variables(convert_shufflenetv2(sd))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_parameter_count_equals_jax():
    jmodel = jax_create_model("shufflenetv2", HEADS, 64)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes["params"]))
    n_torch = sum(p.numel() for p in _model().parameters())
    assert n_torch == n_jax
    n_stats = sum(int(np.prod(a.shape))
                  for a in jax.tree_util.tree_leaves(shapes["batch_stats"]))
    n_buffers = sum(b.numel() for k, b in _model().state_dict().items()
                    if k.endswith(("running_mean", "running_var")))
    assert n_buffers == n_stats


def test_load_jax_ckpt_without_jax(tmp_path):
    """A .ckpt written by the JAX package's save_model, optax Adam state
    included, loads in a process that never imports jax or optax."""
    import optax
    from codenet_tpu.engine.checkpoint import save_model

    want = _learned(_model(2).state_dict())
    variables = convert_shufflenetv2({k: v.numpy() for k, v in want.items()})
    opt_state = optax.adam(1e-3).init(variables["params"])
    ckpt = str(tmp_path / "model_last.ckpt")
    save_model(ckpt, 7, variables, opt_state=opt_state)
    expect = str(tmp_path / "expect.pt")
    torch.save(want, expect)

    script = (
        "import sys, torch\n"
        "from codenet_torch.engine.checkpoint import load_model\n"
        "from codenet_torch.models import create_model\n"
        "m = create_model('shufflenetv2', {'hm': 20, 'wh': 2, 'reg': 2}, "
        "64, device='cpu')\n"
        "_, epoch = load_model(sys.argv[1], m, strict=True)\n"
        "assert epoch == 7, epoch\n"
        "want = torch.load(sys.argv[2])\n"
        "sd = m.state_dict()\n"
        "assert all(torch.equal(sd[k], v) for k, v in want.items())\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'codenet_tpu'))\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", script, ckpt, expect],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_load_reference_pth(tmp_path):
    """A reference .pth (DataParallel 'module.' prefixes) loads with its
    epoch, every learned tensor exact."""
    ref = _synth_reference_state_dict()
    path = str(tmp_path / "model_best.pth")
    torch.save({"epoch": 70, "state_dict": {
        "module." + k: torch.from_numpy(v) for k, v in ref.items()}}, path)
    model, epoch = checkpoint.load_model(path, _model(), strict=True)
    assert epoch == 70
    sd = model.state_dict()
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_load_is_shape_tolerant(tmp_path, capsys):
    """Mismatched, missing and unknown entries are reported and skipped
    (reference model.py:40-69); strict mode raises instead."""
    ref = _synth_reference_state_dict()
    ref["hm.6.weight"] = np.zeros((80, 64, 1, 1), np.float32)
    ref["hm.6.bias"] = np.zeros(80, np.float32)
    del ref["wh.6.bias"]
    ref["extra.weight"] = np.zeros(3, np.float32)
    path = str(tmp_path / "coco.pth")
    torch.save({k: torch.from_numpy(v) for k, v in ref.items()}, path)
    model = _model()
    before = model.hm[6].weight.detach().clone()
    checkpoint.load_model(path, model)
    out = capsys.readouterr().out
    assert "Skip loading parameter hm.6.weight, required shape " \
        "(20, 64, 1, 1), loaded shape (80, 64, 1, 1)." in out
    assert "No param wh.6.bias." in out
    assert "Drop parameter extra.weight." in out
    assert torch.equal(model.hm[6].weight, before)
    np.testing.assert_array_equal(model.layer4[0].weight.detach().numpy(),
                                  ref["layer4.0.weight"])
    with pytest.raises(ValueError):
        checkpoint.load_model(path, _model(), strict=True)
