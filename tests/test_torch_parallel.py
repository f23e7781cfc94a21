"""The port's data parallelism (codenet_torch/parallel/) against one
process and against the JAX package's data-mesh step.

Two gloo ranks run on the CPU in JAX-free subprocesses
(tests/torch_parallel_worker.py: `launch` spawns them; each writes what
it computed), on the rows [lo, hi) of each global batch of 4. They are
held against the port in this process on the concatenated batch
(single-threaded, as the ranks are: the CPU convs may sum in another
order at another thread count):

- synced BatchNorm (forward, dx, the weight's and bias's gradients
  summed over the ranks, running statistics after two updates), the QAT
  activation ranges (min / max, and --act-percentile), and every task's
  loss (parts and gradients w.r.t. the heads), including batches where
  rank 0 has no positive and where none has: f64, 1e-12 of each
  quantity's max;
- 3 FP32 and 3 QAT (--wt-percentile --act_clamp) steps of ShuffleNetV2-
  DCN 1x at 64^2 from the conditioned init: every tensor of the final
  state within 1e-9 relative L2 in f64 (the loss parts within 1e-6: the
  heads are f32 in every mode), and the ranks' states bit-equal;
- one --device_cache_shard step (the JAX dryrun's phase-3 batch, each
  rank holding its half of the cache) against the unsharded cache in one
  process.

And against the JAX package's Trainer on a 2-device mesh (the virtual CPU
devices of tests/conftest.py, as tests/test_parallel.py uses them), from
the same weights carried across by engine/jax_weights.py: one f32 FP32
step within 5e-3 (loss parts; each gradient within 5e-3 of its max; BN
statistics), three steps at test_parallel.py's own tolerances (rtol
5e-2, atol 3e-3), and the phase-3 sharded-cache step (loss parts 5e-3,
each rank's cache rows equal to the JAX shard's). Two JAX compiles.
"""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from test_torch_common import adam_first_moment

from codenet_tpu import config as jcfg
from codenet_tpu.data.device_cache import ImageCache as JaxImageCache
from codenet_tpu.engine.trainer import Trainer as JaxTrainer
from codenet_tpu.parallel import get_mesh, shard_batch
from codenet_torch.engine.jax_weights import (from_jax_variables,
                                              to_jax_variables)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
UNIT_TOL = 1e-12
STEP_TOL = 1e-9
# the model's heads are f32 in every mode (the JAX model casts them so),
# so the loss parts of an f64 step sum f32 terms: the ranks' partial sums
# round apart from the one-process sum at f32 resolution
STEP_LOSS_TOL = 1e-6
JAX_STEP_TOL = 5e-3


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run_ranks(scenario, out_dir):
    proc = subprocess.run([sys.executable, WORKER, scenario, str(out_dir)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [torch.load(os.path.join(out_dir, "rank{}.pt".format(k)),
                       weights_only=False) for k in range(2)]


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    ranks = run_ranks("units", tmp_path_factory.mktemp("units"))
    with one_thread():
        return ranks, W.unit_results(None)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    ranks = run_ranks("steps", tmp_path_factory.mktemp("steps"))
    with one_thread():
        return ranks, W.step_results(None)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    ranks = run_ranks("cache", tmp_path_factory.mktemp("cache"))
    with one_thread():
        return ranks, W.cache_results(None)


def assert_close(got, ref, tol, what):
    scale = max(float(ref.abs().max()), 1e-30)
    err = float((got - ref).abs().max())
    assert err <= tol * scale, (what, err, scale)


def test_synced_bn_matches_one_process(units):
    ranks, ref = units
    a, b = ranks[0]["bn"], ranks[1]["bn"]
    for k in ("y", "dx"):
        assert_close(torch.cat([a[k], b[k]]), ref["bn"][k], UNIT_TOL, k)
    for k in ("dweight", "dbias"):
        assert_close(a[k] + b[k], ref["bn"][k], UNIT_TOL, k)
    for k in ("running_mean", "running_var"):
        assert torch.equal(a[k], b[k]), k
        assert_close(a[k], ref["bn"][k], UNIT_TOL, k)
    assert int(a["num_batches_tracked"]) == 2


@pytest.mark.parametrize("case", ["act", "act_pct"],
                         ids=["minmax", "percentile"])
def test_qat_ranges_match_one_process(units, case):
    """Two EMA updates (the first-batch case, then momentum 0.99) of the
    global range, and the fake-quantized rows."""
    ranks, ref = units
    a, b = ranks[0][case], ranks[1][case]
    for k in ("x_min", "x_max"):
        assert torch.equal(a[k], b[k]), k
        assert_close(a[k], ref[case][k], UNIT_TOL, k)
    assert_close(torch.cat([a["y"], b["y"]]), ref[case]["y"], UNIT_TOL, "y")


@pytest.mark.parametrize("positives", ["all", "rank1", "none"])
@pytest.mark.parametrize("task", list(W.TASKS))
def test_losses_match_one_process(units, task, positives):
    """Each rank's loss is its numerator over the global count: the ranks'
    parts sum to the one-process parts, and their gradients w.r.t. the
    heads are its rows. 'rank1': rank 0 holds no positive (the focal
    loss's num_pos == 0 branch is taken on the global count, and ddd's
    rotation residual on its global selection); 'none': no image has
    one."""
    ranks, ref = units
    key = "loss_{}_{}".format(task, positives)
    a, b, r = ranks[0][key], ranks[1][key], ref[key]
    assert set(a["stats"]) == set(r["stats"])
    for k, v in r["stats"].items():
        assert_close(a["stats"][k] + b["stats"][k], v, UNIT_TOL, k)
    for k, v in r["grads"].items():
        assert_close(torch.cat([a["grads"][k], b["grads"][k]]), v,
                     UNIT_TOL, k)


@pytest.mark.parametrize("case", ["fp32_f64", "qat_f64"])
def test_steps_match_one_process(steps, case):
    ranks, ref = steps
    a, b, r = ranks[0][case], ranks[1][case], ref[case]
    for k in r["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    for i, st in enumerate(r["stats"]):
        for k, v in st.items():
            assert_close(a["stats"][i][k], v, STEP_LOSS_TOL, (i, k))
    moved = 0.0
    for k, v in r["state"].items():
        if not v.is_floating_point():
            assert torch.equal(a["state"][k], v), k
            continue
        err = float((a["state"][k] - v).norm())
        assert err <= STEP_TOL * max(float(v.norm()), 1e-30), (k, err)
        if k.endswith(("running_mean", "x_min", "x_max")):
            moved += float(v.abs().sum())
    assert moved > 0  # the statistics of the mode moved


# -- against the JAX package's mesh step ------------------------------------

def _jax_opt(*extra):
    args = ["ctdet", "--dataset", "pascal", "--arch", "shufflenetv2",
            "--input_res", str(W.RES), "--batch_size", str(W.GLOBAL_BATCH),
            "--gpus", "-1", *extra]
    return jcfg.update_dataset_info_and_set_heads(
        jcfg.parse(args), jcfg.DATASET_SPECS["pascal"])


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_variables():
    return jax.tree_util.tree_map(
        jnp.asarray, to_jax_variables(W.conditioned_state(W.task_opt())))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX Trainer's steps on a 2-device mesh: the variables after
    each, the gradients of the first (Adam's first moment / 0.1) and the
    stats."""
    mesh = get_mesh(jax.devices()[:2])
    jtr = JaxTrainer(_jax_opt(), mesh=mesh)
    variables = _jax_variables()
    batch_stats = _host(variables["batch_stats"])
    state = jtr.tx.init(variables["params"])
    out = {"vars": [], "stats": []}
    for batch in W.step_batches():
        variables, state, stats = jtr.train_step(
            variables, state, shard_batch(mesh, batch))
        out["vars"].append(_host(dict(variables)))
        out["stats"].append({k: float(v) for k, v in stats.items()})
        if "grads" not in out:
            grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                           adam_first_moment(state))
            out["grads"] = from_jax_variables(
                {"params": grads, "batch_stats": batch_stats})
    return out


def test_step_matches_jax_mesh(steps, jax_steps):
    port = steps[0][0]["fp32_f32"]
    for k, v in jax_steps["stats"][0].items():
        np.testing.assert_allclose(float(port["stats"][0][k]), v,
                                   rtol=JAX_STEP_TOL, err_msg=k)
    ref_grads = jax_steps["grads"]
    gmax = max(float(ref_grads[n].abs().max()) for n in port["grads"])
    for name, got in port["grads"].items():
        ref = ref_grads[name]
        # a BN bias feeding a train-mode BN has a gradient of 0 in exact
        # arithmetic: scales floor at 1e-5 of the largest gradient
        scale = max(float(ref.abs().max()), 1e-5 * gmax)
        err = float((got - ref).abs().max())
        assert err <= JAX_STEP_TOL * scale, (name, err, scale)
    after = from_jax_variables(jax_steps["vars"][0])
    for name in port["grads"]:
        np.testing.assert_allclose(port["state_1"][name].numpy(),
                                   after[name].numpy(), rtol=0,
                                   atol=2 * W.LR + 1e-6, err_msg=name)
    for name, buf in port["state_1"].items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), after[name].numpy(),
                                       rtol=JAX_STEP_TOL, atol=1e-5,
                                       err_msg=name)


def test_three_steps_match_jax_mesh(steps, jax_steps):
    """test_parallel.py's multistep tolerances (rtol 5e-2, atol 3e-3) on
    every parameter and BN statistic after three steps."""
    port = steps[0][0]["fp32_f32"]
    after = from_jax_variables(jax_steps["vars"][-1])
    for k, v in jax_steps["stats"][-1].items():
        np.testing.assert_allclose(float(port["stats"][-1][k]), v,
                                   rtol=5e-2, err_msg=k)
    for name, value in port["state"].items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(), after[name].numpy(),
                                   rtol=5e-2, atol=3e-3, err_msg=name)


def test_cache_shard_step_matches_one_process(cache):
    """The ranks' halves of the cache, bit-equal states, and the step of
    the unsharded cache in one process (f32: the loss parts within 1e-5,
    every tensor within 1e-3 relative L2)."""
    ranks, ref = cache
    assert torch.equal(torch.cat([ranks[0]["rows"], ranks[1]["rows"]]),
                       ref["rows"])
    for k in ref["state"]:
        assert torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]), k
    for k, v in ref["stats"].items():
        np.testing.assert_allclose(ranks[0]["stats"][k], v, rtol=1e-5,
                                   err_msg=k)
    for k, v in ref["state"].items():
        if v.is_floating_point():
            err = float((ranks[0]["state"][k] - v).norm())
            assert err <= 1e-3 * max(float(v.norm()), 1e-12), (k, err)


def test_cache_shard_step_matches_jax_dryrun_batch(cache):
    """The JAX dryrun's phase 3 on a 2-device mesh (its cache sharded over
    the data axis, the gather under shard_map) from the port's weights:
    each rank's rows are the JAX shard of its device, the loss parts
    within 5e-3, the parameters within 2 lr and the BN statistics within
    5e-3."""
    ranks, _ = cache
    mesh = get_mesh(jax.devices()[:2])
    jtr = JaxTrainer(_jax_opt("--device_cache_shard"), mesh=mesh)
    images, batch = W.cache_case()
    jcache = JaxImageCache(images, np.full((len(images), 2), W.RES,
                                           np.int32))
    cache_dev = jcache.to_device(mesh, shard=True)
    shards = sorted(cache_dev.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    for k, shard in enumerate(shards):
        np.testing.assert_array_equal(ranks[k]["rows"].numpy(),
                                      np.asarray(shard.data))
    variables = _jax_variables()
    jbatch = shard_batch(mesh, batch)
    jbatch["cache_images"] = cache_dev
    variables, _, stats = jtr.train_step(
        variables, jtr.tx.init(variables["params"]), jbatch)
    for k, v in stats.items():
        np.testing.assert_allclose(ranks[0]["stats"][k], float(v),
                                   rtol=JAX_STEP_TOL, err_msg=k)
    after = from_jax_variables(_host(dict(variables)))
    for name, value in ranks[0]["state"].items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), after[name].numpy(),
                                       rtol=JAX_STEP_TOL, atol=1e-5,
                                       err_msg=name)
        elif not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(value.numpy(), after[name].numpy(),
                                       rtol=0, atol=2 * W.LR + 1e-6,
                                       err_msg=name)
