"""The port's COCO evaluator and COCO result formats against the JAX
package's and against the pycocotools transcription of
tests/cocoeval_oracle.py.

Both evaluators are numpy: on the randomized bbox and keypoint scenarios
of tests/test_coco_oracle.py (crowds, ignored and empty ground truth,
every area range, maxDets binding) the port's precision and recall
tensors and its summary stats equal the JAX package's to 1e-12 and the
oracle's to 1e-10 (the JAX evaluator's own tolerance there).
"""

import numpy as np
import pytest

from cocoeval_oracle import OracleCOCOeval
from test_coco_oracle import _make_bbox_scenario, _make_kps_scenario

from codenet_tpu.data import datasets as JD
from codenet_tpu.data.coco_io import CocoIndex as JaxCocoIndex
from codenet_tpu.eval.coco_eval import CocoDetEval as JaxCocoDetEval
from codenet_torch.data import datasets as TD
from codenet_torch.data.coco_io import CocoIndex
from codenet_torch.eval.coco_eval import CocoDetEval

SCENARIOS = [("bbox", seed) for seed in range(5)] \
    + [("keypoints", seed) for seed in range(3)]


def _run(cls, index, gt, results, iou_type):
    ev = cls(index(gt), results, iou_type)
    ev.evaluate()
    ev.accumulate()
    return ev, ev.summarize()


@pytest.mark.parametrize("iou_type,seed", SCENARIOS)
def test_coco_eval_matches_jax_and_oracle(iou_type, seed):
    make = _make_bbox_scenario if iou_type == "bbox" else _make_kps_scenario
    gt, results = make(seed)
    ours, got = _run(CocoDetEval, CocoIndex, gt, results, iou_type)
    ref, want = _run(JaxCocoDetEval, JaxCocoIndex, gt, results, iou_type)
    oracle = OracleCOCOeval(gt, results, iou_type)
    oracle.evaluate()
    oracle.accumulate()
    expect = oracle.summarize()

    assert len(got) == (12 if iou_type == "bbox" else 10)
    assert list(got) == list(want) and set(got) == set(expect)
    np.testing.assert_allclose(ours.precision, ref.precision, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(ours.recall, ref.recall, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.precision, oracle.eval["precision"],
                               atol=1e-10)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], expect[k], atol=1e-10, err_msg=k)


def _ctdet_results(seed):
    """{image_id: {class (1-80): (n, 5) f32 boxes + score}} with empty
    classes, as CtdetDetector.merge_outputs returns them."""
    r = np.random.RandomState(seed)
    out = {}
    for img_id in (3, 17, 42):
        per = {}
        for cls in range(1, 81):
            n = r.randint(0, 3) if r.rand() < 0.2 else 0
            xy = r.uniform(0, 400, (n, 2))
            wh = r.uniform(1, 120, (n, 2))
            per[cls] = np.concatenate(
                [xy, xy + wh, r.rand(n, 1)], axis=1).astype(np.float32)
        out[img_id] = per
    return out


def _pose_results(seed):
    """{image_id: {1: list of 39-value rows}}, as MultiPoseDetector.
    merge_outputs returns them."""
    r = np.random.RandomState(seed)
    return {img_id: {1: np.concatenate(
        [r.uniform(0, 300, (n, 4)), r.rand(n, 1),
         r.uniform(0, 400, (n, 34))], axis=1).astype(np.float32).tolist()}
        for img_id, n in ((1, 4), (9, 0), (12, 20))}


@pytest.mark.parametrize("name,make", [("COCO", _ctdet_results),
                                       ("COCOHP", _pose_results)])
def test_convert_eval_format_matches_jax(name, make):
    """COCO's detection dicts (valid category ids, xywh, 2-decimal
    rounding) and COCOHP's keypoint dicts, equal to the JAX package's."""
    results = make(7)
    want = getattr(JD, name).convert_eval_format(
        object.__new__(getattr(JD, name)), results)
    got = getattr(TD, name).convert_eval_format(
        object.__new__(getattr(TD, name)), results)
    assert len(got) == len(want) > 0
    assert got == want
    if name == "COCO":
        assert {d["category_id"] for d in got} <= set(JD.COCO._valid_ids)
    else:
        assert all(len(d["keypoints"]) == 51 for d in got)


def test_dataset_metadata_matches_jax():
    for name in ("COCO", "COCOHP"):
        j, t = getattr(JD, name), getattr(TD, name)
        for attr in ("num_classes", "default_resolution", "max_objs",
                     "_valid_ids"):
            assert getattr(t, attr) == getattr(j, attr), (name, attr)
        np.testing.assert_array_equal(t.mean, j.mean)
        np.testing.assert_array_equal(t.std, j.std)
    assert TD.COCOHP.flip_idx == JD.COCOHP.flip_idx
    assert TD.COCOHP.num_joints == JD.COCOHP.num_joints


@pytest.mark.parametrize("dataset,task", [("coco", "ctdet"),
                                          ("pascal", "ctdet"),
                                          ("coco_hp", "multi_pose"),
                                          ("kitti", "ddd"),
                                          ("coco", "exdet"),
                                          ("coco_hp", "ctdet"),
                                          ("pascal", "exdet")])
def test_get_dataset(dataset, task):
    """The served (dataset, task) pairs compose (ctdet on every dataset,
    kitti / ddd and coco / exdet among them); any other pair raises and
    names itself (test_torch_faults.py holds each against the JAX
    package's composition)."""
    if task == "ctdet" or (dataset, task) in (
            ("coco_hp", "multi_pose"), ("kitti", "ddd"), ("coco", "exdet")):
        cls = TD.get_dataset(dataset, task)
        assert issubclass(cls, TD.DATASET_FACTORY[dataset])
        assert hasattr(cls, "get_sample")
        return
    with pytest.raises(NotImplementedError,
                       match="not {} on {}".format(task, dataset)):
        TD.get_dataset(dataset, task)
