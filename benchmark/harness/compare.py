"""How `correct` is decided: the numbers that compare what the program's
timed path produced with the reference, each against its limit.

Training (the first three steps of the object the window then drives):

- loss_gap: the largest relative gap of a step's loss;
- grad_gap: Adam's first gradient (its first moment after one step over
  1 - beta1) against the reference's, leaf by leaf: the gap of the two
  norms over the larger of the reference leaf's norm and the median
  leaf's; the worst leaf;
- change_gap: the same of each leaf's change over the three steps,
  counting only the elements whose first reference gradient is at least
  a thousandth of the median leaf's RMS gradient: an element whose
  gradient cancels to rounding (a BN shift ahead of the next BN, which
  takes the mean out again) moves under Adam by round-off alone, by as
  much as any other.

Serving (every detection of a sample of the window's finished requests),
each served detection found where the reference's boxes lie nearest:

- box_gap_px: the largest distance, in frame pixels, from a served box to
  the nearest box the reference gives anywhere in its maps;
- score_gap: the largest gap of a served score to the reference's there;
- select_gap: the largest amount by which the reference's score there
  lies below the reference's own choice: below a neighbour's (not a
  peak) or below its (K + K/10)-th peak (not among its top K, with the
  slack that ties at the peak test leave; reference/serve.py);
- count_gap: the largest distance of a frame's count of detections from
  K (a decode that returns fewer, or a frame left without any);
- duplicates: the most detections of a frame that repeat another's
  position and class;
- miss_gap: the other way round, the reference's sure peaks (above
  each neighbour by more than TIE) that no served detection of their
  class sits at: the largest amount by which such a peak scores above
  the lowest served detection's reference score. A served set that
  skipped a better peak than one it kept reads above 0.
"""

from __future__ import annotations

import torch

from ..reference.serve import block_peaks

RULE_SHARE = 1e-3
# a reference peak above each of its 8 neighbours by more than this is
# sure: a program within the serving cells' score_gap limit (1e-4) at
# both positions orders them as the reference does. Nearer, rounding
# decides whether the position is a peak at all (an exact tie with a
# neighbour on a slope, a flat letterbox band)
TIE = 2e-4


def load_state(model, state):
    """Load the benchmark's state into the program's model, requiring the
    same names and shapes."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    bad = sorted(k for k in own if k in state
                 and tuple(own[k].shape) != tuple(state[k].shape))
    if missing or extra or bad:
        raise ValueError("state differs from the program's model: missing "
                         "{}, extra {}, shapes {}".format(missing[:5],
                                                          extra[:5],
                                                          bad[:5]))
    model.load_state_dict(state)


def check(value, limit):
    return {"value": float(value), "limit": float(limit)}


def _norms(d):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def _median(values):
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def _worst_gap(prog, ref, keys):
    med = _median([ref[k] for k in keys])
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                for k in keys), default=0.0)


def training_numbers(program, ref, start):
    """(loss_gap, grad_gap, change_gap) of a program's first steps against
    the reference's; `start` is the state both began from."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(program["losses"], ref["losses"]))
    if not all(map(lambda v: v == v, program["losses"])):
        loss_gap = float("inf")
    keys = list(ref["first_grads"])
    g_ref = _norms(ref["first_grads"])
    g_prog = _norms({k: program["first_grads"][k] for k in keys})
    grad_gap = _worst_gap(g_prog, g_ref, keys)
    rms = _median([g_ref[k] / max(ref["first_grads"][k].numel(), 1) ** 0.5
                   for k in keys])
    mask = {k: ref["first_grads"][k].abs().to(start[k].device)
            >= RULE_SHARE * rms for k in keys}
    moving = [k for k in keys if bool(mask[k].any())]

    def change(after):
        return _norms({k: (after[k].to(start[k].device) - start[k])[mask[k]]
                       for k in moving})
    change_gap = _worst_gap(change(program["after"]), change(ref["after"]),
                            moving)
    return loss_gap, grad_gap, change_gap


def training(program, ref, start, limits):
    gaps = training_numbers(program, ref, start)
    return {name: check(v, limits[name]) for name, v in
            zip(("loss_gap", "grad_gap", "change_gap"), gaps)
            if name in limits}


SERVED = ("box_gap_px", "score_gap", "select_gap", "count_gap", "duplicates",
          "miss_gap")


def served_numbers(served, dense, k):
    """{name: value} of SERVED for the served detections of some frames
    against the reference's dense maps of those frames. served: per frame
    an (M, 6) tensor [x1 y1 x2 y2 score class]; dense: a
    reference.serve.Dense; k: the detections a frame is due."""
    out = dict.fromkeys(SERVED, 0.0)

    def worst(name, value):
        out[name] = max(out[name], float(value))
    for i, det in enumerate(served):
        det = det.to(dense.boxes.device).float()
        peak, at, of = block_peaks(dense, i)
        worst("count_gap", abs(len(det) - k))
        if not len(det):
            worst("miss_gap", peak.max())
            continue
        dist = (dense.boxes[i][None, :, :] - det[:, None, :4]).abs().amax(-1)
        best, loc = dist.min(1)
        cls = det[:, 5].long()
        ref_score = dense.scores[i][loc, cls]
        worst("box_gap_px", best.max())
        worst("score_gap", (det[:, 4] - ref_score).abs().max())
        below = torch.maximum(dense.local[i][loc, cls] - ref_score,
                              dense.kth[i] - ref_score)
        worst("select_gap", below.clamp(min=0).max())
        pairs = loc * dense.scores.shape[2] + cls
        worst("duplicates", len(det) - len(torch.unique(pairs)))
        floor = ref_score.min()
        sure = (peak > floor) & (peak - dense.rival[i][at, of] > TIE)
        covered = ((at[sure][:, None] == loc[None])
                   & (of[sure][:, None] == cls[None])).any(1)
        if not bool(covered.all()):
            worst("miss_gap", peak[sure][~covered].max() - floor)
    return out


def serving(served, dense, limits, k):
    got = served_numbers(served, dense, k)
    return {name: check(got[name], limits[name]) for name in SERVED
            if name in limits}


def passed(checks):
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values())
