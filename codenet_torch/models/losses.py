"""The losses of the four CenterNet tasks, NHWC (the JAX package's
models/losses.py; reference lib/models/losses.py and lib/trains/{ctdet,
ddd,multi_pose,exdet}.py).

Pure functions of (outputs, targets). The data-dependent branch of the
focal loss (no positive in the batch) is a `torch.where`, as in the JAX
package, so a step never syncs with the host.

Under data parallelism (`dp`, a parallel.DataParallel: the task losses
read ``opt.dp``) every batch-wide count that divides a loss, and every
branch taken on one, is the count of the global batch (`batch_count`),
so a rank's loss is its own numerator over the global denominator: the
ranks' losses and gradients sum to those of the concatenated batch. The
counts carry no gradient.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_sum


def batch_count(t, dp):
    """A batch-wide count (a 0-dim tensor) summed over the ranks of `dp`,
    without gradient; `t` itself on one process."""
    return t if dp is None else all_sum(t.detach(), dp)


def sigmoid_clamped(x):
    """_sigmoid: clamp to [1e-4, 1 - 1e-4] (reference models/utils.py:
    9-11)."""
    return torch.clamp(torch.sigmoid(x), 1e-4, 1.0 - 1e-4)


def gather_feat(output, ind):
    """Gather (N, H, W, C) at flat spatial indices (N, M) -> (N, M, C)
    (_transpose_and_gather_feat, models/utils.py:19-29)."""
    n, h, w, c = output.shape
    flat = output.reshape(n, h * w, c)
    return torch.gather(flat, 1, ind.long()[..., None].expand(-1, -1, c))


def neg_loss(pred, gt, dp=None):
    """CornerNet-modified focal loss (reference losses.py:42-67); pred is
    post-sigmoid, pred/gt (N, H, W, C)."""
    pos_inds = (gt == 1.0).to(pred.dtype)
    neg_inds = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1.0 - gt, 4)

    pos_loss = torch.log(pred) * torch.square(1.0 - pred) * pos_inds
    neg_loss_ = (torch.log(1.0 - pred) * torch.square(pred) * neg_weights
                 * neg_inds)

    num_pos = batch_count(pos_inds.sum(), dp)
    pos_sum = pos_loss.sum()
    neg_sum = neg_loss_.sum()
    return torch.where(num_pos == 0, -neg_sum,
                       -(pos_sum + neg_sum) / torch.clamp(num_pos, min=1.0))


def reg_l1_loss(output, mask, ind, target, dp=None):
    """Masked L1 at object indices (reference RegL1Loss,
    losses.py:145-155)."""
    pred = gather_feat(output, ind)
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    loss = torch.abs(pred * m - target * m).sum()
    return loss / (batch_count(m.sum(), dp) + 1e-4)


def smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def reg_loss(output, mask, ind, target, dp=None):
    """Smooth-L1 variant (reference RegLoss, losses.py:100-142), normalised
    by the number of objects."""
    pred = gather_feat(output, ind)
    num = batch_count(mask.to(pred.dtype).sum(), dp)
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    loss = smooth_l1(pred * m - target * m).sum()
    return loss / (num + 1e-4)


def norm_reg_l1_loss(output, mask, ind, target, dp=None):
    """L1(pred / target, 1) (reference NormRegL1Loss, losses.py:158-171)."""
    pred = gather_feat(output, ind)
    m = mask[..., None].to(pred.dtype).expand_as(pred)
    pred = pred / (target + 1e-4)
    tgt = torch.ones_like(target)
    loss = torch.abs(pred * m - tgt * m).sum()
    return loss / (batch_count(m.sum(), dp) + 1e-4)


def reg_weighted_l1_loss(output, mask, ind, target, dp=None):
    """Per-element-weighted L1 (reference RegWeightedL1Loss,
    losses.py:173-184); mask has the feature dim."""
    pred = gather_feat(output, ind)
    m = mask.to(pred.dtype)
    loss = torch.abs(pred * m - target * m).sum()
    return loss / (batch_count(m.sum(), dp) + 1e-4)


def _mean(x, dp):
    """The mean of x over the global batch."""
    if dp is None:
        return x.mean()
    return x.sum() / batch_count(x.new_tensor(float(x.numel())), dp)


def mse_loss(pred, gt, dp=None):
    return _mean(torch.square(pred - gt), dp)


def dense_wh_l1_loss(output, dense_wh, dense_wh_mask, dp=None):
    """Dense wh regression (reference trains/ctdet.py:51-56)."""
    m = dense_wh_mask
    return torch.abs(output * m - dense_wh * m).sum() / (
        batch_count(m.sum(), dp) + 1e-4)


def _cross_entropy_masked(logits, target, mask, dp=None):
    """compute_bin_loss (reference losses.py:212-215): the logits are
    masked (not the loss), and the cross-entropy is a mean over all
    rows, masked ones included."""
    logits = logits * mask.to(logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, target.long()[..., None])[..., 0]
    return _mean(nll, dp)


def bin_rot_loss(output, mask, ind, rotbin, rotres, dp=None):
    """2-bin orientation loss (reference BinRotLoss + compute_rot_loss,
    losses.py:197-250): per bin the masked-logit cross-entropy, and the
    smooth-L1 of its sin/cos residual over the rows whose bin is active,
    written as masked sums over a count floored at 1 (the JAX package's
    form, the same value)."""
    pred = gather_feat(output, ind)  # (N, M, 8)
    o = pred.reshape(-1, 8)
    tb = rotbin.reshape(-1, 2)
    tr = rotres.reshape(-1, 2)
    m = mask.reshape(-1, 1)

    loss_bin1 = _cross_entropy_masked(o[:, 0:2], tb[:, 0], m, dp)
    loss_bin2 = _cross_entropy_masked(o[:, 4:6], tb[:, 1], m, dp)

    def res_term(sin_col, cos_col, bin_col, res_col):
        sel = (bin_col != 0).to(o.dtype)
        num = batch_count(sel.sum(), dp)
        cnt = torch.clamp(num, min=1.0)
        ls = (smooth_l1(sin_col - torch.sin(res_col)) * sel).sum() / cnt
        lc = (smooth_l1(cos_col - torch.cos(res_col)) * sel).sum() / cnt
        return torch.where(num > 0, ls + lc, 0.0)

    loss_res = res_term(o[:, 2], o[:, 3], tb[:, 0], tr[:, 0]) \
        + res_term(o[:, 6], o[:, 7], tb[:, 1], tr[:, 1])
    return loss_bin1 + loss_bin2 + loss_res


def ctdet_loss(outputs, batch, opt):
    """CtdetLoss (reference trains/ctdet.py:17-74). outputs: list of head
    dicts (one per stack), NHWC; batch: target dict. Returns (loss, stats
    dict)."""
    dp = getattr(opt, "dp", None)
    hm_loss = wh_loss = off_loss = 0.0
    num_stacks = len(outputs)
    for output in outputs:
        if opt.mse_loss:
            hm_loss += mse_loss(output["hm"], batch["hm"], dp=dp) / num_stacks
        else:
            hm_loss += neg_loss(sigmoid_clamped(output["hm"]),
                                batch["hm"], dp=dp) / num_stacks
        if opt.wh_weight > 0:
            if opt.dense_wh:
                wh_loss += dense_wh_l1_loss(
                    output["wh"], batch["dense_wh"],
                    batch["dense_wh_mask"], dp=dp) / num_stacks
            elif opt.cat_spec_wh:
                wh_loss += reg_weighted_l1_loss(
                    output["wh"], batch["cat_spec_mask"], batch["ind"],
                    batch["cat_spec_wh"], dp=dp) / num_stacks
            else:
                crit = {"l1": reg_l1_loss, "sl1": reg_loss}[opt.reg_loss]
                if opt.norm_wh:
                    crit = norm_reg_l1_loss
                wh_loss += crit(output["wh"], batch["reg_mask"],
                                batch["ind"], batch["wh"], dp=dp) / num_stacks
        if opt.reg_offset and opt.off_weight > 0:
            crit = {"l1": reg_l1_loss, "sl1": reg_loss}[opt.reg_loss]
            off_loss += crit(output["reg"], batch["reg_mask"], batch["ind"],
                             batch["reg"], dp=dp) / num_stacks
    loss = (opt.hm_weight * hm_loss + opt.wh_weight * wh_loss
            + opt.off_weight * off_loss)
    return loss, {"loss": loss, "hm_loss": hm_loss, "wh_loss": wh_loss,
                  "off_loss": off_loss}


def ddd_loss(outputs, batch, opt):
    """DddLoss (reference trains/ddd.py:16-64). The depth head decodes as
    1 / (sigmoid + 1e-6) - 1, as the detector decodes it; wh and reg are
    masked by rot_mask, not reg_mask (the sampler zeroes reg_mask on
    augmented samples, rot_mask never), as in the reference."""
    dp = getattr(opt, "dp", None)
    hm_loss = dep_loss = rot_loss = dim_loss = 0.0
    wh_loss = off_loss = 0.0
    num_stacks = len(outputs)
    for output in outputs:
        dep = 1.0 / (torch.sigmoid(output["dep"]) + 1e-6) - 1.0
        hm_loss += neg_loss(sigmoid_clamped(output["hm"]),
                            batch["hm"], dp=dp) / num_stacks
        if opt.dep_weight > 0:
            dep_loss += reg_l1_loss(dep, batch["reg_mask"], batch["ind"],
                                    batch["dep"], dp=dp) / num_stacks
        if opt.dim_weight > 0:
            dim_loss += reg_l1_loss(output["dim"], batch["reg_mask"],
                                    batch["ind"], batch["dim"],
                                    dp=dp) / num_stacks
        if opt.rot_weight > 0:
            rot_loss += bin_rot_loss(output["rot"], batch["rot_mask"],
                                     batch["ind"], batch["rotbin"],
                                     batch["rotres"], dp=dp) / num_stacks
        if opt.reg_bbox and opt.wh_weight > 0:
            wh_loss += reg_l1_loss(output["wh"], batch["rot_mask"],
                                   batch["ind"], batch["wh"],
                                   dp=dp) / num_stacks
        if opt.reg_offset and opt.off_weight > 0:
            off_loss += reg_l1_loss(output["reg"], batch["rot_mask"],
                                    batch["ind"], batch["reg"],
                                    dp=dp) / num_stacks
    loss = (opt.hm_weight * hm_loss + opt.dep_weight * dep_loss
            + opt.dim_weight * dim_loss + opt.rot_weight * rot_loss
            + opt.wh_weight * wh_loss + opt.off_weight * off_loss)
    return loss, {"loss": loss, "hm_loss": hm_loss, "dep_loss": dep_loss,
                  "dim_loss": dim_loss, "rot_loss": rot_loss,
                  "wh_loss": wh_loss, "off_loss": off_loss}


def multi_pose_loss(outputs, batch, opt):
    """MultiPoseLoss (reference trains/multi_pose.py:16-85). The dense
    joint targets of --dense_hp are not ported (the sampler refuses the
    flag)."""
    dp = getattr(opt, "dp", None)
    hm_loss = wh_loss = off_loss = 0.0
    hp_loss = hm_hp_loss = hp_offset_loss = 0.0
    num_stacks = len(outputs)
    for output in outputs:
        hm_loss += neg_loss(sigmoid_clamped(output["hm"]),
                            batch["hm"], dp=dp) / num_stacks
        hp_loss += reg_weighted_l1_loss(output["hps"], batch["hps_mask"],
                                        batch["ind"],
                                        batch["hps"], dp=dp) / num_stacks
        if opt.wh_weight > 0 and opt.reg_bbox:
            wh_loss += reg_l1_loss(output["wh"], batch["reg_mask"],
                                   batch["ind"], batch["wh"],
                                   dp=dp) / num_stacks
        if opt.reg_offset and opt.off_weight > 0:
            off_loss += reg_l1_loss(output["reg"], batch["reg_mask"],
                                    batch["ind"], batch["reg"],
                                    dp=dp) / num_stacks
        if opt.reg_hp_offset and opt.off_weight > 0:
            hp_offset_loss += reg_l1_loss(
                output["hp_offset"], batch["hp_mask"], batch["hp_ind"],
                batch["hp_offset"], dp=dp) / num_stacks
        if opt.hm_hp and opt.hm_hp_weight > 0:
            hm_hp_loss += neg_loss(sigmoid_clamped(output["hm_hp"]),
                                   batch["hm_hp"], dp=dp) / num_stacks
    loss = (opt.hm_weight * hm_loss + opt.wh_weight * wh_loss
            + opt.off_weight * off_loss + opt.hp_weight * hp_loss
            + opt.hm_hp_weight * hm_hp_loss
            + opt.off_weight * hp_offset_loss)
    return loss, {"loss": loss, "hm_loss": hm_loss, "hp_loss": hp_loss,
                  "hm_hp_loss": hm_hp_loss, "hp_offset_loss": hp_offset_loss,
                  "wh_loss": wh_loss, "off_loss": off_loss}


def exdet_loss(outputs, batch, opt):
    """ExdetLoss (reference trains/exdet.py:18-42): the focal loss of the
    four extreme-point heatmaps and the centre one, and the masked L1 of
    the four points' sub-pixel offsets."""
    dp = getattr(opt, "dp", None)
    hm_loss = reg_loss_ = 0.0
    num_stacks = len(outputs)
    for output in outputs:
        for p in ("t", "l", "b", "r", "c"):
            tag = "hm_{}".format(p)
            hm = sigmoid_clamped(output[tag])
            if opt.mse_loss:
                hm_loss += mse_loss(hm, batch[tag], dp=dp) / num_stacks
            else:
                hm_loss += neg_loss(hm, batch[tag], dp=dp) / num_stacks
            if p != "c" and opt.reg_offset and opt.off_weight > 0:
                reg_loss_ += reg_l1_loss(
                    output["reg_{}".format(p)], batch["reg_mask"],
                    batch["ind_{}".format(p)],
                    batch["reg_{}".format(p)], dp=dp) / num_stacks
    loss = opt.hm_weight * hm_loss + opt.off_weight * reg_loss_
    return loss, {"loss": loss, "off_loss": reg_loss_, "hm_loss": hm_loss}


LOSS_FACTORY = {"ctdet": ctdet_loss, "ddd": ddd_loss,
                "multi_pose": multi_pose_loss, "exdet": exdet_loss}
