"""Training-time debug renders and val-prediction capture (the JAX
package's engine/train_hooks.py; reference lib/trains/{ctdet,multi_pose,
ddd,exdet}.py `debug` and `save_result`, called from base_trainer.py:
93-97).

- `debug` (--debug > 0): the first image of each batch, its predicted and
  ground-truth heatmaps and decoded detections, saved as PNG files into
  opt.debug_dir with the JAX file names, prefixed by phase and iteration
  (headless at every level: no window is assumed).
- `save_result` (--test): each val batch's first image decoded and
  back-projected into `results` keyed by image id, so that Trainer.val
  returns (stats, results) for ctdet, multi_pose and ddd, and the caller
  scores them (reference main.py:51-54).

Both read one eval-mode forward of the batch (BN on running statistics,
no range update), run once per batch when both hooks fire.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.device_aug import model_input, resolve_targets
from ..models import decode as D
from ..utils import post_process as PP


def _np(t):
    return t.detach().float().cpu().numpy()


class TrainHooks:
    """Per-task debug / save_result dispatch bound to one Trainer."""

    def __init__(self, opt, model):
        self.opt = opt
        self.task = opt.task
        self.model = model
        self.mean = np.asarray(opt.mean, np.float32)
        self.std = np.asarray(opt.std, np.float32)

    @torch.no_grad()
    def forward(self, batch):
        """batch (on the device) -> (f32 input, batch with dense targets,
        the last stack's heads), from an eval-mode forward."""
        was_training = self.model.training
        self.model.eval()
        try:
            inp = model_input(batch, self.mean, self.std,
                              (self.opt.input_h, self.opt.input_w),
                              batch.get("cache_images"))
            batch2 = resolve_targets(batch, inp, self.opt.down_ratio,
                                     self.opt.num_classes)
            out = self.model(inp)
        finally:
            self.model.train(was_training)
        out = out[-1] if isinstance(out, (list, tuple)) else out
        return inp, batch2, out

    # -- shared helpers ---------------------------------------------------
    def _first_image(self, inp, batch):
        """uint8 HWC image of sample 0: the warped uint8 input where the
        batch carries it, else the f32 input denormalised."""
        if "input_u8" in batch:
            return _np(batch["input_u8"][0]).astype(np.uint8)
        img = _np(inp[0]) * self.std + self.mean
        return np.clip(img * 255.0, 0, 255).astype(np.uint8)

    def _debugger(self):
        from ..utils.debugger import Debugger
        return Debugger(dataset=self.opt.dataset,
                        theme=self.opt.debugger_theme,
                        num_classes=self.opt.num_classes,
                        down_ratio=self.opt.down_ratio)

    def _emit(self, debugger, phase, iter_id):
        out_dir = getattr(self.opt, "debug_dir", "debug")
        os.makedirs(out_dir, exist_ok=True)
        debugger.save_all_imgs(out_dir,
                               prefix="{}_{}_".format(phase, iter_id))

    # -- debug ------------------------------------------------------------
    def debug(self, batch, meta, iter_id, phase="train", fwd_out=None):
        inp, batch2, out = fwd_out if fwd_out is not None \
            else self.forward(batch)
        fn = getattr(self, "_debug_" + self.task, None)
        if fn is not None:
            fn(inp, batch2, out, meta, iter_id, phase)

    def _debug_ctdet(self, inp, batch, out, meta, iter_id, phase):
        opt = self.opt
        hm = out["hm"].sigmoid()
        reg = out.get("reg") if opt.reg_offset else None
        dets = _np(D.ctdet_decode(hm, out["wh"], reg,
                                  cat_spec_wh=opt.cat_spec_wh, k=opt.K))
        dets[:, :, :4] *= opt.down_ratio
        m0 = meta[0] if meta else {}
        gt = np.array(m0.get("gt_det", np.zeros((1, 6), np.float32)))
        gt = gt.reshape(-1, dets.shape[2]).copy()
        gt[:, :4] *= opt.down_ratio

        dbg = self._debugger()
        img = self._first_image(inp, batch)
        dbg.add_blend_img(img, dbg.gen_colormap(_np(hm[0])), "pred_hm")
        dbg.add_blend_img(img, dbg.gen_colormap(_np(batch["hm"][0])),
                          "gt_hm")
        dbg.add_img(img, img_id="out_pred")
        for k in range(len(dets[0])):
            if dets[0, k, 4] > opt.center_thresh:
                dbg.add_coco_bbox(dets[0, k, :4], dets[0, k, -1],
                                  dets[0, k, 4], img_id="out_pred")
        dbg.add_img(img, img_id="out_gt")
        for k in range(len(gt)):
            if gt[k, 4] > opt.center_thresh:
                dbg.add_coco_bbox(gt[k, :4], gt[k, -1], gt[k, 4],
                                  img_id="out_gt")
        self._emit(dbg, phase, iter_id)

    def _pose_dets(self, out):
        opt = self.opt
        hm = out["hm"].sigmoid()
        reg = out.get("reg") if opt.reg_offset else None
        hm_hp = out["hm_hp"].sigmoid() if opt.hm_hp and "hm_hp" in out \
            else None
        hp_off = out.get("hp_offset") if opt.reg_hp_offset else None
        dets = _np(D.multi_pose_decode(hm, out["wh"], out["hps"], reg=reg,
                                       hm_hp=hm_hp, hp_offset=hp_off,
                                       k=opt.K))
        return hm, hm_hp, dets

    def _debug_multi_pose(self, inp, batch, out, meta, iter_id, phase):
        opt = self.opt
        hm, hm_hp, dets = self._pose_dets(out)
        dets[:, :, :4] *= opt.down_ratio
        dets[:, :, 5:39] *= opt.down_ratio

        dbg = self._debugger()
        img = self._first_image(inp, batch)
        dbg.add_blend_img(img, dbg.gen_colormap(_np(hm[0])), "pred_hm")
        dbg.add_blend_img(img, dbg.gen_colormap(_np(batch["hm"][0])),
                          "gt_hm")
        dbg.add_img(img, img_id="out_pred")
        for k in range(len(dets[0])):
            if dets[0, k, 4] > opt.center_thresh:
                dbg.add_coco_bbox(dets[0, k, :4], dets[0, k, -1],
                                  dets[0, k, 4], img_id="out_pred")
                dbg.add_coco_hp(dets[0, k, 5:39], img_id="out_pred")
        if hm_hp is not None and "hm_hp" in batch:
            dbg.add_blend_img(img, dbg.gen_colormap(_np(hm_hp[0])),
                              "pred_hmhp")
            dbg.add_blend_img(img, dbg.gen_colormap(_np(batch["hm_hp"][0])),
                              "gt_hmhp")
        self._emit(dbg, phase, iter_id)

    def _ddd_dets(self, out):
        """ddd_decode of the raw heads (the JAX hooks pass the depth head
        untransformed, as its trainer's debug does)."""
        opt = self.opt
        hm = out["hm"].sigmoid()
        wh = out.get("wh") if opt.reg_bbox else None
        reg = out.get("reg") if opt.reg_offset else None
        return hm, _np(D.ddd_decode(hm, out["rot"], out["dep"], out["dim"],
                                    wh=wh, reg=reg, k=opt.K))

    def _debug_ddd(self, inp, batch, out, meta, iter_id, phase):
        opt = self.opt
        hm, dets = self._ddd_dets(out)
        m0 = meta[0] if meta else {}
        dbg = self._debugger()
        img = self._first_image(inp, batch)
        dbg.add_blend_img(img, dbg.gen_colormap(_np(hm[0])), "hm_pred")
        dbg.add_blend_img(img, dbg.gen_colormap(_np(batch["hm"][0])),
                          "hm_gt")
        dbg.add_ct_detection(img, dets[0], show_box=opt.reg_bbox,
                             center_thresh=opt.center_thresh,
                             img_id="det_pred")
        if "calib" in m0:
            calib = np.asarray(m0["calib"])[None]
            dets_pred = PP.ddd_post_process(
                dets[0:1].copy(), np.asarray(m0["c"])[None],
                np.asarray([m0["s"]]), calib, opt)
            dbg.add_3d_detection(img, dets_pred[0], calib[0],
                                 center_thresh=opt.center_thresh,
                                 img_id="add_pred")
            dbg.add_bird_view(dets_pred[0], center_thresh=opt.center_thresh,
                              img_id="bird_pred")
        self._emit(dbg, phase, iter_id)

    def _debug_exdet(self, inp, batch, out, meta, iter_id, phase):
        opt = self.opt
        hms = {p: out["hm_" + p].sigmoid() for p in ("t", "l", "b", "r",
                                                      "c")}
        dets = _np(D.exct_decode(hms["t"], hms["l"], hms["b"], hms["r"],
                                 hms["c"], k=opt.K, num_dets=opt.K))
        dets[:, :, :4] *= opt.down_ratio
        dbg = self._debugger()
        img = self._first_image(inp, batch)
        pred_hm = np.zeros(img.shape, dtype=np.uint8)
        gt_hm = np.zeros(img.shape, dtype=np.uint8)
        for p in ("t", "l", "b", "r", "c"):
            pred = dbg.gen_colormap(_np(hms[p][0]))
            gt = dbg.gen_colormap(_np(batch["hm_" + p][0]))
            if p != "c":
                pred_hm = np.maximum(pred_hm, pred)
                gt_hm = np.maximum(gt_hm, gt)
            if p == "c" or opt.debug > 2:
                dbg.add_blend_img(img, pred, "pred_{}".format(p))
                dbg.add_blend_img(img, gt, "gt_{}".format(p))
        dbg.add_blend_img(img, pred_hm, "pred")
        dbg.add_blend_img(img, gt_hm, "gt")
        dbg.add_img(img, img_id="out")
        for k in range(len(dets[0])):
            if dets[0, k, 4] > 0.1:
                dbg.add_coco_bbox(dets[0, k, :4], dets[0, k, -1],
                                  dets[0, k, 4], img_id="out")
        self._emit(dbg, phase, iter_id)

    # -- save_result ------------------------------------------------------
    def save_result(self, batch, meta, results, fwd_out=None):
        """Decode and back-project sample 0's predictions into `results`
        keyed by img_id (the reference's val loader has batch 1)."""
        if not meta or "img_id" not in meta[0]:
            return
        fn = getattr(self, "_save_" + self.task, None)
        if fn is None:
            return
        _, _, out = fwd_out if fwd_out is not None else self.forward(batch)
        m0 = meta[0]
        results[m0["img_id"]] = fn(out, m0)

    def _save_ctdet(self, out, m0):
        opt = self.opt
        hm = out["hm"].sigmoid()
        reg = out.get("reg") if opt.reg_offset else None
        dets = _np(D.ctdet_decode(hm, out["wh"], reg,
                                  cat_spec_wh=opt.cat_spec_wh, k=opt.K))
        h, w = hm.shape[1], hm.shape[2]
        return PP.ctdet_post_process(
            dets[0:1].copy(), np.asarray(m0["c"])[None],
            np.asarray([m0["s"]]), h, w, opt.num_classes)[0]

    def _save_ddd(self, out, m0):
        _, dets = self._ddd_dets(out)
        calib = np.asarray(m0["calib"])[None]
        return PP.ddd_post_process(
            dets[0:1].copy(), np.asarray(m0["c"])[None],
            np.asarray([m0["s"]]), calib, self.opt)[0]

    def _save_multi_pose(self, out, m0):
        hm, _, dets = self._pose_dets(out)
        h, w = hm.shape[1], hm.shape[2]
        return PP.multi_pose_post_process(
            dets[0:1].copy(), np.asarray(m0["c"])[None],
            np.asarray([m0["s"]]), h, w)[0]
