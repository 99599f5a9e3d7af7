"""Omni3D AP evaluation in 2D and 3D, COCOeval's arithmetic in numpy (the
port's copy of ``threedod/evaluation/omni3d_eval.py``, after
cubercnn/evaluation/omni3d_evaluation.py):

* ``Omni3DParams`` (:1020-1086): 2D IoU thresholds .5:.05:.95, 3D ones
  .05:.05:.50, 3D "areas" by depth, all/near/medium/far;
* ``Omni3DEval.evaluate`` (:1369-1562): the greedy matcher with ignores,
  mergesort tie-breaking, and proximity evaluation for non-exhaustively
  annotated datasets;
* ``accumulate`` (:1174-1311) and ``summarize`` (:1564-1706).

The 2D IoU is numpy (pycocotools' ``maskUtils.iou`` for boxes). The 3D IoU
runs in torch on ``device`` (``geometry/iou3d.py``): every (image, category)
block's pairs in one batched call.
"""
from __future__ import annotations

import datetime
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..geometry.iou3d import box3d_overlap, iou3d_pairs

logger = logging.getLogger(__name__)


def iou_2d_xywh(dts, gts) -> np.ndarray:
    """``maskUtils.iou`` for XYWH boxes: (D, 4) x (G, 4) -> (D, G)."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    d = np.asarray(dts, np.float64)
    g = np.asarray(gts, np.float64)
    x1 = np.maximum(d[:, None, 0], g[None, :, 0])
    y1 = np.maximum(d[:, None, 1], g[None, :, 1])
    x2 = np.minimum(d[:, None, 0] + d[:, None, 2], g[None, :, 0] + g[None, :, 2])
    y2 = np.minimum(d[:, None, 1] + d[:, None, 3], g[None, :, 1] + g[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_d = (d[:, 2] * d[:, 3])[:, None]
    area_g = (g[:, 2] * g[:, 3])[None, :]
    union = area_d + area_g - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def iou_3d_corners(d_corners, g_corners, device="cpu") -> np.ndarray:
    """(D, 8, 3) x (G, 8, 3) corners -> the IoU3D matrix; a non-finite or a
    zero-volume box scores 0."""
    if len(d_corners) == 0 or len(g_corners) == 0:
        return np.zeros((len(d_corners), len(g_corners)))
    d = torch.as_tensor(np.asarray(d_corners, np.float32), device=device)
    g = torch.as_tensor(np.asarray(g_corners, np.float32), device=device)
    return box3d_overlap(d, g)[1].cpu().numpy()


class Omni3DParams:
    """Evaluation parameters (reference omni3d_evaluation.py:1020-1086)."""

    def __init__(self, mode: str = "2D"):
        self.imgIds: list = []
        self.catIds: list = []
        self.recThrs = np.linspace(0.0, 1.00, 101, endpoint=True)
        self.maxDets = [1, 10, 100]
        if mode == "2D":
            self.iouThrs = np.linspace(0.5, 0.95, 10, endpoint=True)
            self.areaRng = [[0, 1e10], [0, 32**2], [32**2, 96**2], [96**2, 1e10]]
            self.areaRngLbl = ["all", "small", "medium", "large"]
        elif mode == "3D":
            self.iouThrs = np.linspace(0.05, 0.5, 10, endpoint=True)
            self.areaRng = [[0, 1e5], [0, 10], [10, 35], [35, 1e5]]
            self.areaRngLbl = ["all", "near", "medium", "far"]
        else:
            raise ValueError(f"mode {mode} not supported")
        self.useCats = 1
        self.mode = mode
        self.proximity_thresh = 0.3


class Omni3DEval:
    """COCOeval-compatible evaluator over plain gt/dt record lists.

    gts: list of dicts with keys {id, image_id, category_id, bbox (XYWH),
      area, depth, ignore2D, ignore3D, bbox3D (8x3 corners)}.
    dts: list of dicts with keys {image_id, category_id, bbox (XYWH), score,
      depth, area, bbox3D}.
    """

    def __init__(self, gts: List[dict], dts: List[dict], mode: str = "2D", eval_prox: bool = False,
                 device="cpu"):
        self.mode = mode
        self.device = torch.device(device)
        self.eval_prox = eval_prox
        self.params = Omni3DParams(mode)
        self._raw_gts = gts
        self._raw_dts = dts

        self.params.imgIds = sorted({g["image_id"] for g in gts} | {d["image_id"] for d in dts})
        self.params.catIds = sorted({g["category_id"] for g in gts})

        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for i, g in enumerate(gts):
            g.setdefault("id", i + 1)
            g.setdefault("ignore2D", g.get("ignore", False))
            g.setdefault("ignore3D", g.get("ignore", False))
            self._gts[g["image_id"], g["category_id"]].append(g)
        for i, d in enumerate(dts):
            d.setdefault("id", i + 1)
            if "area" not in d:
                d["area"] = d["bbox"][2] * d["bbox"][3]
            self._dts[d["image_id"], d["category_id"]].append(d)

        self.evalImgs: list = []
        self._iou3d_cache: Dict[tuple, np.ndarray] = {}
        self.eval: dict = {}
        self.stats: np.ndarray = np.array([])
        self.evals_per_cat_area: Optional[dict] = None

    # ------------------------------------------------------------------
    def computeIoU(self, imgId, catId):
        p = self.params
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 and len(dt) == 0:
            return [], None

        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds][: p.maxDets[-1]]

        if self.mode == "2D":
            ious = iou_2d_xywh([d["bbox"] for d in dt], [g["bbox"] for g in gt])
        elif len(dt) > 0 and len(gt) > 0:
            cached = self._iou3d_cache.get((imgId, catId))
            if cached is not None:
                ious = cached
            else:
                ious = iou_3d_corners(
                    np.asarray([d["bbox3D"] for d in dt]),
                    np.asarray([g["bbox3D"] for g in gt]),
                    self.device,
                )
        else:
            ious = []

        in_prox = None
        if self.eval_prox:
            ious2d = iou_2d_xywh([d["bbox"] for d in dt], [g["bbox"] for g in gt])
            in_prox = ious2d > p.proximity_thresh if not isinstance(ious2d, list) else []
        return ious, in_prox

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        p = self.params
        gt = self._gts[imgId, catId]
        dt = self._dts[imgId, catId]
        if len(gt) == 0 and len(dt) == 0:
            return None

        flag_range = "area" if self.mode == "2D" else "depth"
        flag_ignore = "ignore2D" if self.mode == "2D" else "ignore3D"

        for g in gt:
            g["_ignore"] = int(
                bool(g[flag_ignore]) or g[flag_range] < aRng[0] or g[flag_range] > aRng[1]
            )

        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]

        ious_full, in_prox_full = self.ious[imgId, catId]
        ious = ious_full[:, gtind] if len(ious_full) > 0 else ious_full
        if self.eval_prox:
            in_prox = in_prox_full[:, gtind] if len(in_prox_full) > 0 else in_prox_full

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))

        if len(ious) != 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou = min(t, 1 - 1e-10)
                    m = -1
                    for gind in range(G):
                        if self.eval_prox and not in_prox[dind, gind]:
                            continue
                        if gtm[tind, gind] > 0:
                            continue
                        if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]

        a = np.array(
            [d[flag_range] < aRng[0] or d[flag_range] > aRng[1] for d in dt]
        ).reshape((1, D))
        dtIg = np.logical_or(dtIg, np.logical_and(dtm == 0, np.repeat(a, T, 0)))
        if self.eval_prox and len(in_prox) > 0:
            dt_far = in_prox.any(1) == 0
            dtIg = np.logical_or(dtIg, np.repeat(dt_far.reshape((1, D)), T, 0))

        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    def _precompute_ious_3d(self):
        """Every (image, category) block's IoU3D in one batched call of
        ``iou3d_pairs`` on the device, over the pairs in the order
        ``box3d_overlap`` gives them."""
        p = self.params
        blocks, d_list, g_list = [], [], []
        for imgId in p.imgIds:
            for catId in p.catIds:
                gt = self._gts[imgId, catId]
                dt = self._dts[imgId, catId]
                if not gt or not dt:
                    continue
                inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
                dt = [dt[i] for i in inds][: p.maxDets[-1]]
                dc = np.asarray([d["bbox3D"] for d in dt], np.float32)
                gc = np.asarray([g["bbox3D"] for g in gt], np.float32)
                blocks.append(((imgId, catId), len(dt), len(gt)))
                d_list.append(np.repeat(dc, len(gt), axis=0))
                g_list.append(np.tile(gc, (len(dt), 1, 1)))
        if not blocks:
            return
        d_pairs = torch.as_tensor(np.concatenate(d_list), device=self.device)
        g_pairs = torch.as_tensor(np.concatenate(g_list), device=self.device)
        iou = iou3d_pairs(d_pairs, g_pairs)[1].cpu().numpy()
        off = 0
        for key, nd, ng in blocks:
            self._iou3d_cache[key] = iou[off: off + nd * ng].reshape(nd, ng)
            off += nd * ng

    def evaluate(self):
        tic = time.time()
        p = self.params
        self._iou3d_cache: Dict[tuple, np.ndarray] = {}
        if self.mode == "3D":
            self._precompute_ious_3d()
        self.ious = {
            (imgId, catId): self.computeIoU(imgId, catId)
            for imgId in p.imgIds
            for catId in p.catIds
        }
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(imgId, catId, areaRng, maxDet)
            for catId in p.catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds
        ]
        self._paramsEval = p
        logger.info("evaluate() DONE (t=%.2fs).", time.time() - tic)

    # ------------------------------------------------------------------
    def accumulate(self, p=None):
        assert self.evalImgs, "run evaluate() first"
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T, R, K, A, M = (
            len(p.iouThrs), len(p.recThrs), len(p.catIds), len(p.areaRng), len(p.maxDets),
        )
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        _pe = self._paramsEval
        I0 = len(_pe.imgIds)
        A0 = len(_pe.areaRng)
        setK = set(_pe.catIds)
        setA = set(map(tuple, _pe.areaRng))
        setM = set(_pe.maxDets)
        setI = set(_pe.imgIds)
        catid_list = [k for k in p.catIds if k in setK]
        k_list = [n for n, k in enumerate(p.catIds) if k in setK]
        m_list = [m for m in p.maxDets if m in setM]
        a_list = [n for n, a in enumerate(map(tuple, p.areaRng)) if a in setA]
        i_list = [n for n, i in enumerate(p.imgIds) if i in setI]

        has_pre = self.evals_per_cat_area is not None
        evals_per_cat_area = self.evals_per_cat_area if has_pre else {}

        for k, (k0, catId) in enumerate(zip(k_list, catid_list)):
            Nk = k0 * A0 * I0
            for a, a0 in enumerate(a_list):
                Na = a0 * I0
                if has_pre:
                    E = evals_per_cat_area[(catId, a)]
                else:
                    E = [self.evalImgs[Nk + Na + i] for i in i_list]
                    E = [e for e in E if e is not None]
                    evals_per_cat_area[(catId, a)] = E
                if len(E) == 0:
                    continue
                for m, maxDet in enumerate(m_list):
                    dtScores = np.concatenate([e["dtScores"][:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate([e["dtMatches"][:, :maxDet] for e in E], axis=1)[:, inds]
                    dtIg = np.concatenate([e["dtIgnore"][:, :maxDet] for e in E], axis=1)[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(np.logical_not(dtm), np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros((R,))
                        ss = np.zeros((R,))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        for ri, pi in enumerate(inds_r):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        precision[t, :, k, a, m] = np.array(q)
                        scores[t, :, k, a, m] = np.array(ss)

        self.evals_per_cat_area = evals_per_cat_area
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    # ------------------------------------------------------------------
    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.isclose(iouThr, p.iouThrs))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.isclose(iouThr, p.iouThrs))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        if len(s[s > -1]) == 0:
            return -1.0
        return float(np.mean(s[s > -1]))

    def summarize(self):
        """stats vector; in 3D mode includes AP15/25/50 and near/med/far."""
        if not self.eval:
            raise RuntimeError("run accumulate() first")
        if self.mode == "2D":
            stats = np.zeros((12,))
            stats[0] = self._summarize(1)
            stats[1] = self._summarize(1, iouThr=0.5, maxDets=self.params.maxDets[2])
            stats[2] = self._summarize(1, iouThr=0.75, maxDets=self.params.maxDets[2])
            stats[3] = self._summarize(1, areaRng="small", maxDets=self.params.maxDets[2])
            stats[4] = self._summarize(1, areaRng="medium", maxDets=self.params.maxDets[2])
            stats[5] = self._summarize(1, areaRng="large", maxDets=self.params.maxDets[2])
            stats[6] = self._summarize(0, maxDets=self.params.maxDets[0])
            stats[7] = self._summarize(0, maxDets=self.params.maxDets[1])
            stats[8] = self._summarize(0, maxDets=self.params.maxDets[2])
            stats[9] = self._summarize(0, areaRng="small", maxDets=self.params.maxDets[2])
            stats[10] = self._summarize(0, areaRng="medium", maxDets=self.params.maxDets[2])
            stats[11] = self._summarize(0, areaRng="large", maxDets=self.params.maxDets[2])
        else:
            stats = np.zeros((12,))
            stats[0] = self._summarize(1)  # AP3D (mean over 0.05:0.05:0.50)
            stats[1] = self._summarize(1, iouThr=0.15, maxDets=self.params.maxDets[2])
            stats[2] = self._summarize(1, iouThr=0.25, maxDets=self.params.maxDets[2])
            stats[3] = self._summarize(1, iouThr=0.50, maxDets=self.params.maxDets[2])
            stats[4] = self._summarize(1, areaRng="near", maxDets=self.params.maxDets[2])
            stats[5] = self._summarize(1, areaRng="medium", maxDets=self.params.maxDets[2])
            stats[6] = self._summarize(1, areaRng="far", maxDets=self.params.maxDets[2])
            stats[7] = self._summarize(0, maxDets=self.params.maxDets[0])
            stats[8] = self._summarize(0, maxDets=self.params.maxDets[1])
            stats[9] = self._summarize(0, maxDets=self.params.maxDets[2])
            stats[10] = self._summarize(0, areaRng="near", maxDets=self.params.maxDets[2])
            stats[11] = self._summarize(0, areaRng="far", maxDets=self.params.maxDets[2])
        self.stats = stats
        return stats

    def per_category_ap(self) -> Dict[int, float]:
        """AP per category id (mean over IoU thresholds, area 'all')."""
        out = {}
        prec = self.eval["precision"]
        for k, cat in enumerate(self.params.catIds):
            s = prec[:, :, k, 0, -1]
            out[cat] = float(np.mean(s[s > -1])) if (s > -1).any() else -1.0
        return out
