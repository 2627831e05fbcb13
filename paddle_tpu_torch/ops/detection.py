"""The detection ops (counterpart of ``paddle_tpu/ops/detection.py``):
``deformable_conv``, ``matrix_nms``, ``multiclass_nms3``,
``generate_proposals``, ``distribute_fpn_proposals``, ``psroi_pool`` and
``yolo_loss``, with the reference's formulas (Deformable ConvNets, SOLOv2
matrix NMS, the Faster R-CNN RPN, FPN level assignment, R-FCN PS-RoI,
YOLOv3).

Where the reference selects or sorts on the host (per-class score
thresholds and ``np.argsort``, which is quicksort and not stable; the
FPN level assignment) the port makes the same numpy call on the same
values, so ties break the same way (bf16's through :func:`_argsort_desc`);
these host steps are part of the op on either device, never a fallback.
Everything else runs on the tensors' device, batched: ``matrix_nms``
computes its classes' decay matrices in ``[classes, n, n]`` passes and
``multiclass_nms3`` their greedy NMS in batched fixed points
(``parity.nms_keep``), where the reference loops over classes; the
classes go in chunks of at most :data:`NMS_CHUNK_ELEMS` elements a
matrix, so the memory stays bounded at any candidate count. Reference
deviations the port reproduces (ROADMAP R23, R24, R26):
``multiclass_nms3`` applies ``nms_eta`` once, ignores ``normalized`` in
its IoU and takes one image; ``matrix_nms`` takes one image. Not
reproduced (R28): the reference's ``multiclass_nms3`` raises on bf16
scores, where the port returns the rows of their f32 values.
"""
from __future__ import annotations

import numpy as np
import torch

from . import parity
from .registry import defop

__all__ = []


# elements a ``[classes, n, n]`` NMS intermediate of one chunk of classes
# may hold (128 MiB in f32); a class above it runs alone, as the
# reference's per-class loop would (its n^2)
NMS_CHUNK_ELEMS = 1 << 25


def _host(t):
    """``t`` on the host as numpy; bf16, which numpy lacks, widened to f32
    (exact)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _argsort_desc(s, dtype):
    """The reference's ``np.argsort(-s)`` (quicksort: ties break by the
    algorithm, and numpy's differs between dtypes) of host values ``s``
    read from a tensor of ``dtype``. numpy holds those values in ``dtype``
    itself, except bf16, which the reference's numpy sorts as ml_dtypes'
    bfloat16 with its generic quicksort and the port holds as exact f32:
    for it the same quicksort runs over 16-bit keys in bf16's order, so
    ties break the same way."""
    if dtype != torch.bfloat16:
        return np.argsort(-s)
    neg = -s.astype(np.float32) + np.float32(0)     # -0 as +0, as compared
    bits = (neg.view(np.uint32) >> 16).astype(np.uint16)
    return np.argsort(np.where(bits & 0x8000, ~bits, bits | 0x8000))


def _candidates(scores, threshold, background_label):
    """Each class's indices with a score above ``threshold`` (ascending)
    and their scores, read on the host in one transfer: ``{cls: (idx,
    s)}``, the reference's ``np.where(s > threshold)``, the scores in
    ``scores``' own dtype (bf16's as f32). numpy compares a Python float
    with its own float dtypes in that dtype, as torch does, but with
    ml_dtypes' bfloat16 in f32, where torch's bf16 compare would round the
    threshold to bf16."""
    wide = scores.float() if scores.dtype == torch.bfloat16 else scores
    hit = torch.nonzero(wide > threshold)
    # f64 holds every index below 2^53 and every score of a 16- or 32-bit
    # dtype exactly
    vals = _host(torch.cat([hit.double(), scores[hit[:, 0], hit[:, 1]][
        :, None].double()], 1))
    hit = vals[:, :2].astype(np.int64)
    vals = vals[:, 2].astype(np.float32 if scores.dtype == torch.bfloat16
                             else _host(scores[:0]).dtype)
    out = {}
    for cls in np.unique(hit[:, 0]):
        if cls == background_label:
            continue
        rows = hit[:, 0] == cls
        out[int(cls)] = (hit[rows, 1], vals[rows])
    return out


def _chunks(lens):
    """Consecutive runs of class positions whose padded ``[k, n_max,
    n_max]`` block stays within :data:`NMS_CHUNK_ELEMS` (a class above it
    alone)."""
    out, cur, m = [], [], 0
    for k, n in enumerate(lens):
        grown = max(m, n)
        if cur and (len(cur) + 1) * grown * grown > NMS_CHUNK_ELEMS:
            out.append(cur)
            cur, grown = [], n
        cur.append(k)
        m = grown
    return out + [cur] if cur else out


def _padded(lists, device):
    """Index lists as one padded ``[len(lists), n_max]`` long tensor."""
    n = max(len(x) for x in lists)
    pad = np.zeros((len(lists), n), np.int64)
    for i, x in enumerate(lists):
        pad[i, :len(x)] = x
    return torch.as_tensor(pad, device=device)


@defop("deformable_conv")
def _deformable_conv(x, offset, weight, mask=None, stride=(1, 1),
                     padding=(0, 0), dilation=(1, 1), deformable_groups=1,
                     groups=1, im2col_step=64):
    """Deformable conv v1 / v2 without a bias: ``parity``'s
    ``deform_conv2d`` body (x ``[N, C, H, W]``; offset ``[N, 2 * dg * kh *
    kw, Ho, Wo]``; weight ``[Cout, C / groups, kh, kw]``; mask ``[N, dg *
    kh * kw, Ho, Wo]``)."""
    return parity._deform_conv2d.__wrapped__(
        x, offset, weight, None, stride, padding, dilation,
        deformable_groups, groups, mask)


def _iou_matrix(boxes, normalized=True):
    """``iou[..., i, j]`` of boxes ``[..., n, 4]`` (+1 pixel for pixel
    coordinates, the reference's formula)."""
    off = 0.0 if normalized else 1.0
    area = (boxes[..., 2] - boxes[..., 0] + off) * (
        boxes[..., 3] - boxes[..., 1] + off)
    x0 = torch.maximum(boxes[..., :, None, 0], boxes[..., None, :, 0])
    y0 = torch.maximum(boxes[..., :, None, 1], boxes[..., None, :, 1])
    x1 = torch.minimum(boxes[..., :, None, 2], boxes[..., None, :, 2])
    y1 = torch.minimum(boxes[..., :, None, 3], boxes[..., None, :, 3])
    inter = torch.clamp(x1 - x0 + off, min=0) * torch.clamp(y1 - y0 + off,
                                                            min=0)
    return inter / torch.clamp(area[..., :, None] + area[..., None, :]
                               - inter, min=1e-10)


def _empty_rows(dev):
    return torch.zeros((0, 6), dtype=torch.float32, device=dev)


def _matrix_decay(bboxes, scores, classes, orders, normalized, use_gaussian,
                  gaussian_sigma):
    """The decayed scores and boxes of one chunk of classes, ``[k, n_max,
    5]`` on the host (one read)."""
    idx = _padded(orders, bboxes.device)                  # [k, n]
    cls_t = torch.as_tensor(classes, device=bboxes.device)
    b = bboxes[idx]                                       # [k, n, 4]
    sv = scores[cls_t[:, None], idx]
    iou = torch.triu(_iou_matrix(b, normalized), 1)
    # comp[i]: how suppressed suppressor i is itself (the SOLOv2
    # compensation term); padded boxes sit last and never suppress
    comp = iou.amax(-2)
    upper = torch.ones(iou.shape[-2:], dtype=torch.bool,
                       device=iou.device).triu(1)
    if use_gaussian:
        decay = torch.exp(-(iou ** 2 - comp[..., :, None] ** 2)
                          / gaussian_sigma)
    else:
        decay = (1 - iou) / torch.clamp(1 - comp[..., :, None], min=1e-10)
    decay = torch.where(upper, decay, torch.ones((), dtype=decay.dtype,
                                                 device=decay.device))
    return _host(torch.cat([(sv * decay.amin(-2))[..., None], b], -1))


@defop("matrix_nms")
def _matrix_nms(bboxes, scores, score_threshold=0.05, post_threshold=0.0,
                nms_top_k=-1, keep_top_k=-1, use_gaussian=False,
                gaussian_sigma=2.0, normalized=True, background_label=-1):
    """SOLOv2 matrix NMS of one image: bboxes ``[N, 4]``, scores ``[C,
    N]``. Returns ``[kept, 6]`` rows (label, decayed score, x0, y0, x1, y1)
    and ``[kept]``. The classes' decays run in batched chunks
    (:func:`_chunks`); the host reads the candidates once and each chunk's
    decayed scores and boxes once."""
    C, N = scores.shape                 # one image (ValueError otherwise)
    cand = _candidates(scores, score_threshold, background_label)
    classes, orders = [], []
    for cls, (idx, s) in cand.items():
        order = idx[_argsort_desc(s, scores.dtype)]
        if nms_top_k > 0:
            order = order[:nms_top_k]
        classes.append(cls)
        orders.append(order)
    rows = []
    for chunk in _chunks([len(o) for o in orders]):
        both = _matrix_decay(bboxes, scores, [classes[k] for k in chunk],
                             [orders[k] for k in chunk], normalized,
                             use_gaussian, gaussian_sigma)
        for j, k in enumerate(chunk):
            live = both[j, :len(orders[k])]
            live = live[live[:, 0] > post_threshold]
            rows.append(np.concatenate([np.full((len(live), 1), classes[k]),
                                        live], 1))
    rows = [r for r in rows if len(r)]
    if not rows:
        return (_empty_rows(bboxes.device),
                torch.zeros((0,), dtype=torch.int32, device=bboxes.device))
    out = np.concatenate(rows).astype(np.float32)
    out = out[np.argsort(-out[:, 1])]
    if keep_top_k > 0:
        out = out[:keep_top_k]
    return (torch.as_tensor(out, device=bboxes.device),
            torch.as_tensor([len(out)], dtype=torch.int32,
                            device=bboxes.device))


@defop("multiclass_nms3")
def _multiclass_nms3(bboxes, scores, rois_num=None, score_threshold=0.05,
                     nms_top_k=-1, keep_top_k=100, nms_threshold=0.3,
                     normalized=True, nms_eta=1.0, background_label=-1):
    """Per-class hard NMS of one image (``rois_num`` is taken and
    ignored): bboxes ``[N, 4]`` or ``[N, C, 4]``, scores ``[C, N]``.
    Returns (``[kept, 6]`` rows, the kept boxes' indices, ``[kept]``).
    ``nms_eta < 1`` scales a threshold above 0.5 once, where Paddle
    decays it after every kept box (ROADMAP R23); the IoU is the
    reference ``nms``'s, whatever ``normalized`` says (R26). The classes'
    greedy NMS runs as one batched fixed point on the device a chunk of
    classes (:func:`_chunks`)."""
    C, N = scores.shape                 # one image (ValueError otherwise)
    cand = _candidates(scores, score_threshold, background_label)
    classes, sels, svals = [], [], []
    for cls, (sel, s) in cand.items():
        if nms_top_k > 0 and sel.size > nms_top_k:
            top = _argsort_desc(s, scores.dtype)[:nms_top_k]
            sel, s = sel[top], s[top]
        # the reference nms's own order: a stable sort of -score
        order = np.argsort(-s, kind="stable")
        classes.append(cls)
        sels.append(sel[order])
        svals.append(s[order])
    dev = bboxes.device
    if not classes:
        return (_empty_rows(dev), torch.zeros((0,), dtype=torch.int32,
                                              device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev))
    thresh = nms_threshold
    if nms_eta < 1.0 and thresh > 0.5:
        thresh *= nms_eta
    rows, indices = [], []
    for chunk in _chunks([len(x) for x in sels]):
        idx = _padded([sels[k] for k in chunk], dev)
        cls_t = torch.as_tensor([classes[k] for k in chunk], device=dev)
        b = bboxes[idx] if bboxes.dim() == 2 else bboxes[idx, cls_t[:, None]]
        lens = torch.as_tensor([len(sels[k]) for k in chunk], device=dev)
        valid = torch.arange(idx.shape[1], device=dev)[None] < lens[:, None]
        keep, _ = parity.nms_keep(parity.iou_overlaps(b, thresh), valid)
        both = _host(torch.cat([keep[..., None].to(b.dtype), b], -1))
        for j, k in enumerate(chunk):
            kept = np.where(both[j, :len(sels[k]), 0] > 0)[0]
            rows.append(np.concatenate([np.full((len(kept), 1), classes[k]),
                                        svals[k][kept, None].astype(
                                            np.float32),
                                        both[j, kept, 1:]], 1))
            indices.append(sels[k][kept])
    out = np.concatenate(rows).astype(np.float32)
    indices = np.concatenate(indices)
    order = np.argsort(-out[:, 1])
    if keep_top_k > 0:
        order = order[:keep_top_k]
    out = out[order]
    return (torch.as_tensor(out, device=dev),
            torch.as_tensor(indices[order].astype(np.int32), device=dev),
            torch.as_tensor([len(out)], dtype=torch.int32, device=dev))


@defop("generate_proposals")
def _generate_proposals(scores, bbox_deltas, im_shape, anchors, variances,
                        pre_nms_top_n=6000, post_nms_top_n=1000,
                        nms_thresh=0.5, min_size=0.1, eta=1.0,
                        pixel_offset=True):
    """RPN proposals of one image and level (Faster R-CNN): decode the
    anchors' deltas, clip to the image, drop boxes under ``min_size``,
    keep the ``pre_nms_top_n`` best (the reference's host quicksort of
    the scores), NMS on the device, keep ``post_nms_top_n``. scores
    ``[A, H, W]``, bbox_deltas ``[4 A, H, W]``, anchors and variances
    ``[H, W, A, 4]``."""
    A = scores.shape[0]
    sc = scores.permute(1, 2, 0).reshape(-1)
    deltas = bbox_deltas.reshape(A, 4, *bbox_deltas.shape[1:]).permute(
        2, 3, 0, 1).reshape(-1, 4)
    props = parity._box_coder.__wrapped__(
        anchors.reshape(-1, 4), variances.reshape(-1, 4), deltas,
        code_type="decode_center_size", box_normalized=not pixel_offset)
    im_shape = parity._like(im_shape, props)
    off = 1.0 if pixel_offset else 0.0
    hmax, wmax = im_shape[0] - off, im_shape[1] - off
    zero = torch.zeros((), dtype=props.dtype, device=props.device)
    props = torch.stack([torch.clamp(props[:, 0], zero, wmax),
                         torch.clamp(props[:, 1], zero, hmax),
                         torch.clamp(props[:, 2], zero, wmax),
                         torch.clamp(props[:, 3], zero, hmax)], 1)
    ws = props[:, 2] - props[:, 0] + off
    hs = props[:, 3] - props[:, 1] + off
    valid = (ws >= min_size) & (hs >= min_size)
    sc_np, valid = _host(torch.stack([sc, valid.to(sc.dtype)]))
    idx = np.where(valid > 0)[0]
    idx = idx[_argsort_desc(sc_np[idx], sc.dtype)]
    if pre_nms_top_n > 0:
        idx = idx[:pre_nms_top_n]
    idx_t = torch.as_tensor(idx, device=props.device)
    cand, cand_sc = props[idx_t], sc[idx_t]
    keep = parity._nms.__wrapped__(cand, cand_sc, nms_thresh)
    if post_nms_top_n > 0:
        keep = keep[:post_nms_top_n]
    return cand[keep], cand_sc[keep], torch.as_tensor(
        [keep.shape[0]], dtype=torch.int32, device=props.device)


@defop("distribute_fpn_proposals")
def _distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                              refer_scale, rois_num=None, pixel_offset=True):
    """FPN level assignment (Lin 2017) on the host, as the reference
    assigns: ``floor(refer + log2(sqrt(area) / refer_scale))`` clamped to
    ``[min, max]``. Returns each level's rois (f32, on the rois' device)
    and the restore index."""
    off = 1.0 if pixel_offset else 0.0
    r = _host(fpn_rois)
    scale = np.sqrt(np.maximum((r[:, 2] - r[:, 0] + off)
                               * (r[:, 3] - r[:, 1] + off), 1e-10))
    lvl = np.floor(refer_level + np.log2(scale / refer_scale + 1e-8))
    lvl = np.clip(lvl, min_level, max_level).astype(int)
    outs, order = [], []
    dev = fpn_rois.device
    for level in range(min_level, max_level + 1):
        sel = np.where(lvl == level)[0]
        order.extend(sel.tolist())
        outs.append(fpn_rois[torch.as_tensor(sel, device=dev)].to(
            torch.float32))
    restore = np.empty(len(r), np.int32)
    restore[np.asarray(order, int)] = np.arange(len(r))
    return (*outs, torch.as_tensor(restore, device=dev))


@defop("psroi_pool")
def _psroi_pool(x, boxes, boxes_num, pooled_height=1, pooled_width=1,
                output_channels=1, spatial_scale=1.0):
    """Position-sensitive RoI pooling (R-FCN): output bin (i, j) of
    channel c averages 2 x 2 bilinear samples of input channel ``c * ph *
    pw + i * pw + j`` over the bin; all rois in one batched gather."""
    ph, pw, ratio = pooled_height, pooled_width, 2
    bi = parity.roi_batch_index(boxes_num, x.device)
    x0 = boxes[:, 0] * spatial_scale
    y0 = boxes[:, 1] * spatial_scale
    x1 = boxes[:, 2] * spatial_scale
    y1 = boxes[:, 3] * spatial_scale
    bh = parity.quot(torch.clamp(y1 - y0, min=0.1), ph)
    bw = parity.quot(torch.clamp(x1 - x0, min=0.1), pw)
    ys, xs = parity._roi_grid(y0, x0, bh, bw, ph, pw, ratio,
                              torch.promote_types(x.dtype, boxes.dtype))
    samp = parity.bilinear_gather(x, bi[:, None, None], ys, xs)
    R, C = samp.shape[0], samp.shape[-1]
    samp = samp.reshape(R, ph, ratio, pw, ratio, C).mean((2, 4))
    dev = x.device
    chan = (torch.arange(output_channels, device=dev)[None, None, :]
            * (ph * pw)
            + torch.arange(ph, device=dev)[:, None, None] * pw
            + torch.arange(pw, device=dev)[None, :, None])   # [ph, pw, oc]
    out = torch.gather(samp, 3, chan.expand(R, -1, -1, -1))
    return out.permute(0, 3, 1, 2)


def _bce(logit, target):
    return (torch.clamp(logit, min=0) - logit * target
            + torch.log1p(torch.exp(-logit.abs())))


@defop("yolo_loss")
def _yolo_loss(x, gt_box, gt_label, gt_score=None, anchors=(),
               anchor_mask=(), class_num=1, ignore_thresh=0.7,
               downsample_ratio=32, use_label_smooth=False, scale_x_y=1.0):
    """YOLOv3 training loss (Redmon 2018): coordinate BCE / MSE on the
    responsible anchors, objectness BCE with an ignore region, class BCE.
    x ``[N, mask * (5 + cls), H, W]``; gt_box ``[N, B, 4]`` (cx, cy, w,
    h, relative); gt_label ``[N, B]``. The buffers are in x's and the
    boxes' promoted dtype (the reference's are f64 under x64)."""
    n, _, h, w = x.shape
    na = len(anchor_mask)
    xr = x.reshape(n, na, 5 + class_num, h, w)
    dt = torch.promote_types(x.dtype, gt_box.dtype)
    dev = x.device
    in_size = h * downsample_ratio
    all_np = np.asarray(anchors, np.float32).reshape(-1, 2)
    all_anchors = torch.as_tensor(all_np, device=dev)
    mask_anchors = torch.as_tensor(all_np[list(anchor_mask)], device=dev)

    tobj = xr[:, :, 4]
    gx = torch.arange(w, device=dev)[None, None, None, :]
    gy = torch.arange(h, device=dev)[None, None, :, None]
    px = (torch.sigmoid(xr[:, :, 0]) + gx) / w
    py = (torch.sigmoid(xr[:, :, 1]) + gy) / h
    pw = torch.exp(xr[:, :, 2]) * mask_anchors[None, :, 0, None,
                                               None] / in_size
    phh = torch.exp(xr[:, :, 3]) * mask_anchors[None, :, 1, None,
                                                None] / in_size

    gt_valid = (gt_box[:, :, 2] > 0) & (gt_box[:, :, 3] > 0)      # [N, B]
    gw = gt_box[:, :, 2] * in_size
    gh = gt_box[:, :, 3] * in_size
    # the responsible anchor (over all anchors) of each box, by wh IoU
    inter = (torch.minimum(gw[..., None], all_anchors[None, None, :, 0])
             * torch.minimum(gh[..., None], all_anchors[None, None, :, 1]))
    union = (gw * gh)[..., None] + (all_anchors[:, 0] * all_anchors[:, 1]
                                    )[None, None] - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-10), -1)
    gi = torch.clamp((gt_box[:, :, 0] * w).int(), 0, w - 1).long()
    gj = torch.clamp((gt_box[:, :, 1] * h).int(), 0, h - 1).long()

    loss = torch.zeros((n,), dtype=torch.float32, device=dev)
    obj_target = torch.zeros((n, na, h * w), dtype=dt, device=dev)
    score_w = gt_score if gt_score is not None else torch.ones(
        gt_box.shape[:2], dtype=torch.float32, device=dev)
    bsel = torch.arange(n, device=dev)[:, None]
    onehot = torch.nn.functional.one_hot(gt_label.long(), class_num).to(dt)
    if use_label_smooth:
        delta = 1.0 / max(class_num, 1)
        onehot = onehot * (1 - delta) + delta / 2
    cls_all = xr.permute(0, 1, 3, 4, 2)
    for a_idx, a_global in enumerate(anchor_mask):
        wgt = (gt_valid & (best == a_global)).float() * score_w
        scale_wh = 2.0 - gt_box[:, :, 2] * gt_box[:, :, 3]
        sx = gt_box[:, :, 0] * w - gi
        sy = gt_box[:, :, 1] * h - gj
        tw = torch.log(torch.clamp(gw / mask_anchors[a_idx, 0], min=1e-9))
        th = torch.log(torch.clamp(gh / mask_anchors[a_idx, 1], min=1e-9))
        cell = xr[bsel, a_idx, :, gj, gi]                   # [N, B, 5 + cls]
        loss = loss + torch.sum(wgt * scale_wh * (
            _bce(cell[..., 0], sx) + _bce(cell[..., 1], sy)
            + torch.square(cell[..., 2] - tw)
            + torch.square(cell[..., 3] - th)), 1)
        cls_logits = cls_all[bsel, a_idx, gj, gi, 5:]
        loss = loss + torch.sum(wgt[..., None] * _bce(cls_logits, onehot),
                                (1, 2))
        plane = obj_target[:, a_idx].scatter_reduce(
            1, gj * w + gi, wgt.to(dt), "amax", include_self=True)
        obj_target = torch.cat([obj_target[:, :a_idx], plane[:, None],
                                obj_target[:, a_idx + 1:]], 1)
    obj_target = obj_target.reshape(n, na, h, w)

    # objectness: predictions overlapping a box above ignore_thresh are
    # ignored unless responsible
    gbx0 = (gt_box[:, :, 0] - gt_box[:, :, 2] / 2)[:, None, None, None, :]
    gbx1 = (gt_box[:, :, 0] + gt_box[:, :, 2] / 2)[:, None, None, None, :]
    gby0 = (gt_box[:, :, 1] - gt_box[:, :, 3] / 2)[:, None, None, None, :]
    gby1 = (gt_box[:, :, 1] + gt_box[:, :, 3] / 2)[:, None, None, None, :]
    px0 = (px - pw / 2)[..., None]
    px1 = (px + pw / 2)[..., None]
    py0 = (py - phh / 2)[..., None]
    py1 = (py + phh / 2)[..., None]
    ix = torch.clamp(torch.minimum(px1, gbx1) - torch.maximum(px0, gbx0),
                     min=0)
    iy = torch.clamp(torch.minimum(py1, gby1) - torch.maximum(py0, gby0),
                     min=0)
    inter_o = ix * iy
    area_p = pw[..., None] * phh[..., None]
    area_g = (gt_box[:, :, 2] * gt_box[:, :, 3])[:, None, None, None, :]
    iou_o = inter_o / torch.clamp(area_p + area_g - inter_o, min=1e-10)
    iou_o = torch.where(gt_valid[:, None, None, None, :], iou_o,
                        torch.zeros((), dtype=iou_o.dtype, device=dev))
    ignore = (iou_o.amax(-1) > ignore_thresh) & (obj_target < 0.5)
    obj_mask = torch.where(ignore, torch.zeros((), dtype=dt, device=dev),
                           torch.ones((), dtype=dt, device=dev))
    return loss + torch.sum(obj_mask * _bce(tobj, obj_target), (1, 2, 3))
