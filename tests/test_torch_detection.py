"""The detection slice and the surfaces around the rest of the op library,
the port against the JAX package on the CPU:

- ``vision.ops.DeformConv2D`` (v1 and v2) with the reference layer's
  ``state_dict`` carried across through ``vision_state_from_jax``:
  output and every gradient (f32 in both packages: 1e-5);
- the PP-YOLO and Faster R-CNN post-processing pipelines of
  ``chip_smoke.py`` at a small size (three YOLO heads -> ``yolo_box`` ->
  ``matrix_nms`` a image; five RPN levels -> ``generate_proposals`` -> the
  top proposals -> ``distribute_fpn_proposals`` -> ``roi_align`` ->
  ``box_coder`` -> ``multiclass_nms3``), each stage fed the same inputs in
  both packages: f64 values at 1e-9, kept rows equal;
- the greedy ``nms`` fixed point against a sequential numpy greedy NMS;
- matrix / multiclass NMS of bf16 and f16 scores past 256 / 2048
  candidates, and of many candidates a class in any class chunking;
- the reference's deviations (ROADMAP R21-R28: R21-R26 reproduced, R27
  and R28 not), one test each;
- ``paddle.fft`` (every function, values and the gradients of real
  losses of real inputs), ``TensorArray`` / ``SelectedRows``, the
  ``FLAGS_check_nan_inf`` / ``FLAGS_benchmark`` hooks (and that with both
  off no op reads a flag), ``text.viterbi_decode`` / ``ViterbiDecoder``.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.models import vision_state_from_jax
from paddle_tpu_torch.ops import parity
from paddle_tpu_torch.ops.registry import OPS as TOPS
from tools.eager_op_cases import _anchors, _boxes

torch.set_num_threads(2)
VAL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(autouse=True)
def on_cpu():
    prev = tdevice._state["device"]
    T.set_device("cpu")
    yield
    tdevice._state["device"] = prev


def _np(t):
    return np.asarray(t.numpy())


def _both(name, *args, **kwargs):
    """``name`` through both registries on the same numpy inputs."""
    def conv(P, a):
        return P.to_tensor(a) if isinstance(a, np.ndarray) else a

    outs = []
    for P, ops in ((J, JOPS), (T, TOPS)):
        out = ops[name].fn(*[conv(P, a) for a in args],
                           **{k: conv(P, v) for k, v in kwargs.items()})
        outs.append([_np(o) for o in out] if isinstance(out, (tuple, list))
                    else _np(out))
    return outs


def _same(j, t, **tol):
    for a, b in zip(j, t) if isinstance(j, list) else [(j, t)]:
        assert a.shape == b.shape, (a.shape, b.shape)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, **(tol or VAL))
        else:
            np.testing.assert_array_equal(b, a)


# -- DeformConv2D -------------------------------------------------------------

@pytest.mark.parametrize("v2,stride,groups,dg", [(False, 1, 1, 1),
                                                 (True, 2, 2, 2)])
def test_deform_conv2d_layer_from_the_reference_state_dict(v2, stride,
                                                           groups, dg):
    J.seed(3)
    jl = J.vision.ops.DeformConv2D(4, 6, 3, stride=stride, padding=1,
                                   deformable_groups=dg, groups=groups)
    arrays = {n: _np(p) for n, p in jl.state_dict().items()}
    tl = T.vision.ops.DeformConv2D(4, 6, 3, stride=stride, padding=1,
                                   deformable_groups=dg, groups=groups,
                                   device="cpu")
    missing, unexpected = tl.load_state_dict(vision_state_from_jax(arrays,
                                                                   tl))
    assert not missing and not unexpected
    assert list(tl.weight.shape) == [6, 4 // groups, 3, 3]
    rng = np.random.RandomState(0)
    ho = (7 + 2 - 3) // stride + 1
    x = rng.randn(2, 4, 7, 7).astype(np.float32)
    off = (rng.randn(2, 2 * dg * 9, ho, ho) * 0.8).astype(np.float32)
    mask = rng.uniform(0.1, 0.9, (2, dg * 9, ho, ho)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (2, 6, ho, ho)).astype(np.float32)
    res = []
    for P, layer in ((J, jl), (T, tl)):
        ins = [P.to_tensor(a, stop_gradient=False) for a in (x, off, mask)]
        out = layer(ins[0], ins[1], ins[2] if v2 else None)
        loss = (out * P.to_tensor(w)).sum()
        params = [layer.weight, layer.bias]
        grads = P.grad(loss, ins[:2 + v2] + params)
        res.append([_np(out)] + [_np(g) for g in grads])
    for k, (a, b) in enumerate(zip(*res)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                   err_msg=f"output {k}")


# -- nms: the fixed point is the greedy answer --------------------------------

def _greedy(boxes, scores, thr):
    order = np.argsort(-scores, kind="stable")
    b = boxes[order]
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    keep = []
    for i in range(len(b)):
        ok = True
        for j in keep:
            x0, y0 = max(b[i, 0], b[j, 0]), max(b[i, 1], b[j, 1])
            x1, y1 = min(b[i, 2], b[j, 2]), min(b[i, 3], b[j, 3])
            inter = max(x1 - x0, 0) * max(y1 - y0, 0)
            if inter / (area[i] + area[j] - inter + 1e-10) > thr:
                ok = False
                break
        if ok:
            keep.append(i)
    return order[keep]


@pytest.mark.parametrize("n,seed,thr", [(40, 0, 0.3), (200, 1, 0.5),
                                        (300, 2, 0.1)])
def test_nms_fixed_point_is_the_sequential_greedy(n, seed, thr):
    boxes = _boxes(n, seed, hi=60.0, wh=(4.0, 30.0))
    scores = np.random.RandomState(seed).rand(n)
    want = _greedy(boxes, scores, thr)
    got = _np(TOPS["nms"].fn(T.to_tensor(boxes), T.to_tensor(scores), thr))
    np.testing.assert_array_equal(got, want)
    j = _np(JOPS["nms"].fn(J.to_tensor(boxes), J.to_tensor(scores), thr))
    np.testing.assert_array_equal(got, j)
    # a chain where each box suppresses the next: the keep mask alternates,
    # so the fixed point needs one step a box
    chain = np.array([[i * 6.0, 0.0, i * 6.0 + 10.0, 10.0]
                      for i in range(24)])
    keep, reads = parity.nms_keep(parity.iou_overlaps(
        torch.as_tensor(chain), 0.2))
    assert keep.tolist() == [i % 2 == 0 for i in range(24)]
    assert 1 < reads <= 24 // parity.NMS_ROUND + 1


# -- the two detection pipelines at a small size ------------------------------

ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156,
           198, 373, 326]
MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]


def test_ppyolo_post_processing_small():
    rng = np.random.RandomState(7)
    B, C, size = 2, 6, 128
    img = np.array([[size, size], [size - 8, size]])
    boxes_all, scores_all = [], []
    for mask, ds in zip(MASKS, (32, 16, 8)):
        hw = size // ds
        x = rng.randn(B, 3 * (5 + C), hw, hw)
        anchors = sum(([ANCHORS[2 * m], ANCHORS[2 * m + 1]] for m in mask),
                      [])
        j, t = _both("yolo_box", x, img, anchors, C, conf_thresh=0.01,
                     downsample_ratio=ds, clip_bbox=True, scale_x_y=1.05)
        _same(j, t)
        boxes_all.append(j[0])
        scores_all.append(j[1])
    boxes = np.concatenate(boxes_all, 1)
    scores = np.concatenate(scores_all, 1)
    kept = 0
    for b in range(B):
        j, t = _both("matrix_nms", boxes[b], scores[b].T.copy(),
                     score_threshold=0.05, post_threshold=0.05,
                     nms_top_k=-1, keep_top_k=20, background_label=-1)
        _same(j, t, rtol=1e-6, atol=1e-6)       # rows come back in f32
        kept += int(t[1][0])
    assert kept > 0


def test_faster_rcnn_post_processing_small():
    rng = np.random.RandomState(8)
    H, W, A, classes = 64, 96, 3, 5
    im = np.array([float(H), float(W)])
    props, scores = [], []
    for level, stride in enumerate((4, 8, 16, 32, 64)):
        h, w = H // stride, W // stride
        size = 32.0 * 2 ** level
        anchors = _anchors(h, w, [size / 2, size, size * 1.5], stride)
        sc = rng.rand(A, h, w)
        deltas = rng.randn(4 * A, h, w) * 0.1
        j, t = _both("generate_proposals", sc, deltas, im, anchors,
                     np.ones_like(anchors), pre_nms_top_n=100,
                     post_nms_top_n=100, nms_thresh=0.7, min_size=0.0)
        _same(j, t)
        props.append(j[0])
        scores.append(j[1])
    props, scores = np.concatenate(props), np.concatenate(scores)
    top = np.argsort(-scores, kind="stable")[:120]
    rois = props[top]
    j, t = _both("distribute_fpn_proposals", rois, 2, 5, 4, 224)
    _same(j, t)
    feats = [rng.randn(1, 8, H // s, W // s) for s in (4, 8, 16, 32)]
    for lvl_rois, feat, s in zip(j[:4], feats, (4, 8, 16, 32)):
        if not len(lvl_rois):
            continue
        jr, tr = _both("roi_align", feat, lvl_rois.astype(np.float64),
                       np.array([len(lvl_rois)]), pooled_height=7,
                       pooled_width=7, spatial_scale=1.0 / s,
                       sampling_ratio=0, aligned=True)
        _same(jr, tr)
    deltas = rng.randn(len(rois), 4) * 0.1
    jd, td = _both("box_coder", rois, np.tile([[0.1, 0.1, 0.2, 0.2]],
                                              (len(rois), 1)), deltas,
                   code_type="decode_center_size", box_normalized=False)
    _same(jd, td)
    cls = rng.dirichlet(np.full(classes, 0.3), len(rois)).T.copy()
    j, t = _both("multiclass_nms3", jd, cls, score_threshold=0.05,
                 nms_threshold=0.5, keep_top_k=50)
    _same(j, t, rtol=1e-6, atol=1e-6)
    assert int(t[2][0]) > 0


# -- low-precision scores and many candidates a class -------------------------

LOW = {"bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
       "float16": (np.float16, torch.float16)}


def _low_both(name, boxes, scores, dtype, ref_scores=None, **kw):
    """``name`` on f32 boxes and ``scores`` rounded to ``dtype``, both
    packages fed the same values (the reference ``ref_scores`` if given)."""
    np_dt, t_dt = LOW[dtype]
    low = scores.astype(np_dt)
    j = JOPS[name].fn(J.to_tensor(boxes), J.to_tensor(
        low if ref_scores is None else ref_scores), **kw)
    t = TOPS[name].fn(torch.as_tensor(boxes), torch.as_tensor(
        low.astype(np.float32)).to(t_dt), **kw)
    return [_np(o) for o in j], [_np(o) for o in t]


@pytest.mark.parametrize("name,dtype,n,kw", [
    ("matrix_nms", "bfloat16", 600, dict(post_threshold=0.05)),
    ("matrix_nms", "bfloat16", 600, dict(post_threshold=0.05,
                                         nms_top_k=150)),
    ("matrix_nms", "float16", 2600, dict(post_threshold=0.05)),
    ("multiclass_nms3", "float16", 2600, dict(nms_threshold=0.5)),
    ("multiclass_nms3", "float16", 2600, dict(nms_threshold=0.5,
                                              nms_top_k=300)),
])
def test_nms_of_low_precision_scores_matches_reference(name, dtype, n, kw):
    """Candidate indices above bf16's 256 and f16's 2048 come back exact,
    and the host sorts break the many ties of 8- and 11-bit scores as the
    reference's numpy does."""
    boxes = _boxes(n, 11, hi=300.0, wh=(4.0, 40.0)).astype(np.float32)
    scores = np.random.RandomState(12).rand(3, n)
    j, t = _low_both(name, boxes, scores, dtype, score_threshold=0.05,
                     keep_top_k=-1, **kw)
    assert t[0].shape[0] > 256 and t[0][:, 0].max() == 2
    _same(j, t, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("budget", [1, 2 * 900 ** 2, 1 << 25])
def test_nms_class_chunks_match_the_per_class_path(budget, monkeypatch):
    """Many candidates a class: whatever :data:`NMS_CHUNK_ELEMS` packs
    into one ``[classes, n, n]`` pass (one class, a few, all), both NMS
    ops give the reference's per-class answer."""
    from paddle_tpu_torch.ops import detection
    monkeypatch.setattr(detection, "NMS_CHUNK_ELEMS", budget)
    n = 900
    boxes = _boxes(n, 13, hi=400.0, wh=(4.0, 60.0))
    scores = np.random.RandomState(14).rand(3, n) ** np.arange(1, 4)[:, None]
    for name, kw in (("matrix_nms", dict(post_threshold=0.02)),
                     ("multiclass_nms3", dict(nms_threshold=0.4))):
        j, t = _both(name, boxes, scores, score_threshold=0.02,
                     keep_top_k=-1, **kw)
        _same(j, t, rtol=1e-6, atol=1e-6)
    lens = [int((scores[c] > 0.02).sum()) for c in range(3)]
    assert min(lens) > 600 and max(lens) > 850
    chunks = detection._chunks(lens)
    assert [k for c in chunks for k in c] == list(range(3))
    assert all(len(c) == 1 or len(c) * max(lens[k] for k in c) ** 2
               <= budget for c in chunks)


def test_nms_chunks_bound_the_memory_at_detector_counts():
    """PP-YOLO's 80 classes: ~220 candidates a class share one pass; 5000
    a class (a detector early in training) run a class at a time, each
    pass ``5000^2`` elements, the reference's own peak."""
    from paddle_tpu_torch.ops.detection import NMS_CHUNK_ELEMS, _chunks
    assert _chunks([220] * 80) == [list(range(80))]
    assert _chunks([5000] * 80) == [[k] for k in range(80)]
    assert 5000 ** 2 <= NMS_CHUNK_ELEMS < 2 * 5000 ** 2


# -- the reference's deviations (ROADMAP R21-R28) ---------------------------

def test_r21_roi_align_sampling_ratio_zero_takes_two():
    rng = np.random.RandomState(1)
    x, boxes = rng.randn(1, 3, 16, 16), np.array([[1.3, 2.2, 13.9, 9.1]])
    zero = _both("roi_align", x, boxes, np.array([1]), pooled_height=2,
                 pooled_width=2, sampling_ratio=0)
    two = _both("roi_align", x, boxes, np.array([1]), pooled_height=2,
                pooled_width=2, sampling_ratio=2)
    _same(zero[0], zero[1])
    np.testing.assert_array_equal(zero[1], two[1])


def test_r22_roi_pool_is_a_dense_sample_max():
    x = np.arange(64.0).reshape(1, 1, 8, 8)
    boxes = np.array([[0.0, 0.0, 5.0, 5.0]])
    j, t = _both("roi_pool", x, boxes, np.array([1]), pooled_height=2,
                 pooled_width=2)
    _same(j, t)
    # Paddle's quantised bins over rows / cols 0-2 and 3-5 take the max of
    # the grid values; the reference's bilinear samples fall between them
    quantised = np.array([[x[0, 0, :3, :3].max(), x[0, 0, :3, 3:6].max()],
                          [x[0, 0, 3:6, :3].max(), x[0, 0, 3:6, 3:6].max()]])
    assert not np.allclose(t[0, 0], quantised)


def test_r23_multiclass_nms3_applies_nms_eta_once():
    boxes, sc = _boxes(12, 3, hi=20.0), np.random.RandomState(4).rand(2, 12)
    eta = _both("multiclass_nms3", boxes, sc, score_threshold=0.1,
                nms_threshold=0.6, nms_eta=0.9)
    once = _both("multiclass_nms3", boxes, sc, score_threshold=0.1,
                 nms_threshold=0.6 * 0.9)
    _same(eta[0], eta[1], rtol=1e-6, atol=1e-6)
    _same(eta[1], once[1])


def test_r24_matrix_and_multiclass_nms_take_one_image():
    boxes, sc = _boxes(6, 5)[None], np.random.RandomState(5).rand(1, 2, 6)
    for ops, P in ((JOPS, J), (TOPS, T)):
        for name in ("matrix_nms", "multiclass_nms3"):
            with pytest.raises(ValueError):
                ops[name].fn(P.to_tensor(boxes), P.to_tensor(sc))


def test_r25_viterbi_ignores_include_bos_eos_tag():
    rng = np.random.RandomState(6)
    pot, trans = rng.randn(2, 5, 4), rng.randn(4, 4)
    lens = np.array([5, 3])
    on = _both("viterbi_decode", pot, trans, lens, include_bos_eos_tag=True)
    off = _both("viterbi_decode", pot, trans, lens,
                include_bos_eos_tag=False)
    _same(on[0], on[1])
    _same(on[1], off[1])


def test_r26_multiclass_nms3_ignores_normalized():
    boxes, sc = _boxes(12, 6, hi=20.0), np.random.RandomState(7).rand(2, 12)
    a = _both("multiclass_nms3", boxes, sc, score_threshold=0.1,
              nms_threshold=0.3, normalized=True)
    b = _both("multiclass_nms3", boxes, sc, score_threshold=0.1,
              nms_threshold=0.3, normalized=False)
    _same(a[1], b[1])
    _same(a[0], b[0])


def test_r28_multiclass_nms3_of_bf16_scores_is_not_the_references_error():
    """The reference's ``multiclass_nms3`` raises on bf16 scores (numpy
    cannot promote an int label with an ml_dtypes bfloat16 score); the
    port returns the rows the reference gives for the same values in f32."""
    n = 600
    boxes = _boxes(n, 15, hi=300.0, wh=(4.0, 40.0)).astype(np.float32)
    scores = np.random.RandomState(16).rand(3, n)
    kw = dict(score_threshold=0.05, nms_threshold=0.5, keep_top_k=-1)
    with pytest.raises(Exception, match="promot"):
        JOPS["multiclass_nms3"].fn(J.to_tensor(boxes), J.to_tensor(
            scores.astype(ml_dtypes.bfloat16)), **kw)
    j, t = _low_both("multiclass_nms3", boxes, scores, "bfloat16",
                     scores.astype(ml_dtypes.bfloat16).astype(np.float32),
                     **kw)
    assert t[0].shape[0] > 256
    _same(j, t, rtol=1e-6, atol=1e-6)


def test_r27_merged_updates_return_tuples():
    p = [np.ones((2, 2)), np.ones(3)]
    g = [np.full((2, 2), 0.5), np.full(3, 0.5)]
    def args(P):
        return ([P.to_tensor(a) for a in p], [P.to_tensor(a) for a in g],
                [P.to_tensor(np.zeros_like(a)) for a in p], 0.1)

    jout = JOPS["merged_momentum_"].fn(*args(J))
    tout = TOPS["merged_momentum_"].fn(*args(T))
    # the reference wraps each tuple in one Tensor; the port returns them
    assert isinstance(jout[0]._value, tuple) and len(jout[0]._value) == 2
    assert isinstance(tout[0], tuple) and len(tout[0]) == 2
    for jt, tt in zip(jout, tout):
        for a, b in zip(jt._value, tt):
            np.testing.assert_allclose(_np(b), np.asarray(a), **VAL)


# -- paddle.fft -------------------------------------------------------------

FFTS = [("fft", {}), ("ifft", {"n": 6}), ("fft2", {"norm": "ortho"}),
        ("ifft2", {}), ("fftn", {"axes": [0, 2]}), ("ifftn", {"s": [4, 3]}),
        ("rfft", {"norm": "forward"}), ("irfft", {"n": 8}), ("rfft2", {}),
        ("irfft2", {}), ("rfftn", {}), ("irfftn", {"axes": [1, 2]}),
        ("hfft", {}), ("ihfft", {}), ("hfft2", {}), ("ihfft2", {}),
        ("hfftn", {"axes": [1, 2]}), ("ihfftn", {}),
        ("fftshift", {}), ("ifftshift", {"axes": [1]})]


@pytest.mark.parametrize("name,kw", FFTS)
def test_fft_matches_reference(name, kw):
    rng = np.random.RandomState(3)
    real = rng.randn(3, 4, 5)
    cplx = real + 1j * rng.randn(3, 4, 5)
    real_in = name in ("rfft", "rfft2", "rfftn", "ihfft", "ihfft2",
                       "ihfftn")
    for x in ([real] if real_in else [real, cplx]):
        outs, grads = [], []
        for P in (J, T):
            t = P.to_tensor(x, stop_gradient=not np.isrealobj(x))
            out = getattr(P.fft, name)(t, **kw)
            outs.append(_np(out))
            if np.isrealobj(x):
                w = P.to_tensor(np.random.RandomState(1).uniform(
                    0.5, 1.5, _np(out).shape))
                if np.iscomplexobj(_np(out)):
                    re = J.real(out) if P is J else out.real
                    im = J.imag(out) if P is J else out.imag
                    loss = (re * w).sum() + (im * w * 0.5).sum()
                else:
                    loss = (out * w).sum()
                grads.append(_np(P.grad(loss, [t])[0]))
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-9, atol=1e-12)
        if grads:
            np.testing.assert_allclose(grads[1], grads[0], rtol=1e-9,
                                       atol=1e-12)
    for fn in ("fftfreq", "rfftfreq"):
        np.testing.assert_allclose(_np(getattr(T.fft, fn)(8, 0.5)),
                                   _np(getattr(J.fft, fn)(8, 0.5)))
    with pytest.raises(ValueError):
        T.fft.fft(T.to_tensor(real), norm="bogus")


# -- containers ---------------------------------------------------------------

def test_tensor_array_round_trip():
    xs = [np.full((2, 3), float(i)) for i in range(3)]
    res = []
    for P in (J, T):
        arr = P.create_array("float64")
        for i, x in enumerate(xs):
            arr = P.array_write(P.to_tensor(x), P.to_tensor(np.array(i)),
                                arr)
        assert int(_np(P.array_length(arr))) == 3 and len(arr) == 3
        with pytest.raises(IndexError):
            arr.write(5, P.to_tensor(xs[0]))
        arr.write(1, P.to_tensor(xs[2]))
        res.append([_np(P.array_read(arr, 1)), _np(arr.stack(axis=1)),
                    _np(arr.concat()), _np(arr.pop())])
        assert len(arr) == 2
    for a, b in zip(*res):
        np.testing.assert_array_equal(b, a)
    arr = T.create_array(initialized_list=[xs[0]])
    assert type(arr[0]) is T.Tensor


def test_selected_rows_to_dense_and_merge():
    rows, vals = np.array([3, 0, 3]), np.arange(6.0).reshape(3, 2)
    res = []
    for P, C in ((J, J.SelectedRows), (T, T.SelectedRows)):
        sr = C(rows, P.to_tensor(vals), 5)
        m = sr.merge()
        res.append([_np(sr.to_dense()), np.asarray(m.rows),
                    np.asarray(m.values if not hasattr(m.values, "numpy")
                               else m.values.numpy())])
        assert repr(sr) == "SelectedRows(height=5, nrows=3)"
    for a, b in zip(*res):
        np.testing.assert_array_equal(b, a)


# -- the debug flags ----------------------------------------------------------

def test_check_nan_inf_raises_with_the_op_name():
    for P in (J, T):
        P.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(RuntimeError) as e:
                P.log(P.to_tensor(np.array([-1.0, 0.0, 2.0])))
            msg = str(e.value)
            assert "'log'" in msg and "1 NaN" in msg and "1 Inf" in msg
            assert _np(P.exp(P.to_tensor(np.array([1.0])))).shape == (1,)
        finally:
            P.set_flags({"FLAGS_check_nan_inf": False})
        out = P.log(P.to_tensor(np.array([-1.0])))        # off: no raise
        assert np.isnan(_np(out)).all()


def test_debug_flags_off_read_no_flag_per_op(monkeypatch):
    from paddle_tpu_torch.core import dispatch
    from paddle_tpu_torch.framework import flags

    assert dispatch.DEBUG_HOOKS is False

    def boom(name):
        raise AssertionError(f"flag_value({name!r}) on the eager path")

    monkeypatch.setattr(flags, "flag_value", boom)
    x = T.to_tensor(np.array([[1.0, 2.0], [3.0, 4.0]]), stop_gradient=False)
    y = T.matmul(T.log(x), x).sum()
    y.backward()
    T.set_flags({"FLAGS_benchmark": True})
    try:
        assert dispatch.DEBUG_HOOKS is True
        with pytest.raises(AssertionError):
            T.exp(x)
    finally:
        monkeypatch.undo()
        T.set_flags({"FLAGS_benchmark": False})
    assert dispatch.DEBUG_HOOKS is False
    T.set_flags({"FLAGS_benchmark": True})
    try:
        np.testing.assert_allclose(_np(T.exp(x)), np.exp(_np(x)))
    finally:
        T.set_flags({"FLAGS_benchmark": False})
    assert T.get_flags(["FLAGS_check_nan_inf", "FLAGS_benchmark"]) == {
        "FLAGS_check_nan_inf": False, "FLAGS_benchmark": False}


def test_check_nan_inf_skips_a_compiled_program():
    T.set_flags({"FLAGS_check_nan_inf": True})
    try:
        fn = torch.compile(lambda v: T.log(v) * 2, backend="aot_eager",
                           fullgraph=False)
        out = fn(torch.tensor([-1.0, 2.0]))
        assert torch.isnan(out[0]) and torch.isfinite(out[1])
    finally:
        T.set_flags({"FLAGS_check_nan_inf": False})
        torch._dynamo.reset()


# -- text.viterbi -------------------------------------------------------------

def test_viterbi_decoder_matches_reference():
    rng = np.random.RandomState(9)
    pot, trans = rng.randn(3, 6, 5), rng.randn(5, 5)
    lens = np.array([6, 4, 1])
    res = []
    for P in (J, T):
        dec = P.text.ViterbiDecoder(P.to_tensor(trans))
        scores, path = dec(P.to_tensor(pot), P.to_tensor(lens))
        s2, p2 = P.text.viterbi_decode(P.to_tensor(pot), P.to_tensor(trans),
                                       P.to_tensor(lens))
        np.testing.assert_array_equal(_np(path), _np(p2))
        res.append((_np(scores), _np(path)))
    np.testing.assert_allclose(res[1][0], res[0][0], **VAL)
    np.testing.assert_array_equal(res[1][1], res[0][1])
    # the full-length row is the brute-force best path
    import itertools

    best = max(itertools.product(range(5), repeat=6), key=lambda s: pot[
        0, 0, s[0]] + sum(trans[s[i - 1], s[i]] + pot[0, i, s[i]]
                          for i in range(1, 6)))
    np.testing.assert_array_equal(res[1][1][0], best)
