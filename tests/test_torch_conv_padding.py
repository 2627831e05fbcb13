"""Paddle's nested pair form of a convolution's ``padding`` (F5).

Paddle takes one ``[before, after]`` pair per dimension of ``x``, batch and
channel included: ``[[0, 0], [0, 0], [t, b], [l, r]]`` for NCHW and
``[[0, 0], [t, b], [l, r], [0, 0]]`` for NHWC, and raises when a batch or
channel pair is not zeros. The port's ``conv1d`` / ``conv2d`` / ``conv3d``
drop those pairs by ``data_format`` and pad the spatial dimensions.

The JAX package cannot be the oracle here: its ``_padding``
(``paddle_tpu/nn/functional/conv.py``) rejects every pair form (R15: a list
of n + 2 pairs reaches ``lax.conv_general_dilated`` as n + 2 spatial
pairs, which raises). Each case is held instead against
``torch.nn.functional.pad`` of the spatial dimensions followed by torch's
convolution with zero padding, on the same seeded inputs.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

from paddle_tpu_torch.nn import functional as PF

CONV = {1: (PF.conv1d, TF.conv1d, "NCL", "NLC"),
        2: (PF.conv2d, TF.conv2d, "NCHW", "NHWC"),
        3: (PF.conv3d, TF.conv3d, "NCDHW", "NDHWC")}
SIZES = {1: (11,), 2: (9, 8), 3: (6, 7, 5)}
KERNELS = {1: (3,), 2: (3, 2), 3: (2, 3, 2)}
# spatial pairs per n: equal (before == after) and unequal
PAIRS = {1: {"equal": [(2, 2)], "unequal": [(1, 3)]},
         2: {"equal": [(1, 1), (2, 2)], "unequal": [(0, 2), (3, 1)]},
         3: {"equal": [(1, 1), (0, 0), (2, 2)],
             "unequal": [(2, 0), (1, 2), (0, 1)]}}


def _inputs(n, seed=0):
    rng = np.random.RandomState(seed + n)
    x = torch.from_numpy(rng.randn(2, 3, *SIZES[n]).astype(np.float32))
    w = torch.from_numpy(rng.randn(4, 3, *KERNELS[n]).astype(np.float32))
    b = torch.from_numpy(rng.randn(4).astype(np.float32))
    return x, w, b


def _want(n, x, w, b, pairs, stride):
    """``F.pad`` of the spatial dimensions (last first), then torch's
    convolution with zero padding; NC... layout."""
    flat = [p for pair in reversed(pairs) for p in pair]
    return CONV[n][1](TF.pad(x, flat), w, b, stride)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("kind", ["equal", "unequal"])
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_nested_pairs_of_every_dim_match_pad_then_conv(n, kind, last,
                                                       stride):
    x, w, b = _inputs(n)
    pairs = PAIRS[n][kind]
    zero = [[0, 0]]
    spatial = [list(p) for p in pairs]
    fmt = CONV[n][3 if last else 2]
    padding = zero + spatial + zero if last else zero + zero + spatial
    xin = x.movedim(1, -1) if last else x
    got = CONV[n][0](xin, w, b, stride=stride, padding=padding,
                     data_format=fmt)
    if last:
        got = got.movedim(-1, 1)
    want = _want(n, x, w, b, pairs, stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("last", [False, True])
def test_nested_and_flat_spatial_forms_agree(n, last):
    """The n + 2 pairs give what the 2n-int and the n-pair forms of the
    same spatial padding give."""
    x, w, b = _inputs(n, seed=5)
    pairs = PAIRS[n]["unequal"]
    fmt = CONV[n][3 if last else 2]
    xin = x.movedim(1, -1) if last else x
    spatial = [list(p) for p in pairs]
    full = ([[0, 0]] + spatial + [[0, 0]] if last
            else [[0, 0], [0, 0]] + spatial)
    outs = [CONV[n][0](xin, w, b, padding=p, data_format=fmt)
            for p in (full, spatial, [q for p in pairs for q in p])]
    for o in outs[1:]:
        np.testing.assert_array_equal(o.numpy(), outs[0].numpy())


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("which", ["batch", "channel"])
def test_nonzero_batch_or_channel_pair_raises(n, last, which):
    x, w, b = _inputs(n)
    fmt = CONV[n][3 if last else 2]
    xin = x.movedim(1, -1) if last else x
    pad = [[0, 0] for _ in range(n + 2)]
    # the batch pair is first; the channel pair second (NC...) or last
    idx = 0 if which == "batch" else (n + 1 if last else 1)
    pad[idx] = [1, 0]
    with pytest.raises(ValueError, match="batch and channel"):
        CONV[n][0](xin, w, b, padding=pad, data_format=fmt)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_channels_last_never_pads_the_channels(n):
    """The NHWC misread padded the channel dimension; the spatial pairs of
    the nested form now land on the spatial dimensions only."""
    x, w, b = _inputs(n, seed=9)
    pairs = PAIRS[n]["equal"]
    pad = [[0, 0]] + [list(p) for p in pairs] + [[0, 0]]
    got = CONV[n][0](x.movedim(1, -1), w, b, padding=pad,
                     data_format=CONV[n][3])
    assert got.shape[-1] == w.shape[0]
    want = _want(n, x, w, b, pairs, 1)
    np.testing.assert_allclose(got.movedim(-1, 1).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
