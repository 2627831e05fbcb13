"""Seeded inputs for every op of the port's op library
(``paddle_tpu_torch.ops``), shared by ``tests/test_torch_ops.py`` (the port
against the JAX package on the CPU, f64) and ``chip_smoke.py``'s
``[eager ops]`` phase (each op on the card against the CPU, f32). It
imports neither JAX nor ``paddle_tpu``.

``cases(name, probe)`` gives ``[(args, kwargs), ...]`` for op ``name``:
a structured case from :data:`CASES` (ranges that keep an op in its
domain, integer inputs for the integer ops, the decompositions'
well-conditioned matrices: the helpers below are those of
``tests/test_op_grads.py``), else the first generic probe, a unary
``A(2, 3)`` or a binary ``(A(2, 3), A(2, 3, seed=1))``, that ``probe``
(a callable that runs the op) takes. Arrays are float64; callers cast
them for an f32 run.
"""
from __future__ import annotations

import numpy as np

__all__ = ["A", "SPD", "CASES", "LOOSE", "SIGNED", "cases"]


def A(*shape, lo=0.25, hi=0.85, seed=0, neg=False):
    """Seeded float64 array in [lo, hi] (or symmetric ±[lo,hi] with neg)."""
    rng = np.random.RandomState(abs(seed + sum(shape) * 7 + int(lo * 100)))
    a = rng.uniform(lo, hi, size=shape)
    if neg:
        a *= rng.choice([-1.0, 1.0], size=shape)
    return a.astype(np.float64)


def SPD(n, seed=0):
    """Symmetric positive-definite matrix (cholesky/inv/solve family)."""
    rng = np.random.RandomState(seed)
    m = rng.randn(n, n)
    return (m @ m.T + n * np.eye(n)).astype(np.float64)


def SEP_SV(rows, cols=None, seed=0):
    """Matrix with well-separated singular values: FD through U/V is stable
    iff the spectral gaps dominate the step (reference check_grad uses the
    same trick for its decomposition op tests)."""
    cols = cols or rows
    k = min(rows, cols)
    rng = np.random.RandomState(seed)
    u, _ = np.linalg.qr(rng.randn(rows, rows))
    v, _ = np.linalg.qr(rng.randn(cols, cols))
    sv = np.zeros((rows, cols))
    sv[np.arange(k), np.arange(k)] = np.linspace(3.0, 1.0, k)
    return (u @ sv @ v.T).astype(np.float64)


def SEP_SYM(n, seed=0):
    """Symmetric with well-separated eigenvalues (eigh family)."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(n, n))
    return (q @ np.diag(np.linspace(4.0, 1.0, n)) @ q.T).astype(np.float64)


def DIAG_DOM(n, seed=0):
    """Diagonally dominant with strictly descending diagonal: partial
    pivoting never swaps in an FD-step neighborhood (lu family)."""
    rng = np.random.RandomState(seed)
    return (np.diag(np.linspace(2 * n, n, n)) +
            0.2 * rng.randn(n, n)).astype(np.float64)


I64 = np.array([[7, -7, 5], [-3, 12, 0]], np.int64)
I64B = np.array([[2, 3, -4], [5, -5, 7]], np.int64)

CASES = {
    # tests/test_op_grads.py's SPECS for these ops
    "broadcast_to": [((A(1, 3),), {"shape": [2, 3]})],
    "expand_as": [((A(1, 3), np.zeros((2, 3))), {})],
    "view_as": [((A(2, 3), np.zeros(6)), {})],
    "tile": [((A(2, 3),), {"repeat_times": [2, 1]})],
    "rot90": [((A(2, 3),), {})],
    "moveaxis": [((A(2, 3),), {"source": 0, "destination": 1})],
    "transpose": [((A(2, 3),), {"perm": [1, 0]})],
    "crop": [((A(4, 5),), {"shape": [2, 3], "offsets": [1, 1]})],
    "chunk": [((A(4, 3),), {"chunks": 2, "axis": 0})],
    "dsplit": [((A(2, 2, 4),), {"num_or_indices": 2})],
    "hsplit": [((A(2, 4),), {"num_or_indices": 2})],
    "vsplit": [((A(4, 2),), {"num_or_indices": 2})],
    "concat": [(([A(2, 3), A(2, 3, seed=1)],), {"axis": 0})],
    "stack": [(([A(2, 3), A(2, 3, seed=1)],), {"axis": 0})],
    "unbind": [((A(2, 3),), {"axis": 0})],
    "unstack": [((A(2, 3),), {"axis": 0})],
    "flatten": [((A(2, 3),), {})],
    "gather_nd": [((A(3, 3), np.array([[0, 1], [2, 0]])), {})],
    "index_select": [((A(4, 3), np.array([0, 2])), {})],
    "index_sample": [((A(2, 4), np.array([[0, 1], [2, 3]])), {})],
    "index_add": [((A(4, 3), np.array([0, 2]), 0, A(2, 3, seed=3)), {})],
    "take_along_axis": [((A(3, 4), np.array([[0, 1, 2, 3], [1, 0, 1, 0],
                                            [2, 2, 2, 2]])), {"axis": 1})],
    "scatter_nd_add": [((A(4, 3), np.array([[1], [3]]), A(2, 3, seed=4)), {})],
    "kthvalue": [((A(2, 5),), {"k": 2})],
    "mm": [((A(2, 3), A(3, 4, seed=1)), {})],
    "bmm": [((A(2, 2, 3), A(2, 3, 2, seed=1)), {})],
    "mv": [((A(3, 4), A(4, seed=1)), {})],
    "dot": [((A(4), A(4, seed=1)), {})],
    "inner": [((A(2, 4), A(3, 4, seed=1)), {})],
    "outer": [((A(3), A(4, seed=1)), {})],
    "kron": [((A(2, 2), A(2, 3, seed=1)), {})],
    "cdist": [((A(3, 4), A(2, 4, seed=1)), {})],
    "dist": [((A(2, 3), A(2, 3, seed=1)), {"p": 2})],
    "multi_dot": [(([A(2, 3), A(3, 4, seed=1), A(4, 2, seed=2)],), {})],
    "einsum": [(("ij,jk->ik", A(2, 3), A(3, 4, seed=1)), {})],
    "lerp": [((A(2, 3), A(2, 3, seed=1), 0.3), {})],
    "pow": [((A(2, 3), 2.5), {})],
    "float_power": [((A(2, 3), A(2, 3, lo=1.0, hi=2.0, seed=1)), {})],
    "heaviside": [((A(2, 3, neg=True), A(2, 3, seed=1)), {})],
    "cumprod": [((A(2, 3),), {"dim": 1})],
    "amin": [((A(2, 3),), {"axis": 1})],
    "diagflat": [((A(3),), {})],
    "cholesky": [((SPD(3),), {})],
    "svd": [((SEP_SV(3),), {})],
    "eigh": [((SEP_SYM(3),), {})],
    "eigvalsh": [((SEP_SYM(3),), {})],
    "lu": [((DIAG_DOM(3),), {})],
    "lstsq": [((SEP_SV(4, 3), A(4, 2, neg=True)), {})],
    "erfinv": [((A(2, 3, lo=0.1, hi=0.6, neg=True),), {})],
    "angle": [((A(2, 3, neg=True),), {})],
    "clone": [((A(2, 3),), {})],
    "as_complex": [((A(2, 3, 2, neg=True),), {})],
    "det": [((SPD(3),), {})],
    "slogdet": [((SPD(3),), {})],
    "inv": [((SPD(3),), {})],
    "pinv": [((SPD(3),), {})],
    "matrix_power": [((SPD(3),), {"n": 2})],
    "qr": [((A(3, 2),), {"mode": "reduced"})],
    "solve": [((SPD(3), A(3, 2)), {})],
    "triangular_solve": [((np.linalg.cholesky(SPD(3)), A(3, 2)),
                         {"upper": False})],
    "householder_product": [((A(3, 2), A(2, seed=1)), {})],
    "corrcoef": [((A(3, 5, neg=True),), {})],
    "atan2": [((A(2, 3), A(2, 3, seed=1)), {})],
    "stanh": [((A(2, 3, neg=True),), {})],
    "acosh": [((A(2, 3, lo=1.3, hi=2.5),), {})],
    "digamma": [((A(2, 3, lo=0.5, hi=2.0),), {})],
    "lgamma": [((A(2, 3, lo=0.5, hi=2.0),), {})],
    # structured cases the port's ops need beyond them
    "zeros": [(([2, 3],), {})], "ones": [(([2, 3],), {"dtype": "int64"})],
    "full": [(([2, 3], 1.5), {}), (([2], 3), {})],
    "zeros_like": [((A(2, 3),), {})], "ones_like": [((A(2, 3),), {})],
    "full_like": [((A(2, 3), 2.0), {})], "empty": [(([2, 3],), {})],
    "empty_like": [((A(2, 3),), {})],
    "arange": [((0, 5, 1), {}), ((0.5, 3.0, 0.5), {}), ((4,), {})],
    "linspace": [((0, 1, 5), {})], "logspace": [((0, 2, 5), {})],
    "eye": [((3, 4), {}), ((3,), {})],
    "diag": [((A(3, 3),), {}), ((A(3),), {"offset": 1,
                                          "padding_value": 2.0})],
    "meshgrid": [(([A(3), A(2, seed=1)],), {})],
    "floor_divide": [((I64, I64B), {}), ((A(2, 3, neg=True),
                                          A(2, 3, seed=1)), {})],
    "remainder": [((I64, I64B), {}), ((A(2, 3, neg=True),
                                       A(2, 3, seed=1)), {})],
    "mod": [((I64, I64B), {})],
    "divide": [((A(2, 3), A(2, 3, seed=1)), {}), ((I64, I64B), {})],
    "gcd": [((I64, I64B), {})], "lcm": [((I64, I64B), {})],
    "bitwise_and": [((I64, I64B), {})], "bitwise_or": [((I64, I64B), {})],
    "bitwise_xor": [((I64, I64B), {})], "bitwise_not": [((I64,), {})],
    "sum": [((A(2, 3, 4),), {"axis": [0, 2], "keepdim": True}),
            ((A(2, 3),), {"axis": 1, "dtype": "float32"})],
    "mean": [((A(2, 3, 4),), {"axis": [1]}), ((A(2, 3),), {})],
    "prod": [((A(2, 3, 4),), {"axis": [0, 2]}), ((A(2, 3),), {"axis": 1})],
    "max": [((A(2, 3),), {"axis": 1, "keepdim": True}), ((A(2, 3),), {})],
    "min": [((A(2, 3),), {"axis": 0}), ((A(2, 3),), {})],
    "amax": [((A(2, 3, 4),), {"axis": [0, 2]})],
    "nansum": [((A(2, 3),), {"axis": 1})],
    "nanmean": [((A(2, 3),), {"axis": 0})],
    "all": [((A(2, 3) > 0.5,), {"axis": 1})],
    "any": [((A(2, 3) > 0.5,), {"axis": 0, "keepdim": True})],
    "count_nonzero": [((A(2, 3) > 0.5,), {"axis": 1})],
    "logsumexp": [((A(2, 3),), {}), ((A(2, 3),), {"axis": 1})],
    "trace": [((A(3, 4),), {"offset": 1})],
    "cumsum": [((A(2, 3),), {"axis": 1}), ((A(2, 3),), {})],
    "cummax": [((A(2, 3),), {"axis": 1})], "cummin": [((A(2, 3),),
                                                      {"axis": 0})],
    "diff": [((A(2, 4),), {}), ((A(3, 2),), {"axis": 0})],
    "add_n": [(([A(2, 3), A(2, 3, seed=1), A(2, 3, seed=2)],), {})],
    "multiplex": [(([A(3, 2), A(3, 2, seed=1)], np.array([[1], [0], [1]])),
                   {})],
    "clip": [((A(2, 3, neg=True),), {"min": -0.5, "max": 0.5}),
             ((A(2, 3, neg=True),), {"max": 0.2})],
    "scale": [((A(2, 3),), {"scale": 2.0, "bias": 0.5,
                            "bias_after_scale": False})],
    "logit": [((A(2, 3, lo=0.2, hi=0.8),), {"eps": 0.3})],
    "nan_to_num": [((np.array([1.0, np.nan, np.inf, -np.inf]),), {})],
    "neg": [((A(2, 3),), {})], "negative": [((A(2, 3),), {})],
    "reshape": [((A(2, 3),), {"shape": [3, 2]}),
                ((A(2, 3),), {"shape": [-1]})],
    "squeeze": [((A(2, 1, 3),), {"axis": 1}), ((A(2, 1, 3),), {}),
                ((A(2, 1, 3),), {"axis": 0})],
    "unsqueeze": [((A(2, 3),), {"axis": [0, 2]})],
    "split": [((A(4, 3),), {"num_or_sections": 2, "axis": 0}),
              ((A(5, 3),), {"num_or_sections": [2, -1], "axis": 0})],
    "expand": [((A(1, 3),), {"shape": [2, -1]}),
               ((A(3,),), {"shape": [2, 3]})],
    "gather": [((A(4, 3), np.array([0, 2])), {}),
               ((A(4, 3), np.array([[0, 2], [1, 1]])), {"axis": 1})],
    "scatter": [((A(4, 3), np.array([1, 3]), A(2, 3, seed=4)), {}),
                ((A(4, 3), np.array([1, 3]), A(2, 3, seed=4)),
                 {"overwrite": False})],
    "put_along_axis": [((A(3, 4), np.array([[0], [1], [2]]),
                         A(3, 1, seed=5)), {"axis": 1}),
                       ((A(3, 4), np.array([[0], [1], [2]]),
                         A(3, 1, seed=5)), {"axis": 1, "reduce": "add"})],
    "masked_select": [((A(2, 3), A(2, 3, seed=1) > 0.5), {})],
    "roll": [((A(2, 3),), {"shifts": 1, "axis": 0}),
             ((A(2, 3),), {"shifts": 2})],
    "flip": [((A(2, 3),), {"axis": [0, 1]})],
    "cast": [((A(2, 3),), {"dtype": "float32"}),
             ((A(2, 3),), {"dtype": "int64"})],
    "view": [((A(2, 3), [6]), {}), ((A(2, 3), "float32"), {})],
    "tensor_split": [((A(5, 3),), {"num_or_indices": 2, "axis": 0}),
                     ((A(5, 3),), {"num_or_indices": [1, 3]})],
    "repeat_interleave": [((A(2, 3),), {"repeats": 2, "axis": 0}),
                          ((A(2, 3),), {"repeats": 2})],
    "as_real": [((A(2, 3) + 1j * A(2, 3, seed=1),), {})],
    "index_put": [((A(4, 3), (np.array([0, 2]),), A(2, 3, seed=3)), {}),
                  ((A(4, 3), (np.array([0, 0]),), A(2, 3, seed=3)),
                   {"accumulate": True})],
    "fill_diagonal": [((A(3, 3),), {"value": 0.5}),
                      ((A(3, 4),), {"value": 0.5, "offset": 1})],
    "pad": [((A(2, 3),), {"pad": [1, 1, 0, 2]}),
            ((A(1, 2, 3, 4),), {"pad": [1, 2], "mode": "reflect"}),
            ((A(1, 2, 3, 4),), {"pad": [1, 1, 1, 1], "mode": "replicate"}),
            ((A(1, 2, 3, 4),), {"pad": [1, 1], "value": 2.0})],
    "slice": [((A(4, 5),), {"axes": [0, 1], "starts": [1, -3],
                            "ends": [3, 100]})],
    "matmul": [((A(2, 3), A(3, 4, seed=1)), {}),
               ((A(2, 3, 4), A(2, 3, 5, seed=1)), {"transpose_x": True}),
               ((A(3), A(3, seed=1)), {})],
    "norm": [((A(2, 3),), {}), ((A(2, 3),), {"p": 1, "axis": 1}),
             ((A(2, 3),), {"p": np.inf, "axis": 0}),
             ((A(2, 3),), {"p": 3.0, "axis": [0, 1], "keepdim": True})],
    "cross": [((A(2, 3), A(2, 3, seed=1)), {}),
              ((A(3, 2), A(3, 2, seed=1)), {"axis": 0})],
    "cov": [((A(3, 5, neg=True),), {"rowvar": False, "ddof": False})],
    "eig": [((SPD(3),), {})], "eigvals": [((SPD(3),), {})],
    "matrix_rank": [((SPD(3),), {})],
    "argmax": [((A(2, 3),), {}), ((A(2, 3),), {"axis": 1,
                                               "keepdim": True})],
    "argmin": [((A(2, 3),), {"axis": 0})],
    "argsort": [((A(2, 5),), {"axis": 1, "descending": True})],
    "sort": [((A(2, 5),), {"axis": 1}), ((A(2, 5),), {"axis": 0,
                                                      "descending": True})],
    "topk": [((A(2, 5),), {"k": 2}), ((A(4, 3),), {"k": 2, "axis": 0,
                                                   "largest": False})],
    "nonzero": [((np.array([[0.0, 1.0], [2.0, 0.0]]),), {}),
                ((np.array([[0.0, 1.0], [2.0, 0.0]]),),
                 {"as_tuple": True})],
    "searchsorted": [((np.array([1.0, 2.0, 4.0, 8.0]),
                       np.array([[0.5, 2.0], [5.0, 9.0]])), {}),
                     ((np.array([1.0, 2.0, 4.0, 8.0]), np.array([2.0])),
                      {"right": True})],
    "bucketize": [((np.array([[0.5, 2.0], [5.0, 9.0]]),
                    np.array([1.0, 2.0, 4.0, 8.0])), {})],
    "unique": [((np.array([3, 1, 3, 2, 1]),),
                {"return_index": True, "return_inverse": True,
                 "return_counts": True})],
    "unique_consecutive": [((np.array([1, 1, 2, 2, 3, 1]),),
                            {"return_inverse": True,
                             "return_counts": True})],
    "mode": [((np.array([[1, 2, 2, 3], [4, 4, 1, 1]]),), {})],
    "median": [((A(7, neg=True),), {}), ((A(3, 4),), {"axis": 1}),
               ((A(3, 4),), {"axis": 0, "keepdim": True})],
    "quantile": [((A(7, neg=True),), {"q": 0.37}),
                 ((A(3, 5),), {"q": 0.5, "axis": 1})],
    "histogram": [((A(20),), {"bins": 4}),
                  ((A(20),), {"bins": 5, "min": 0.0, "max": 1.0})],
    "where": [((np.array([[True, False, True], [False, True, False]]),
                A(2, 3), A(2, 3, seed=1)), {})],
    "std": [((A(2, 3),), {"axis": 1, "unbiased": False})],
    "var": [((A(2, 3, 4),), {"axis": [0, 2], "keepdim": True})],
    "fused_linear_param_grad_add": [((A(2, 3), A(2, 4, seed=1)), {}),
                                    ((A(2, 3), A(2, 4, seed=1), A(3, 4),
                                      A(4, seed=2)),
                                     {"multi_precision": False})],
    "fused_dropout_add": [((A(2, 3), A(2, 3, seed=1)), {"p": 0.0}),
                          ((A(2, 3), A(2, 3, seed=1)),
                           {"p": 0.3, "training": False,
                            "mode": "downscale_in_infer"})],
    "equal_all": [((A(2, 3), A(2, 3)), {}),
                  ((A(2, 3), A(2, 3, seed=1)), {})],
}
# looser value tolerance: LAPACK / special-function implementations
LOOSE = {"svd", "eigh", "eigvalsh", "qr", "lu", "lstsq", "pinv", "inv",
         "det", "slogdet", "solve", "cholesky", "triangular_solve",
         "matrix_power", "householder_product", "erfinv", "lgamma",
         "digamma", "eig", "eigvals", "corrcoef", "cov", "cdist"}
# decompositions whose factors are defined up to a sign per column
SIGNED = {"svd": ((0, 2), -2), "qr": ((0,), -2), "eigh": ((1,), -2)}


def cases(name, probe):
    """The inputs of op ``name``; ``probe(args, kwargs)`` returns True when
    the op takes a generic probe."""
    if name in CASES:
        return CASES[name]
    for args, kwargs in (((A(2, 3),), {}),
                         ((A(2, 3), A(2, 3, seed=1)), {})):
        if probe(args, kwargs):
            return [(args, kwargs)]
    raise KeyError(f"no input for op {name}")
