"""``paddle.static.nn``: layer builders and control flow of static programs
(counterpart of ``paddle_tpu/static/nn.py``; Paddle's
``python/paddle/static/nn/common.py`` and ``control_flow.py``).

The builders create parameters with ``static.create_parameter`` (in the
current Program and the global Scope) and apply the same functionals the
dygraph layers use, which record their replay on the placeholder graph;
``layer_norm`` runs the LayerNorm kernel (a registered op inside the
compiled program).

Control flow records nodes the replay lowers through the dy2static runtime:
``cond`` records both branches at build time (``torch.cond`` on a traced
predicate), ``while_loop`` records its condition and body once over
loop-variable placeholders (``while_loop`` on a traced condition). As in
Paddle, parameters are built outside a branch or a body.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.capture import build_value, next_uid
from ..core.tensor import StaticTensor, wrap
from ..nn import functional as F
from ..ops.linalg import matmul
from . import (_CondNode, _Env, _WhileNode, _placeholder, _record_outputs,
               create_parameter)

__all__ = [
    "fc", "embedding", "conv2d", "conv3d", "batch_norm", "layer_norm",
    "group_norm", "instance_norm", "prelu", "cond", "case", "switch_case",
    "while_loop",
]


def _name(name, suffix):
    return None if name is None else f"{name}.{suffix}"


def _act(out, act):
    return getattr(F, act)(out) if act else out


def _ones(shape):
    return np.ones(shape, np.float32)


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """Fully-connected builder (Paddle's ``static.nn.fc``)."""
    shape = [int(s) for s in x.shape]
    in_dim = int(np.prod(shape[num_flatten_dims:]))
    w = create_parameter([in_dim, size], name=_name(name, "w"))
    # -1 keeps the batch dims dynamic (the placeholder's build-time shape
    # has its None dims at 1: never bake those in)
    flat = x if len(shape) == num_flatten_dims + 1 and shape[-1] == in_dim \
        else x.reshape([-1, in_dim])
    out = matmul(flat, w)
    if bias_attr is not False:
        out = out + create_parameter([size], is_bias=True,
                                     name=_name(name, "b"))
    return _act(out, activation)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None):
    """Embedding lookup builder (Paddle's ``static.nn.embedding``)."""
    w = create_parameter(list(size), dtype=dtype, name=_name(name, "w"))
    return F.embedding(input, w, padding_idx=padding_idx)


def _conv(f, n, input, num_filters, filter_size, stride, padding, dilation,
          groups, bias_attr, act, data_format, name):
    k = (filter_size if isinstance(filter_size, (list, tuple))
         else (filter_size,) * n)
    in_ch = int(input.shape[1 if data_format.startswith("NC") else -1])
    w = create_parameter([num_filters, in_ch // groups, *k],
                         name=_name(name, "w"))
    b = (None if bias_attr is False else
         create_parameter([num_filters], is_bias=True, name=_name(name, "b")))
    out = f(input, w, bias=b, stride=stride, padding=padding,
            dilation=dilation, groups=groups, data_format=data_format)
    return _act(out, act)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    return _conv(F.conv2d, 2, input, num_filters, filter_size, stride,
                 padding, dilation, groups, bias_attr, act, data_format, name)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCDHW", name=None):
    return _conv(F.conv3d, 3, input, num_filters, filter_size, stride,
                 padding, dilation, groups, bias_attr, act, data_format, name)


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5, param_attr=None,
               bias_attr=None, data_layout="NCHW", is_test=False, name=None):
    """Static batch_norm: batch statistics in the training graph (serving
    graphs export the program with ``save_inference_model``)."""
    C = int(input.shape[1 if data_layout == "NCHW" else -1])
    scale = create_parameter([C], default_initializer=_ones,
                             name=_name(name, "scale"))
    bias = create_parameter([C], is_bias=True, name=_name(name, "bias"))
    if is_test:
        raise NotImplementedError(
            "static.nn.batch_norm(is_test=True) has no learned running "
            "statistics in this builder: export the trained program with "
            "save_inference_model and run that for eval/serving")
    rm = torch.zeros(C, device=input.device)
    rv = torch.ones(C, device=input.device)
    out = F.batch_norm(input, rm, rv, weight=scale, bias=bias, training=True,
                       momentum=momentum, epsilon=epsilon,
                       data_format=data_layout)
    return _act(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    shape = [int(s) for s in input.shape[begin_norm_axis:]]
    w = create_parameter(shape, default_initializer=_ones) if scale else None
    b = create_parameter(shape, is_bias=True) if shift else None
    out = F.layer_norm(input, normalized_shape=shape, weight=w, bias=b,
                       epsilon=epsilon)
    return _act(out, act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    C = int(input.shape[1 if data_layout == "NCHW" else -1])
    w = create_parameter([C], default_initializer=_ones)
    b = create_parameter([C], is_bias=True)
    out = F.group_norm(input, num_groups=groups, weight=w, bias=b,
                       epsilon=epsilon, data_format=data_layout)
    return _act(out, act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    C = int(input.shape[1])
    w = create_parameter([C], default_initializer=_ones)
    b = create_parameter([C], is_bias=True)
    return F.instance_norm(input, weight=w, bias=b, eps=epsilon)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    if mode == "all":
        shape = [1]
    elif mode == "channel":
        shape = [int(x.shape[1 if data_format == "NCHW" else -1])]
    else:
        raise NotImplementedError(
            "prelu mode='element' needs a per-element weight; the functional "
            "prelu takes scalar and per-channel weights")
    a = create_parameter(shape,
                         default_initializer=lambda s: np.full(s, 0.25,
                                                               np.float32))
    return F.prelu(x, a, data_format=data_format)


# -- control flow (Paddle's static/nn/control_flow.py) -----------------------

def _as_list(out):
    if out is None:
        return []
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _unlist(outs, like):
    if isinstance(like, (list, tuple)):
        return type(like)(outs)
    return outs[0] if outs else None


def cond(pred, true_fn=None, false_fn=None, name=None):
    """``paddle.static.nn.cond``: both branches are recorded; in the
    compiled program a traced predicate runs the taken one through
    ``torch.cond`` (the branches must give matching shapes and dtypes).
    At build time the predicate's build value picks the returned value."""
    t_out = true_fn() if true_fn is not None else None
    f_out = false_fn() if false_fn is not None else None
    t_list, f_list = _as_list(t_out), _as_list(f_out)
    if len(t_list) != len(f_list):
        raise TypeError(f"static.nn.cond: the branches give {len(t_list)} "
                        f"and {len(f_list)} outputs")
    if not t_list:
        return None
    node = _CondNode(pred, [_graph_tensor(t) for t in t_list],
                     [_graph_tensor(f) for f in f_list])
    return _unlist(_record_outputs(node, node.run(_Env({}, build=True))), t_out)


def _graph_tensor(v):
    """A branch output as a Tensor the replay resolves (numbers as 0-d
    constants)."""
    if isinstance(v, torch.Tensor):
        return v
    return wrap(torch.as_tensor(v))


def case(pred_fn_pairs, default=None, name=None):
    """The first predicate that holds picks its function (Paddle's
    ``case``)."""
    if not pred_fn_pairs:
        raise ValueError("case needs at least one (pred, fn) pair")
    (pred, fn), rest = pred_fn_pairs[0], pred_fn_pairs[1:]
    if not rest:
        return cond(pred, fn, default if default is not None else fn)
    return cond(pred, fn, lambda: case(rest, default))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Integer dispatch (Paddle's ``switch_case``)."""
    pairs = sorted(branch_fns.items() if isinstance(branch_fns, dict)
                   else list(enumerate(branch_fns)))
    return case([(branch_index == int(i), fn) for i, fn in pairs],
                default=default)


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """``paddle.static.nn.while_loop``: ``cond_fn`` and ``body_fn`` are
    recorded once over placeholders of the loop variables; in the compiled
    program a traced condition runs ``while_loop`` (the body must keep the
    variables' shapes). Returns the list of final variables (at build time,
    the initial values)."""
    init = [_graph_tensor(v) for v in loop_vars]
    values = [build_value(v).detach() if isinstance(v, StaticTensor)
              else torch.Tensor.detach(v) for v in init]
    uid = next_uid()
    keys = [("loop", uid, k) for k in range(len(init))]
    lvs = [_placeholder(v.clone(), key) for key, v in zip(keys, values)]
    cond_out = _graph_tensor(cond_fn(*lvs))
    body_outs = [_graph_tensor(o) for o in _as_list(body_fn(*lvs))]
    if len(body_outs) != len(init):
        raise TypeError(f"static.nn.while_loop: the body gives "
                        f"{len(body_outs)} values for {len(init)} loop "
                        f"variables")
    node = _WhileNode(init, keys, cond_out, body_outs)
    return _record_outputs(node, values)
