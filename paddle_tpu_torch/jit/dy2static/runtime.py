"""dy2static conversion runtime (the ``_jst`` namespace of transformed
code; counterpart of ``paddle_tpu/jit/dy2static/runtime.py``).

The AST transformer (``jit/dy2static/__init__.py``) rewrites Python control
flow into calls here. Each converter decides at run time: a condition that
is a Python value, or a tensor outside a trace, keeps exact Python
semantics; a tensor met while ``torch.compile`` / ``torch.export`` traces
(:func:`_traced`) lowers to ``torch.cond`` / ``torch._higher_order_ops.
while_loop``, so the function compiles to ONE graph (Paddle's
``convert_ifelse`` / ``convert_while_loop`` in
``python/paddle/jit/dy2static/convert_operators.py``).

Both higher-order ops take tensors only, and their branches / bodies must
agree in shapes and dtypes; Python numbers among the outputs become 0-d
tensors, other Python values must agree between branches (they are baked
into the graph), and the diagnostics say which variable broke the rule.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

__all__ = ["UNDEFINED", "convert_ifelse", "convert_while", "convert_bool_op",
           "convert_not", "to_index", "range_cond", "convert_assert"]


class _Undefined:
    """Marker for a name with no binding yet (Paddle's UndefinedVar). Using
    it raises clearly."""

    _msg = ("dy2static: variable used before assignment inside transformed "
            "control flow")

    def __repr__(self):
        return "<undefined>"

    def _raise(self, *a, **k):
        raise NameError(self._msg)

    __add__ = __radd__ = __sub__ = __mul__ = __call__ = _raise
    __bool__ = __iter__ = __len__ = _raise


UNDEFINED = _Undefined()


class _ProbeValue:
    """Placeholder carried through the LENIENT shape probe for loop
    variables first assigned inside the loop (e.g. the return-value slot the
    loop-control pass threads for ``return``-in-loop). During probing,
    ``convert_ifelse`` resolves a placeholder-vs-value pair to the value, so
    the variable's post-body shape/dtype can be discovered without a real
    initial value."""

    def __repr__(self):
        return "<probe>"


_STATE = {"probe": False}


def _is_placeholder(x):
    return isinstance(x, (_Undefined, _ProbeValue))


def _traced(x) -> bool:
    """A tensor met while ``torch.compile`` or ``torch.export`` traces:
    its value is unknown, so control flow on it must become a graph op."""
    return isinstance(x, torch.Tensor) and torch.compiler.is_compiling()


def _is_leaf(x):
    return isinstance(x, (torch.Tensor, _Undefined, _ProbeValue))


def _flatten(tree):
    return pytree.tree_flatten(tree, is_leaf=_is_leaf)


def _arraylike(a) -> bool:
    return isinstance(a, (torch.Tensor, bool, int, float))


def _as_tensor(a, like=None):
    """``a`` (a tensor or a Python number) as a tensor on ``like``'s
    device."""
    if isinstance(a, torch.Tensor):
        return a
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.tensor(a, device=dev)


def _fill_undefined_vars(t_out, f_out, names):
    """Resolve per-VARIABLE undefined branches before flattening.

    The outputs are tuples aligned with ``names`` (one slot per assigned
    variable); a variable may flatten to several leaves, so undefined-branch
    handling must happen at variable granularity: zipping names against the
    fully flattened leaf list would shift alignment after any nested value.
    """
    if not (names and isinstance(t_out, (tuple, list))
            and isinstance(f_out, (tuple, list))
            and len(t_out) == len(f_out) == len(names)):
        return t_out, f_out
    t_vars, f_vars = list(t_out), list(f_out)
    for k, n in enumerate(names):
        # probe mode ONLY: a WHOLE-variable placeholder (loop var first
        # assigned inside the loop) vs a structured value resolves to the
        # value at variable granularity. Outside the probe, a one-sided
        # _Undefined stays an error.
        ph_t = _STATE["probe"] and _is_placeholder(t_vars[k])
        ph_f = _STATE["probe"] and _is_placeholder(f_vars[k])
        if ph_t != ph_f:
            if ph_t:
                t_vars[k] = f_vars[k]
            else:
                f_vars[k] = t_vars[k]
            continue
        und_t = isinstance(t_vars[k], _Undefined)
        und_f = isinstance(f_vars[k], _Undefined)
        if not (und_t or und_f) or (und_t and und_f):
            continue
        if str(n).startswith("_pd_ctl_"):
            # loop-control slots (the threaded return value) are only ever
            # READ under their guard flag, so the undefined branch can carry
            # zeros (Paddle fills UndefinedVar with RETURN_NO_VALUE the
            # same way), per leaf over the defined value's structure
            defined = f_vars[k] if und_t else t_vars[k]

            def _zero(leaf):
                if isinstance(leaf, torch.Tensor):
                    return torch.zeros_like(leaf)
                if isinstance(leaf, (bool, int, float)):
                    return type(leaf)(0)
                return leaf  # non-array python values: copy defined side

            fill = pytree.tree_map(_zero, defined, is_leaf=_is_leaf)
            if und_t:
                t_vars[k] = fill
            else:
                f_vars[k] = fill
        else:
            raise NameError(
                f"dy2static: variable '{n}' is assigned in only one branch "
                "of a compiled if/else; assign it in both (or before)")
    return type(t_out)(t_vars), type(f_out)(f_vars)


def _merge_spec(a, b):
    """The probe's merge of two branch values: the broadcast / promoted
    zeros of both (Python values: the first)."""
    if _arraylike(a) and _arraylike(b) and (
            isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor)):
        ta, tb = _as_tensor(a, b), _as_tensor(b, a)
        return torch.zeros_like(ta) + torch.zeros_like(tb)
    return a


def convert_ifelse(pred, true_fn, false_fn, names=()):
    """if/else over a possibly-traced predicate.

    Python values and eager tensors: exact Python semantics (only the taken
    branch runs). Traced: both branches are traced to learn their outputs,
    then ``torch.cond`` runs the taken one; their outputs must match in
    structure, shape and dtype (Paddle's cond op contract)."""
    if not _traced(pred):
        return true_fn() if pred else false_fn()

    t_out = true_fn()
    f_out = false_fn()
    t_out, f_out = _fill_undefined_vars(t_out, f_out, names)
    t_leaves, t_def = _flatten(t_out)
    f_leaves, f_def = _flatten(f_out)
    if t_def != f_def:
        if any(_is_placeholder(l) for l in t_leaves + f_leaves) and any(
                str(n).startswith("_pd_ctl_") for n in names):
            raise TypeError(
                "dy2static: a `return` inside a compiled loop produced a "
                "non-array structure (e.g. a tuple); return a single tensor "
                "from inside the loop, or initialize the result before it")
        raise TypeError(
            f"dy2static: if/else branches assign mismatched structures for "
            f"{names or 'outputs'}: {t_def} vs {f_def}")
    if _STATE["probe"]:
        # lenient shape probe (no torch.cond): placeholder-vs-value resolves
        # to the value; value-vs-value merges to the broadcast/promoted spec
        merged = []
        for tl, fl in zip(t_leaves, f_leaves):
            if _is_placeholder(tl):
                merged.append(fl)
            elif _is_placeholder(fl):
                merged.append(tl)
            else:
                merged.append(_merge_spec(tl, fl))
        return pytree.tree_unflatten(merged, t_def)
    for tl, fl in zip(t_leaves, f_leaves):
        und_t, und_f = isinstance(tl, _Undefined), isinstance(fl, _Undefined)
        if und_t != und_f:
            # single-sided undefineds are resolved per VARIABLE by
            # _fill_undefined_vars above; reaching here means the outputs
            # were not a names-aligned tuple, so no leaf-level name can be
            # trusted: fail loudly instead of zero-filling the wrong leaf
            raise NameError(
                f"dy2static: one of {names or 'the outputs'} is assigned in "
                "only one branch of a compiled if/else; assign it in both "
                "(or before)")
    # tensors and Python numbers go through torch.cond (numbers as 0-d
    # tensors); other Python leaves must agree: they are baked into the graph
    sel, dtypes = [], []
    for tl, fl in zip(t_leaves, f_leaves):
        if isinstance(tl, _Undefined):
            sel.append(False)
            continue
        if _arraylike(tl) and _arraylike(fl):
            ta, tb = _as_tensor(tl, fl), _as_tensor(fl, tl)
            if ta.shape != tb.shape:
                raise TypeError(
                    f"dy2static: if/else branches give {names or 'outputs'} "
                    f"different shapes {tuple(ta.shape)} vs "
                    f"{tuple(tb.shape)}; torch.cond needs equal shapes")
            sel.append(True)
            dtypes.append(torch.promote_types(ta.dtype, tb.dtype))
            continue
        if tl is not fl and tl != fl:
            raise TypeError(
                "dy2static: non-tensor branch outputs differ "
                f"({tl!r} vs {fl!r}); they would be baked into the program")
        sel.append(False)

    if not any(sel):
        return pytree.tree_unflatten(t_leaves, t_def)
    picked = torch.cond(
        pred.reshape(()).to(torch.bool),
        _cond_branch(true_fn, f_out, names, sel, dtypes, pred),
        _cond_branch(false_fn, t_out, names, sel, dtypes, pred), ())
    it = iter(picked)
    merged = [next(it) if keep else tl for tl, keep in zip(t_leaves, sel)]
    return pytree.tree_unflatten(merged, t_def)


def _cond_branch(fn, other_out, names, sel, dtypes, like):
    """One side of ``torch.cond``: ``fn``'s outputs (undefined loop-control
    slots zero-filled from the other side's), the selected leaves as
    tensors of the merged dtypes."""
    def run():
        out, _ = _fill_undefined_vars(fn(), other_out, names)
        leaves, _ = _flatten(out)
        picked = []
        for leaf, keep in zip(leaves, sel):
            if keep:
                dt = dtypes[len(picked)]
                # torch.cond's outputs may not alias its inputs
                picked.append(_as_tensor(leaf, like).to(dt).clone())
        return tuple(picked)
    return run


def _probe_undefined(body_fn, vars_in, names):
    """Resolve UNDEFINED loop vars: variables assigned in the body before any
    read get zero-initialized with the body's output shape/dtype, which is
    equivalent whenever the eager code would not hit UnboundLocalError. The
    body runs under the LENIENT probe (placeholders flow through
    convert_ifelse picking the assigned branch), so even vars assigned only
    under data-dependent conditions, like the return-value slot the
    loop-control pass threads, get a spec. The probe's ops are dead code of
    the graph."""
    vars_list = list(vars_in)
    # placeholders can also arrive from an ENCLOSING loop's probe (nested
    # loops whose outer condition is traced from the start): re-probe them
    # here the same as UNDEFINED
    undef = [i for i, v in enumerate(vars_list) if _is_placeholder(v)]
    if not undef:
        return vars_list
    probe_vars = list(vars_list)
    for i in undef:
        probe_vars[i] = _ProbeValue()
    resolved: dict[int, tuple] = {}
    for _ in range(4):
        prev_probe = _STATE["probe"]   # reentrant: nested loops probe too
        _STATE["probe"] = True
        try:
            out = tuple(body_fn(*probe_vars))
        finally:
            _STATE["probe"] = prev_probe
        progress = False
        for i in undef:
            leaves, tdef = _flatten(out[i])
            if any(_is_placeholder(x) for x in leaves):
                continue                # still unassigned this round
            zeros = [torch.zeros_like(_as_tensor(x)) for x in leaves]
            key = tuple((tuple(z.shape), z.dtype) for z in zeros)
            if resolved.get(i) != key:
                probe_vars[i] = pytree.tree_unflatten(zeros, tdef)
                resolved[i] = key
                progress = True
        if len(resolved) == len(undef) and not progress:
            return probe_vars
        if not progress:
            break
    missing = [names[i] if i < len(names) else str(i)
               for i in undef if i not in resolved]
    if missing:
        raise TypeError(
            f"dy2static: loop variable(s) {missing} are never assigned a "
            "concrete value on any path through the compiled loop body; "
            "initialize them before the loop")
    raise TypeError(
        f"dy2static: could not infer a stable shape for loop variable(s) "
        f"{[names[i] for i in undef]} first assigned inside a compiled loop")


def convert_while(cond_fn, body_fn, init_vars, names=()):
    """while over a possibly-traced condition.

    Python condition: a plain Python while. Traced:
    ``torch._higher_order_ops.while_loop`` with the assigned-in-body
    variables as the carry (Python numbers become 0-d tensors); carries
    must keep their shapes across iterations, and keep their dtypes (a
    body's result is cast back to its carry's dtype)."""
    from torch._higher_order_ops import while_loop

    vars_t = tuple(init_vars)
    # Python-condition iterations run as plain Python; if the condition
    # BECOMES traced mid-loop (e.g. a break/return guard flag merged through
    # torch.cond turns the test into a tensor), the remaining iterations
    # fall through to the traced lowering below with the current vars
    while True:
        p = cond_fn(*vars_t)
        if _traced(p):
            break
        if not p:
            return vars_t
        vars_t = tuple(body_fn(*vars_t))

    vars_list = _probe_undefined(body_fn, vars_t, names)
    if _STATE["probe"]:
        # inside an enclosing loop's probe: a compiled loop keeps its
        # carries' shapes, so its results' spec is its resolved inputs' (a
        # real while_loop here would be dead code the graph still runs);
        # numbers come out as the tensors the loop would carry
        leaves, treedef = _flatten(tuple(vars_list))
        return tuple(pytree.tree_unflatten(
            [_as_tensor(x, p) if _arraylike(x) else x for x in leaves],
            treedef))
    leaves, treedef = _flatten(tuple(vars_list))
    like = next((x for x in leaves if isinstance(x, torch.Tensor)), p)
    for n, x in zip(_leaf_names(names, vars_list), leaves):
        if not _arraylike(x):
            raise TypeError(
                f"dy2static: loop variable '{n}' holds {x!r}, which a "
                "compiled while cannot carry; carry tensors or numbers")
    init = [_as_tensor(x, like) for x in leaves]
    leaf_names = _leaf_names(names, vars_list)

    def c(*flat):
        vs = pytree.tree_unflatten(list(flat), treedef)
        return _as_tensor(cond_fn(*vs), like).to(torch.bool).reshape(())

    def b(*flat):
        vs = pytree.tree_unflatten(list(flat), treedef)
        out_leaves, out_def = _flatten(tuple(body_fn(*vs)))
        if out_def != treedef:
            raise TypeError(
                f"dy2static: while body changed the structure of loop "
                f"variables {names}: {out_def} vs {treedef}")
        outs = []
        for n, a, o in zip(leaf_names, init, out_leaves):
            o = _as_tensor(o, like)
            if tuple(a.shape) != tuple(o.shape):
                raise TypeError(
                    f"dy2static: loop variable '{n}' changes shape "
                    f"{tuple(a.shape)} -> {tuple(o.shape)} inside a "
                    "compiled while; shapes must be loop-invariant")
            # stable carry dtypes; a fresh tensor (while_loop's outputs may
            # not alias its inputs)
            outs.append(o.to(a.dtype).clone())
        return tuple(outs)

    out_flat = while_loop(c, b, tuple(init))
    return tuple(pytree.tree_unflatten(list(out_flat), treedef))


def _leaf_names(names, vars_list):
    """One name per flattened leaf (a loop var may flatten to several)."""
    if len(names) != len(vars_list):
        return [""] * len(_flatten(tuple(vars_list))[0])
    out = []
    for n, v in zip(names, vars_list):
        out.extend([n] * len(_flatten(v)[0]))
    return out


def convert_bool_op(op, *thunks):
    """``and``/``or`` chains: Python short-circuit semantics for Python
    values and eager tensors, ``logical_and/or`` once an operand is
    traced."""
    val = thunks[0]()
    for t in thunks[1:]:
        if _traced(val):
            nxt = _as_tensor(t(), val)
            fn = torch.logical_and if op == "and" else torch.logical_or
            val = fn(val.to(torch.bool), nxt.to(torch.bool))
            continue
        truthy = bool(val)
        if op == "and":
            if not truthy:
                return val
            val = t()
        else:
            if truthy:
                return val
            val = t()
    return val


def convert_not(x):
    if _traced(x):
        return torch.logical_not(x.to(torch.bool))
    return not x


def to_index(x):
    """A range() bound that may be a tensor."""
    if isinstance(x, torch.Tensor):
        return x if _traced(x) else int(x)
    return x


def range_cond(i, stop, step):
    """Continuation test of a for-range lowered to while (sign-aware)."""
    if _traced(step):
        i, stop = _as_tensor(i, step), _as_tensor(stop, step)
        return torch.where(step > 0, i < stop, i > stop)
    return (i < stop) if step > 0 else (i > stop)


def convert_assert(test, msg=None):
    """Python asserts keep Python semantics; traced asserts are dropped
    (Paddle's Assert op is a no-op in inference programs too)."""
    if _traced(test):
        return
    if not test:
        raise AssertionError(msg if msg is not None else "")
