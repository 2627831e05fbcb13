"""dy2static: AST transformation of data-dependent Python control flow
(counterpart of ``paddle_tpu/jit/dy2static/__init__.py``, of which this is a
copy: it imports only ``ast``, ``inspect`` and ``textwrap``).

Paddle converts Python ``if``/``while``/``for`` over tensors into
static-graph control-flow ops through one AST transformer per construct
(``python/paddle/jit/dy2static/ifelse_transformer.py``,
``loop_transformer.py``, ``logical_transformer.py``). Here the rewritten
code calls the converters in ``runtime.py``, which lower tensor conditions
met while ``torch.compile`` traces to ``torch.cond`` /
``torch._higher_order_ops.while_loop``, so a function with data-dependent
control flow compiles to ONE graph instead of breaking the graph (which
``to_static``'s ``fullgraph=True`` refuses).

Supported rewrites:
- ``if``/``elif``/``else`` over traced predicates (assignment merging, and
  the early-return pattern via return-normalization);
- ``while`` with traced conditions (assigned names become the loop carry);
- ``for .. in range(..)`` with traced bounds (lowered to while);
- ``break``/``continue``/``return`` inside compiled while/for-range loops:
  lowered to boolean guard flags threaded through the loop carry, with the
  statements after a control transfer wrapped in flag-guarded ifs, Paddle's
  ``break_continue_transformer.py`` / ``return_transformer.py`` strategy;
- ``and``/``or``/``not`` over tensors; ternary ``a if c else b``; ``assert``.

Unsupported syntax raises :class:`UnsupportedSyntax`; ``to_static`` then
either raises (default) or, with the explicit eager-fallback opt-in, warns
and runs the function eagerly.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap

__all__ = ["transform_function", "UnsupportedSyntax"]


class UnsupportedSyntax(Exception):
    """Control flow the transformer cannot lower to torch.cond / while_loop."""


_CTRL = (ast.Return, ast.Break, ast.Continue)
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def _walk_shallow(stmts, *, into_loops=True):
    """Yield nodes in ``stmts`` without descending into nested function/class
    scopes (their statements belong to a different frame); optionally skip
    loop bodies (break/continue inside them are legal)."""
    stack = list(stmts)
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, _SCOPES):
            continue
        if not into_loops and isinstance(n, (ast.For, ast.While)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _assigned_names(stmts):
    """Names stored at this scope level inside ``stmts`` (the branch/loop
    outputs), excluding nested function/class scopes."""
    names = set()
    for n in _walk_shallow(stmts):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            names.add(n.id)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
    # generated transform internals are scoped to their own branch/body —
    # EXCEPT loop-control flags (_pd_ctl_*), which must be loop carries
    return {n for n in names
            if n.startswith("_pd_ctl_") or not n.startswith("_pd_")}


def _has_side_store(stmts):
    """Attribute/Subscript stores (object mutation) can't be replayed in both
    torch.cond branches safely."""
    for n in _walk_shallow(stmts):
        if isinstance(n, (ast.Attribute, ast.Subscript)) and isinstance(
                n.ctx, (ast.Store, ast.Del)):
            return True
    return False


def _contains(stmts, kinds, *, into_loops=True):
    for n in _walk_shallow(stmts, into_loops=into_loops):
        if isinstance(n, kinds):
            return True
    return False


def _ends_in_return(stmts):
    """All control paths through ``stmts`` end in return (recursing into a
    trailing if/else)."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, ast.Return):
        return True
    if isinstance(last, ast.If):
        return _ends_in_return(last.body) and _ends_in_return(last.orelse)
    return False


def _normalize_returns(stmts):
    """Early-return normalization: ``if c: return a`` followed by S becomes
    ``if c: return a  else: S`` so both branches end in return and the If can
    lower to one convert_ifelse (the reference's return_transformer role)."""
    out = []
    for idx, s in enumerate(stmts):
        if isinstance(s, ast.If):
            s.body = _normalize_returns(s.body)
            s.orelse = _normalize_returns(s.orelse)
            rest = stmts[idx + 1:]
            body_ret = _ends_in_return(s.body)
            else_ret = _ends_in_return(s.orelse)
            if body_ret and not else_ret:
                merged = list(s.orelse) + rest
                s.orelse = (_normalize_returns(merged) if merged
                            else [ast.Return(value=ast.Constant(value=None))])
                out.append(s)
                return out
            if else_ret and not body_ret and rest:
                s.body = _normalize_returns(list(s.body) + rest)
                out.append(s)
                return out
            if body_ret and else_ret:
                out.append(s)
                return out  # anything after is dead code
            out.append(s)
        elif isinstance(s, (ast.While, ast.For)):
            s.body = _normalize_returns(s.body)
            out.append(s)
        else:
            out.append(s)
    return out


def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _jst_call(fn_name, args):
    return ast.Call(
        func=ast.Attribute(value=_name("_jst"), attr=fn_name, ctx=ast.Load()),
        args=args, keywords=[])


def _guard_init(names):
    """A marker per name that the name may be unbound here: the hoisting
    pass (:func:`_hoist_guards`) turns the markers of a function into
    ``name = _jst.UNDEFINED`` at the top of that function (where it is not
    an argument). The reference reads the name in a ``try`` / ``except
    NameError`` at this point; Dynamo cannot trace a read of an unbound
    cell, and binding the marker at entry is the same wherever the name
    is first bound later."""
    out = []
    for n in sorted(names):
        mark = ast.Pass()
        mark._pd_guard = n
        out.append(mark)
    return out


class _HoistGuards(ast.NodeTransformer):
    """Move each function's :func:`_guard_init` markers to ``name =
    _jst.UNDEFINED`` assignments at the top of that function."""

    def visit_FunctionDef(self, node):
        self.generic_visit(node)        # nested helpers first
        names = []
        node.body = self._strip(node.body, names)
        args = {a.arg for a in (*node.args.posonlyargs, *node.args.args,
                                *node.args.kwonlyargs)}
        args |= {a.arg for a in (node.args.vararg, node.args.kwarg) if a}
        inits = [ast.Assign(
            targets=[_name(n, ast.Store())],
            value=ast.Attribute(value=_name("_jst"), attr="UNDEFINED",
                                ctx=ast.Load()))
            for n in dict.fromkeys(names) if n not in args]
        node.body = inits + node.body
        return node

    def _strip(self, stmts, names):
        out = []
        for st in stmts:
            if hasattr(st, "_pd_guard"):
                names.append(st._pd_guard)
                continue
            if not isinstance(st, _SCOPES):
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(st, field, None)
                    if isinstance(sub, list) and sub and \
                            isinstance(sub[0], ast.stmt):
                        setattr(st, field, self._strip(sub, names) or
                                [ast.Pass()])
                for h in getattr(st, "handlers", ()):
                    h.body = self._strip(h.body, names) or [ast.Pass()]
            out.append(st)
        return out


def _names_tuple(names, ctx=None):
    return ast.Tuple(elts=[_name(n, ctx or ast.Load()) for n in names],
                     ctx=ctx or ast.Load())


def _str_tuple(names):
    return ast.Tuple(elts=[ast.Constant(value=n) for n in names],
                     ctx=ast.Load())


def _desugar_for_range(node, tag):
    """Shared for-range → while desugar. Returns (setup_stmts, while_node,
    incr_stmt) with the increment NOT yet appended to the body (the
    loop-control pass must guard it), or None if ``node`` isn't a plain
    for-over-range."""
    if not (isinstance(node.iter, ast.Call)
            and isinstance(node.iter.func, ast.Name)
            and node.iter.func.id == "range"
            and isinstance(node.target, ast.Name)
            and not node.orelse
            and not node.iter.keywords):
        return None
    i = node.target.id
    ra = node.iter.args
    if len(ra) == 1:
        start, stop, step = ast.Constant(value=0), ra[0], ast.Constant(value=1)
    elif len(ra) == 2:
        start, stop, step = ra[0], ra[1], ast.Constant(value=1)
    else:
        start, stop, step = ra[0], ra[1], ra[2]
    sv, ev, tv = (f"_pd_start_{tag}", f"_pd_stop_{tag}", f"_pd_step_{tag}")
    setup = [
        ast.Assign(targets=[_names_tuple([sv, ev, tv], ast.Store())],
                   value=ast.Tuple(elts=[
                       _jst_call("to_index", [start]),
                       _jst_call("to_index", [stop]),
                       _jst_call("to_index", [step])], ctx=ast.Load())),
        ast.Assign(targets=[_name(i, ast.Store())], value=_name(sv)),
    ]
    incr = ast.Assign(
        targets=[_name(i, ast.Store())],
        value=ast.BinOp(left=_name(i), op=ast.Add(), right=_name(tv)))
    loop = ast.While(
        test=_jst_call("range_cond", [_name(i), _name(ev), _name(tv)]),
        body=list(node.body), orelse=[])
    return setup, loop, incr


class LoopControlLowering(ast.NodeTransformer):
    """Pre-pass: lower break/continue/return inside compiled loops to guard
    flags threaded through the loop carry (Paddle's strategy:
    break_continue_transformer.py + return_transformer.py). Runs BEFORE
    Dy2StaticTransformer so the generated flag-guard ifs and flag-extended
    loop conditions go through the normal if/while conversion.

    Flag names use the reserved ``_pd_ctl_`` prefix: excluded from user
    namespaces (transform_function rejects user identifiers starting with
    ``_pd_``) but explicitly exempted in ``_assigned_names`` so they become
    loop-carry variables."""

    def __init__(self):
        self._n = 0

    def _uid(self):
        self._n += 1
        return self._n

    @staticmethod
    def _has_ctrl(stmts):
        return _contains(stmts, _CTRL, into_loops=False)

    def visit_While(self, node):
        self.generic_visit(node)  # nested loops first (inner returns
        # become guarded returns in this body, then lower here)
        if node.orelse:
            raise UnsupportedSyntax("while/else")
        if not self._has_ctrl(node.body):
            return node
        return self._lower(node)

    def visit_For(self, node):
        self.generic_visit(node)
        if not self._has_ctrl(node.body):
            return node
        if node.orelse:
            raise UnsupportedSyntax("for/else with break/continue")
        des = _desugar_for_range(node, f"c{self._uid()}")
        if des is None:
            # concrete-iterable python loop: the trip count is static, so
            # break/continue under TRACED conditions lower by guarded
            # unrolling — every iteration still runs, wrapped in
            # `if not (brk|ret)`, and the guard ifs become torch.cond in the
            # main transformer (Paddle's break_continue_transformer.py
            # threads the same flags through its static loop)
            return self._lower_concrete_for(node)
        setup, loop, incr = des
        return setup + self._lower(loop, incr=incr)

    # -- the guard-threading core ------------------------------------------
    def _lower(self, node, incr=None):
        uid = self._uid()
        has_brk = _contains(node.body, (ast.Break,), into_loops=False)
        has_cont = _contains(node.body, (ast.Continue,), into_loops=False)
        has_ret = _contains(node.body, (ast.Return,), into_loops=False)
        flags = {
            "brk": f"_pd_ctl_brk_{uid}" if has_brk else None,
            "cont": f"_pd_ctl_cont_{uid}" if has_cont else None,
            "retf": f"_pd_ctl_retf_{uid}" if has_ret else None,
            "retv": f"_pd_ctl_retv_{uid}" if has_ret else None,
        }
        body = self._thread(list(node.body), flags)
        # leftover control statements mean a construct we can't thread
        # (e.g. break inside try/with)
        for n in _walk_shallow(body, into_loops=False):
            if isinstance(n, _CTRL) and not isinstance(n, ast.Return):
                raise UnsupportedSyntax(
                    "break/continue inside a construct the loop-control "
                    "pass cannot thread (e.g. try/with)")
        prologue = []
        if has_cont:
            prologue.append(_assign_const(flags["cont"], False))
        exit_flags = [f for f in (flags["brk"], flags["retf"]) if f]
        if incr is not None:
            # python for semantics: continue still increments; break/return
            # skip the increment
            if exit_flags:
                body.append(ast.If(test=self._not_any(exit_flags),
                                   body=[incr], orelse=[]))
            else:
                body.append(incr)
        node.body = prologue + body
        if exit_flags:
            node.test = ast.BoolOp(
                op=ast.And(),
                values=[node.test] + [ast.UnaryOp(op=ast.Not(),
                                                  operand=_name(f))
                                      for f in exit_flags])
        pre = [_assign_const(f, False)
               for f in (flags["brk"], flags["cont"], flags["retf"]) if f]
        post = []
        if has_ret:
            post.append(ast.If(test=_name(flags["retf"]),
                               body=[ast.Return(value=_name(flags["retv"]))],
                               orelse=[]))
        return pre + [node] + post

    def _lower_concrete_for(self, node):
        """Guarded unroll for a python-iterable for loop containing
        break/continue/return: flags thread exactly as in _lower, but the
        python for statement itself is kept (static trip count)."""
        uid = self._uid()
        has_brk = _contains(node.body, (ast.Break,), into_loops=False)
        has_cont = _contains(node.body, (ast.Continue,), into_loops=False)
        has_ret = _contains(node.body, (ast.Return,), into_loops=False)
        flags = {
            "brk": f"_pd_ctl_brk_{uid}" if has_brk else None,
            "cont": f"_pd_ctl_cont_{uid}" if has_cont else None,
            "retf": f"_pd_ctl_retf_{uid}" if has_ret else None,
            "retv": f"_pd_ctl_retv_{uid}" if has_ret else None,
        }
        body = self._thread(list(node.body), flags)
        for n in _walk_shallow(body, into_loops=False):
            if isinstance(n, _CTRL) and not isinstance(n, ast.Return):
                raise UnsupportedSyntax(
                    "break/continue inside a construct the loop-control "
                    "pass cannot thread (e.g. try/with)")
        prologue = []
        if has_cont:
            prologue.append(_assign_const(flags["cont"], False))
        exit_flags = [f for f in (flags["brk"], flags["retf"]) if f]
        if exit_flags:
            # python freezes the loop variable at the break point, but the
            # kept-for statement reassigns it every iteration — so iterate a
            # hidden temp and only bind the real target inside the guard
            it_tmp = f"_pd_ctl_it_{uid}"
            bind = ast.Assign(targets=[node.target],
                              value=_name(it_tmp))
            node.target = _name(it_tmp, ast.Store())
            node.body = [ast.If(test=self._not_any(exit_flags),
                                body=[bind] + prologue + body, orelse=[])]
        else:
            node.body = prologue + body
        pre = [_assign_const(f, False)
               for f in (flags["brk"], flags["cont"], flags["retf"]) if f]
        post = []
        if has_ret:
            post.append(ast.If(test=_name(flags["retf"]),
                               body=[ast.Return(value=_name(flags["retv"]))],
                               orelse=[]))
        return pre + [node] + post

    @staticmethod
    def _not_any(flag_names):
        if len(flag_names) == 1:
            return ast.UnaryOp(op=ast.Not(), operand=_name(flag_names[0]))
        return ast.UnaryOp(
            op=ast.Not(),
            operand=ast.BoolOp(op=ast.Or(),
                               values=[_name(f) for f in flag_names]))

    @staticmethod
    def _check_return_value(s):
        """Tuple/single-value returns both lower (the _pd_ctl_retv carry
        holds a pytree; convert_ifelse zero-fills undefined branches per
        VARIABLE over all leaves). Only a bare ``return`` is rejected —
        it would make the function's value None on one path and the carry
        can't represent that."""
        if s.value is None:
            raise UnsupportedSyntax(
                "bare `return` inside a compiled loop; return a value "
                "(or restructure with a flag variable set in the loop)")

    def _thread(self, stmts, flags):
        """Rewrite one statement list: control transfers become flag sets;
        everything after a statement that may have transferred control is
        wrapped in ``if not (<flags>):``. Unreachable trailing code after a
        bare break/continue/return is dropped (python drops it too)."""
        out = []
        for idx, s in enumerate(stmts):
            rest = stmts[idx + 1:]
            if isinstance(s, ast.Break):
                out.append(_assign_const(flags["brk"], True))
                return out
            if isinstance(s, ast.Continue):
                out.append(_assign_const(flags["cont"], True))
                return out
            if isinstance(s, ast.Return):
                self._check_return_value(s)
                out.append(ast.Assign(
                    targets=[_name(flags["retv"], ast.Store())],
                    value=s.value))
                out.append(_assign_const(flags["retf"], True))
                return out
            if isinstance(s, ast.If) and self._has_ctrl([s]):
                s.body = self._thread(s.body, flags)
                if s.orelse:
                    s.orelse = self._thread(s.orelse, flags)
                out.append(s)
                if rest:
                    used = [f for k, f in flags.items()
                            if f and k != "retv"]
                    out.append(ast.If(test=self._not_any(used),
                                      body=self._thread(rest, flags),
                                      orelse=[]))
                return out
            out.append(s)
        return out


def _assign_const(name, value):
    return ast.Assign(targets=[_name(name, ast.Store())],
                      value=ast.Constant(value=value))


class Dy2StaticTransformer(ast.NodeTransformer):
    def __init__(self):
        self._n = 0

    def _uid(self):
        self._n += 1
        return self._n

    # -- function entry ------------------------------------------------------
    def visit_FunctionDef(self, node):
        if not _ends_in_return(node.body):
            # make the implicit fall-off-the-end return explicit so
            # early-return normalization always has a tail to merge
            node.body = list(node.body) + [
                ast.Return(value=ast.Constant(value=None))]
        node.body = _normalize_returns(node.body)
        self.generic_visit(node)
        return node

    # -- boolean operators ---------------------------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        op = "and" if isinstance(node.op, ast.And) else "or"
        thunks = [ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[], vararg=None,
                               kwonlyargs=[], kw_defaults=[], kwarg=None,
                               defaults=[]),
            body=v) for v in node.values]
        return _jst_call("convert_bool_op", [ast.Constant(value=op), *thunks])

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return _jst_call("convert_not", [node.operand])
        return node

    def visit_IfExp(self, node):
        self.generic_visit(node)
        mk = lambda b: ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[], vararg=None,
                               kwonlyargs=[], kw_defaults=[], kwarg=None,
                               defaults=[]),
            body=b)
        return _jst_call("convert_ifelse",
                         [node.test, mk(node.body), mk(node.orelse)])

    def visit_Assert(self, node):
        self.generic_visit(node)
        return ast.Expr(value=_jst_call(
            "convert_assert",
            [node.test] + ([node.msg] if node.msg else [])))

    # -- if / else -----------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        body_ret = _ends_in_return(node.body)
        else_ret = _ends_in_return(node.orelse)

        # branch helpers take the assigned names as PARAMETERS (called with
        # the current outer values) so read-then-write patterns like
        # ``y = y * 2`` don't trip UnboundLocalError — the reference's
        # ifelse transformer passes input vars the same way
        def _branch(name, stmts, params):
            return ast.FunctionDef(
                name=name,
                args=ast.arguments(
                    posonlyargs=[], args=[ast.arg(arg=n) for n in params],
                    vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
                    defaults=[]),
                body=stmts, decorator_list=[], returns=None)

        def _thunk(fn_name, params):
            return ast.Lambda(
                args=_noargs(),
                body=ast.Call(func=_name(fn_name),
                              args=[_name(n) for n in params], keywords=[]))

        if body_ret and else_ret:
            if _has_side_store(node.body + node.orelse):
                raise UnsupportedSyntax(
                    "attribute/subscript assignment inside a data-dependent "
                    "if branch (object mutation can't run in both torch.cond "
                    "branches)")
            names = sorted(_assigned_names(node.body)
                           | _assigned_names(node.orelse))
            uid = self._uid()
            t_def = _branch(f"_pd_ret_true_{uid}", list(node.body), names)
            f_def = _branch(f"_pd_ret_false_{uid}", list(node.orelse), names)
            ret = ast.Return(value=_jst_call(
                "convert_ifelse",
                [node.test, _thunk(t_def.name, names),
                 _thunk(f_def.name, names)]))
            return [*_guard_init(names), t_def, f_def, ret]

        if _contains(node.body + node.orelse, (ast.Return,)):
            raise UnsupportedSyntax(
                "return inside a data-dependent if branch "
                "(only the early-return pattern is supported)")
        # break/continue scoped to a nested concrete loop are legal python;
        # only bare ones (targeting a loop outside this if) can't convert
        if _contains(node.body + node.orelse, (ast.Break, ast.Continue),
                     into_loops=False):
            raise UnsupportedSyntax(
                "break/continue inside a data-dependent if branch")
        if _has_side_store(node.body + node.orelse):
            raise UnsupportedSyntax(
                "attribute/subscript assignment inside a data-dependent "
                "if branch (object mutation can't run in both torch.cond "
                "branches)")
        names = sorted(_assigned_names(node.body) | _assigned_names(node.orelse))
        uid = self._uid()
        ret_tuple = ast.Return(value=_names_tuple(names))
        t_def = _branch(f"_pd_true_{uid}",
                        list(node.body) + [ret_tuple], names)
        f_def = _branch(f"_pd_false_{uid}",
                        (list(node.orelse) or [ast.Pass()]) + [ret_tuple],
                        names)
        call = _jst_call("convert_ifelse",
                         [node.test, _thunk(t_def.name, names),
                          _thunk(f_def.name, names), _str_tuple(names)])
        if names:
            assign = ast.Assign(
                targets=[_names_tuple(names, ast.Store())], value=call)
        else:
            assign = ast.Expr(value=call)
        return [*_guard_init(names), t_def, f_def, assign]

    # -- while ---------------------------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse:
            raise UnsupportedSyntax("while/else")
        if _contains(node.body, (ast.Return,)):
            raise UnsupportedSyntax("return inside a data-dependent while")
        if _contains(node.body, (ast.Break, ast.Continue), into_loops=False):
            raise UnsupportedSyntax(
                "break/continue inside a data-dependent while")
        if _has_side_store(node.body):
            raise UnsupportedSyntax(
                "attribute/subscript assignment inside a data-dependent "
                "while body")
        names = sorted(_assigned_names(node.body))
        uid = self._uid()
        args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in names], vararg=None,
            kwonlyargs=[], kw_defaults=[], kwarg=None, defaults=[])
        cond_def = ast.FunctionDef(
            name=f"_pd_while_cond_{uid}", args=args,
            body=[ast.Return(value=node.test)], decorator_list=[], returns=None)
        body_def = ast.FunctionDef(
            name=f"_pd_while_body_{uid}",
            args=ast.arguments(
                posonlyargs=[], args=[ast.arg(arg=n) for n in names],
                vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
                defaults=[]),
            body=list(node.body) + [ast.Return(value=_names_tuple(names))],
            decorator_list=[], returns=None)
        call = _jst_call("convert_while",
                         [_name(cond_def.name), _name(body_def.name),
                          _names_tuple(names), _str_tuple(names)])
        if names:
            assign = ast.Assign(
                targets=[_names_tuple(names, ast.Store())], value=call)
        else:
            assign = ast.Expr(value=call)
        return [*_guard_init(names), cond_def, body_def, assign]

    # -- for over range ------------------------------------------------------
    def visit_For(self, node):
        des = _desugar_for_range(node, str(self._uid()))
        if des is not None:
            setup, loop, incr = des
            loop.body = loop.body + [incr]
            result = self.visit_While(loop)
            return setup + (result if isinstance(result, list) else [result])
        self.generic_visit(node)
        return node


def _noargs():
    return ast.arguments(posonlyargs=[], args=[], vararg=None, kwonlyargs=[],
                         kw_defaults=[], kwarg=None, defaults=[])


def transform_function(fn):
    """Rewrite ``fn``'s control flow through the conversion runtime; returns
    a new function object over the same module globals, with the closure's
    values snapshot (Paddle does the same in its ast-to-func utility,
    python/paddle/jit/dy2static/utils.py ast_to_func)."""
    inner = inspect.unwrap(fn)
    inner = getattr(inner, "__func__", inner)  # bound method -> function
    try:
        src = textwrap.dedent(inspect.getsource(inner))
    except (OSError, TypeError) as e:
        raise UnsupportedSyntax(f"source unavailable: {e}") from e
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        raise UnsupportedSyntax(f"could not re-parse source: {e}") from e
    if not tree.body or not isinstance(tree.body[0], ast.FunctionDef):
        raise UnsupportedSyntax("not a plain function definition")
    fdef = tree.body[0]
    fdef.decorator_list = []
    for n in ast.walk(fdef):
        # the _pd_ namespace (branch helpers, loop internals, control flags)
        # is reserved for generated code; a user identifier there could
        # collide with — or trigger — flag-specific semantics like the
        # undefined-branch zero-fill
        if isinstance(n, ast.Name) and n.id.startswith("_pd_"):
            raise UnsupportedSyntax(
                f"identifier {n.id!r} uses the reserved '_pd_' prefix")
    LoopControlLowering().visit(fdef)
    Dy2StaticTransformer().visit(fdef)
    _HoistGuards().visit(fdef)
    # the rewritten function is built inside a factory whose parameters are
    # the runtime and the closure's values (a snapshot, as Paddle's
    # ast_to_func takes), run in the function's own module globals: what
    # torch.compile guards on stays the module's
    from . import runtime as _jst

    freevars = list(inner.__code__.co_freevars)
    values = []
    for name, cell in zip(freevars, inner.__closure__ or ()):
        try:
            values.append(cell.cell_contents)
        except ValueError as e:
            raise UnsupportedSyntax(
                f"unresolvable closure cell {name!r}") from e
    factory = ast.FunctionDef(
        name="_pd_factory",
        args=ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in ["_jst", *freevars]],
            vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
            defaults=[]),
        body=[fdef, ast.Return(value=_name(fdef.name))], decorator_list=[],
        returns=None)
    tree.body = [factory]
    ast.fix_missing_locations(tree)
    code = compile(tree, filename=f"<dy2static:{inner.__qualname__}>",
                   mode="exec")
    ns: dict = {}
    exec(code, inner.__globals__, ns)
    new_fn = ns["_pd_factory"](_jst, *values)
    functools.update_wrapper(new_fn, inner)
    new_fn.__dy2static_original__ = fn
    return new_fn
