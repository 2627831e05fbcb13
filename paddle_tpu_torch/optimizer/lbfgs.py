"""L-BFGS with a strong-Wolfe line search (counterpart of
``paddle_tpu/optimizer/lbfgs.py``, Paddle's ``paddle.optimizer.LBFGS``:
the two-loop recursion and the bracketing / zooming line search with
cubic interpolation of Nocedal & Wright, ch. 6-7).

``step(closure)`` drives the whole inner optimisation: the closure clears
the gradients, recomputes the loss, calls ``loss.backward()`` and returns
the loss. The curvature pairs, the direction and the line search work on
the flattened parameters in float64 on the parameters' device (the
reference's host numpy, in float64 too); the search's decisions read
scalars on the host, one at each function evaluation, as the reference's
do. :meth:`state_dict` holds the reference's ``lbfgs_state`` (numpy
arrays), so either package's ``.pdopt`` loads into the other.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.tensor import raw_grad
from .optimizer import Optimizer

__all__ = ["LBFGS"]


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """The minimiser of the cubic through ``(x1, f1, g1)`` and ``(x2, f2,
    g2)``, clamped to ``bounds`` (default the two points); their midpoint
    where the cubic has no real minimiser."""
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = (x1, x2) if x1 <= x2 else (x2, x1)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1 ** 2 - g1 * g2
    if d2_square >= 0:
        d2 = math.sqrt(d2_square)
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return float(min(max(min_pos, xmin_bound), xmax_bound))
    return float((xmin_bound + xmax_bound) / 2.0)


def _dot(a, b):
    return float(torch.dot(a, b))


def _scalar(loss):
    """A closure's loss as a host float (one device-to-host read)."""
    return float(torch.Tensor.detach(loss))


def _strong_wolfe(obj_func, x, t, d, f, g, gtd, c1=1e-4, c2=0.9,
                  tolerance_change=1e-9, max_ls=25):
    """Bracketing strong-Wolfe search along ``d`` from ``x`` with first step
    ``t``; ``obj_func(x, t, d)`` gives the loss and flat gradient at
    ``x + t d``. Returns ``(f_new, g_new, t, evaluations)``."""
    d_norm = float(d.abs().max())
    g = g.clone()
    f_new, g_new = obj_func(x, t, d)
    ls_func_evals = 1
    gtd_new = _dot(g_new, d)

    t_prev, f_prev, g_prev, gtd_prev = 0.0, f, g, gtd
    done = False
    ls_iter = 0
    while ls_iter < max_ls:
        if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev):
            bracket = [t_prev, t]
            bracket_f = [f_prev, f_new]
            bracket_g = [g_prev, g_new.clone()]
            bracket_gtd = [gtd_prev, gtd_new]
            break
        if abs(gtd_new) <= -c2 * gtd:
            bracket = [t, t]
            bracket_f = [f_new, f_new]
            bracket_g = [g_new, g_new]
            done = True
            break
        if gtd_new >= 0:
            bracket = [t_prev, t]
            bracket_f = [f_prev, f_new]
            bracket_g = [g_prev, g_new.clone()]
            bracket_gtd = [gtd_prev, gtd_new]
            break

        min_step = t + 0.01 * (t - t_prev)
        max_step = t * 10
        tmp = t
        t = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, f_new, gtd_new,
                               bounds=(min_step, max_step))
        t_prev, f_prev, g_prev, gtd_prev = tmp, f_new, g_new.clone(), gtd_new
        f_new, g_new = obj_func(x, t, d)
        ls_func_evals += 1
        gtd_new = _dot(g_new, d)
        ls_iter += 1
    else:
        bracket = [0.0, t]
        bracket_f = [f, f_new]
        bracket_g = [g, g_new]

    # zoom
    insuf_progress = False
    low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[-1] else (1, 0)
    while not done and ls_iter < max_ls:
        if abs(bracket[1] - bracket[0]) * d_norm < tolerance_change:
            break
        t = _cubic_interpolate(bracket[0], bracket_f[0], bracket_gtd[0],
                               bracket[1], bracket_f[1], bracket_gtd[1])
        eps = 0.1 * (max(bracket) - min(bracket))
        if min(max(bracket) - t, t - min(bracket)) < eps:
            if insuf_progress or t >= max(bracket) or t <= min(bracket):
                t = (max(bracket) - eps if abs(t - max(bracket))
                     < abs(t - min(bracket)) else min(bracket) + eps)
                insuf_progress = False
            else:
                insuf_progress = True
        else:
            insuf_progress = False

        f_new, g_new = obj_func(x, t, d)
        ls_func_evals += 1
        gtd_new = _dot(g_new, d)
        ls_iter += 1

        if f_new > (f + c1 * t * gtd) or f_new >= bracket_f[low_pos]:
            bracket[high_pos] = t
            bracket_f[high_pos] = f_new
            bracket_g[high_pos] = g_new.clone()
            bracket_gtd[high_pos] = gtd_new
            low_pos, high_pos = ((0, 1) if bracket_f[0] <= bracket_f[1]
                                 else (1, 0))
        else:
            if abs(gtd_new) <= -c2 * gtd:
                done = True
            elif gtd_new * (bracket[high_pos] - bracket[low_pos]) >= 0:
                bracket[high_pos] = bracket[low_pos]
                bracket_f[high_pos] = bracket_f[low_pos]
                bracket_g[high_pos] = bracket_g[low_pos]
                bracket_gtd[high_pos] = bracket_gtd[low_pos]
            bracket[low_pos] = t
            bracket_f[low_pos] = f_new
            bracket_g[low_pos] = g_new.clone()
            bracket_gtd[low_pos] = gtd_new

    t = bracket[low_pos]
    return bracket_f[low_pos], bracket_g[low_pos], t, ls_func_evals


class LBFGS(Optimizer):
    """Limited-memory BFGS (Paddle's ``paddle.optimizer.LBFGS``).
    ``line_search_fn``: None (a fixed ``learning_rate`` step) or
    ``"strong_wolfe"``; ``weight_decay`` folds L2 into the gradient the
    search and the curvature pairs see; ``grad_clip`` is refused (it would
    corrupt the quasi-Newton model)."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("only 'strong_wolfe' is supported as "
                             f"line_search_fn, got {line_search_fn!r}")
        if grad_clip is not None:
            raise ValueError("LBFGS does not support grad_clip")
        self.max_iter = max_iter
        self.max_eval = (max_eval if max_eval is not None
                         else max_iter * 5 // 4)
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._hist = {"old_dirs": [], "old_stps": [], "ro": [],
                      "prev_flat_grad": None, "d": None, "t": None,
                      "h_diag": 1.0, "n_iter": 0, "func_evals": 0}

    # -- the flattened parameters ------------------------------------------
    def _params(self):
        if self._parameter_list is None:
            raise ValueError("LBFGS constructed without parameters")
        return [p for p in self._parameter_list if p.requires_grad]

    def _device(self):
        return self._params()[0].device

    def _gather_flat_grad(self):
        chunks = []
        for p in self._params():
            g = raw_grad(p)
            flat = (torch.zeros(max(p.numel(), 1), dtype=torch.float64,
                                device=p.device) if g is None
                    else g.detach().reshape(-1).double())
            if self._weight_decay:
                flat = flat + float(self._weight_decay) * \
                    p.detach().reshape(-1).double()
            chunks.append(flat)
        return torch.cat(chunks)

    def _clone_flat_params(self):
        return torch.cat([p.detach().reshape(-1).double()
                          for p in self._params()])

    @torch.no_grad()
    def _set_flat_params(self, flat):
        off = 0
        for p in self._params():
            n = max(p.numel(), 1)
            p.copy_(flat[off:off + n].view_as(p))
            off += n

    def _evaluate(self, closure, x, t, d):
        """The loss and flat gradient at ``x + t d``."""
        self._set_flat_params(x + t * d)
        with torch.enable_grad():
            loss = closure()
        self._hist["func_evals"] += 1
        return _scalar(loss), self._gather_flat_grad()

    # -- the iterations ------------------------------------------------------
    def step(self, closure):
        """Up to ``max_iter`` L-BFGS iterations from the closure's loss and
        gradients; returns the first loss."""
        st = self._hist
        lr = self.get_lr()
        with torch.enable_grad():
            orig_loss = closure()
        loss = _scalar(orig_loss)
        st["func_evals"] += 1
        current_evals = 1

        flat_grad = self._gather_flat_grad()
        if float(flat_grad.abs().max()) <= self.tolerance_grad:
            return orig_loss

        d, t = st["d"], st["t"]
        old_dirs, old_stps, ro = st["old_dirs"], st["old_stps"], st["ro"]
        h_diag = st["h_diag"]
        prev_flat_grad = st["prev_flat_grad"]
        prev_loss = loss

        n_iter = 0
        while n_iter < self.max_iter:
            n_iter += 1
            st["n_iter"] += 1

            if st["n_iter"] == 1:
                d = -flat_grad
                h_diag = 1.0
            else:
                y = flat_grad - prev_flat_grad
                s = d * t
                ys = _dot(y, s)
                if ys > 1e-10:
                    if len(old_dirs) >= self.history_size:
                        old_dirs.pop(0)
                        old_stps.pop(0)
                        ro.pop(0)
                    old_dirs.append(y)
                    old_stps.append(s)
                    ro.append(1.0 / ys)
                    h_diag = ys / _dot(y, y)
                # the two-loop recursion
                q = -flat_grad.clone()
                al = [0.0] * len(old_dirs)
                for i in range(len(old_dirs) - 1, -1, -1):
                    al[i] = _dot(old_stps[i], q) * ro[i]
                    q -= al[i] * old_dirs[i]
                d = q * h_diag
                for i in range(len(old_dirs)):
                    be_i = _dot(old_dirs[i], d) * ro[i]
                    d += (al[i] - be_i) * old_stps[i]

            prev_flat_grad = flat_grad.clone()
            prev_loss = loss

            gtd = _dot(flat_grad, d)
            if gtd > -self.tolerance_change:
                break
            t = (min(1.0, 1.0 / float(flat_grad.abs().sum())) * lr
                 if st["n_iter"] == 1 else lr)

            if self.line_search_fn == "strong_wolfe":
                x_init = self._clone_flat_params()
                loss, flat_grad, t, ls_evals = _strong_wolfe(
                    lambda x, step_t, dd: self._evaluate(closure, x, step_t,
                                                         dd),
                    x_init, t, d, loss, flat_grad, gtd,
                    tolerance_change=self.tolerance_change)
                self._set_flat_params(x_init + t * d)
                current_evals += ls_evals
            else:
                self._set_flat_params(self._clone_flat_params() + t * d)
                if n_iter != self.max_iter:
                    with torch.enable_grad():
                        loss = _scalar(closure())
                    flat_grad = self._gather_flat_grad()
                    current_evals += 1
                    st["func_evals"] += 1

            if current_evals >= self.max_eval:
                break
            if float(flat_grad.abs().max()) <= self.tolerance_grad:
                break
            if float((d * t).abs().max()) <= self.tolerance_change:
                break
            if abs(loss - prev_loss) < self.tolerance_change:
                break

        st.update(d=d, t=t, prev_flat_grad=prev_flat_grad, h_diag=h_diag)
        self._step_count += 1
        return orig_loss

    def state_dict(self):
        out = super().state_dict()
        st = self._hist

        def host(a):
            return None if a is None else a.cpu().numpy()

        out["lbfgs_state"] = {
            "old_dirs": [host(a) for a in st["old_dirs"]],
            "old_stps": [host(a) for a in st["old_stps"]],
            "ro": list(st["ro"]),
            "prev_flat_grad": host(st["prev_flat_grad"]),
            "d": host(st["d"]), "t": st["t"], "h_diag": st["h_diag"],
            "n_iter": st["n_iter"], "func_evals": st["func_evals"],
        }
        return out

    def set_state_dict(self, state):
        super().set_state_dict(state)
        saved = state.get("lbfgs_state")
        if not saved:
            return
        dev = self._device()

        def dev64(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a), dtype=torch.float64, device=dev)

        self._hist.update(saved)
        for k in ("old_dirs", "old_stps"):
            self._hist[k] = [dev64(a) for a in saved[k]]
        for k in ("prev_flat_grad", "d"):
            self._hist[k] = dev64(saved.get(k))
        self._hist["ro"] = [float(r) for r in saved["ro"]]
