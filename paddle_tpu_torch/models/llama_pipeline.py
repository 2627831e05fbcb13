"""Llama training step on one device (counterpart of
``paddle_tpu/models/llama_pipeline.py``'s ``LlamaPipelineTrainer`` at
dp = pp = 1, the configuration ``bench.py`` trains).

The reference jits one SPMD step over a mesh; here the step runs eagerly
on one device and keeps the reference's numerics:

- f32 master parameters (a ``LlamaForCausalLM``), with the block, embedding
  and head weights cast to the compute dtype inside each step
  (``torch.func.functional_call`` on the casts, so the gradients land on
  the f32 masters); the final norm's weight stays f32;
- the head loss of the reference's ``head_loss``: the final RMSNorm in f32,
  the head matmul in the compute dtype, then the mean over tokens of the
  f32 logsumexp minus the label's logit, which the softmax-CE kernel
  computes from the compute-dtype logits without an f32 copy of them;
- the remat policies ``"off"``, ``"full"`` (``torch.utils.checkpoint`` per
  block) and ``"dots"``, the default (selective checkpointing that saves
  the matrix products' outputs and recomputes the rest; the kernels are
  opaque ``autograd.Function``s, so recomputation launches them again);
- the optimizer's own update (``optimizer.AdamW``), applied to the masters.

On a CUDA device every attention, RMSNorm and softmax-CE of the step,
forward and backward, runs a hand-written kernel (``kernels/``).
"""
from __future__ import annotations

import functools

import torch
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.device import resolve_device
from ..kernels.softmax_ce import softmax_ce
from ..nn.functional import rms_norm
from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["LlamaPipelineTrainer", "REMAT_POLICIES"]

REMAT_POLICIES = ("off", "full", "dots")
# "dots": the outputs of these products are kept, as the reference's
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable keeps them
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class LlamaPipelineTrainer:
    """Owns the f32 master model and takes optimizer steps.

    config:        ``LlamaConfig``.
    optimizer:     a port optimizer (``optimizer.AdamW(...)``); built without
                   ``parameters``, it is given the master parameters.
    n_micro:       micro-batches per step (gradients accumulate; the loss is
                   the mean over the whole batch, as in the reference).
    remat:         ``"dots"`` (default), ``"full"`` or ``"off"``.
    compute_dtype: ``"auto"`` (bf16 on ``cuda``, f32 on the CPU, as the
                   reference picks bf16 on the TPU and f32 on the CPU mesh)
                   or a ``torch.dtype``.
    device:        ``None`` runs on ``cuda`` (raises without a GPU); pass
                   ``"cpu"`` for the CPU.
    seed, generator: the masters' seeded init (a ``torch.Generator`` on the
                   device wins over ``seed``).
    """

    def __init__(self, config: LlamaConfig, optimizer, *, n_micro=1,
                 remat="dots", compute_dtype="auto", device=None, seed=0,
                 generator: torch.Generator | None = None):
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat must be one of {REMAT_POLICIES}; got "
                             f"{remat!r}")
        if n_micro < 1:
            raise ValueError(f"n_micro must be >= 1; got {n_micro}")
        self.device = resolve_device(device)
        if compute_dtype == "auto":
            compute_dtype = (torch.bfloat16 if self.device.type == "cuda"
                             else torch.float32)
        self.config = config
        self.compute_dtype = compute_dtype
        self.n_micro = n_micro
        self.remat = remat
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model = LlamaForCausalLM(config, device=self.device,
                                      dtype=torch.float32,
                                      generator=generator)
        self.optimizer = optimizer
        if optimizer._parameter_list is None:
            optimizer._parameter_list = list(self.model.parameters())

    # ------------------------------------------------------------------
    def _compute_params(self) -> dict[str, torch.Tensor]:
        """The masters cast to the compute dtype (differentiable casts);
        the final norm's weight stays f32, as in the reference."""
        cdt = self.compute_dtype
        return {n: (p if n == "norm.weight" else p.to(cdt))
                for n, p in self.model.named_parameters()}

    def _block(self, i, params, h):
        layer = self.model.layers[i]
        lp = {n: params[f"layers.{i}.{n}"] for n, _ in layer.named_parameters()}
        cos, sin = self.model.rope_cos, self.model.rope_sin

        def run(hh):
            return functional_call(layer, lp, (hh, cos, sin))

        if self.remat == "off":
            return run(h)
        if self.remat == "full":
            return checkpoint(run, h, use_reentrant=False)
        return checkpoint(run, h, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))

    def _head_loss(self, params, h, y):
        """The reference's ``head_loss``: f32 norm, compute-dtype head,
        mean CE over tokens."""
        hn = rms_norm(h.float(), params["norm.weight"],
                      self.config.rms_norm_eps)
        logits = torch.nn.functional.linear(hn.to(self.compute_dtype),
                                            params["lm_head.weight"])
        return softmax_ce(logits, y).mean()

    def _loss(self, x, y):
        """The mean next-token loss of one (micro-)batch, differentiable
        in the master parameters."""
        params = self._compute_params()
        h = torch.nn.functional.embedding(x, params["embed_tokens.weight"])
        h = h.to(self.compute_dtype)
        for i in range(len(self.model.layers)):
            h = self._block(i, params, h)
        return self._head_loss(params, h, y)

    def _batch(self, a):
        return torch.as_tensor(a, device=self.device).long()

    def loss_and_grads(self, x, y):
        """Forward and backward over ``n_micro`` micro-batches; the f32
        gradients accumulate into the masters' ``.grad``. Returns the
        batch's mean loss (a detached f32 tensor)."""
        x, y = self._batch(x), self._batch(y)
        if x.shape[0] % self.n_micro:
            raise ValueError(f"batch {x.shape[0]} does not split into "
                             f"{self.n_micro} micro-batches")
        total = torch.zeros((), device=self.device)
        for xm, ym in zip(x.chunk(self.n_micro), y.chunk(self.n_micro)):
            loss = self._loss(xm, ym) / self.n_micro
            loss.backward()
            total += loss.detach()
        return total

    def step(self, x, y):
        """One training step: loss and gradients, then the optimizer's
        update of the masters. Returns the loss before the update."""
        loss = self.loss_and_grads(x, y)
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss

    # ------------------------------------------------------------------
    def num_params(self):
        return self.model.num_params()

    def flops_per_token(self, seq_len):
        """6N + attention FLOPs with N = all params (the reference's
        convention; overcounts the input embedding, a gather)."""
        c = self.config
        return (6 * self.num_params()
                + 12 * c.num_hidden_layers * c.hidden_size * seq_len)

    def matmul_flops_per_token(self, seq_len):
        """Matmul FLOPs per token: without the input embedding table, with
        the LM head (the number MFU is reported from)."""
        c = self.config
        n = self.num_params() - c.vocab_size * c.hidden_size
        return 6 * n + 12 * c.num_hidden_layers * c.hidden_size * seq_len
