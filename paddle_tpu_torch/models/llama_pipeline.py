"""The hybrid-parallel Llama training step (counterpart of
``paddle_tpu/models/llama_pipeline.py``'s ``LlamaPipelineTrainer``, the
trainer ``bench.py`` builds over ``build_mesh(degrees={"dp": 1})``).

The reference jits one SPMD step over a mesh of (dp, sharding, pp, mp).
Here each rank of the mesh (``distributed.build_mesh``) runs its part:

- mp: the model's projections are tensor-parallel (``models.llama``):
  this rank's heads, halves and vocabulary rows, with Paddle's
  collective pairs over the mp group;
- pp: this rank holds the decoder layers of its virtual stages (the
  embedding on the first, the final norm and head on the last) and runs
  the schedule ``pp_schedule`` ("1f1b", "fthenb" or "interleaved" with
  ``vpp`` chunks a rank, ``distributed.pipeline``) over ``n_micro``
  micro-batches;
- dp x sharding: the batch rows split over the data ranks, gradients are
  averaged over them, and ZeRO stage ``zero_stage`` (with ``offload``)
  shards the optimizer state over ``sharding``
  (``distributed.engine.ShardedUpdate``).

A mesh of one rank, or ``mesh=None`` (groups of one,
``collective.OneRank``), is the one-device step and issues no
collective; every trainer updates through ``ShardedUpdate``. The
numerics are the reference's:

- f32 master parameters, with the block, embedding and head weights cast
  to the compute dtype inside each step (``torch.func.functional_call``
  on the casts, so the gradients land on the f32 masters); the final
  norm's weight stays f32;
- the head loss of the reference's ``head_loss``: the final RMSNorm in
  f32, the head matmul in the compute dtype, then the mean over tokens of
  the f32 logsumexp minus the label's logit (the softmax-CE kernel);
- the loss is the mean over micro-batches of each one's mean;
- the remat policies ``"off"``, ``"full"`` (``torch.utils.checkpoint``
  per block) and ``"dots"``, the default (selective checkpointing that
  saves the matrix products' outputs and recomputes the rest; the kernels
  are opaque ``autograd.Function``s, so recomputation launches them
  again);
- the optimizer's own update (``optimizer.AdamW``), applied to the
  masters (or to this rank's ZeRO slice of them).

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

__all__ = ["LlamaPipelineTrainer", "REMAT_POLICIES", "llama_num_params"]

REMAT_POLICIES = ("off", "full", "dots")
# "dots": the outputs of these products are kept, as the reference's
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable keeps them
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def llama_num_params(c: LlamaConfig) -> int:
    """The logical parameter count (every rank's shards together)."""
    qkv = (c.num_attention_heads + 2 * c.num_key_value_heads) * c.head_dim
    block = (2 * c.hidden_size + c.hidden_size * qkv
             + c.num_attention_heads * c.head_dim * c.hidden_size
             + 3 * c.hidden_size * c.intermediate_size)
    return (2 * c.vocab_size * c.hidden_size + c.hidden_size
            + c.num_hidden_layers * block)


class LlamaPipelineTrainer:
    """Owns this rank's f32 master parameters and takes optimizer steps.

    config:        ``LlamaConfig``.
    mesh:          ``distributed.build_mesh(...)`` (this process is one of
                   its ranks), or None for one device without a process
                   group.
    optimizer:     a port optimizer (``optimizer.AdamW(...)``); built
                   without ``parameters``, it is given this rank's.
    n_micro:       micro-batches per step (default ``max(2 * pp, 2)``).
    zero_stage:    ZeRO stage over the mesh's ``sharding`` axis (1-3).
    compute_dtype: ``"auto"`` (bf16 on ``cuda``, f32 on the CPU, as the
                   reference picks bf16 on the TPU and f32 on the CPU mesh)
                   or a ``torch.dtype``.
    seed:          the masters' seeded init (every rank draws the logical
                   weights and keeps its shards).
    pp_schedule:   ``"1f1b"``, ``"fthenb"`` or ``"interleaved"``.
    vpp:           chunks per rank under ``"interleaved"``.
    offload:       the optimizer state and update in host memory.
    remat:         ``"dots"`` (default), ``"full"`` or ``"off"``.
    device:        without a mesh: ``None`` runs on ``cuda`` (raises
                   without a GPU), ``"cpu"`` on the CPU; with a mesh, the
                   rank's device.
    generator:     a ``torch.Generator`` on the device (wins over
                   ``seed``).
    """

    def __init__(self, config: LlamaConfig, mesh, optimizer, n_micro=None,
                 zero_stage=2, compute_dtype="auto", seed=0,
                 pp_schedule="1f1b", vpp=2, offload=False, *, remat="dots",
                 device=None, generator: torch.Generator | None = None):
        from ..distributed.collective import OneRank
        from ..distributed.mesh import (HybridCommunicateGroup, mesh_shape,
                                        set_hybrid_communicate_group)
        from ..distributed.parallel import env_device
        from ..distributed.pipeline import SCHEDULES

        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat must be one of {REMAT_POLICIES}; got "
                             f"{remat!r}")
        if pp_schedule not in SCHEDULES:
            raise ValueError(f"pp_schedule must be one of {SCHEDULES}; got "
                             f"{pp_schedule!r}")
        shape = mesh_shape(mesh) if mesh is not None else {}
        for axis in ("sep", "ep"):
            if shape.get(axis, 1) > 1:
                raise ValueError(f"the trainer runs dp, sharding, pp and mp;"
                                 f" the mesh has {axis}={shape[axis]}")
        self.mesh = mesh
        self.hcg = None
        if mesh is not None:
            self.hcg = HybridCommunicateGroup(None, mesh)
            set_hybrid_communicate_group(self.hcg)
            self.device = env_device()
            self._data, self._pp = self.hcg.data_group(), self.hcg.group("pp")
            self._data_rank = self.hcg.get_data_rank()
        else:
            # one rank: every verb over these groups returns at once
            self.device = resolve_device(device)
            self._data = self._pp = OneRank()
            self._data_rank = 0
        self.n_stages = S = shape.get("pp", 1)
        self.stage = self.hcg.get_stage_id() if self.hcg else 0
        self.zero_stage, self.offload = zero_stage, offload
        self.pp_schedule = pp_schedule
        self.vpp = vpp if pp_schedule == "interleaved" and S > 1 else 1
        L = config.num_hidden_layers
        if L % (S * self.vpp):
            raise ValueError(f"{L} layers do not divide over {S} stages x "
                             f"{self.vpp} chunks")
        n_micro = max(2 * S, 2) if n_micro is None else n_micro
        if n_micro < 1:
            raise ValueError(f"n_micro must be >= 1; got {n_micro}")
        if compute_dtype == "auto":
            compute_dtype = (torch.bfloat16 if self.device.type == "cuda"
                             else torch.float32)
        self.config = config
        self.compute_dtype = compute_dtype
        self.n_micro = n_micro
        self.remat = remat
        self.optimizer = optimizer
        # virtual stage v = c * S + stage holds layers [v * lpv, (v+1) lpv)
        lpv = L // (S * self.vpp)
        self.chunks = [list(range((c * S + self.stage) * lpv,
                                  (c * S + self.stage + 1) * lpv))
                       for c in range(self.vpp)]
        self.first = self.stage == 0
        self.last = self.stage == S - 1
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model = LlamaForCausalLM(
            config, device=self.device, dtype=torch.float32,
            generator=generator, mp_group=None if mesh is not None else False,
            layers=[i for ch in self.chunks for i in ch])
        self._local = {g: j for j, g in enumerate(self.model.layer_ids)}
        if S > 1:
            # a stage keeps only what it runs
            if not self.first:
                self.model.embed_tokens = None
            if not self.last:
                self.model.norm = None
                self.model.lm_head = None
        if optimizer._parameter_list is None:
            optimizer._parameter_list = list(self.model.parameters())
        self._sharded = None
        self._step_count = 0

    # ------------------------------------------------------------------
    def global_name(self, name):
        """A local parameter name with its decoder layer's global index."""
        if name.startswith("layers."):
            _, j, rest = name.split(".", 2)
            return f"layers.{self.model.layer_ids[int(j)]}.{rest}"
        return name

    def named_parameters(self):
        """``(global name, Parameter)`` of this rank's masters."""
        return [(self.global_name(n), p)
                for n, p in self.model.named_parameters()]

    def placements(self):
        """``{global name: checkpoint.Placement}`` of this rank's shards
        in the logical parameters."""
        from ..distributed.checkpoint import layer_placements

        return {self.global_name(n): pl
                for n, pl in layer_placements(self.model).items()}

    @torch.no_grad()
    def set_state_dict(self, state):
        """Load this rank's masters from ``{global name: tensor}`` (this
        rank's shards, as ``models.convert.rank_state_from_jax`` gives
        them); every parameter of the rank must be there."""
        own = dict(self.named_parameters())
        missing = sorted(set(own) - set(state))
        if missing:
            raise KeyError(f"no value for {missing[0]} (and "
                           f"{len(missing) - 1} more)")
        for n, p in own.items():
            v = torch.as_tensor(state[n])
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{n}: shape {tuple(v.shape)}, this rank "
                                 f"holds {tuple(p.shape)}")
            p.copy_(v.to(p.device, p.dtype))

    def shard_of(self, name, full):
        """This rank's part of the logical parameter (or gradient) ``name``
        given whole: the placement's boxes, in local order."""
        pl = self.placements()[name]
        p = dict(self.named_parameters())[name]
        out = torch.empty(p.shape, dtype=full.dtype, device=full.device)
        for _, gsl, view in pl.pieces(out):
            view.copy_(full[gsl])
        return out

    def _sharded_update(self):
        if self._sharded is None:
            from ..distributed.engine import ShardedUpdate

            self._sharded = ShardedUpdate(
                list(self.model.named_parameters()),
                self._local_placements(),
                self.optimizer, self.hcg, self.zero_stage, self.offload)
        return self._sharded

    def _local_placements(self):
        pl = self.placements()
        return {n: pl[self.global_name(n)]
                for n, _ in self.model.named_parameters()}

    # ------------------------------------------------------------------
    def _compute_params(self) -> dict[str, torch.Tensor]:
        """The masters cast to the compute dtype (differentiable casts);
        the final norm's weight stays f32, as in the reference."""
        cdt = self.compute_dtype
        return {n: (p if n == "norm.weight" else p.to(cdt))
                for n, p in self.model.named_parameters()}

    def _block(self, j, params, h):
        layer = self.model.layers[j]
        lp = {n: params[f"layers.{j}.{n}"] for n, _ in layer.named_parameters()}
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

    def _embed(self, params, x):
        h = self.model.embed_tokens(x, weight=params["embed_tokens.weight"])
        return h.to(self.compute_dtype)

    def _chunk(self, c, params, h):
        for i in self.chunks[c]:
            h = self._block(self._local[i], params, h)
        return h

    def _head_loss(self, params, h, y):
        """The reference's ``head_loss``: f32 norm, compute-dtype head,
        mean CE over tokens."""
        hn = rms_norm(h.float(), params["norm.weight"],
                      self.config.rms_norm_eps)
        logits = self.model.lm_head(hn.to(self.compute_dtype),
                                    weight=params["lm_head.weight"])
        return softmax_ce(logits, y).mean()

    def _loss(self, x, y):
        """The mean next-token loss of one micro-batch on one stage,
        differentiable in the master parameters."""
        params = self._compute_params()
        return self._head_loss(params, self._chunk(0, params,
                                                   self._embed(params, x)), y)

    def _batch(self, a):
        """This rank's rows of the global batch ``a``."""
        t = torch.as_tensor(a, device=self.device).long()
        n = self._data.nranks
        if t.shape[0] % n:
            raise ValueError(f"batch {t.shape[0]} does not split over {n} "
                             f"data ranks")
        per = t.shape[0] // n
        return t[self._data_rank * per:(self._data_rank + 1) * per]

    def _forward_backward(self, x, y):
        """Forward and backward of this rank's rows over ``n_micro``
        micro-batches; the f32 gradients accumulate into the masters'
        ``.grad``. Returns the mean loss of this rank's rows (the last
        stage's; 0 on other stages)."""
        x, y = self._batch(x), self._batch(y)
        if x.shape[0] % self.n_micro:
            raise ValueError(f"batch {x.shape[0]} does not split into "
                             f"{self.n_micro} micro-batches")
        xs, ys = x.chunk(self.n_micro), y.chunk(self.n_micro)
        if self.n_stages == 1:
            total = torch.zeros((), device=self.device)
            for xm, ym in zip(xs, ys):
                loss = self._loss(xm, ym) / self.n_micro
                loss.backward()
                total += loss.detach()
            return total
        from ..distributed.pipeline import PipelineRunner

        params = self._compute_params()
        c = self.config
        runner = PipelineRunner(
            self._pp, self.n_micro, self.vpp,
            (xs[0].shape[0], xs[0].shape[1], c.hidden_size),
            self.compute_dtype, self.device)
        return runner.run(
            self.pp_schedule,
            first=lambda m: self._embed(params, xs[m]),
            chunk=lambda ch, h: self._chunk(ch, params, h),
            last=lambda m, h: self._head_loss(params, h, ys[m])
            / self.n_micro)

    def _global_loss(self, local):
        """The whole batch's loss: the last stage's, averaged over the
        data ranks, on every rank."""
        from ..distributed.collective import ReduceOp, all_reduce

        t = local.reshape(1).clone()
        all_reduce(t, group=self._pp)
        all_reduce(t, op=ReduceOp.AVG, group=self._data)
        return t[0]

    def loss_and_grads(self, x, y):
        """Forward and backward of the global batch ``x``, ``y``: each
        master's ``.grad`` holds this rank's part of the whole batch's
        gradient (averaged over the data ranks). Returns the batch's mean
        loss (a detached f32 tensor)."""
        from ..distributed.collective import ReduceOp, all_reduce

        loss = self._forward_backward(x, y)
        for p in self.model.parameters():
            if p.grad is not None:
                all_reduce(p.grad, op=ReduceOp.AVG, group=self._data)
        return self._global_loss(loss)

    def step(self, x, y):
        """One training step: loss and gradients, then the optimizer's
        update of the masters. Returns the loss before the update."""
        sh = self._sharded_update()
        with sh.whole():
            loss = self._forward_backward(x, y)
            sh.apply(sh.reduce())
        self.optimizer._step_count += 1
        self._step_count += 1
        return self._global_loss(loss)

    def sync_to_layer(self):
        """Make ``self.model`` hold this rank's whole masters (ZeRO stage 3
        keeps only slices between steps; they stay gathered until the next
        step)."""
        if self._sharded is not None:
            self._sharded.gather()

    # -- checkpoints ---------------------------------------------------
    def _ckpt_items(self):
        items = self._sharded_update().ckpt_items(
            extra_axes=("pp",) if self.n_stages > 1 else ())
        out = {}
        for k, v in items.items():
            kind, name, *rest = k.split("/")
            out["/".join([kind, self.global_name(name)] + rest)] = v
        return out

    def _ckpt_extra(self):
        return {"step_count": self._step_count,
                "optimizer_step_count": self.optimizer._step_count}

    def _ckpt_restore(self, flat, extra):
        to_local = {self.global_name(n): n
                    for n, _ in self.model.named_parameters()}
        local = {}
        for k, v in flat.items():
            kind, name, *rest = k.split("/")
            if kind in ("params", "opt_state") and name in to_local:
                local["/".join([kind, to_local[name]] + rest)] = v
        self._sharded_update().restore(local)
        self._step_count = int(extra.get("step_count", self._step_count))
        self.optimizer._step_count = int(extra.get("optimizer_step_count",
                                                   self.optimizer._step_count))

    def save_checkpoint(self, path, async_save=False):
        """A sharded checkpoint (``distributed.checkpoint`` layout, global
        parameter names) that any mesh shape loads."""
        from ..distributed.checkpoint import DistributedSaver

        saver = DistributedSaver(self)
        saver.save(path, async_save=async_save)
        return saver

    def load_checkpoint(self, path):
        from ..distributed.checkpoint import DistributedSaver

        return DistributedSaver(self).load(path)

    # ------------------------------------------------------------------
    def num_params(self):
        """The logical parameter count (the whole model)."""
        return llama_num_params(self.config)

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
