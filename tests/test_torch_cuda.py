"""The port's CUDA kernels on the card (paddle_tpu_torch.kernels).

Every test here is marked ``cuda`` and skips without a CUDA device; the
file imports neither JAX nor ``paddle_tpu``, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs.
Tolerances, as ``|kernel - plain| <= atol + rtol * |plain|``: f32 kernels
differ from the plain versions only in summation order (atol 1e-4,
rtol 1e-4; the f32 flash and paged kernels sum up to 128 products per dot
and rescale through an online softmax); bf16 outputs differ by bf16
rounding, one step of which is 2^-7 relative (rtol 1e-2, atol 2e-2 on
attention outputs, whose tensor-core products also round the
probabilities to bf16, and 1e-3 on RMSNorm outputs). The f32 lse and rstd
get atol 1e-3 in bf16 runs.

Backward kernels: a gradient is a sum over many rows, so its rounding
error scales with the largest summand, not with each element. f32
gradients get atol 1e-4 * max|plain| + rtol 1e-4; bf16 ones atol
1e-2 * max|plain| + rtol 1e-2 (the flash backward also rounds p and ds to
bf16 as tensor-core operands, and every bf16 output is rounded once more).
The regression tests hold ``loss.backward()`` through the public
functionals on the card against the same calls on CPU copies (the plain
versions), for every input that requires grad.

Whisper slice: the sm90 flash kernels at a decode step's one query row
against one key and against 1500, and at the training step's 224 queries
against 1500 keys; softmax-CE at Whisper's odd vocabulary 51865 (every
other bf16 row off 16-byte alignment); a small f32 Whisper on the card:
``generate`` gives its own uncached greedy rollout and the CPU's tokens
(cuDNN's TF32 off), with exactly its structure's launches.

ERNIE slice: the LayerNorm kernel matches its plain version at f32 atol
1e-5 (rtol 1e-5) and in bf16 to one bf16 step of the output's scale
(atol 2^-7 * max|plain| rounded down to a power of two, as the output
rounds once); mean and rstd at 1e-5. The flash kernels' dropout bits
equal the plain version's exactly, each kernel's applied mask (read out
by probes) equals them, and outputs and gradients with dropout match the
plain versions under the dense tolerances above.

Conformer slice: flash at head_dim 36 (zero-padded to 48 in the kernels)
under the same tolerances, dropout on and off, and its applied mask read
back exactly. The CTC kernels against their plain versions: the -1e30
("dead") entries of alpha and beta equal exactly, the live ones within
atol 1e-3 + rtol 1e-5 (the same f32 recursion; expf/logf may differ by an
ulp, and a lattice entry is a sum over up to T steps of magnitude ~5),
the log-likelihood rtol 1e-5; the gradient through ``ctc_loss`` against
the CPU's plain version within the f32 gradient tolerance. The cases span
both routes of ``kernels/ctc.py`` ``launch_plan`` (S 127 / 129), both
stagings (whole rows of an odd C; a vocabulary of 5001 and 9000), the
widest lattice (S 8191) and T = 1; each case's route and plan are the
launch plan's, and two calls give the same bits; the kernels' expf and
logf sequences give CUDA's bits over every argument they take.

RNN-T slice: the alpha and beta-gradient kernels against their plain
versions at the smoke's shapes (``[16, 400, 49]``, ``[8, 200, 513]``),
edges (``u_len = 0``, ``t_len = 1``, ``U + 1 = 1024``), both sides of the
warp boundary (``U + 1`` 64 and 65) and odd ``T x (U + 1)``, on every route
and cell count (``U + 1`` 2500 and 4096), each case's route and plan the
launch plan's: dead cells equal
exactly, live alphas and betas within atol 1e-3 + rtol 1e-5 as CTC's, the
log-likelihood and ``bhat[0, 0]`` rtol 1e-5 (atol 1e-4), the posteriors
(probabilities) atol 1e-5; ``rnnt_loss`` gradients against the CPU's plain
versions within the f32 gradient tolerance; a ``ConformerForRNNT`` step
against the CPU with exactly its structure's launches.

Flash slice: the flash kernels against their plain versions, under the
dense tolerances, at head widths 1 to 256 (96 and 200 among them, which
earlier slices refused), on rows misaligned for 16-byte loads, with bool
masks of every broadcast mode (a fully masked row included) and the
reference's canonical masks with a mode, and on packed sequences (an
empty sequence, tails past cu[-1], cu_q != cu_k, GQA, dropout); the
public entries count their own variants (``_mask``, ``_varlen``); head
widths past 256 raise; ``nn.RMSNorm`` with an f32 weight runs under
``amp.auto_cast`` on a bf16 input (F2).

Vision slice: softmax-CE at ResNet-50's head, ``[64, 1000]`` in the bf16
its O1 step hands it (and f32), under the tolerances above; a ResNet-18
step on the card against the same weights' f32 step on the CPU (in f32,
TF32 off: loss and every gradient; under O1: the launches, finite
gradients, the loss, and a second step that lowers it), and the pooling
and batch-norm functionals on the card against the CPU in f32.

High-level API slice: a small conv net's ``Model.fit`` on the card against
the same weights' ``fit`` on the CPU (f32, TF32 off: per-batch losses and
final parameters within 1e-4, summation order through Adam steps; one
softmax-CE forward and backward a step), the ``DataLoader``'s worker
processes forked after CUDA is initialised (order and content equal the
inline loader's; CUDA initialised in no worker), and the native batcher
built into ``paddle_tpu_torch/csrc/build/`` and serving a card ``fit``.

Eager API slice: every kernel family's entry point handed the port's
``Tensor`` launches its kernels (the counters move, backward ones through
``backward()``) and hands back a ``Tensor``; ``to_tensor`` with no card
and no ``set_device("cpu")`` raises; a DenseNet-121 step in the dygraph
idiom on the card against the CPU (f32, TF32 off: the loss within 1e-4,
each gradient within 5e-2 relative L2 or 3x the CPU's own f32 error
against f64 where that is larger, ROADMAP C3).

Static-graph slice: the registered LayerNorm and flash forward ops inside
a ``torch.compile`` (inductor) program and after ``torch.export``, f32 and
bf16: the counters move inside the ops, the design is bf16's sm90 and
f32's mma, outputs at the kernels' tolerances above; a small ERNIE
through ``jit.StaticFunction`` launches what its eager forward does, its
f32 logits (TF32 off) within 1e-4 relative L2.

The last nn slice: every case of ``tools/nn_surface_cases.py`` (the 36
functionals and 44 layers it added; the recurrent layers as 2-layer
bidirectional GRU and SimpleRNN with ``sequence_length``) on the card
against the CPU, outputs and gradients, f32 with TF32 off, rtol 1e-4 and
atol 1e-5 (the card's convolutions and GEMMs sum in another order); an
O1 step of ShuffleNetV2 and one of GoogLeNet (main loss plus 0.3 x each
auxiliary head's) launch exactly one softmax-CE forward and backward a
head: 1 / 1 and 3 / 3.
"""
import math

import pytest
import torch

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels.flash_attention import (
    delta_minus_glse, dropout_bits_cuda, dropout_bits_plain,
    dropout_keep_plain, flash_attention_bwd_cuda, flash_attention_bwd_plain,
    flash_attention_cuda, flash_attention_fwd, flash_attention_plain,
    mask_view)
from paddle_tpu_torch.kernels.layernorm import (
    layer_norm_cuda, layer_norm_plain, layernorm)
from paddle_tpu_torch.kernels.paged_attention import (
    launch_plan, paged_attention, paged_attention_cuda, paged_attention_plain)
from paddle_tpu_torch.kernels.rmsnorm import (
    rmsnorm, rmsnorm_bwd_cuda, rmsnorm_bwd_plain, rmsnorm_cuda, rmsnorm_plain)
from paddle_tpu_torch.kernels.softmax_ce import (
    softmax_ce, softmax_ce_bwd_cuda, softmax_ce_bwd_plain, softmax_ce_cuda,
    softmax_ce_plain)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]
_ELEM = {torch.float32: 4, torch.bfloat16: 2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    return torch.Generator(device="cuda").manual_seed(0)


def _tol(dtype, attention=True):
    if dtype == torch.float32:
        return dict(atol=1e-4, rtol=1e-4)
    return dict(atol=2e-2 if attention else 1e-3, rtol=1e-2)


def _rnd(gen, dtype, *shape):
    return torch.randn(*shape, device="cuda", generator=gen).to(dtype)


def _close(got, want, **tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,cols", [(1, 256), (37, 4096)])
def test_rmsnorm_kernel_matches_plain(gen, dtype, rows, cols):
    x, r = _rnd(gen, dtype, rows, cols), _rnd(gen, dtype, rows, cols)
    w = (1 + 0.1 * torch.randn(cols, device="cuda", generator=gen)).to(dtype)
    for res in (None, r):
        out, h, rstd = rmsnorm_cuda(x, w, 1e-5, res)
        p_out, p_h, p_rstd = rmsnorm_plain(x, w, 1e-5, res)
        _close(out, p_out, **_tol(dtype, attention=False))
        _close(rstd, p_rstd, atol=1e-3 if dtype == torch.bfloat16 else 1e-5,
               rtol=1e-5)
        if res is not None:     # x + r is one rounding of the same f32 sum
            _close(h, p_h, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2)])
def test_paged_kernel_matches_plain(gen, dtype, hq, hkv):
    bs, M, N = 16, 8, 40
    q, pool = _rnd(gen, dtype, 5, hq, 128), _rnd(gen, dtype, N, 2, hkv, bs, 128)
    bt = torch.randint(1, N, (5, M), device="cuda", generator=gen,
                       dtype=torch.int32)
    ctx = torch.tensor([1, 17, M * bs, 33, 16], device="cuda",
                       dtype=torch.int32)
    _close(paged_attention_cuda(q, pool, bt, ctx),
           paged_attention_plain(q, pool, bt, ctx), **_tol(dtype))
    _close(paged_attention_cuda(q, pool, bt, ctx, sm_scale=0.05),
           paged_attention_plain(q, pool, bt, ctx, sm_scale=0.05),
           **_tol(dtype))


def _paged_inputs(gen, dtype, S, hq, hkv, bs, D, M):
    N = S * M + 1                        # block 0 is the engine's scratch
    q, pool = _rnd(gen, dtype, S, hq, D), _rnd(gen, dtype, N, 2, hkv, bs, D)
    perm = torch.randperm(N - 1, device="cuda", generator=gen) + 1
    return q, pool, perm[:S * M].reshape(S, M).to(torch.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128, 256, 80])
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_split_kernel_matches_plain(gen, dtype, d, rep, bs):
    """Every split a page (6 slots x 2 kv heads, table width 8) and a run
    of pages a split (width 64): ctx 1 (every later split past it), at a
    split boundary and one past it, the whole table, past the table (the
    table's tokens only) and one page."""
    for M in (8, 64):
        plan = launch_plan(6, 2 * rep, 2, bs, d, M, _ELEM[dtype])
        span = plan.pps * bs
        ctx = torch.tensor([1, span, span + 1, M * bs, M * bs + 5, bs],
                           device="cuda", dtype=torch.int32)
        q, pool, bt = _paged_inputs(gen, dtype, 6, 2 * rep, 2, bs, d, M)
        out = paged_attention_cuda(q, pool, bt, ctx)
        _close(out, paged_attention_plain(q, pool, bt, ctx), **_tol(dtype))
        # the splits merge in a fixed order: the same bits every call
        assert torch.equal(out, paged_attention_cuda(q, pool, bt, ctx))


def test_paged_kernel_at_the_bandwidth_shape(gen):
    """32 slots of 512-1024 tokens, 32 heads of 128, bf16: one split a
    (slot, head), 32-64 stage loads a block."""
    q, pool, bt = _paged_inputs(gen, torch.bfloat16, 32, 32, 32, 16, 128, 64)
    ctx = torch.randint(512, 1025, (32,), device="cuda", generator=gen,
                        dtype=torch.int32)
    _close(paged_attention_cuda(q, pool, bt, ctx),
           paged_attention_plain(q, pool, bt, ctx), **_tol(torch.bfloat16))


def test_paged_kernel_takes_misaligned_q_and_gives_zeros_at_ctx_0(gen):
    q, pool, bt = _paged_inputs(gen, torch.bfloat16, 3, 8, 2, 16, 64, 4)
    view = _rnd(gen, torch.bfloat16, 3 * 8 * 64 + 1)[1:].view(3, 8, 64)
    view.copy_(q)
    ctx = torch.tensor([0, 40, 64], device="cuda", dtype=torch.int32)
    out = paged_attention_cuda(view, pool, bt, ctx)
    _close(out[1:], paged_attention_plain(q, pool, bt, ctx)[1:],
           **_tol(torch.bfloat16))
    assert torch.equal(out[0], torch.zeros_like(out[0]))


def test_paged_kernel_raises_on_what_it_does_not_take(gen):
    q, pool, bt = _paged_inputs(gen, torch.float32, 2, 2, 2, 16, 520, 2)
    ctx = torch.tensor([3, 20], device="cuda", dtype=torch.int32)
    with pytest.raises(ValueError, match="wider"):   # head_dim past 512 f32
        paged_attention_cuda(q, pool, bt, ctx)
    with pytest.raises(TypeError):                   # no fp16 kernel
        paged_attention_cuda(q.half(), pool.half(), bt, ctx)
    with pytest.raises(ValueError, match="16 bytes"):   # 12-byte rows
        paged_attention_cuda(q[..., :6].bfloat16().contiguous(),
                             pool[..., :6].bfloat16().contiguous(), bt, ctx)
    with pytest.raises(TypeError):                   # int64 tables
        paged_attention_cuda(q, pool, bt.long(), ctx)


def test_tiny_engine_on_the_card_matches_its_cpu_run(gen):
    """The same f32 weights served on the card (paged kernel in decode) and
    on the CPU (plain version): the same greedy tokens."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams

    cfg = llama_tiny(vocab=101, hidden=256, layers=2, heads=4, kv_heads=2,
                     inter=512, seq=256)
    card = LlamaForCausalLM(cfg, generator=gen)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    prompts = [list(range(3, 90)), list(range(50, 55)), [7] * 200]
    want = [LLMEngine(m, block_size=16, max_slots=3, max_model_len=256)
            .generate(prompts, SamplingParams(max_new_tokens=8))
            for m in (card, cpu)]
    assert want[0] == want[1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,hkv", [(77, 77, 4), (130, 130, 8),
                                       (5, 77, 8), (1, 1, 8)])
def test_flash_kernel_matches_plain(gen, dtype, d, causal, sq, sk, hkv):
    q = _rnd(gen, dtype, 2, sq, 8, d)
    k, v = _rnd(gen, dtype, 2, sk, hkv, d), _rnd(gen, dtype, 2, sk, hkv, d)
    out, lse = flash_attention_cuda(q, k, v, causal)
    p_out, p_lse = flash_attention_plain(q, k, v, causal)
    _close(out, p_out, **_tol(dtype))
    _close(lse, p_lse, atol=1e-3 if dtype == torch.bfloat16 else 1e-4,
           rtol=1e-5)


def test_wrappers_launch_on_cuda_and_count(gen):
    x = _rnd(gen, torch.bfloat16, 3, 64)
    w = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    q = _rnd(gen, torch.bfloat16, 1, 9, 4, 64)
    pool = _rnd(gen, torch.bfloat16, 4, 2, 4, 16, 64)
    bt = torch.tensor([[1, 2]], device="cuda", dtype=torch.int32)
    ctx = torch.tensor([20], device="cuda", dtype=torch.int32)
    before = K.launch_counts()
    rmsnorm(x, w)
    flash_attention_fwd(q, q, q, causal=True)
    paged_attention(q[:, 0], pool, bt, ctx)
    after = K.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "flash_attention": 1, "flash_attention_dropout": 0,
        "flash_attention_mask": 0, "flash_attention_varlen": 0,
        "flash_attention_bwd": 0, "flash_attention_bwd_dropout": 0,
        "flash_attention_bwd_mask": 0, "flash_attention_bwd_varlen": 0,
        "layernorm": 0, "paged_attention": 1, "rmsnorm": 1,
        "rmsnorm_bwd": 0, "softmax_ce": 0, "softmax_ce_bwd": 0,
        "ctc_alpha": 0, "ctc_beta": 0, "rnnt_alpha": 0, "rnnt_beta_grad": 0,
        "flash_attention_sm90": 1, "flash_attention_mma": 0,
        "flash_attention_bwd_sm90": 0, "flash_attention_bwd_mma": 0}


def test_wrappers_raise_on_what_the_kernel_does_not_take(gen):
    q = _rnd(gen, torch.float16, 1, 9, 4, 64)
    with pytest.raises(TypeError):                 # no fp16 kernel
        flash_attention_fwd(q, q, q)
    q = _rnd(gen, torch.float32, 1, 9, 4, 264)
    with pytest.raises(ValueError, match="1..256"):   # head_dim past 256
        flash_attention_fwd(q, q, q)
    x = _rnd(gen, torch.bfloat16, 2, 12)
    with pytest.raises(ValueError):                # 24-byte rows
        rmsnorm(x, torch.ones(12, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError):                # split across devices
        rmsnorm(x.cpu(), torch.ones(12, device="cuda", dtype=torch.bfloat16))
    # a contiguous view 2 bytes into its storage: misaligned for 16-byte loads
    x = _rnd(gen, torch.bfloat16, 2 * 64 + 1)[1:].view(2, 64)
    w = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        rmsnorm_cuda(x, w, 1e-5)
    with pytest.raises(ValueError):
        rmsnorm_cuda(w.expand(2, 64).contiguous(), w, 1e-5, x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiny_engine_on_the_card_agrees_with_the_full_forward(gen, dtype):
    """The serving path on the card (paged kernel in decode, RMSNorm in every
    layer) against the no-cache forward (flash kernel): each greedy token's
    logit is within a dtype tolerance of its row's maximum."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving import LLMEngine, SamplingParams

    model = LlamaForCausalLM(
        llama_tiny(vocab=101, hidden=256, layers=2, heads=4, kv_heads=2,
                   inter=512, seq=128), dtype=dtype, generator=gen)
    eng = LLMEngine(model, block_size=16, max_slots=2, max_model_len=128)
    prompts = [list(range(3, 40)), list(range(50, 55)), list(range(3, 40)) + [7]]
    outs = eng.generate(prompts, SamplingParams(max_new_tokens=6))
    tol = 1e-3 if dtype == torch.float32 else 0.1
    with torch.inference_mode():
        for p, o in zip(prompts, outs):
            assert len(o) == 6
            logits = model(torch.tensor([p + o], device="cuda"))[0].float()
            rows = logits[len(p) - 1:len(p) - 1 + len(o)]
            chosen = rows.gather(1, torch.tensor(o, device="cuda")[:, None])
            assert (rows.max(1, keepdim=True).values - chosen).max() <= tol


# ---------------------------------------------------------------------------
# backward kernels (training slice)
# ---------------------------------------------------------------------------

def _grad_tol(dtype, want):
    frac = 1e-4 if dtype == torch.float32 else 1e-2
    return dict(atol=frac * want.float().abs().max().item(), rtol=frac)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,hkv", [(77, 77, 8), (130, 130, 2),
                                       (40, 100, 4), (1, 1, 8)])
def test_flash_bwd_kernel_matches_plain(gen, dtype, d, causal, sq, sk, hkv):
    q = _rnd(gen, dtype, 2, sq, 8, d)
    k, v = _rnd(gen, dtype, 2, sk, hkv, d), _rnd(gen, dtype, 2, sk, hkv, d)
    g = _rnd(gen, dtype, 2, sq, 8, d)
    g_lse = 0.1 * torch.randn(2, 8, sq, device="cuda", generator=gen)
    out, lse = flash_attention_plain(q, k, v, causal)
    dg = delta_minus_glse(out, g, g_lse)
    got = flash_attention_bwd_cuda(q, k, v, g, lse, dg, causal)
    want = flash_attention_bwd_plain(q, k, v, g, lse, dg, causal)
    for a, b in zip(got, want):
        _close(a, b, **_grad_tol(dtype, b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,cols", [(1, 256), (37, 4096), (600, 512)])
def test_rmsnorm_bwd_kernel_matches_plain(gen, dtype, rows, cols):
    x, r = _rnd(gen, dtype, rows, cols), _rnd(gen, dtype, rows, cols)
    g = _rnd(gen, dtype, rows, cols)
    w = (1 + 0.1 * torch.randn(cols, device="cuda", generator=gen)).to(dtype)
    for res in (None, r):
        _, _, rstd = rmsnorm_plain(x, w, 1e-5, res)
        dx, dw = rmsnorm_bwd_cuda(x, w, rstd, g, res)
        p_dx, p_dw = rmsnorm_bwd_plain(x, w, rstd, g, res)
        _close(dx, p_dx, **_grad_tol(dtype, p_dx))
        _close(dw, p_dw, **_grad_tol(dtype, p_dw))
        again = rmsnorm_bwd_cuda(x, w, rstd, g, res)   # no atomics: same bits
        torch.testing.assert_close(again[1], dw, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,vocab", [(7, 1001), (33, 32000), (4, 5),
                                     (48, 51865)])
@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
def test_softmax_ce_kernels_match_plain(gen, dtype, n, vocab, label_dtype):
    x = (3 * torch.randn(n, vocab, device="cuda", generator=gen)).to(dtype)
    lab = torch.randint(0, vocab, (n,), device="cuda", generator=gen,
                        dtype=label_dtype)
    g = torch.rand(n, device="cuda", generator=gen)
    loss, lse = softmax_ce_cuda(x, lab)
    p_loss, p_lse = softmax_ce_plain(x, lab)
    _close(loss, p_loss, atol=1e-4, rtol=1e-5)
    _close(lse, p_lse, atol=1e-4, rtol=1e-5)
    dx = softmax_ce_bwd_cuda(x, lab, lse, g)
    p_dx = softmax_ce_bwd_plain(x, lab, p_lse, g)
    _close(dx, p_dx, **_grad_tol(dtype, p_dx))


def test_softmax_ce_out_of_range_label_is_nan(gen):
    x = _rnd(gen, torch.float32, 3, 11)
    lab = torch.tensor([0, 11, -1], device="cuda")
    loss, _ = softmax_ce_cuda(x, lab)
    torch.cuda.synchronize()
    assert torch.isfinite(loss[0]) and torch.isnan(loss[1:]).all()


def test_backward_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    q = _rnd(gen, torch.float32, 1, 9, 4, 264)
    lse = torch.zeros(1, 4, 9, device="cuda")
    with pytest.raises(ValueError, match="1..256"):   # head_dim past 256
        flash_attention_bwd_cuda(q, q, q, q, lse, lse)
    q = _rnd(gen, torch.bfloat16, 1, 9, 4, 64)
    with pytest.raises(ValueError):                # gradient in f32
        flash_attention_bwd_cuda(q, q, q, q.float(), lse, lse)
    with pytest.raises(ValueError):                # lse of the wrong shape
        flash_attention_bwd_cuda(q, q, q, q, lse[:, :2], lse)
    x = _rnd(gen, torch.bfloat16, 4, 64)
    w = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    rstd = torch.ones(4, device="cuda")
    with pytest.raises(ValueError):                # gradient dtype differs
        rmsnorm_bwd_cuda(x, w, rstd, x.float())
    with pytest.raises(ValueError):                # rstd not float32
        rmsnorm_bwd_cuda(x, w, rstd.bfloat16(), x)
    lab = torch.zeros(4, device="cuda", dtype=torch.int64)
    with pytest.raises(TypeError):                 # no fp16 kernel
        softmax_ce_cuda(x.half(), lab)
    with pytest.raises(TypeError):                 # float labels
        softmax_ce_cuda(x, lab.float())
    with pytest.raises(ValueError):                # labels of another shape
        softmax_ce_cuda(x, lab[:3])
    # a raw wrapper never returns an output cut from the autograd graph
    xg = x.detach().requires_grad_()
    with pytest.raises(RuntimeError):
        rmsnorm_cuda(xg, w, 1e-5)
    with pytest.raises(RuntimeError):
        softmax_ce_cuda(xg, lab)
    with pytest.raises(RuntimeError):
        flash_attention_cuda(q.requires_grad_(), q, q)


def _leaves(*tensors):
    """(CUDA leaves, CPU leaf copies) that require grad."""
    cuda = [t.detach().clone().requires_grad_() for t in tensors]
    cpu = [t.detach().cpu().requires_grad_() for t in tensors]
    return cuda, cpu


def _grads_match(loss_fn, tensors, dtype):
    cuda, cpu = _leaves(*tensors)
    before = K.launch_counts()
    loss_fn(*cuda).backward()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in K.launch_counts().items()}
    loss_fn(*cpu).backward()
    for a, b in zip(cuda, cpu):
        assert a.grad is not None and b.grad is not None
        _close(a.grad, b.grad.cuda(), **_grad_tol(dtype, b.grad))
    return launched


@pytest.mark.parametrize("dtype", DTYPES)
def test_regression_backward_through_rms_norm_on_the_card(gen, dtype):
    from paddle_tpu_torch.nn.functional import rms_norm

    x = _rnd(gen, dtype, 2, 5, 256)
    w = (1 + 0.1 * torch.randn(256, device="cuda", generator=gen)).to(dtype)
    t = _rnd(gen, dtype, 2, 5, 256).float().cpu()

    def f(x_, w_):
        return (rms_norm(x_, w_, 1e-5).float() * t.to(x_.device)).sum()

    n = _grads_match(f, (x, w), dtype)
    assert n["rmsnorm"] == 1 and n["rmsnorm_bwd"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_regression_backward_through_attention_on_the_card(gen, dtype):
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

    q = _rnd(gen, dtype, 2, 70, 8, 64)
    k, v = _rnd(gen, dtype, 2, 70, 2, 64), _rnd(gen, dtype, 2, 70, 2, 64)
    t = _rnd(gen, dtype, 2, 70, 8, 64).float().cpu()

    def f(q_, k_, v_):
        out = scaled_dot_product_attention(q_, k_, v_, is_causal=True)
        return (out.float() * t.to(q_.device)).sum()

    n = _grads_match(f, (q, k, v), dtype)
    assert n["flash_attention"] == 1 and n["flash_attention_bwd"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_regression_backward_through_cross_entropy_on_the_card(gen, dtype):
    from paddle_tpu_torch.nn.functional import cross_entropy

    x = (2 * torch.randn(3, 9, 1001, device="cuda", generator=gen)).to(dtype)
    lab = torch.randint(0, 1001, (3, 9), device="cuda", generator=gen)
    lab[0, :4] = -100                                  # ignored rows

    def f(x_):
        return cross_entropy(x_, lab.to(x_.device), ignore_index=-100)

    n = _grads_match(f, (x,), dtype)
    assert n["softmax_ce"] == 1 and n["softmax_ce_bwd"] == 1


def test_trainer_step_on_the_card_matches_the_cpu(gen):
    """One f32 trainer step, every kernel forward and backward on the card,
    against the same masters on the CPU through the plain versions."""
    from paddle_tpu_torch.models import LlamaPipelineTrainer, llama_tiny
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_tiny(vocab=97, hidden=128, layers=2, heads=2, kv_heads=1,
                     inter=256, seq=64)
    x = torch.randint(0, 97, (2, 48), generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 97, (2, 48), generator=torch.Generator().manual_seed(2))
    on_card = LlamaPipelineTrainer(cfg, AdamW(learning_rate=1e-3),
                                   compute_dtype=torch.float32, generator=gen)
    on_cpu = LlamaPipelineTrainer(cfg, AdamW(learning_rate=1e-3),
                                  device="cpu")
    on_cpu.model.load_state_dict(
        {k: v.cpu() for k, v in on_card.model.state_dict().items()})
    before = K.launch_counts()
    loss = on_card.loss_and_grads(x, y).item()
    launched = {k: v - before[k] for k, v in K.launch_counts().items()}
    assert loss == pytest.approx(on_cpu.loss_and_grads(x, y).item(),
                                 rel=1e-5, abs=1e-5)
    for a, b in zip(on_card.model.parameters(), on_cpu.model.parameters()):
        _close(a.grad, b.grad.cuda(), **_grad_tol(torch.float32, b.grad))
    trainer_kernels = ("flash_attention", "flash_attention_bwd", "rmsnorm",
                       "rmsnorm_bwd", "softmax_ce", "softmax_ce_bwd")
    assert all(launched[k] > 0 for k in trainer_kernels)
    # Adam's first steps move each weight by about lr * sign(g): compare
    # the losses that follow, not weights whose gradient is near zero
    for tr in (on_card, on_cpu):
        tr.optimizer.step()
        tr.optimizer.clear_grad()
    losses = [on_card.step(x, y).item() for _ in range(2)]
    ref = [on_cpu.step(x, y).item() for _ in range(2)]
    assert losses == pytest.approx(ref, rel=1e-4, abs=1e-5)


# ---------------------------------------------------------------------------
# ERNIE slice: LayerNorm and flash dropout
# ---------------------------------------------------------------------------

def _ln_tol(out, want):
    if out.dtype == torch.float32:
        return dict(atol=1e-5, rtol=1e-5)
    top = want.float().abs().max().item()
    return dict(atol=2.0 ** (math.floor(math.log2(top)) - 7), rtol=0.0)


@pytest.mark.parametrize("xd,wd", [(torch.float32, torch.float32),
                                   (torch.bfloat16, torch.bfloat16),
                                   (torch.bfloat16, torch.float32),
                                   (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("rows,cols", [(1, 64), (37, 768), (300, 1000),
                                       (8, 4096), (5, 100)])
def test_layernorm_kernel_matches_plain(gen, xd, wd, rows, cols):
    x = (2 * torch.randn(rows, cols, device="cuda", generator=gen) + 0.5
         ).to(xd)
    w = (1 + 0.1 * torch.randn(cols, device="cuda", generator=gen)).to(wd)
    b = (0.1 * torch.randn(cols, device="cuda", generator=gen)).to(wd)
    out, mean, rstd = layer_norm_cuda(x, w, b, 1e-5)
    p_out, p_mean, p_rstd = layer_norm_plain(x, w, b, 1e-5)
    assert out.dtype == p_out.dtype
    _close(out, p_out, **_ln_tol(out, p_out))
    _close(mean, p_mean, atol=1e-5, rtol=1e-5)
    _close(rstd, p_rstd, atol=1e-5, rtol=1e-5)


def test_layernorm_kernel_misaligned_rows_take_the_scalar_path(gen):
    for dtype in DTYPES:
        # a contiguous view one element into its storage
        x = torch.randn(3 * 64 + 1, device="cuda", generator=gen).to(
            dtype)[1:].view(3, 64)
        w = (1 + 0.1 * torch.randn(64, device="cuda", generator=gen)).to(dtype)
        b = torch.zeros(64, device="cuda", dtype=dtype)
        out, _, _ = layer_norm_cuda(x, w, b, 1e-5)
        p_out, _, _ = layer_norm_plain(x, w, b, 1e-5)
        _close(out, p_out, **_ln_tol(out, p_out))
    with pytest.raises(TypeError):
        layer_norm_cuda(x.half(), w.half(), b.half(), 1e-5)


def test_dropout_bits_equal_the_plain_function(gen):
    for seed, bh, sq, sk in ((0, 1, 1, 1), (12345, 24, 77, 130),
                             (2 ** 31 - 1, 192, 64, 512)):
        got = dropout_bits_cuda(seed, bh, sq, sk, "cuda")
        torch.cuda.synchronize()
        assert torch.equal(got, dropout_bits_plain(seed, bh, sq, sk, "cuda"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq", [150, 300])
def test_flash_kernels_apply_the_plain_mask(gen, dtype, d, sq):
    """Probes with S_k = D: q = k = 0 makes every probability 1 / D, so
    out reads z / (D (1 - p)) with v = I; dQ with k = v = I and dO = 1
    reads scale * z / (D (1 - p)); dV with dO = I (S_q = D) reads z^T.
    S_q 300 spans three of the sm90 kernels' 128-row query tiles (bf16
    takes them at both widths; f32 the mma kernels)."""
    B, H, Sq, p, seed = 2, 3, sq, 0.1, 77
    before = K.launch_counts()
    zeros = torch.zeros(B, Sq, H, d, device="cuda", dtype=dtype)
    kzero = torch.zeros(B, d, H, d, device="cuda", dtype=dtype)
    eye = torch.eye(d, device="cuda", dtype=dtype)[None, :, None, :].expand(
        B, d, H, d).contiguous()
    keep = dropout_keep_plain(seed, B, H, Sq, d, p, "cuda").float()
    out, _ = flash_attention_cuda(zeros, kzero, eye, False, None, p, seed)
    torch.cuda.synchronize()
    z = (out.float() * d * (1 - p)).round().permute(0, 2, 1, 3)
    assert torch.equal(z, keep)
    lse = torch.full((B, H, Sq), math.log(d), device="cuda")
    dg = torch.zeros(B, H, Sq, device="cuda")
    dq, _, _ = flash_attention_bwd_cuda(zeros, eye, eye, torch.ones_like(zeros),
                                        lse, dg, False, None, p, seed)
    zq = (dq.float() * d * (1 - p) * math.sqrt(d)).round()
    assert torch.equal(zq.permute(0, 2, 1, 3), keep)
    lse2, dg2 = lse[:, :, :d].contiguous(), dg[:, :, :d].contiguous()
    _, _, dv = flash_attention_bwd_cuda(kzero, kzero, eye, eye, lse2, dg2,
                                        False, None, p, seed)
    zv = (dv.float() * d * (1 - p)).round().permute(0, 2, 3, 1)
    assert torch.equal(zv, keep[:, :, :d])
    design = "sm90" if dtype == torch.bfloat16 else "mma"
    assert _designs(before) == {f"flash_attention_{design}": 1,
                                f"flash_attention_bwd_{design}": 2}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,hkv", [(77, 77, 8), (130, 130, 2),
                                       (40, 100, 4)])
def test_flash_dropout_kernels_match_plain(gen, dtype, d, causal, sq, sk,
                                           hkv):
    p, seed = 0.1, 2024
    q = _rnd(gen, dtype, 2, sq, 8, d)
    k, v = _rnd(gen, dtype, 2, sk, hkv, d), _rnd(gen, dtype, 2, sk, hkv, d)
    g = _rnd(gen, dtype, 2, sq, 8, d)
    out, lse = flash_attention_cuda(q, k, v, causal, None, p, seed)
    p_out, p_lse = flash_attention_plain(q, k, v, causal, None, p, seed)
    _close(out, p_out, **_tol(dtype))
    _close(lse, p_lse, atol=1e-3 if dtype == torch.bfloat16 else 1e-4,
           rtol=1e-5)
    dg = delta_minus_glse(p_out, g)
    got = flash_attention_bwd_cuda(q, k, v, g, p_lse, dg, causal, None, p,
                                   seed)
    want = flash_attention_bwd_plain(q, k, v, g, p_lse, dg, causal, None, p,
                                     seed)
    for a, b in zip(got, want):
        _close(a, b, **_grad_tol(dtype, b))


def test_dropout_variants_count_under_their_own_names(gen):
    q = _rnd(gen, torch.bfloat16, 1, 9, 4, 64).requires_grad_()
    before = K.launch_counts()
    out, _ = flash_attention_fwd(q, q, q, dropout_p=0.1, seed=3)
    out.float().sum().backward()
    layernorm(q.detach()[0], torch.ones(64, device="cuda"),
              torch.zeros(64, device="cuda"))
    after = K.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"flash_attention_dropout": 1, "flash_attention_bwd_dropout": 1,
            "flash_attention_sm90": 1, "flash_attention_bwd_sm90": 1,
            "layernorm": 1}


def test_bool_mask_on_the_card_runs_the_mask_kernels(gen):
    """A bool attn_mask takes the flash kernels' mask variant, forward and
    backward, and its gradients match the CPU's plain versions."""
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

    mask = torch.rand(2, 1, 1, 9, device="cuda", generator=gen) > 0.3
    mask[..., 0] = True
    tensors = [_rnd(gen, torch.bfloat16, 2, 9, 4, 64) for _ in range(3)]
    launched = _grads_match(
        lambda q, k, v: scaled_dot_product_attention(
            q, k, v, attn_mask=mask.to(q.device)).float().square().sum(),
        tensors, torch.bfloat16)
    assert {k: v for k, v in launched.items() if v} == {
        "flash_attention_mask": 1, "flash_attention_bwd_mask": 1,
        "flash_attention_sm90": 1, "flash_attention_bwd_sm90": 1}


@pytest.mark.parametrize("dtype", DTYPES)
def test_regression_backward_through_layer_norm_on_the_card(gen, dtype):
    from paddle_tpu_torch.nn.functional import layer_norm

    x = _rnd(gen, dtype, 2, 5, 768)
    w = (1 + 0.1 * torch.randn(768, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(768, device="cuda", generator=gen)).to(dtype)
    t = _rnd(gen, dtype, 2, 5, 768).float().cpu()
    out = layer_norm(x.detach().requires_grad_(), 768, w, b)
    assert out.grad_fn is not None

    def f(x_, w_, b_):
        return (layer_norm(x_, 768, w_, b_).float() * t.to(x_.device)).sum()

    n = _grads_match(f, (x, w, b), dtype)
    assert n["layernorm"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_regression_backward_through_dropout_attention_on_the_card(gen,
                                                                   dtype):
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention

    q = _rnd(gen, dtype, 2, 70, 8, 64)
    k, v = _rnd(gen, dtype, 2, 70, 2, 64), _rnd(gen, dtype, 2, 70, 2, 64)
    t = _rnd(gen, dtype, 2, 70, 8, 64).float().cpu()
    out = scaled_dot_product_attention(q.requires_grad_(), k, v,
                                       dropout_p=0.1, seed=5)
    assert out.grad_fn is not None
    q = q.detach()

    def f(q_, k_, v_):
        out = scaled_dot_product_attention(q_, k_, v_, dropout_p=0.1,
                                           seed=5)
        return (out.float() * t.to(q_.device)).sum()

    n = _grads_match(f, (q, k, v), dtype)
    assert n["flash_attention_dropout"] == 1
    assert n["flash_attention_bwd_dropout"] == 1


def test_ernie_tiny_step_on_the_card_matches_the_cpu(gen):
    """One f32 ERNIE MLM step with attention dropout 0.1 (same seeds on
    both sides), every kernel forward and backward on the card, against
    the same weights on the CPU through the plain versions."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import ErnieForMaskedLM, ernie_tiny
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import AdamW

    cfg = ernie_tiny(vocab=211, hidden=128, layers=2, heads=2, inter=256,
                     seq=64)
    cfg.attention_probs_dropout_prob = 0.1
    rng = torch.Generator().manual_seed(1)
    x = torch.randint(0, 211, (2, 48), generator=rng)
    y = torch.where(torch.rand(2, 48, generator=rng) < 0.3, x, -100)
    models = [ErnieForMaskedLM(cfg, generator=gen),
              ErnieForMaskedLM(cfg, device="cpu")]
    models[1].load_state_dict({k: v.cpu()
                               for k, v in models[0].state_dict().items()})
    losses, launched = [], None
    for m in models:
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        dev = m.ernie.device
        framework.seed(3)
        before = K.launch_counts()
        loss = cross_entropy(m(x.to(dev)).reshape(-1, 211),
                             y.to(dev).reshape(-1))
        loss.backward()
        if launched is None:
            launched = {k: v - before[k] for k, v in K.launch_counts().items()}
        losses.append(loss.item())
        opt.step()
        opt.clear_grad()
        framework.seed(4)
        losses.append(cross_entropy(m(x.to(dev)).reshape(-1, 211),
                                    y.to(dev).reshape(-1)).item())
    assert losses[:2] == pytest.approx(losses[2:], rel=1e-4, abs=1e-5)
    assert launched["layernorm"] == 6
    assert launched["flash_attention_dropout"] == 2
    assert launched["flash_attention_bwd_dropout"] == 2
    assert launched["softmax_ce"] == 1 and launched["softmax_ce_bwd"] == 1


# ---------------------------------------------------------------------------
# Conformer slice: flash at head_dim 36, the CTC kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("causal,sq,sk,hkv", [(False, 400, 400, 4),
                                              (True, 77, 77, 2),
                                              (False, 40, 100, 4)])
def test_flash_head_dim_36_matches_plain(gen, dtype, p, causal, sq, sk, hkv):
    q = _rnd(gen, dtype, 2, sq, 4, 36)
    k, v = _rnd(gen, dtype, 2, sk, hkv, 36), _rnd(gen, dtype, 2, sk, hkv, 36)
    g = _rnd(gen, dtype, 2, sq, 4, 36)
    out, lse = flash_attention_cuda(q, k, v, causal, None, p, 99)
    p_out, p_lse = flash_attention_plain(q, k, v, causal, None, p, 99)
    _close(out, p_out, **_tol(dtype))
    _close(lse, p_lse, atol=1e-3 if dtype == torch.bfloat16 else 1e-4,
           rtol=1e-5)
    dg = delta_minus_glse(p_out, g)
    got = flash_attention_bwd_cuda(q, k, v, g, p_lse, dg, causal, None, p, 99)
    want = flash_attention_bwd_plain(q, k, v, g, p_lse, dg, causal, None, p,
                                     99)
    for a, b in zip(got, want):
        _close(a, b, **_grad_tol(dtype, b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H", [3, 4])
def test_flash_head_dim_36_applies_the_plain_mask(gen, dtype, H):
    """The probes of ``test_flash_kernels_apply_the_plain_mask`` at
    D = 36, whose padding columns must neither leak into the real ones nor
    be stored: at 3 heads in bf16 the mma kernels (token rows of 216
    bytes), at 4 the sm90 ones through the flattened maps."""
    d, B, Sq, p, seed = 36, 2, 150, 0.1, 78
    zeros = torch.zeros(B, Sq, H, d, device="cuda", dtype=dtype)
    kzero = torch.zeros(B, d, H, d, device="cuda", dtype=dtype)
    eye = torch.eye(d, device="cuda", dtype=dtype)[None, :, None, :].expand(
        B, d, H, d).contiguous()
    keep = dropout_keep_plain(seed, B, H, Sq, d, p, "cuda").float()
    out, _ = flash_attention_cuda(zeros, kzero, eye, False, None, p, seed)
    torch.cuda.synchronize()
    assert torch.equal((out.float() * d * (1 - p)).round()
                       .permute(0, 2, 1, 3), keep)
    lse = torch.full((B, H, Sq), math.log(d), device="cuda")
    dg = torch.zeros(B, H, Sq, device="cuda")
    dq, _, _ = flash_attention_bwd_cuda(zeros, eye, eye, torch.ones_like(zeros),
                                        lse, dg, False, None, p, seed)
    zq = (dq.float() * d * (1 - p) * math.sqrt(d)).round()
    assert torch.equal(zq.permute(0, 2, 1, 3), keep)
    _, _, dv = flash_attention_bwd_cuda(
        kzero, kzero, eye, eye, lse[:, :, :d].contiguous(),
        dg[:, :, :d].contiguous(), False, None, p, seed)
    zv = (dv.float() * d * (1 - p)).round().permute(0, 2, 3, 1)
    assert torch.equal(zv, keep[:, :, :d])


def _ctc_batch(T, B, C, L, seed):
    """Ragged lengths, repeated labels (row 1), an empty label (row 2) and
    an infeasible row (row 3), on the card (with L = 0 every label is
    empty)."""
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(2 * torch.randn(T, B, C, generator=g), -1)
    labels = torch.randint(1, C, (B, L), generator=g)
    in_len = torch.randint(3 * T // 4, T + 1, (B,), generator=g)
    lbl_len = torch.randint(L // 2, L + 1, (B,), generator=g)
    lbl_len[2] = 0
    if L:
        labels[1, 1:4] = labels[1, 0]
        labels[3], lbl_len[3], in_len[3] = 5, L, L + 2
    return [t.cuda() for t in (lp, labels, in_len, lbl_len)]


def _lattice_close(got, want):
    torch.cuda.synchronize()
    dead = want <= -5e29
    assert torch.equal(dead, got <= -5e29)
    assert torch.equal(got[dead], want[dead])
    torch.testing.assert_close(got[~dead], want[~dead], atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("T,B,C,L,route", [
    (400, 16, 128, 48, "warp"), (400, 5, 128, 100, "block"),
    (9, 4, 6, 3, "warp"), (60, 4, 30, 0, "warp"),
    # both sides of the warp boundary (S 127 / 129; 129 with whole rows
    # of an odd C, so no row starts on a 16-byte boundary)
    (70, 4, 200, 63, "warp"), (70, 4, 41, 64, "block"),
    # a vocabulary of thousands, odd; the widest lattice (S 8191) with
    # whole rows and with gathered states; one time step
    (60, 4, 5001, 20, "warp"), (24, 4, 33, 4095, "block"),
    (12, 4, 9000, 4095, "block"), (1, 4, 6, 3, "warp")])
def test_ctc_kernels_match_plain(gen, T, B, C, L, route):
    from paddle_tpu_torch.kernels import ctc as CT
    from paddle_tpu_torch.kernels.ctc import (ctc_alpha_cuda, ctc_alpha_plain,
                                              ctc_beta_cuda, ctc_beta_plain)

    S = 2 * L + 1
    p = CT.launch_plan(S, C)         # the kernels' own plan is the wrapper's
    assert p.route == route
    assert CT.ctc_launch_plan_cuda(S, C) == (
        p.cells, p.warps, p.helpers, int(p.stage == "rows"), p.band,
        p.stages, p.smem)
    args = _ctc_batch(T, B, C, L, T + L)
    before = dict(CT.ROUTES)
    alphas, ll = ctc_alpha_cuda(*args)
    betas = ctc_beta_cuda(*args)
    assert {k: v - before[k] for k, v in CT.ROUTES.items()
            if v != before[k]} == {f"ctc_alpha_{route}": 1,
                                   f"ctc_beta_{route}": 1}
    p_alphas, p_ll = ctc_alpha_plain(*args)
    _lattice_close(alphas, p_alphas)
    _close(ll, p_ll, atol=1e-4, rtol=1e-5)
    _lattice_close(betas, ctc_beta_plain(*args))
    # the same bits again
    again, ll2 = ctc_alpha_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(again, alphas) and torch.equal(ll2, ll)
    assert torch.equal(ctc_beta_cuda(*args), betas)


def test_ctc_kernels_expf_logf_are_cudas_bit_for_bit(gen):
    """The CTC kernels write expf and logf out as CUDA's own instruction
    sequences (to step four states in lockstep): every argument they take
    must give CUDA's bits. The exps take x - max <= 0 (every non-NaN
    negative float, -0 to -inf), the logs a sum 1 + e^x (+ e^y) in
    [1, 3]."""
    from paddle_tpu_torch.kernels.ctc import math_check_cuda

    assert math_check_cuda(0x80000000, 0xFF800000 - 0x80000000 + 1,
                           "exp") == 0
    assert math_check_cuda(0x3F800000, 0x40400000 - 0x3F800000 + 1,
                           "log") == 0


def test_regression_ctc_loss_on_the_card_launches_the_kernels(gen):
    from paddle_tpu_torch.kernels.ctc import MAX_STATES, ctc_alpha_cuda
    from paddle_tpu_torch.nn.functional import ctc_loss

    lp, labels, in_len, lbl_len = _ctc_batch(80, 6, 20, 12, 3)
    x = lp.clone().requires_grad_()
    before = K.launch_counts()
    loss = ctc_loss(x, labels, in_len, lbl_len)
    assert loss.grad_fn is not None
    loss.backward()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in K.launch_counts().items()
                if v != before[k]}
    assert launched == {"ctc_alpha": 1, "ctc_beta": 1}
    xc = lp.cpu().requires_grad_()
    ref = ctc_loss(xc, labels.cpu(), in_len.cpu(), lbl_len.cpu())
    ref.backward()
    _close(loss, ref.cuda(), atol=1e-4, rtol=1e-5)
    _close(x.grad, xc.grad.cuda(), **_grad_tol(torch.float32, xc.grad))
    assert not x.grad[:, 3].any()              # the infeasible row
    again = lp.clone().requires_grad_()        # the same bits again
    ctc_loss(again, labels, in_len, lbl_len).backward()
    torch.testing.assert_close(again.grad, x.grad, atol=0, rtol=0)
    long = torch.zeros(2, (MAX_STATES + 1) // 2, device="cuda",
                       dtype=torch.int64)
    with pytest.raises(ValueError, match="extended states"):
        ctc_alpha_cuda(lp[:, :2], long, in_len[:2], lbl_len[:2])
    with pytest.raises(RuntimeError):          # the raw wrapper: no autograd
        ctc_alpha_cuda(x, labels, in_len, lbl_len)


def test_conformer_tiny_step_on_the_card_matches_the_cpu(gen):
    """One f32 ConformerForCTC step at head_dim 36 with attention dropout
    0.1 (same seeds; hidden dropout 0, whose masks come from each device's
    generator), against the same weights on the CPU. cuDNN's f32
    convolutions would run in TF32 by default (three decimal digits), so
    this test turns that off, as it holds f32 against f32."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import ConformerForCTC, conformer_tiny
    from paddle_tpu_torch.nn import Dropout
    from paddle_tpu_torch.nn.functional import ctc_loss

    cfg = conformer_tiny(vocab=40, hidden=72, layers=2, heads=2)
    cfg.dropout = 0.1
    models = [ConformerForCTC(cfg, generator=gen),
              ConformerForCTC(cfg, device="cpu")]
    models[1].load_state_dict({k: v.cpu()
                               for k, v in models[0].state_dict().items()})
    rng = torch.Generator().manual_seed(2)
    x = torch.rand(3, 64, 16, generator=rng)
    labels = torch.randint(1, 40, (3, 5), generator=rng)
    in_len, lbl_len = torch.tensor([16, 14, 12]), torch.tensor([5, 4, 3])
    out = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    for m in models:
        for mod in m.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
        framework.seed(3)
        before = K.launch_counts()
        dev = m.device
        loss = ctc_loss(m(x.to(dev)), labels, in_len, lbl_len)
        loss.backward()
        launched = {k: v - before[k] for k, v in K.launch_counts().items()
                    if v != before[k]}
        out.append((loss.item(), launched,
                    {n: p.grad.cpu() for n, p in m.named_parameters()},
                    {n: b.cpu() for n, b in m.named_buffers()}))
    torch.backends.cudnn.allow_tf32 = tf32
    (l0, launched, g0, b0), (l1, _, g1, b1) = out
    assert l0 == pytest.approx(l1, rel=1e-4)
    assert launched == {"layernorm": 10, "flash_attention_dropout": 2,
                        "flash_attention_bwd_dropout": 2,
                        "flash_attention_mma": 2,
                        "flash_attention_bwd_mma": 2, "ctc_alpha": 1,
                        "ctc_beta": 1}
    for n in g1:
        torch.testing.assert_close(g0[n], g1[n], atol=1e-4, rtol=1e-3,
                                   msg=n)
    for n in b1:
        torch.testing.assert_close(b0[n], b1[n], atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# RNN-T slice: the RNN-T lattice kernels, ConformerForRNNT
# ---------------------------------------------------------------------------

def _rnnt_batch(B, T, U1, seed, edges=False):
    """Log-prob lattices ``[B, T, U1]`` (blank and one emit class of a
    3-way log-softmax), t_len over 3T/4..T and u_len over (U1-1)/2..U1-1,
    emits past u_len and at column U1-1 at -1e30; with ``edges`` row 0
    has u_len 0, row 1 t_len 1 and row 2 both."""
    from paddle_tpu_torch.kernels.rnnt import NEG

    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(2 * torch.randn(B, T, U1, 3, generator=g), -1)
    tl = torch.randint(3 * T // 4, T + 1, (B,), generator=g)
    ul = torch.randint((U1 - 1) // 2, U1, (B,), generator=g)
    if edges:
        ul[0], tl[1], tl[2], ul[2] = 0, 1, 1, 0
    emit = torch.where(torch.arange(U1) < ul[:, None, None], lp[..., 1], NEG)
    return [t.cuda() for t in (lp[..., 0].contiguous(), emit, tl, ul)]


@pytest.mark.parametrize("B,T,U1,edges,route", [
    (16, 400, 49, False, "warp"), (8, 200, 513, False, "block"),
    (4, 50, 1024, True, "block"), (3, 9, 7, True, "warp"),
    # both sides of the warp boundary; odd T x (U + 1), so every utterance
    # but the first starts off a 16-byte boundary
    (4, 21, 64, True, "warp"), (5, 37, 65, True, "block"),
    (3, 41, 49, True, "warp"),
    # four cells a lane; eight, with a ring of two bands of one diagonal
    (2, 7, 2500, False, "block"), (2, 5, 4096, False, "block")])
def test_rnnt_kernels_match_plain(gen, B, T, U1, edges, route):
    from paddle_tpu_torch.kernels import rnnt as R
    from paddle_tpu_torch.kernels.rnnt import (
        rnnt_alpha_cuda, rnnt_alpha_plain, rnnt_beta_grad_cuda,
        rnnt_beta_grad_plain)

    for beta in (False, True):      # the kernels' own plan is the wrapper's
        p = R.launch_plan(U1, beta)
        assert p.route == route
        assert R.rnnt_launch_plan_cuda(U1, beta) == (
            p.cells, p.warps, p.helpers, p.band, p.stages, p.smem)
    args = _rnnt_batch(B, T, U1, T + U1, edges)
    before = dict(R.ROUTES)
    alphas, ll = rnnt_alpha_cuda(*args)
    p_alphas, p_ll = rnnt_alpha_plain(*args)
    _lattice_close(alphas, p_alphas)
    _close(ll, p_ll, atol=1e-4, rtol=1e-5)
    gb, ge, betas = rnnt_beta_grad_cuda(*args[:2], p_alphas, *args[2:], p_ll,
                                        with_betas=True)
    assert {k: v - before[k] for k, v in R.ROUTES.items()
            if v != before[k]} == {f"rnnt_alpha_{route}": 1,
                                   f"rnnt_beta_grad_{route}": 1}
    p_gb, p_ge, p_betas = rnnt_beta_grad_plain(*args[:2], p_alphas,
                                               *args[2:], p_ll,
                                               with_betas=True)
    _lattice_close(betas, p_betas)
    _close(gb, p_gb, atol=1e-5, rtol=0)
    _close(ge, p_ge, atol=1e-5, rtol=0)
    _close(betas[:, 0, 0], ll, atol=1e-4, rtol=1e-5)
    # the same bits again, and without bhat the same posteriors
    again = rnnt_beta_grad_cuda(*args[:2], p_alphas, *args[2:], p_ll)
    torch.testing.assert_close(rnnt_alpha_cuda(*args)[0], alphas, atol=0,
                               rtol=0)
    torch.testing.assert_close(again[0], gb, atol=0, rtol=0)
    torch.testing.assert_close(again[1], ge, atol=0, rtol=0)


def test_regression_rnnt_loss_on_the_card_launches_the_kernels(gen):
    from paddle_tpu_torch.kernels.rnnt import (MAX_STATES, rnnt_alpha_cuda,
                                               rnnt_beta_grad_cuda)
    from paddle_tpu_torch.nn.functional import rnnt_loss

    g = torch.Generator().manual_seed(4)
    logits = torch.randn(3, 30, 8, 11, generator=g)
    labels = torch.randint(1, 11, (3, 7), generator=g)
    tl, ul = torch.tensor([30, 1, 21]), torch.tensor([7, 3, 0])
    x = logits.cuda().requires_grad_()
    before = K.launch_counts()
    loss = rnnt_loss(x, labels, tl, ul, reduction="sum", fastemit_lambda=0.01)
    assert loss.grad_fn is not None
    loss.backward()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in K.launch_counts().items()
                if v != before[k]}
    assert launched == {"rnnt_alpha": 1, "rnnt_beta_grad": 1}
    xc = logits.clone().requires_grad_()
    ref = rnnt_loss(xc, labels, tl, ul, reduction="sum", fastemit_lambda=0.01)
    ref.backward()
    _close(loss, ref.cuda(), atol=1e-4, rtol=1e-5)
    _close(x.grad, xc.grad.cuda(), **_grad_tol(torch.float32, xc.grad))
    again = logits.cuda().requires_grad_()          # the same bits again
    rnnt_loss(again, labels, tl, ul, reduction="sum",
              fastemit_lambda=0.01).backward()
    torch.testing.assert_close(again.grad, x.grad, atol=0, rtol=0)
    lat = torch.zeros(2, 3, 4, device="cuda", requires_grad=True)
    lens = torch.ones(2, device="cuda", dtype=torch.int64)
    with pytest.raises(RuntimeError):          # the raw wrappers: no autograd
        rnnt_alpha_cuda(lat, lat, lens, lens)
    with pytest.raises(RuntimeError):
        rnnt_beta_grad_cuda(lat, lat, lat, lens, lens,
                            torch.zeros(2, device="cuda"))
    wide = torch.zeros(1, 2, MAX_STATES + 1, device="cuda")
    with pytest.raises(ValueError, match="label positions"):
        rnnt_alpha_cuda(wide, wide, lens[:1], lens[:1])


def test_conformer_rnnt_tiny_step_on_the_card_matches_the_cpu(gen):
    """One f32 ConformerForRNNT step (head_dim 36, attention dropout 0.1 with
    the same seeds, hidden dropout 0) against the same weights on the CPU,
    cuDNN's TF32 off as in the CTC model's test; the launches are exactly
    the model's structure."""
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.models import ConformerForRNNT, conformer_tiny
    from paddle_tpu_torch.nn import Dropout
    from paddle_tpu_torch.nn.functional import rnnt_loss

    cfg = conformer_tiny(vocab=40, hidden=72, layers=2, heads=2)
    cfg.dropout = 0.1
    models = [ConformerForRNNT(cfg, generator=gen),
              ConformerForRNNT(cfg, device="cpu")]
    models[1].load_state_dict({k: v.cpu()
                               for k, v in models[0].state_dict().items()})
    rng = torch.Generator().manual_seed(2)
    x = torch.rand(3, 64, 16, generator=rng)
    labels = torch.randint(1, 40, (3, 5), generator=rng)
    tl, ul = torch.tensor([16, 14, 12]), torch.tensor([5, 4, 0])
    out = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for m in models:
            for mod in m.modules():
                if isinstance(mod, Dropout):
                    mod.p = 0.0
            framework.seed(3)
            before = K.launch_counts()
            dev = m.device
            loss = rnnt_loss(m(x.to(dev), labels.to(dev)), labels, tl, ul)
            loss.backward()
            launched = {k: v - before[k] for k, v in K.launch_counts().items()
                        if v != before[k]}
            out.append((loss.item(), launched,
                        {n: p.grad.cpu() for n, p in m.named_parameters()}))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (l0, launched, g0), (l1, _, g1) = out
    assert l0 == pytest.approx(l1, rel=1e-4)
    assert launched == {"layernorm": 10, "flash_attention_dropout": 2,
                        "flash_attention_bwd_dropout": 2,
                        "flash_attention_mma": 2,
                        "flash_attention_bwd_mma": 2, "rnnt_alpha": 1,
                        "rnnt_beta_grad": 1}
    for n in g1:
        torch.testing.assert_close(g0[n], g1[n], atol=1e-4, rtol=1e-3,
                                   msg=n)


# ---------------------------------------------------------------------------
# flash slice: bool masks, varlen, every head width; rms_norm under amp
# ---------------------------------------------------------------------------

def _flash_pair(gen, dtype, B, Sq, Sk, H, Hkv, D, causal, p=0.0, mask=None):
    """The flash kernels against the plain versions, forward and backward
    (an lse cotangent included), on one case."""
    q = _rnd(gen, dtype, B, Sq, H, D)
    k, v = _rnd(gen, dtype, B, Sk, Hkv, D), _rnd(gen, dtype, B, Sk, Hkv, D)
    g = _rnd(gen, dtype, B, Sq, H, D)
    g_lse = 0.1 * torch.randn(B, H, Sq, device="cuda", generator=gen)
    out, lse = flash_attention_cuda(q, k, v, causal, None, p, 5, mask)
    p_out, p_lse = flash_attention_plain(q, k, v, causal, None, p, 5, mask)
    _close(out, p_out, **_tol(dtype))
    _close(lse, p_lse, atol=1e-3 if dtype == torch.bfloat16 else 1e-4,
           rtol=1e-5)
    dg = delta_minus_glse(p_out, g, g_lse)
    got = flash_attention_bwd_cuda(q, k, v, g, p_lse, dg, causal, None, p, 5,
                                   mask)
    want = flash_attention_bwd_plain(q, k, v, g, p_lse, dg, causal, None, p,
                                     5, mask)
    for a, b in zip(got, want):
        _close(a, b, **_grad_tol(dtype, b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 7, 16, 18, 33, 34, 40, 96, 136, 200,
                               256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_every_head_dim_matches_plain(gen, dtype, d, causal):
    """Head widths ride zero-padded to their class (multiples of 16 up to
    128, of 32 up to 256); 96 used to raise."""
    _flash_pair(gen, dtype, 2, 77, 77, 4, 2, d, causal, 0.1 if d % 2 else 0.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_misaligned_rows_take_narrower_chunks(gen, dtype):
    """Views 2 bytes into their storage: the kernels move rows in 2-byte
    chunks instead of raising, and still match."""
    def view(*shape):
        n = math.prod(shape)
        return _rnd(gen, dtype, n + 1)[1:].view(*shape)
    q, k, v, g = (view(1, 33, 4, 64) for _ in range(4))
    out, lse = flash_attention_cuda(q, k, v, True)
    p_out, p_lse = flash_attention_plain(q, k, v, True)
    _close(out, p_out, **_tol(dtype))
    dg = delta_minus_glse(p_out, g)
    for a, b in zip(flash_attention_bwd_cuda(q, k, v, g, p_lse, dg, True),
                    flash_attention_bwd_plain(q, k, v, g, p_lse, dg, True)):
        _close(a, b, **_grad_tol(dtype, b))


MASK_SHAPES = [(1, 1, 1, 130), (2, 1, 1, 130), (1, 4, 130, 130),
               (2, 4, 130, 130), (2, 1, 130, 130), (130, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MASK_SHAPES)
@pytest.mark.parametrize("causal,p", [(False, 0.0), (False, 0.1),
                                     (True, 0.1)])
def test_flash_mask_kernels_match_plain(gen, dtype, shape, causal, p):
    """Every mask mode, row dim 1 or Sq, key dim 1; with a fully masked row
    in the per-query masks (the mirror's average over the hidden keys)."""
    mask = torch.rand(*shape, device="cuda", generator=gen) > 0.3
    if len(shape) == 4 and shape[2] == 130:
        mask[0, 0, 5] = False
    _flash_pair(gen, dtype, 2, 130, 130, 4, 2, 64, causal, p, mask)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,n", [("one", 1), ("batch", 2), ("head", 2),
                                    ("bh", 4)])
def test_flash_canonical_mask_with_mode_matches_plain(gen, dtype, mode, n):
    """The reference's canonical [N, Sq, Sk] with its mode, B == H."""
    mask = torch.rand(n, 70, 70, device="cuda", generator=gen) > 0.4
    q, k, v = (_rnd(gen, dtype, 2, 70, 2, 64) for _ in range(3))
    m4 = mask_view(mask, 2, 2, 70, 70, mode)
    out, lse = flash_attention_cuda(q, k, v, True, mask=m4)
    p_out, p_lse = flash_attention_plain(q, k, v, True, mask=m4)
    _close(out, p_out, **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_flash_varlen_kernels_match_plain(gen, dtype, causal, p):
    """Packed sequences with an empty one, tails past cu[-1], GQA; without
    causality cu_q != cu_k with an empty key part."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attn_varlen_bwd_cuda, flash_attn_varlen_bwd_plain,
        flash_attn_varlen_cuda, flash_attn_varlen_plain)

    cq = torch.tensor([0, 50, 50, 130, 200], device="cuda", dtype=torch.int32)
    ck = cq if causal else torch.tensor([0, 7, 90, 90, 150], device="cuda",
                                        dtype=torch.int32)
    tk = 210 if causal else 160
    q, g = _rnd(gen, dtype, 210, 8, 64), _rnd(gen, dtype, 210, 8, 64)
    k, v = _rnd(gen, dtype, tk, 2, 64), _rnd(gen, dtype, tk, 2, 64)
    out, lse = flash_attn_varlen_cuda(q, k, v, cq, ck, causal, None, p, 3)
    p_out, p_lse = flash_attn_varlen_plain(q, k, v, cq, ck, causal, None, p,
                                           3)
    _close(out, p_out, **_tol(dtype))
    _close(lse, p_lse, atol=1e-3 if dtype == torch.bfloat16 else 1e-4,
           rtol=1e-5)
    assert not out[200:].any()
    dg = delta_minus_glse(p_out, g)
    got = flash_attn_varlen_bwd_cuda(q, k, v, g, p_lse, dg, cq, ck, causal,
                                     None, p, 3)
    want = flash_attn_varlen_bwd_plain(q, k, v, g, p_lse, dg, cq, ck, causal,
                                       None, p, 3)
    for a, b in zip(got, want):
        _close(a, b, **_grad_tol(dtype, b))


def test_flash_attn_unpadded_on_the_card_counts_the_varlen_kernels(gen):
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded

    cu = torch.tensor([0, 40, 41, 130], device="cuda", dtype=torch.int32)
    tensors = [_rnd(gen, torch.bfloat16, 140, 4, 96) for _ in range(3)]
    launched = _grads_match(
        lambda q, k, v: flash_attn_unpadded(
            q, k, v, cu.to(q.device), cu.to(q.device),
            causal=True)[0].float().square().sum(),
        tensors, torch.bfloat16)
    assert {k: v for k, v in launched.items() if v} == {
        "flash_attention_varlen": 1, "flash_attention_bwd_varlen": 1,
        "flash_attention_sm90": 1, "flash_attention_bwd_sm90": 1}


def test_rms_norm_layer_under_auto_cast_on_the_card(gen):
    """F2: nn.RMSNorm (f32 weight) on a bf16 input under amp O1 runs the
    kernels in f32, forward and backward, and matches the CPU."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import RMSNorm

    layers = [RMSNorm(256), RMSNorm(256, device="cpu")]
    x = _rnd(gen, torch.bfloat16, 6, 256)
    # a random projection: the x-gradient of sum(out ** 2) is all
    # cancellation (out is scale-free in x), this one's is not
    proj = _rnd(gen, torch.float32, 6, 256)
    xs = [x.clone().requires_grad_(), x.cpu().requires_grad_()]
    before = K.launch_counts()
    outs = []
    for layer, xi in zip(layers, xs):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            out = layer(xi)
        assert out.dtype == torch.float32
        (out * proj.to(out.device)).sum().backward()
        outs.append(out)
    launched = {k: v - before[k] for k, v in K.launch_counts().items()}
    assert launched["rmsnorm"] == 1 and launched["rmsnorm_bwd"] == 1
    _close(outs[0], outs[1].cuda(), atol=1e-5, rtol=1e-5)
    _close(xs[0].grad, xs[1].grad.cuda(), **_grad_tol(torch.bfloat16,
                                                      xs[1].grad))
    _close(layers[0].weight.grad, layers[1].weight.grad.cuda(),
           **_grad_tol(torch.float32, layers[1].weight.grad))


# ---------------------------------------------------------------------------
# the Hopper flash kernels (wgmma / TMA): bf16 at every head-width class
# ---------------------------------------------------------------------------

def _designs(before):
    """The flash design counters that moved since the counts ``before``."""
    return {k: v - before[k] for k, v in K.launch_counts().items()
            if v != before[k] and k.endswith(("_sm90", "_mma"))}


SM90_BOTH = {"flash_attention_sm90": 1, "flash_attention_bwd_sm90": 1}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(200, 333), (1000, 1000), (77, 300),
                                   (129, 129), (1, 257), (1, 1), (1, 1500),
                                   (224, 1500)])
def test_flash_sm90_ragged_tiles_match_plain(gen, d, causal, sq, sk):
    """Sq and Sk off the 128-row tiles, Sk > Sq causal (the bottom-right
    diagonal), one query row: the TMA boxes read past the ends, the
    kernels mask and never store there. (1, 1) is a Whisper decode step's
    first self-attention, (1, 1500) its cross-attention, (224, 1500) the
    training step's."""
    before = K.launch_counts()
    _flash_pair(gen, torch.bfloat16, 2, sq, sk, 4, 2, d, causal)
    assert _designs(before) == SM90_BOTH


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_flash_sm90_gqa_32_8_matches_plain(gen, d, causal, p):
    before = K.launch_counts()
    _flash_pair(gen, torch.bfloat16, 1, 300, 300, 32, 8, d, causal, p)
    assert _designs(before) == SM90_BOTH


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape", [(2, 4, 257, 257), (2, 1, 257, 257)])
def test_flash_sm90_fully_masked_rows_with_causality(gen, d, shape):
    """Rows whose every visible key is masked average V over the causally
    hidden keys, which lie in key tiles past the block's diagonal: the
    forward and dQ warpgroups walk on, the dK/dV producer loads the query
    tiles above the diagonal that hold such a row."""
    mask = torch.rand(*shape, device="cuda", generator=gen) > 0.5
    mask[:, :, 5:40] = False
    mask[1, :, 200] = False
    before = K.launch_counts()
    _flash_pair(gen, torch.bfloat16, 2, 257, 257, 4, 4, d, True, 0.1, mask)
    assert _designs(before) == SM90_BOTH


@pytest.mark.parametrize("d", [64, 128])
def test_flash_sm90_key_padding_mask_matches_plain(gen, d):
    lens = torch.tensor([130, 300], device="cuda")
    mask = (torch.arange(300, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    before = K.launch_counts()
    _flash_pair(gen, torch.bfloat16, 2, 300, 300, 8, 8, d, False, 0.1, mask)
    assert _designs(before) == SM90_BOTH


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lo,hi", [(130, 135), (3, 203), (0, 400),
                                   (250, 400)])
def test_flash_sm90_varlen_leaves_the_neighbours_untouched(gen, d, causal,
                                                           lo, hi):
    """One packed sequence [lo, hi) of 400 rows (shorter than a tile, or
    ending mid-tile) through the launch entries with out, dq, dk and dv
    pre-filled with a sentinel: its rows match the plain version, every
    other row comes back untouched although the tiles' TMA boxes read
    them."""
    from paddle_tpu_torch.kernels.flash_attention import (
        _drop_args, _launch_bwd, _launch_fwd, flash_attn_varlen_bwd_plain,
        flash_attn_varlen_plain)

    T, H, Hkv, p, seed = 400, 8, 2, 0.1, 13
    dt = torch.bfloat16
    q, g = _rnd(gen, dt, T, H, d), _rnd(gen, dt, T, H, d)
    k, v = _rnd(gen, dt, T, Hkv, d), _rnd(gen, dt, T, Hkv, d)
    L, sl = hi - lo, slice(lo, hi)
    cu = torch.tensor([lo, hi], device="cuda", dtype=torch.int32)
    # the plain version of the same packed positions (dropout keys on
    # them): [lo, hi) as the second of the sequences [0, lo), [lo, hi)
    cu_p = torch.tensor([0, lo, hi], device="cuda", dtype=torch.int32)
    p_out, p_lse = flash_attn_varlen_plain(q, k, v, cu_p, cu_p, causal,
                                           None, p, seed)
    sentinel = 7.0
    out = torch.full_like(q, sentinel)
    lse = torch.full((H, T), sentinel, device="cuda")
    drop, scale = _drop_args(p, seed), 1.0 / math.sqrt(d)
    before = K.launch_counts()
    _launch_fwd(q, k, v, out, lse, 1, L, L, causal, scale, drop, None,
                (cu, cu), T)
    _close(out[sl], p_out[sl], **_tol(dt))
    _close(lse[:, sl], p_lse[:, sl], atol=1e-3, rtol=1e-5)
    assert (out[:lo] == sentinel).all() and (out[hi:] == sentinel).all()
    assert (lse[:, :lo] == sentinel).all() and (lse[:, hi:] == sentinel).all()
    dg = delta_minus_glse(p_out, g)
    dq = torch.full_like(q, sentinel)
    dk, dv = torch.full_like(k, sentinel), torch.full_like(v, sentinel)
    _launch_bwd(q, k, v, g, p_lse, dg, dq, dk, dv, 1, L, L, causal, scale,
                drop, None, (cu, cu), T)
    want = flash_attn_varlen_bwd_plain(q, k, v, g, p_lse, dg, cu_p, cu_p,
                                       causal, None, p, seed)
    for a, b in zip((dq, dk, dv), want):
        _close(a[sl], b[sl], **_grad_tol(dt, b[sl]))
        assert (a[:lo] == sentinel).all() and (a[hi:] == sentinel).all()
    assert _designs(before) == SM90_BOTH


@pytest.mark.parametrize("causal", [True, False])
def test_flash_sm90_varlen_kernels_match_plain(gen, causal):
    """The public varlen entries at head_dim 128 with GQA, an empty
    sequence, one shorter than a tile and tails past cu[-1]."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attn_varlen_bwd_cuda, flash_attn_varlen_bwd_plain,
        flash_attn_varlen_cuda, flash_attn_varlen_plain)

    cu = torch.tensor([0, 5, 5, 133, 300, 301, 700], device="cuda",
                      dtype=torch.int32)
    dt = torch.bfloat16
    q, g = _rnd(gen, dt, 720, 8, 128), _rnd(gen, dt, 720, 8, 128)
    k, v = _rnd(gen, dt, 720, 2, 128), _rnd(gen, dt, 720, 2, 128)
    before = K.launch_counts()
    out, lse = flash_attn_varlen_cuda(q, k, v, cu, cu, causal, None, 0.1, 3)
    p_out, p_lse = flash_attn_varlen_plain(q, k, v, cu, cu, causal, None,
                                           0.1, 3)
    _close(out, p_out, **_tol(dt))
    _close(lse[:, :700], p_lse[:, :700], atol=1e-3, rtol=1e-5)
    assert not out[700:].any()
    dg = delta_minus_glse(p_out, g)
    got = flash_attn_varlen_bwd_cuda(q, k, v, g, p_lse, dg, cu, cu, causal,
                                     None, 0.1, 3)
    want = flash_attn_varlen_bwd_plain(q, k, v, g, p_lse, dg, cu, cu, causal,
                                       None, 0.1, 3)
    for a, b in zip(got, want):
        _close(a, b, **_grad_tol(dt, b))
    assert _designs(before) == SM90_BOTH


# one width of every sm90 head-width class (and the flattened 8-byte rows
# of 36 and 44): 24 -> 32, 56 -> 64, 72 -> 96, 120 -> 128, 136 -> 160,
# 176 -> 192, 200 -> 224
SM90_CLASS_WIDTHS = [8, 16, 24, 36, 44, 48, 56, 72, 96, 120, 136, 160, 176,
                     192, 200, 224, 256]


@pytest.mark.parametrize("d", SM90_CLASS_WIDTHS)
@pytest.mark.parametrize("case", ["causal_gqa_dropout", "mask", "cross"])
def test_flash_sm90_every_class_matches_plain(gen, d, case):
    """Every head-width class of the sm90 kernels, forward and backward
    against the plain versions: causal with GQA (8 query heads on 4 KV
    heads; 8 on 8 for the flattened rows of 36 and 44) and dropout; a bool key-padding mask with fully masked rows
    and dropout; Sq 70 against Sk 300 causal (the bottom-right diagonal)."""
    before = K.launch_counts()
    rep = 1 if d % 8 else 2     # the flattened maps take no GQA
    if case == "causal_gqa_dropout":
        _flash_pair(gen, torch.bfloat16, 2, 200, 200, 8, 8 // rep, d, True,
                    0.1)
    elif case == "mask":
        mask = torch.rand(2, 4, 1, 150, device="cuda", generator=gen) > 0.3
        mask[1, :, :, :] = False
        mask[1, :, :, 140:] = True
        _flash_pair(gen, torch.bfloat16, 2, 150, 150, 4, 4, d, True, 0.1,
                    mask.expand(2, 4, 150, 150))
    else:
        _flash_pair(gen, torch.bfloat16, 2, 70, 300, 4, 4 // rep, d, True)
    assert _designs(before) == SM90_BOTH


@pytest.mark.parametrize("d", [16, 36, 96, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_sm90_varlen_classes_match_plain(gen, d, causal):
    """Packed sequences (an empty one, one shorter than a tile, a tail past
    cu[-1]) at the timed widths, dropout on."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attn_varlen_bwd_cuda, flash_attn_varlen_bwd_plain,
        flash_attn_varlen_cuda, flash_attn_varlen_plain)

    cu = torch.tensor([0, 37, 37, 200, 333], device="cuda",
                      dtype=torch.int32)
    dt, hkv = torch.bfloat16, 4 if d % 8 else 2
    q, g = _rnd(gen, dt, 340, 4, d), _rnd(gen, dt, 340, 4, d)
    k, v = _rnd(gen, dt, 340, hkv, d), _rnd(gen, dt, 340, hkv, d)
    before = K.launch_counts()
    out, lse = flash_attn_varlen_cuda(q, k, v, cu, cu, causal, None, 0.1, 3)
    p_out, p_lse = flash_attn_varlen_plain(q, k, v, cu, cu, causal, None,
                                           0.1, 3)
    _close(out, p_out, **_tol(dt))
    _close(lse[:, :333], p_lse[:, :333], atol=1e-3, rtol=1e-5)
    dg = delta_minus_glse(p_out, g)
    got = flash_attn_varlen_bwd_cuda(q, k, v, g, p_lse, dg, cu, cu, causal,
                                     None, 0.1, 3)
    want = flash_attn_varlen_bwd_plain(q, k, v, g, p_lse, dg, cu, cu, causal,
                                       None, 0.1, 3)
    for a, b in zip(got, want):
        _close(a, b, **_grad_tol(dt, b))
    assert _designs(before) == SM90_BOTH


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_flash_sm90_d36_keeps_a_neighbours_non_finite_values_out(gen, p):
    """At head_dim 36 the flattened maps' boxes of head h read head h + 1's
    first 12 columns (the class 48's padding), which the kernels zero
    before every product at depth D. Head 2 of q, k, v and dO holds NaN and
    inf: heads 0, 1 and 3 (1 reads 2's columns) come out finite and equal
    to the plain version's, forward and backward."""
    B, S, H, d = 2, 140, 4, 36
    q, k, v, g = (_rnd(gen, torch.bfloat16, B, S, H, d) for _ in range(4))
    for t in (q, k, v, g):
        t[:, :, 2] = float("nan")
        t[:, 5, 2, 3] = float("inf")
    keep = [0, 1, 3]
    before = K.launch_counts()
    out, lse = flash_attention_cuda(q, k, v, False, None, p, 7)
    p_out, p_lse = flash_attention_plain(q, k, v, False, None, p, 7)
    assert torch.isfinite(out[:, :, keep]).all()
    assert torch.isfinite(lse[:, keep]).all()
    _close(out[:, :, keep], p_out[:, :, keep], **_tol(torch.bfloat16))
    dg = delta_minus_glse(p_out, g)
    got = flash_attention_bwd_cuda(q, k, v, g, p_lse, dg, False, None, p, 7)
    want = flash_attention_bwd_plain(q, k, v, g, p_lse, dg, False, None, p,
                                     7)
    for a, b in zip(got, want):
        assert torch.isfinite(a[:, :, keep]).all()
        _close(a[:, :, keep], b[:, :, keep],
               **_grad_tol(torch.bfloat16, b[:, :, keep]))
    assert _designs(before) == SM90_BOTH


@pytest.mark.parametrize("offset", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_misaligned_view_routes_to_the_mma_kernels(gen, offset, d):
    """A view 2, 4 or 8 bytes into its storage is no TMA source: the
    launch takes the mma kernels (narrower chunks) and still matches."""
    def view(*shape):
        n = math.prod(shape)
        return _rnd(gen, torch.bfloat16, n + offset)[offset:].view(*shape)
    q, k, v, g = (view(1, 150, 4, d) for _ in range(4))
    before = K.launch_counts()
    out, lse = flash_attention_cuda(q, k, v, True)
    p_out, p_lse = flash_attention_plain(q, k, v, True)
    _close(out, p_out, **_tol(torch.bfloat16))
    dg = delta_minus_glse(p_out, g)
    for a, b in zip(flash_attention_bwd_cuda(q, k, v, g, p_lse, dg, True),
                    flash_attention_bwd_plain(q, k, v, g, p_lse, dg, True)):
        _close(a, b, **_grad_tol(torch.bfloat16, b))
    assert _designs(before) == {"flash_attention_mma": 1,
                                "flash_attention_bwd_mma": 1}


@pytest.mark.parametrize("dtype,d,design", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 36, "sm90"), (torch.bfloat16, 96, "sm90"),
    (torch.bfloat16, 56, "sm90"), (torch.bfloat16, 120, "sm90"),
    (torch.bfloat16, 256, "sm90"), (torch.bfloat16, 16, "sm90"),
    (torch.bfloat16, 34, "mma"), (torch.bfloat16, 33, "mma"),
    (torch.float32, 64, "mma"), (torch.float32, 128, "mma"),
    (torch.float32, 36, "mma")])
def test_flash_design_counters_name_the_kernels_that_ran(gen, dtype, d,
                                                         design):
    """Through the differentiable entry: bf16 at every head_dim whose rows
    TMA reads takes the sm90 kernels (36, the Conformer's, through the
    flattened maps at 4 heads; 56 and 120 ride padded in the classes 64 and
    128, 96 and 256 in their own), bf16 rows of 4-byte chunks (34) or odd
    widths (33) and f32 the mma ones; the variant counters count as
    before."""
    q, k, v = (_rnd(gen, dtype, 2, 100, 4, d).requires_grad_()
               for _ in range(3))
    before = K.launch_counts()
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert _designs(before) == {f"flash_attention_{design}": 1,
                                f"flash_attention_bwd_{design}": 1}
    launched = {k_: v_ - before[k_] for k_, v_ in K.launch_counts().items()}
    assert launched["flash_attention"] == launched["flash_attention_bwd"] == 1


# ---------------------------------------------------------------------------
# Whisper slice: the seq2seq decoder with incremental caches
# ---------------------------------------------------------------------------

def test_whisper_generate_on_the_card_matches_the_cpu_and_its_rollout(gen):
    """A small f32 Whisper (d_model 128, 2 heads of 64, 2 + 2 layers):
    ``generate`` over the caches gives the card's own uncached greedy
    rollout and the CPU's tokens, and launches exactly the structure's
    kernels: the encoder's self-attention and LayerNorms once, then per
    step two flash forwards and three LayerNorms a decoder layer and the
    final LayerNorm."""
    from paddle_tpu_torch.models import (WhisperConfig,
                                         WhisperForConditionalGeneration)

    cfg = WhisperConfig(n_mels=16, vocab_size=97, d_model=128,
                        encoder_layers=2, decoder_layers=2, num_heads=2,
                        ffn_dim=256, max_source_positions=100,
                        max_target_positions=32)
    card = WhisperForConditionalGeneration(cfg, generator=gen).eval()
    cpu = WhisperForConditionalGeneration(cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    mel = torch.randn(3, 16, 200, generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = K.launch_counts()
        got = card.generate(mel.cuda(), max_new_tokens=10)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in K.launch_counts().items()
                    if v != before[k]}
        toks, done = got[:, :1], torch.zeros(3, dtype=torch.bool,
                                             device="cuda")
        with torch.no_grad():       # generate's end-of-text rule
            for _ in range(got.shape[1] - 1):
                nxt = card(mel.cuda(), toks)[:, -1].argmax(-1)
                nxt = torch.where(done, cfg.eot_token, nxt)
                done |= nxt == cfg.eot_token
                toks = torch.cat([toks, nxt[:, None]], dim=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want = cpu.generate(mel, max_new_tokens=10)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(toks, got)
    steps = got.shape[1] - 1
    flash = 2 + 2 * 2 * steps
    assert launched == {"flash_attention": flash, "flash_attention_mma": flash,
                        "layernorm": 5 + 7 * steps}


# ---------------------------------------------------------------------------
# Vision slice: softmax-CE at ResNet-50's head, a ResNet-18 O1 step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_softmax_ce_kernels_at_resnet_head(gen, dtype):
    """The classifier head's [64, 1000] logits (bf16 under O1)."""
    x = (3 * torch.randn(64, 1000, device="cuda", generator=gen)).to(dtype)
    lab = torch.randint(0, 1000, (64,), device="cuda", generator=gen)
    g = torch.full((64,), 1 / 64, device="cuda")
    loss, lse = softmax_ce_cuda(x, lab)
    p_loss, p_lse = softmax_ce_plain(x, lab)
    _close(loss, p_loss, atol=1e-4, rtol=1e-5)
    _close(lse, p_lse, atol=1e-4, rtol=1e-5)
    dx = softmax_ce_bwd_cuda(x, lab, lse, g)
    p_dx = softmax_ce_bwd_plain(x, lab, p_lse, g)
    _close(dx, p_dx, **_grad_tol(dtype, p_dx))


def test_resnet18_step_on_the_card(gen):
    """A ResNet-18 step (8 x 64 x 64) on the card against the CPU's plain
    path from the same weights. In f32 (TF32 off): the loss within 1e-4
    and every gradient within 5e-2 relative L2 (training-mode batch norm
    makes this step badly conditioned at initialisation: the CPU's own f32
    gradients are ~1 % off f64 here). Under O1: exactly one softmax-CE
    forward and backward launch, finite gradients, the loss within 2e-2 of
    the f32 one (bf16 moves the gradients themselves by tens of per cent
    at this point, on the CPU's bf16 autocast too, so they are not held),
    and a second step (Momentum over PiecewiseDecay, lr 0.01) that lowers
    it."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum, PiecewiseDecay
    from paddle_tpu_torch.vision.models import resnet18

    card = resnet18(num_classes=10, generator=gen)
    cpu = resnet18(num_classes=10, device="cpu")
    state = {k: v.cpu() for k, v in card.state_dict().items()}
    cpu.load_state_dict(state)
    rng = torch.Generator().manual_seed(4)
    x = torch.randn(8, 3, 64, 64, generator=rng)
    y = torch.randint(0, 10, (8, 1), generator=rng)
    cpu_loss = cross_entropy(cpu(x), y)
    cpu_loss.backward()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        loss = cross_entropy(card(x.cuda()), y.cuda())
        loss.backward()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert loss.item() == pytest.approx(cpu_loss.item(), rel=1e-4)
    for n, p in card.named_parameters():
        want = cpu.get_parameter(n).grad
        err = ((p.grad.cpu() - want).norm() / want.norm()).item()
        assert err < 5e-2, (n, err)
    card.zero_grad(set_to_none=True)
    card.load_state_dict(state)
    # lr 0.01: at 0.1 one step on 8 images can overshoot (the loss of a
    # second step rises for some seeds on the CPU too)
    sched = PiecewiseDecay([1], [0.01, 0.001])
    opt = Momentum(learning_rate=sched, momentum=0.9,
                   parameters=card.parameters(), weight_decay=1e-4)
    losses = []
    for _ in range(2):
        before = K.launch_counts()
        with amp.auto_cast(level="O1"):
            loss = cross_entropy(card(x.cuda()), y.cuda())
        loss.backward()
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in K.launch_counts().items()
                    if v != before[k]}
        assert launched == {"softmax_ce": 1, "softmax_ce_bwd": 1}
        assert all(torch.isfinite(p.grad).all() for p in card.parameters())
        losses.append(loss.item())
        opt.step()
        opt.clear_grad()
        sched.step()
    assert abs(losses[0] - cpu_loss.item()) < 2e-2
    assert math.isfinite(losses[1]) and losses[1] < losses[0]


def test_pooling_and_batch_norm_on_the_card_match_the_cpu(gen):
    """The reference's pooling semantics (explicit padding, ceil-mode
    windows in the padding, exclusive counts, return_mask indices) and the
    batch-norm layer's training step through cuDNN, f32 against the CPU."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    x = torch.randn(4, 8, 13, 11, device="cuda", generator=gen)
    cases = [(F.max_pool2d, dict(kernel_size=3, stride=2, padding=1,
                                 ceil_mode=True)),
             (F.avg_pool2d, dict(kernel_size=3, stride=2, padding=1,
                                 ceil_mode=True)),
             (F.avg_pool2d, dict(kernel_size=2, padding="SAME")),
             (F.adaptive_avg_pool2d, dict(output_size=(3, 4))),
             (F.adaptive_max_pool2d, dict(output_size=(2, 5)))]
    for fn, kw in cases:
        _close(fn(x, **kw).cpu(), fn(x.cpu(), **kw), atol=1e-5, rtol=1e-5)
    out, idx = F.max_pool2d(x, 3, 2, 1, return_mask=True)
    want, widx = F.max_pool2d(x.cpu(), 3, 2, 1, return_mask=True)
    _close(out.cpu(), want, atol=0, rtol=0)
    assert torch.equal(idx.cpu(), widx)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        layers = [nn.BatchNorm2D(8), nn.BatchNorm2D(8, device="cpu")]
        outs = [bn(x.to(bn._mean.device)) for bn in layers]
        _close(outs[0].cpu(), outs[1], atol=1e-5, rtol=1e-5)
        for n in ("_mean", "_variance"):
            _close(layers[0].get_buffer(n).cpu(), layers[1].get_buffer(n),
                   atol=1e-6, rtol=1e-5)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _small_conv_net(device):
    from paddle_tpu_torch import nn

    return nn.Sequential(nn.Conv2D(1, 4, 3, padding=1, device=device),
                         nn.ReLU(), nn.MaxPool2D(2, 2), nn.Flatten(),
                         nn.Linear(4 * 14 * 14, 10, device=device))


def test_model_fit_on_the_card_matches_the_cpu(gen):
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.hapi import callbacks as cbks
    from paddle_tpu_torch.io import Subset
    from paddle_tpu_torch.vision.datasets import MNIST

    class Losses(cbks.Callback):
        def __init__(self):
            super().__init__()
            self.values = []

        def on_train_batch_end(self, step, logs=None):
            self.values.append(logs["loss"][0])

    card = _small_conv_net(None)
    cpu = _small_conv_net("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    runs = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for net in (card, cpu):
            model = paddle.Model(net)
            assert model.device == next(net.parameters()).device
            model.prepare(paddle.optimizer.Adam(parameters=net.parameters(),
                                                learning_rate=1e-3),
                          paddle.nn.CrossEntropyLoss(),
                          paddle.metric.Accuracy())
            rec = Losses()
            K.reset_launch_counts()
            np.random.seed(0)
            model.fit(Subset(MNIST(mode="train"), range(512)), batch_size=64,
                      epochs=1, verbose=0, callbacks=[rec])
            runs.append((rec.values, {k: v for k, v in
                                      K.launch_counts().items() if v}))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert runs[0][1] == {"softmax_ce": 8, "softmax_ce_bwd": 8}
    assert runs[1][1] == {}
    np.testing.assert_allclose(runs[0][0], runs[1][0], atol=1e-4, rtol=0)
    for a, b in zip(card.parameters(), cpu.parameters()):
        _close(a.detach().cpu(), b.detach(), atol=1e-4, rtol=1e-4)


class _Flags:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        import os

        import numpy as np

        return (np.full(3, i, np.float32), np.int64(i),
                np.int64(torch.cuda.is_initialized()), np.int64(os.getpid()))


def test_loader_workers_fork_after_cuda_is_initialised(gen):
    import os

    import numpy as np

    from paddle_tpu_torch import io

    torch.ones(1, device="cuda").sum().item()     # CUDA live in the parent
    assert torch.cuda.is_initialized()
    ds = type("Flags", (_Flags, io.Dataset), {})()
    np.random.seed(2)
    want = list(io.DataLoader(ds, batch_size=4, shuffle=True))
    np.random.seed(2)
    got = list(io.DataLoader(ds, batch_size=4, shuffle=True, num_workers=2))
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        assert torch.equal(w[0], g[0]) and torch.equal(w[1], g[1])
    assert {int(f) for b in got for f in b[2]} == {0}
    pids = {int(p) for b in got for p in b[3]}
    assert os.getpid() not in pids and len(pids) == 2


def test_native_batcher_builds_and_serves_a_card_fit(gen):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.io import native_batcher
    from paddle_tpu_torch.vision.datasets import MNIST

    assert native_batcher.supported()
    path = native_batcher._lib_path()
    assert path.exists()
    assert path.parent.parts[-3:] == ("paddle_tpu_torch", "csrc", "build")
    net = _small_conv_net(None)
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.SGD(parameters=net.parameters(),
                                       learning_rate=0.05),
                  paddle.nn.CrossEntropyLoss())
    native_batcher.reset_batch_count()
    hist = model.fit(MNIST(mode="test"), batch_size=128, epochs=1, verbose=0)
    assert native_batcher.batch_count() == 4
    assert math.isfinite(hist.history["loss"][0][0])


# -- the eager API slice: the port's Tensor through every kernel family ------


def _paddle(*tensors, grad=False):
    """The port's Tensors over ``tensors`` (floating ones requiring grad
    with ``grad``)."""
    import paddle_tpu_torch as T

    return [T.to_tensor(t, stop_gradient=not (grad and t.is_floating_point()))
            for t in tensors]


def test_a_port_tensor_launches_every_kernel_family_and_comes_back_one(gen):
    """Each family's entry point, handed the port's ``Tensor``: the kernel
    launches (its counter moves) and the result is a ``Tensor``; the
    backward kernels launch through ``backward()`` on it."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.kernels.ctc import ctc_lattice
    from paddle_tpu_torch.kernels.rnnt import rnnt_lattice

    bf = torch.bfloat16
    q, k, v = _paddle(*[_rnd(gen, bf, 1, 128, 4, 64) for _ in range(3)],
                      grad=True)
    pq, pool = _paddle(_rnd(gen, bf, 2, 8, 128), _rnd(gen, bf, 9, 2, 8, 16,
                                                       128))
    bt = torch.arange(1, 9, device="cuda", dtype=torch.int32).reshape(2, 4)
    ctx = torch.tensor([17, 64], device="cuda", dtype=torch.int32)
    lp, labels, in_len, lbl_len = _ctc_batch(9, 4, 6, 3, 1)
    blank, emit, tl, ul = _rnnt_batch(3, 9, 7, 2)
    x, w = _paddle(_rnd(gen, bf, 8, 256), _rnd(gen, bf, 256), grad=True)
    ln_x, ln_w, ln_b = _paddle(_rnd(gen, torch.float32, 8, 768),
                               _rnd(gen, torch.float32, 768),
                               _rnd(gen, torch.float32, 768), grad=True)
    logits, y = _paddle(_rnd(gen, bf, 8, 1000),
                        torch.randint(0, 1000, (8,), device="cuda",
                                      generator=gen), grad=True)
    cases = {
        ("flash_attention", "flash_attention_bwd"):
            lambda: flash_attention_fwd(q, k, v, causal=True)[0],
        ("paged_attention",): lambda: paged_attention(
            pq, pool, T.to_tensor(bt), T.to_tensor(ctx)),
        ("rmsnorm", "rmsnorm_bwd"): lambda: rmsnorm(x, w),
        ("layernorm",): lambda: layernorm(ln_x, ln_w, ln_b),
        ("softmax_ce", "softmax_ce_bwd"): lambda: softmax_ce(logits, y),
        ("ctc_alpha", "ctc_beta"): lambda: ctc_lattice(
            *_paddle(lp, grad=True), *_paddle(labels, in_len, lbl_len)),
        ("rnnt_alpha", "rnnt_beta_grad"): lambda: rnnt_lattice(
            *_paddle(blank, emit, grad=True), *_paddle(tl, ul)),
    }
    for names, call in cases.items():
        K.reset_launch_counts()
        out = call()
        assert type(out) is T.Tensor, names
        if len(names) > 1:
            out.float().sum().backward()
        torch.cuda.synchronize()
        counts = K.launch_counts()
        for n in names:
            assert counts[n] >= 1, (n, counts)


def test_to_tensor_with_no_card_and_no_set_device_raises(gen, monkeypatch):
    import paddle_tpu_torch as T
    from paddle_tpu_torch.core import device as D

    monkeypatch.setitem(D._state, "device", None)
    assert T.to_tensor([1.0]).device.type == "cuda"     # the default: here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.to_tensor([1.0])
    T.set_device("cpu")
    assert T.to_tensor([1.0]).device.type == "cpu"


def test_densenet_dygraph_step_on_the_card_matches_the_cpu(gen):
    """A DenseNet-121 step in the dygraph idiom (Tensors in, ``backward``)
    on the card against the same weights on the CPU, f32 with TF32 off:
    loss within 1e-4, every gradient within 5e-2 relative L2 (the
    whole-step limit) or, where f32 itself resolves it worse, within 3x
    the CPU's f32 error against its f64 step (ROADMAP C3: the stem batch
    norm's weight); one softmax-CE forward and backward launch; the loss
    and logits are the port's Tensor."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.vision.models import densenet121

    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = densenet121(num_classes=10, seed=0)
        cpu = densenet121(num_classes=10, device="cpu")
        cpu.set_state_dict(card.state_dict())
        cpu64 = densenet121(num_classes=10, device="cpu")
        cpu64.set_state_dict(card.state_dict())
        cpu64 = cpu64.double()
        g = torch.Generator().manual_seed(1)
        x = torch.randn(4, 3, 64, 64, generator=g)
        y = torch.randint(0, 10, (4, 1), generator=g)
        out = {}
        for name, m in (("card", card), ("cpu", cpu), ("cpu64", cpu64)):
            dev = "cuda" if name == "card" else "cpu"
            K.reset_launch_counts()
            xt = T.to_tensor(x.double() if name == "cpu64" else x, place=dev)
            yt = T.to_tensor(y, place=dev)
            logits = m(xt)
            loss = T.nn.functional.cross_entropy(logits, yt)
            loss.backward()
            torch.cuda.synchronize()
            if name == "card":
                assert type(loss) is T.Tensor and type(logits) is T.Tensor
                launched = {k: c for k, c in K.launch_counts().items() if c}
                assert launched == {"softmax_ce": 1, "softmax_ce_bwd": 1}
            out[name] = (loss.item(), {n: p.grad.detach().cpu()
                                       for n, p in m.named_parameters()})
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    assert abs(out["card"][0] - out["cpu"][0]) <= 1e-4

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    for n, want in out["cpu"][1].items():
        limit = max(5e-2, 3 * rel(want, out["cpu64"][1][n]))
        assert rel(out["card"][1][n], want) <= limit, n


# -- static-graph slice: the registered ops inside compiled / exported
#    programs --------------------------------------------------------------

def _compiled_kernels():
    """LayerNorm and flash attention through their autograd Functions, as a
    compiled program runs them (the registered ops)."""
    from paddle_tpu_torch.kernels.flash_attention import (
        FlashAttentionFunction)
    from paddle_tpu_torch.kernels.layernorm import LayerNormFunction

    def f(x, w, b, q, k, v):
        h, _, _ = LayerNormFunction.apply(x, w, b, 1e-5)
        out, lse = FlashAttentionFunction.apply(q, k, v, False, None, 0.0, 0,
                                                None)
        return h, out, lse
    return f


def _compiled_inputs(gen, dtype):
    x = torch.randn(256, 768, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(768, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(768, device="cuda", generator=gen)).to(dtype)
    q, k, v = (torch.randn(2, 128, 12, 64, device="cuda", generator=gen
                           ).to(dtype) for _ in range(3))
    return x, w, b, q, k, v


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["compile", "export"])
def test_registered_ops_launch_the_kernels_in_programs(gen, dtype, route):
    """Under torch.compile (inductor) and after torch.export the kernels
    launch (the counters move inside the ops) and match the plain versions
    (LayerNorm within one bf16 step of its scale, flash at the dense
    tolerances)."""
    args = _compiled_inputs(gen, dtype)
    f = _compiled_kernels()
    if route == "compile":
        prog = torch.compile(f, fullgraph=True, dynamic=False)
    else:
        class M(torch.nn.Module):
            def forward(self, *a):
                return f(*a)

        prog = torch.export.export(M(), args, strict=False).module()
    with torch.no_grad():
        K.reset_launch_counts()
        h, out, lse = prog(*args)
        torch.cuda.synchronize()
    counts = K.launch_counts()
    design = "sm90" if dtype == torch.bfloat16 else "mma"
    assert counts["layernorm"] == 1 and counts["flash_attention"] == 1
    assert counts[f"flash_attention_{design}"] == 1
    x, w, b, q, k, v = args
    p_h, _, _ = layer_norm_plain(x, w, b, 1e-5)
    _close(h, p_h, **_ln_tol(h, p_h))
    p_out, p_lse = flash_attention_plain(q, k, v)
    _close(out, p_out, **_tol(dtype))
    _close(lse, p_lse, atol=1e-3, rtol=1e-4)


def test_to_static_ernie_launches_in_its_program(gen):
    """A small ERNIE through jit.to_static (inductor) on the card: the
    compiled forward's launches are the eager forward's, its f32 logits
    (TF32 off) the eager ones within 1e-4 relative L2."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                         ernie_tiny)

    m = ErnieForSequenceClassification(
        ernie_tiny(vocab=97, hidden=128, layers=2, heads=2, inter=256,
                   seq=64), device="cuda", seed=0).eval()
    ids = torch.randint(0, 97, (4, 64), device="cuda", generator=gen)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = m(ids)
            sf = jit.StaticFunction(m)
            sf(ids)
            K.reset_launch_counts()
            got = sf(ids)
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    counts = K.launch_counts()
    assert counts["layernorm"] == 5 and counts["flash_attention"] == 2
    assert ((got - want).norm() / want.norm()).item() <= 1e-4


def _surface_cases():
    from tools.nn_surface_cases import cases

    return cases()


@pytest.mark.parametrize("index", range(len(_surface_cases())))
def test_nn_surface_case_on_the_card_matches_the_cpu(gen, index):
    from tools.nn_surface_cases import run

    case = _surface_cases()[index]
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = run(torch, case, "cuda")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    want = run(torch, case, "cpu")
    assert len(got) == len(want), case[1]
    for a, b in zip(got, want):
        torch.testing.assert_close(torch.from_numpy(a), torch.from_numpy(b),
                                   rtol=1e-4, atol=1e-5, msg=case[1])


@pytest.mark.parametrize("name,heads,size", [("shufflenet_v2_x1_0", 1, 224),
                                             ("googlenet", 3, 224)])
def test_vision_o1_step_launches_one_softmax_ce_a_head(gen, name, heads,
                                                       size):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.vision import models

    model = getattr(models, name)(generator=gen)
    x = torch.randn(4, 3, size, size, device="cuda", generator=gen)
    y = torch.randint(0, 1000, (4, 1), device="cuda", generator=gen)
    K.reset_launch_counts()
    with amp.auto_cast(level="O1"):
        out = model(x)
        if heads == 1:
            loss = cross_entropy(out, y)
        else:
            loss = cross_entropy(out[0], y) + 0.3 * (
                cross_entropy(out[1], y) + cross_entropy(out[2], y))
    loss.backward()
    torch.cuda.synchronize()
    launched = {k: v for k, v in K.launch_counts().items() if v}
    assert launched == {"softmax_ce": heads, "softmax_ce_bwd": heads}
    assert math.isfinite(loss.item())
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


# -- every kernel a registered op (F6 repaired): each Function inside a
#    to_static program on the card, forward and backward, against its
#    eager launches -----------------------------------------------------------

def _program_and_eager(f, n):
    """A program computing ``f``'s outputs and the gradients of
    ``sum(out0 * cot)`` w.r.t. its first ``n`` arguments
    (``torch.func.grad``; the inputs aliased, see ``static._GradNode``),
    and the same through eager ``backward()``."""
    def program(*a):
        *xs, cot = a

        def loss(*d):
            outs = f(*(t.view_as(t) for t in d), *xs[n:])
            return (outs[0].float() * cot).sum(), outs

        grads, outs = torch.func.grad(loss, argnums=tuple(range(n)),
                                      has_aux=True)(*xs[:n])
        return (*outs, *grads)

    def eager(*a):
        *xs, cot = a
        leaves = [x.detach().requires_grad_() for x in xs[:n]]
        outs = f(*leaves, *xs[n:])
        (outs[0].float() * cot).sum().backward()
        return (*(o.detach() for o in outs), *(x.grad for x in leaves))
    return program, eager


def _op_case(gen, name):
    """(f, differentiable arguments, arguments with the cotangent last,
    the launches one program run makes)."""
    from paddle_tpu_torch.kernels import ctc as C
    from paddle_tpu_torch.kernels import rnnt as R
    from paddle_tpu_torch.kernels.flash_attention import flash_attn_varlen

    bf = torch.bfloat16
    q, k, v = (_rnd(gen, bf, 2, 128, 8, 64) for _ in range(3))
    cot = torch.randn(2, 128, 8, 64, device="cuda", generator=gen)
    if name == "flash":
        return (lambda a, b, c: flash_attention_fwd(a, b, c, causal=True), 3,
                (q, k, v, cot),
                {"flash_attention": 1, "flash_attention_bwd": 1})
    if name == "flash_mask":
        m = torch.rand(2, 1, 128, 128, device="cuda", generator=gen) > 0.2
        return (lambda a, b, c: flash_attention_fwd(a, b, c, mask=m), 3,
                (q, k, v, cot),
                {"flash_attention_mask": 1, "flash_attention_bwd_mask": 1})
    if name == "flash_dropout_seed":
        return (lambda a, b, c: flash_attention_fwd(a, b, c, dropout_p=0.1,
                                                    seed=99), 3,
                (q, k, v, cot), {"flash_attention_dropout": 1,
                                 "flash_attention_bwd_dropout": 1})
    if name == "varlen":
        cu = torch.tensor([0, 100, 117, 256], device="cuda",
                          dtype=torch.int32)
        vq, vk, vv = (_rnd(gen, bf, 256, 8, 64) for _ in range(3))
        return (lambda a, b, c, u: flash_attn_varlen(
            a, b, c, u, u, causal=True, max_seqlen_q=139, max_seqlen_k=139),
            3, (vq, vk, vv, cu,
                torch.randn(256, 8, 64, device="cuda", generator=gen)),
            {"flash_attention_varlen": 1, "flash_attention_bwd_varlen": 1})
    if name == "rmsnorm":
        return (lambda a, w: (rmsnorm(a, w, 1e-5),), 2,
                (_rnd(gen, bf, 64, 4096), _rnd(gen, bf, 4096),
                 torch.randn(64, 4096, device="cuda", generator=gen)),
                {"rmsnorm": 1, "rmsnorm_bwd": 1})
    if name == "softmax_ce":
        labels = torch.randint(0, 32000, (64,), device="cuda", generator=gen)
        return (lambda a, y: (softmax_ce(a, y),), 1,
                (_rnd(gen, bf, 64, 32000), labels,
                 torch.randn(64, device="cuda", generator=gen)),
                {"softmax_ce": 1, "softmax_ce_bwd": 1})
    if name == "ctc":
        lp = torch.log_softmax(torch.randn(100, 4, 32, device="cuda",
                                           generator=gen), -1)
        lbl = torch.randint(1, 32, (4, 12), device="cuda", generator=gen)
        lens = (torch.tensor([100, 90, 80, 70], device="cuda"),
                torch.tensor([12, 10, 7, 12], device="cuda"))
        return (lambda a, *r: (C.ctc_lattice(a, *r),), 1,
                (lp, lbl, *lens, torch.randn(4, device="cuda",
                                             generator=gen)),
                {"ctc_alpha": 1, "ctc_beta": 1})
    assert name == "rnnt"
    blank = torch.log_softmax(torch.randn(4, 50, 9, device="cuda",
                                          generator=gen), -1)
    emit = torch.log_softmax(torch.randn(4, 50, 9, device="cuda",
                                         generator=gen), -1)
    lens = (torch.tensor([50, 40, 45, 30], device="cuda"),
            torch.tensor([8, 5, 8, 2], device="cuda"))
    return (lambda a, b, *r: (R.rnnt_lattice(a, b, *r),), 2,
            (blank, emit, *lens, torch.randn(4, device="cuda",
                                             generator=gen)),
            {"rnnt_alpha": 1, "rnnt_beta_grad": 1})


@pytest.mark.parametrize("name", ["flash", "flash_mask", "flash_dropout_seed",
                                  "varlen", "rmsnorm", "softmax_ce", "ctc",
                                  "rnnt"])
def test_registered_op_in_a_program_equals_its_eager_launch(gen, name):
    """Forward and backward of each kernel family inside a to_static
    (aot_eager) program: the counters move inside the ops, and every
    output and gradient equals the eager launches' bit for bit (the
    kernels are deterministic: no atomics, fixed-order sums)."""
    from paddle_tpu_torch import jit

    f, n, args, counts = _op_case(gen, name)
    program, eager = _program_and_eager(f, n)
    compiled = jit.to_static(program, backend="aot_eager")
    K.reset_launch_counts()
    got = compiled(*args)
    torch.cuda.synchronize()
    moved = {k: K.launch_counts()[k] for k in counts}
    want = eager(*args)
    torch.cuda.synchronize()
    assert moved == counts
    for a, b in zip(got, want):
        assert torch.equal(torch.Tensor.detach(a), b)


def test_registered_paged_attention_in_a_program_equals_its_launch(gen):
    from paddle_tpu_torch import jit

    pool = _rnd(gen, torch.bfloat16, 4 * 64 + 1, 2, 32, 16, 128)
    q = _rnd(gen, torch.bfloat16, 4, 32, 128)
    bt = (torch.randperm(256, device="cuda", generator=gen) + 1).reshape(
        4, 64).to(torch.int32)
    ctx = torch.tensor([1, 17, 1000, 513], device="cuda", dtype=torch.int32)
    compiled = jit.to_static(paged_attention, backend="aot_eager")
    K.reset_launch_counts()
    got = compiled(q, pool, bt, ctx)
    torch.cuda.synchronize()
    assert K.launch_counts()["paged_attention"] == 1
    assert torch.equal(got, paged_attention(q, pool, bt, ctx))


def test_regression_f6_compiled_dropout_reads_its_seed_on_the_card(gen):
    """F6: a compiled program with flash dropout draws its seed on the card
    each call (two calls drop different masks) and the kernels read it
    there; an explicit seed gives the eager mask bit for bit."""
    from paddle_tpu_torch import jit

    q = _rnd(gen, torch.bfloat16, 2, 256, 8, 64)
    unseeded = jit.to_static(
        lambda a: flash_attention_fwd(a, a, a, dropout_p=0.2)[0],
        backend="aot_eager")
    a, b = unseeded(q), unseeded(q)
    assert not torch.equal(a, b)
    seeded = jit.to_static(
        lambda a: flash_attention_fwd(a, a, a, dropout_p=0.2, seed=5)[0],
        backend="aot_eager")
    assert torch.equal(seeded(q),
                       flash_attention_fwd(q, q, q, dropout_p=0.2, seed=5)[0])


def test_regression_f6_llama_compiles_exports_and_differentiates(gen, tmp_path):
    """F6: a small bf16 Llama through to_static (inductor), jit.save /
    jit.load and a static program's gradients on the card, every kernel
    launched as an op (2 L + 1 RMSNorm and L flash a forward; the
    backward kernels in the gradient program), the logits within 3x eager
    bf16's error against f32 and the gradients within 5e-2 relative L2 of
    eager autograd's."""
    from paddle_tpu_torch import jit, static
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.nn.functional import cross_entropy

    cfg = llama_tiny(vocab=512, hidden=256, layers=2, heads=4, kv_heads=4,
                     inter=512, seq=256)
    m32 = LlamaForCausalLM(cfg, device="cuda", generator=gen).eval()
    m16 = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16).eval()
    m16.set_state_dict(m32.state_dict())
    ids = torch.randint(0, 512, (2, 128), device="cuda", generator=gen)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = m32(ids).float()
            ref = ((m16(ids).float() - want).norm() / want.norm()).item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    jit.save(m16, str(tmp_path / "llama"),
             input_spec=[([None, None], "int64")])
    for fn in (jit.StaticFunction(m16), jit.load(str(tmp_path / "llama"))):
        with torch.no_grad():
            K.reset_launch_counts()
            out = fn(ids).float()
            torch.cuda.synchronize()
        counts = K.launch_counts()
        assert counts["rmsnorm"] == 5 and counts["flash_attention"] == 2
        assert ((out - want).norm() / want.norm()).item() <= 3 * ref

    def loss_of(logits, tok):
        return cross_entropy(logits[:, :-1].reshape([-1, 512]),
                             tok[:, 1:].reshape([-1]))

    params = list(m16.parameters())
    loss_of(m16(ids), ids).backward()
    eager = [p.grad.float().clone() for p in params]
    for p in params:
        p.grad = None
    main = static.Program()
    with static.program_guard(main):
        tok = static.data("ids", [None, 128], "int64")
        grads = static.gradients([loss_of(m16(tok), tok)], params)
    K.reset_launch_counts()
    outs = static.Executor().run(main, feed={"ids": ids}, fetch_list=grads,
                                 return_numpy=False)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    for k in ("rmsnorm_bwd", "flash_attention_bwd", "softmax_ce_bwd"):
        assert counts[k] > 0, k
    for g, e in zip(outs, eager):
        assert ((g.float() - e).norm() / e.norm()).item() <= 5e-2
