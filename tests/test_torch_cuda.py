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
"""
import pytest
import torch

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention_cuda, flash_attention_fwd, flash_attention_plain)
from paddle_tpu_torch.kernels.paged_attention import (
    paged_attention, paged_attention_cuda, paged_attention_plain)
from paddle_tpu_torch.kernels.rmsnorm import (
    rmsnorm, rmsnorm_cuda, rmsnorm_plain)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


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
        "flash_attention": 1, "paged_attention": 1, "rmsnorm": 1}


def test_wrappers_raise_on_what_the_kernel_does_not_take(gen):
    q = _rnd(gen, torch.float16, 1, 9, 4, 64)
    with pytest.raises(TypeError):                 # no fp16 kernel
        flash_attention_fwd(q, q, q)
    q = _rnd(gen, torch.float32, 1, 9, 4, 96)
    with pytest.raises(ValueError):                # head_dim 96
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
