"""``ops/norms.py`` on the CPU: RMSNorm and LayerNorm keep their plain code,
with the values and gradients they had before the card's norm kernel came,
on CPU tensors, in fp32 and under autograd; the rule that sends a card
tensor to the kernel (bf16 rows of a width it holds, contiguous, aligned,
weights it reads as they are, nothing under autograd); the counters
``norm.kernel_rows`` / ``norm.plain_rows``, which count rows of card tensors
only while a profiler records; and the kernel's plan per width. The kernel
itself runs on the card: tests/test_torch_norm_kernel.py."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from llava_reward_torch.ops import norms
from llava_reward_torch.utils import profiling

EPS = 1e-5


def _seed_rms_norm(x, weight, eps):
    """ops/norms.rms_norm as it was before the kernel, the reference."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(var + eps))
    return weight * xf.to(dtype)


def _seed_layer_norm(x, weight, bias, eps):
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    xf = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    out = xf * weight.float() + bias.float()
    return out.to(dtype)


def _inputs(shape, dtype, wdtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(*shape, generator=g)).to(dtype)
    H = shape[-1]
    w = (1 + 0.5 * torch.randn(H, generator=g)).to(wdtype)
    b = (0.1 * torch.randn(H, generator=g)).to(wdtype)
    return x, w, b


DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.float32), (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("dtype,wdtype", DTYPES, ids=["bf16", "bf16_w32", "f32", "f32_wbf16"])
@pytest.mark.parametrize("shape", [(7, 64), (2, 5, 1024), (3, 136), (1, 1280)])
def test_cpu_tensors_keep_the_plain_values(dtype, wdtype, shape):
    x, w, b = _inputs(shape, dtype, wdtype)
    got = norms.rms_norm(x, w, EPS)
    want = _seed_rms_norm(x, w, EPS)
    assert got.dtype == want.dtype and torch.equal(got, want)
    got = norms.layer_norm(x, w, b, EPS)
    want = _seed_layer_norm(x, w, b, EPS)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_autograd_keeps_the_plain_gradients(dtype):
    x, w, b = _inputs((4, 3, 64), dtype, torch.float32, seed=1)
    grads = []
    for rms, ln in ((norms.rms_norm, norms.layer_norm), (_seed_rms_norm, _seed_layer_norm)):
        xs, ws, bs = (t.detach().clone().requires_grad_() for t in (x, w, b))
        loss = (rms(xs, ws, EPS).float() ** 2).sum() + (ln(xs, ws, bs, EPS).float() ** 3).sum()
        loss.backward()
        grads.append([xs.grad, ws.grad, bs.grad])
    for g, want in zip(*grads):
        assert torch.equal(g, want)


def _takes(x, *ws, grad=True):
    with torch.set_grad_enabled(grad):
        return norms._kernel_takes(x, *ws)


def test_the_kernel_takes_bf16_rows_it_holds_and_nothing_under_autograd():
    bf, f32 = torch.bfloat16, torch.float32
    x = torch.zeros(6, 1024, dtype=bf)
    w, b = torch.ones(1024, dtype=bf), torch.zeros(1024, dtype=f32)
    for H in (16, 1024, 1280, 1040, 3072, 3584, 5120):
        assert _takes(torch.zeros(2, 3, H, dtype=bf), torch.ones(H, dtype=bf)), H
    # LayerNorm: the vision towers' widths, up to 2048
    for H in (16, 1024, 1280, 2048):
        assert _takes(torch.zeros(2, H, dtype=bf), torch.ones(H, dtype=bf),
                      torch.zeros(H, dtype=bf)), H
    for H in (2064, 3072, 5120):
        assert not _takes(torch.zeros(2, H, dtype=bf), torch.ones(H, dtype=bf),
                          torch.zeros(H, dtype=bf)), H
    assert _takes(x, w, b) and _takes(x, w.float(), b.to(bf))
    assert not _takes(x, w.float())  # an f32 RMSNorm weight: the product is f32
    assert not _takes(x.float(), w)  # fp32 rows
    assert not _takes(x.half(), w)
    assert not _takes(torch.zeros(6, 136, dtype=bf), torch.ones(136, dtype=bf))  # not 16 k
    assert not _takes(torch.zeros(6, 5376, dtype=bf), torch.ones(5376, dtype=bf))  # too wide
    assert not _takes(torch.zeros(1024, 6, dtype=bf).t(), w)  # not contiguous
    assert not _takes(torch.zeros(6 * 1024 + 1, dtype=bf)[1:].view(6, 1024), w)  # 2-byte offset
    assert not _takes(x, w.half())
    assert not _takes(x, torch.ones(2, 1024, dtype=bf)[:, 0])  # a strided weight
    assert not _takes(x, torch.ones(512, dtype=bf))
    assert not _takes(x, w, torch.zeros(1024, dtype=torch.float64))
    wg = w.clone().requires_grad_()
    assert not _takes(x, wg) and not _takes(x.requires_grad_(), w)
    assert _takes(x, wg, grad=False)  # under no_grad nothing is recorded
    assert not _takes(torch.zeros((), dtype=bf))


class _Launches:
    """A stand-in for the kernel's launch, on the CPU: the plain values, and
    the names the wrapper launched."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, x, weight, bias, eps):
        self.calls.append(name)
        if bias is None:
            return norms.rms_norm_plain(x, weight, eps)
        return norms.layer_norm_plain(x, weight, bias, eps)


@pytest.fixture
def as_on_card(monkeypatch):
    launches = _Launches()
    monkeypatch.setattr(norms, "on_card", lambda x: True)
    monkeypatch.setattr(norms, "_launch", launches)
    return launches


def test_card_rows_are_counted_by_route_only_while_a_profiler_records(as_on_card):
    bf = torch.bfloat16
    x, w, b = _inputs((2, 5, 64), bf, bf)
    with profile(activities=[ProfilerActivity.CPU]):
        norms.rms_norm(x, w, EPS)  # 10 rows, the kernel
        norms.layer_norm(x[0], w, b, EPS)  # 5 rows, the kernel
        norms.rms_norm(x.float(), w, EPS)  # 10 rows, plain: fp32
        norms.layer_norm(x.transpose(0, 1), w, b, EPS)  # 10 rows, plain: not contiguous
        norms.rms_norm(x, w.float().requires_grad_(), EPS)  # 10 rows, plain: autograd
    counts = profiling.session().counts
    assert counts == {"norm.kernel_rows": 15, "norm.plain_rows": 30}
    session = profiling.session()
    norms.rms_norm(x, w, EPS)
    norms.rms_norm(x.float(), w, EPS)
    assert profiling.session() is session and session.counts == counts


def test_the_kernel_is_asked_for_the_plain_result_dtype(as_on_card):
    """The kernel stores bf16: it takes the norms whose plain result is bf16,
    and an RMSNorm with an f32 weight, whose product the plain code promotes
    to f32, keeps the plain code."""
    bf = torch.bfloat16
    x, w, b = _inputs((3, 64), bf, bf)
    assert norms.rms_norm(x, w, EPS).dtype == bf
    assert norms.rms_norm(x, w.float(), EPS).dtype == torch.float32  # the product promotes
    assert norms.layer_norm(x, w.float(), b.float(), EPS).dtype == bf
    assert as_on_card.calls == ["rms_norm", "layer_norm"]


# the widths of the models the repository runs: CLIP, Qwen2.5-VL's tower,
# Phi-3, Qwen2.5-VL's decoder, LLaVA-NeXT-13B
PLANS = {1024: (4, 7), 1280: (5, 7), 3072: (12, 4), 3584: (14, 4), 5120: (20, 3)}


@pytest.mark.parametrize("H", sorted(PLANS))
def test_norm_plan_at_the_model_widths(H):
    for ln in (False, True) if H <= norms.LN_MAX_WIDTH else (False,):
        p = norms.norm_plan(H, ln)
        assert (p.nv, p.rows, p.stages) == (*PLANS[H], 2)
        assert p.smem == 128 + 4 * p.rows * H + 4 * p.rows * H + 4 * H * (2 if ln else 1)


def test_norm_plan_fits_a_block_at_every_width_it_takes():
    for H in range(16, 5121, 16):
        for ln in (False, True) if H <= norms.LN_MAX_WIDTH else (False,):
            p = norms.norm_plan(H, ln)
            assert 256 * p.nv >= H and p.smem <= 232448, (H, ln)
            assert H == 256 * p.nv or p.nv != 5  # 5 chunks a lane: whole lanes only
            assert not ln or p.nv <= 8  # LayerNorm's ladder stops at 8 chunks
    for H in (136, 5376, 0):
        with pytest.raises(ValueError, match="row width"):
            norms.norm_plan(H, False)
    with pytest.raises(ValueError, match="LayerNorm"):
        norms.norm_plan(3072, True)
