"""byteps_tpu_torch's CUDA kernels on the card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have no
CPU mode).  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from byteps_tpu_torch.ops import flash_attention as fa
from byteps_tpu_torch.ops.compressor import bitpack as bp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkvdo(device, bh, s, d, dtype):
    gen = torch.Generator(device=device).manual_seed(0)
    return [torch.randn(bh, s, d, generator=gen, device=device).to(dtype)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
def test_kernels_match_plain(cuda_device, causal, d, dtype, tol):
    """Each kernel against its plain version run in float32 on the same
    (dtype-rounded) inputs; the float32 kernels run one CTA a tile up to
    D = 128 and clusters of two at 256.  Tolerance relative to the
    reference's max: the float32 kernels differ by summation order and
    their 3xTF32 products (about 22 significant bits; the recipe's CPU
    emulation reads at most 0.22 of this tolerance at these shapes,
    tests/test_torch_port_flash_f32tc.py); a bf16 output also rounds once
    at 2^-8 relative."""
    q, k, v, do = _qkvdo(cuda_device, 4, 256, d, dtype)
    f = [t.float() for t in (q, k, v, do)]
    scale = d ** -0.5
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    o_p, lse_p = fa.flash_fwd_plain(*f[:3], causal, scale)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal, scale)
    dq_p, delta_p = fa.flash_bwd_dq_plain(*f[:3], o.float(), lse, f[3],
                                          causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(*f[:3], f[3], lse, delta, causal,
                                        scale)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
        "flash_fwd_str": 0, "flash_bwd_dq_str": 0, "flash_bwd_dkv_str": 0}
    for name, got, ref, t in (("o", o, o_p, tol), ("lse", lse, lse_p, 1e-6),
                              ("dq", dq, dq_p, tol),
                              ("delta", delta, delta_p, 1e-5),
                              ("dk", dk, dk_p, tol), ("dv", dv, dv_p, tol)):
        err = float((got.float() - ref).abs().max())
        top = float(ref.abs().max())
        assert err <= t * top, f"{name}: max err {err} vs max {top}"


@pytest.mark.parametrize("d", [64, 256])
def test_f32_backward_repeat_is_bit_identical(cuda_device, monkeypatch, d):
    """The float32 backward at D = 64 (one CTA a tile) and 256 (clusters of
    two) takes its sums in a fixed order with no atomics: two calls of each
    of its four kernels give the same bits, causal and not (3 splits, the
    last ragged).  With one split the streaming pair gives the resident
    pair's bits: delta is summed in the same order, and the one partial
    of each output is added to zero and scaled as the resident kernels
    scale it."""
    q, k, v, do = _qkvdo(cuda_device, 3, 320, d, torch.float32)
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, True, scale)

    def backward(causal, streaming):
        dq_fn, dkv_fn = ((fa.flash_bwd_dq_str, fa.flash_bwd_dkv_str)
                         if streaming else (fa.flash_bwd_dq, fa.flash_bwd_dkv))
        dq, delta = dq_fn(q, k, v, o, lse, do, causal, scale)
        return (dq, delta, *dkv_fn(q, k, v, do, lse, delta, causal, scale))

    for causal in (False, True):
        monkeypatch.setattr(fa, "_split_len", lambda s: 128)
        runs = [(*backward(causal, False), *backward(causal, True))
                for _ in range(2)]
        monkeypatch.setattr(fa, "_split_len", lambda s: s)
        one, resident = backward(causal, True), runs[0][:4]
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(*runs)):
            assert torch.equal(a, b), (causal, i)
        for i, (a, b) in enumerate(zip(one, resident)):
            assert torch.equal(a, b), (causal, "one split", i)


def test_f32_backward_refuses_misaligned(cuda_device):
    """The float32 backward copies q, k, v and dO in 16-byte pieces at every
    head dim: a contiguous view that starts 4 bytes into its storage is
    refused by both families (D = 64, one CTA, and 256, a cluster), not
    read wrongly."""
    for d in (64, 256):
        flat = torch.zeros(2 * 128 * d + 1, device=cuda_device)
        q = flat[1:].view(2, 128, d)
        assert q.is_contiguous() and q.data_ptr() % 16
        ok = torch.zeros(2, 128, d, device=cuda_device)
        rows = torch.zeros(2, 128, device=cuda_device)
        with pytest.raises(RuntimeError, match="misaligned"):
            fa.flash_bwd_dq(q, ok, ok, ok, rows, ok, True, 0.125)
        with pytest.raises(RuntimeError, match="misaligned"):
            fa.flash_bwd_dkv(ok, ok, ok, q, rows, rows, True, 0.125)
        with pytest.raises(RuntimeError, match="misaligned"):
            fa.flash_bwd_dq_str(ok, ok, q, ok, rows, ok, False, 0.125)
        with pytest.raises(RuntimeError, match="misaligned"):
            fa.flash_bwd_dkv_str(ok, q, ok, ok, rows, rows, False, 0.125)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_f32_forward_holds_the_gates(cuda_device, monkeypatch, causal, d):
    """The float32 forward on the tensor cores (one CTA a tile up to
    D = 128, a cluster of two at 256) against the plain versions,
    elementwise under chip_smoke.py's float32 gates: O within 1e-4 |plain|
    + 1e-5, LSE within 1e-5 |plain| + 1e-6, resident and streaming (3
    splits, the last ragged), one launch counted a call."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 128)
    q, k, v, _ = _qkvdo(cuda_device, 4, 320, d, torch.float32)
    scale = d ** -0.5
    for fwd, plain, name in ((fa.flash_fwd, fa.flash_fwd_plain, "flash_fwd"),
                             (fa.flash_fwd_str, fa.flash_fwd_str_plain,
                              "flash_fwd_str")):
        before = fa.launches[name]
        o, lse = fwd(q, k, v, causal, scale)
        o_p, lse_p = plain(q, k, v, causal, scale)
        torch.cuda.synchronize()
        assert fa.launches[name] - before == 1
        worst = {"o": _worst(o, o_p, (1e-4, 1e-5)),
                 "lse": _worst(lse, lse_p, ROWS_GATE)}
        assert all(w <= 1.0 for w in worst.values()), (name, worst)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_f32_forward_repeat_is_bit_identical(cuda_device, monkeypatch, d):
    """The float32 forward takes its sums in a fixed order with no atomics:
    two calls of each family give the same bits, causal and not (3 splits,
    the last ragged).  With one split the streaming kernel gives the
    resident kernel's bits (the merge weighs the one partial by exp(0))."""
    q, k, v, _ = _qkvdo(cuda_device, 3, 320, d, torch.float32)
    scale = d ** -0.5
    for causal in (False, True):
        monkeypatch.setattr(fa, "_split_len", lambda s: 128)
        runs = [(*fa.flash_fwd(q, k, v, causal, scale),
                 *fa.flash_fwd_str(q, k, v, causal, scale))
                for _ in range(2)]
        monkeypatch.setattr(fa, "_split_len", lambda s: s)
        one = fa.flash_fwd_str(q, k, v, causal, scale)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(*runs)):
            assert torch.equal(a, b), (causal, i)
        assert torch.equal(one[0], runs[0][0]), causal
        assert torch.equal(one[1], runs[0][1]), causal


def test_f32_forward_refuses_misaligned(cuda_device):
    """The float32 forward copies q, k and v in 16-byte pieces at every
    head dim: a contiguous view that starts 4 bytes into its storage is
    refused by both families (D = 64, one CTA, and 256, a cluster), not
    read wrongly."""
    for d in (64, 256):
        flat = torch.zeros(2 * 128 * d + 1, device=cuda_device)
        q = flat[1:].view(2, 128, d)
        assert q.is_contiguous() and q.data_ptr() % 16
        ok = torch.zeros(2, 128, d, device=cuda_device)
        for args in ((q, ok, ok), (ok, q, ok), (ok, ok, q)):
            with pytest.raises(RuntimeError, match="misaligned"):
                fa.flash_fwd(*args, True, 0.125)
            with pytest.raises(RuntimeError, match="misaligned"):
                fa.flash_fwd_str(*args, False, 0.125)


def test_autograd_block_hints(cuda_device):
    """The autograd op with block_q != block_k gives the plain gradients."""
    q, k, v, do = _qkvdo(cuda_device, 2, 256, 64, torch.float32)
    for t in (q, k, v):
        t.requires_grad_()
    out = fa.flash_attention(q, k, v, True, None, 64, 128)
    grads = torch.autograd.grad(out, (q, k, v), do)
    with torch.no_grad():
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, True, 0.125)
        dq_p, delta = fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, True,
                                            0.125)
        dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, True,
                                            0.125)
    torch.testing.assert_close(out, o_p, atol=2e-5, rtol=1e-4)
    for got, ref in zip(grads, (dq_p, dk_p, dv_p)):
        assert float((got - ref).abs().max()) <= 1e-4 * float(
            ref.abs().max())


def test_autograd_op_takes_strided_views(cuda_device):
    """At batch 1 a model without RoPE folds its [1, S, H, D] -> [1, H, S,
    D] heads into a non-contiguous [H, S, D] view; the autograd op makes
    it contiguous before the kernels, which refuse strided tensors."""
    from byteps_tpu_torch.models.transformer import (dense_attention,
                                                     flash_attention_fn)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(1, 256, 4, 64, generator=gen,
                    device=cuda_device).transpose(1, 2)
    assert not x.reshape(4, 256, 64).is_contiguous()
    out = flash_attention_fn(x, x, x, True)
    torch.testing.assert_close(out, dense_attention(x, x, x, True),
                               atol=2e-5, rtol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(2, 128, 64, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_fwd(q, q, q, True, 0.125)
    q = torch.zeros(2, 128, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, q, q, True, 0.125)
    q = torch.zeros(2, 96, 64, device=cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_fwd(q, q, q, True, 0.125)
    q = torch.zeros(2, 64, 128, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q, q, q, True, 0.125)


def test_tiny_train_step_launches(cuda_device):
    """One train step of the tiny transformer (2 layers, remat) launches
    the forward kernel twice per layer and each backward kernel once."""
    from byteps_tpu_torch import DistributedOptimizer, build_train_step
    from byteps_tpu_torch.common.tree import tree_leaves
    from byteps_tpu_torch.models import transformer as tfm
    cfg = tfm.get_config("tiny", attn_impl="flash")
    gen = torch.Generator().manual_seed(0)
    params = tfm.init_params(gen, cfg)
    batch = tfm.synthetic_batch(gen, 2, 128, cfg)
    opt = DistributedOptimizer(torch.optim.AdamW(tree_leaves(params),
                                                 lr=1e-3, weight_decay=1e-4))
    step = build_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt)
    fa.reset_launches()
    loss = float(step(params, batch))
    assert loss == loss and abs(loss) < 1e3
    assert fa.launches == {"flash_fwd": 4, "flash_bwd_dq": 2,
                           "flash_bwd_dkv": 2, "flash_fwd_str": 0,
                           "flash_bwd_dq_str": 0, "flash_bwd_dkv_str": 0}


def _streaming_vs_plain(q, k, v, do, causal, scale):
    """Each streaming kernel and its plain version (float32, on the same
    dtype-rounded inputs): [(name, kernel out, plain out)]."""
    o, lse = fa.flash_fwd_str(q, k, v, causal, scale)
    dq, delta = fa.flash_bwd_dq_str(q, k, v, o, lse, do, causal, scale)
    dk, dv = fa.flash_bwd_dkv_str(q, k, v, do, lse, delta, causal, scale)
    f = [t.float() for t in (q, k, v, do)]
    o_p, lse_p = fa.flash_fwd_str_plain(*f[:3], causal, scale)
    dq_p, delta_p = fa.flash_bwd_dq_str_plain(*f[:3], o.float(), lse, f[3],
                                              causal, scale)
    dk_p, dv_p = fa.flash_bwd_dkv_str_plain(*f[:3], f[3], lse, delta,
                                            causal, scale)
    torch.cuda.synchronize()
    return [("o", o, o_p), ("lse", lse, lse_p), ("dq", dq, dq_p),
            ("delta", delta, delta_p), ("dk", dk, dk_p), ("dv", dv, dv_p)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("s,split", [(512, 128), (320, 128), (256, 4096)])
def test_streaming_kernels_match_plain(cuda_device, monkeypatch, s, split,
                                       causal, d, dtype, tol):
    """The streaming kernels against their plain versions, in 4, 3 (the
    last ragged) and 1 splits; one launch counted per wrapper."""
    monkeypatch.setattr(fa, "_split_len", lambda s: split)
    q, k, v, do = _qkvdo(cuda_device, 4, s, d, dtype)
    before = dict(fa.launches)
    res = _streaming_vs_plain(q, k, v, do, causal, d ** -0.5)
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "flash_fwd_str": 1, "flash_bwd_dq_str": 1, "flash_bwd_dkv_str": 1}
    tols = {"lse": 1e-6, "delta": 1e-5}
    for name, got, ref in res:
        err = float((got.float() - ref).abs().max())
        top = float(ref.abs().max())
        assert err <= tols.get(name, tol) * top, \
            f"{name}: max err {err} vs max {top}"


# chip_smoke.py's elementwise gates: |kernel - plain| <= rtol |plain| + atol,
# one bf16 step for bf16 outputs, 1e-5 for delta (float32 in every dtype).
BF16_GATE = (2 ** -7, 1e-5)
ROWS_GATE = (1e-5, 1e-6)


def _worst(got, want, tol):
    rtol, atol = tol
    return float(((got.float() - want.float()).abs()
                  / (want.float().abs() * rtol + atol)).max())


@pytest.mark.parametrize("family,split", [("resident", None),
                                          ("streaming", 4096),
                                          ("streaming", 1024)])
def test_bf16_backward_long_contraction(cuda_device, monkeypatch, family,
                                        split):
    """bf16 causal at S = 4096 (64 k tiles in one contraction; one split,
    four, or the resident kernels), every element of dQ, dK and dV held to
    one bf16 step of the plain version on the plain forward's O and LSE.
    A tensor-core kernel that rounds P and dS to bf16 once before the
    second products fails this by a factor near 100; the hi/lo pair passes.
    Every diagonal tile is checked elementwise, where the causal mask cuts
    through the MMA fragments."""
    if split is not None:
        monkeypatch.setattr(fa, "_split_len", lambda s: split)
    bh, s, d = 2, 4096, 64
    q, k, v, do = _qkvdo(cuda_device, bh, s, d, torch.bfloat16)
    scale = d ** -0.5
    str_ = family == "streaming"
    dq_fn = fa.flash_bwd_dq_str if str_ else fa.flash_bwd_dq
    dkv_fn = fa.flash_bwd_dkv_str if str_ else fa.flash_bwd_dkv
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, True, scale)
    dq_p, delta_p = fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, True,
                                          scale)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p, True,
                                        scale)
    dq, delta = dq_fn(q, k, v, o_p, lse_p, do, True, scale)
    dk, dv = dkv_fn(q, k, v, do, lse_p, delta_p, True, scale)
    torch.cuda.synchronize()
    worst = {"dq": _worst(dq, dq_p, BF16_GATE),
             "delta": _worst(delta, delta_p, ROWS_GATE),
             "dk": _worst(dk, dk_p, BF16_GATE),
             "dv": _worst(dv, dv_p, BF16_GATE)}
    assert all(w <= 1.0 for w in worst.values()), worst


def test_bf16_backward_refuses_misaligned(cuda_device):
    """The tensor-core kernels copy 16-byte pieces: a contiguous bf16 view
    that starts 2 bytes into its storage is refused, not read wrongly."""
    flat = torch.zeros(2 * 128 * 64 + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    q = flat[1:].view(2, 128, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    rows = torch.zeros(2, 128, device=cuda_device)
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_bwd_dq(q, q, q, q, rows, q, True, 0.125)
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_bwd_dkv_str(q, q, q, q, rows, rows, True, 0.125)


@pytest.mark.parametrize("family,split", [("resident", None),
                                          ("streaming", 4096),
                                          ("streaming", 1024)])
def test_bf16_forward_long_contraction(cuda_device, monkeypatch, family,
                                       split):
    """bf16 causal at S = 4096 (64 k tiles in one contraction; the
    resident kernel, one split or four), every element of O held to one
    bf16 step of the plain version and every LSE to 1e-5.  A tensor-core
    forward that rounds P to bf16 once before P V fails the O gate by a
    factor near 70; the hi/lo pair passes.  Every diagonal tile is checked
    elementwise, where the causal mask cuts through the MMA fragments."""
    if split is not None:
        monkeypatch.setattr(fa, "_split_len", lambda s: split)
    bh, s, d = 2, 4096, 64
    q, k, v, _ = _qkvdo(cuda_device, bh, s, d, torch.bfloat16)
    scale = d ** -0.5
    fwd = fa.flash_fwd_str if family == "streaming" else fa.flash_fwd
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, True, scale)
    o, lse = fwd(q, k, v, True, scale)
    torch.cuda.synchronize()
    worst = {"o": _worst(o, o_p, BF16_GATE),
             "lse": _worst(lse, lse_p, ROWS_GATE)}
    assert all(w <= 1.0 for w in worst.values()), worst


def test_bf16_forward_refuses_misaligned(cuda_device):
    """The tensor-core forward copies q, k and v in 16-byte pieces: a
    contiguous bf16 view that starts 2 bytes into its storage is refused
    by both families, not read wrongly."""
    flat = torch.zeros(2 * 128 * 64 + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    q = flat[1:].view(2, 128, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    ok = torch.zeros(2, 128, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_fwd(q, ok, ok, True, 0.125)
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_fwd_str(ok, ok, q, False, 0.125)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bf16_streaming_forward_repeat_is_bit_identical(cuda_device,
                                                        monkeypatch, d):
    """The tensor-core streaming forward writes its partials with no
    atomics and the merge reads them in split order: two calls over 4
    splits give the same O and LSE bits, causal (with dead pairs) or
    not, and each call is one launch of the wrapper."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 512)
    q, k, v, _ = _qkvdo(cuda_device, 4, 2048, d, torch.bfloat16)
    for causal in (False, True):
        before = fa.launches["flash_fwd_str"]
        first = fa.flash_fwd_str(q, k, v, causal, d ** -0.5)
        second = fa.flash_fwd_str(q, k, v, causal, d ** -0.5)
        torch.cuda.synchronize()
        assert fa.launches["flash_fwd_str"] == before + 2
        assert torch.equal(first[0], second[0]), ("o", causal)
        assert torch.equal(first[1], second[1]), ("lse", causal)


def test_streaming_dead_splits_are_never_read(cuda_device, monkeypatch):
    """Causal, 8 splits of 64 keys: q tile 0 has 7 dead splits.  The
    workspaces come from the caching allocator, here from blocks of their
    sizes just filled with NaN; a merge that read a dead split would
    spread them (or another call's partials) into the result."""
    bh, s, d, split = 2, 512, 64, 64
    monkeypatch.setattr(fa, "_split_len", lambda s: split)
    q, k, v, do = _qkvdo(cuda_device, bh, s, d, torch.float32)
    junk = [torch.full((s // split, bh, s, d), float("nan"),
                       device=cuda_device) for _ in range(3)]
    junk += [torch.full((s // split, bh, s), float("nan"),
                        device=cuda_device) for _ in range(2)]
    del junk
    for name, got, ref in _streaming_vs_plain(q, k, v, do, True,
                                              d ** -0.5):
        assert bool(torch.isfinite(got).all()), name
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (name, err)


def test_streaming_repeat_is_bit_identical(cuda_device, monkeypatch):
    """Fixed-order merges, no atomics: two calls give the same bits."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 256)
    q, k, v, do = _qkvdo(cuda_device, 4, 1024, 64, torch.bfloat16)
    for causal in (False, True):
        first = _streaming_vs_plain(q, k, v, do, causal, 0.125)
        second = _streaming_vs_plain(q, k, v, do, causal, 0.125)
        for (name, a, _), (_, b, _) in zip(first, second):
            assert torch.equal(a, b), name


def test_streaming_autoselect_launches(cuda_device):
    """Past RESIDENT_VMEM_BUDGET (float32, head_dim 128: S > 6144) the
    autograd op takes the streaming kernels, forward and backward, and
    gives the plain gradients."""
    q, k, v, do = _qkvdo(cuda_device, 1, 6208, 128, torch.float32)
    for t in (q, k, v):
        t.requires_grad_()
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, True, None, 64, 64)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert fa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0, "flash_fwd_str": 1,
                           "flash_bwd_dq_str": 1, "flash_bwd_dkv_str": 1}
    with torch.no_grad():
        scale = 128 ** -0.5
        o_p, lse_p = fa.flash_fwd_str_plain(q, k, v, True, scale)
        dq_p, delta = fa.flash_bwd_dq_str_plain(q, k, v, o_p, lse_p, do,
                                                True, scale)
        dk_p, dv_p = fa.flash_bwd_dkv_str_plain(q, k, v, do, lse_p, delta,
                                                True, scale)
    torch.testing.assert_close(out, o_p, atol=2e-5, rtol=1e-4)
    for got, ref in zip(grads, (dq_p, dk_p, dv_p)):
        assert float((got - ref).abs().max()) <= 1e-4 * float(
            ref.abs().max())


def test_tiny_train_step_streaming_launches(cuda_device, monkeypatch):
    """With the resident budget at 0, the tiny transformer's step runs the
    streaming family: 4 forward launches, 2 of each backward kernel."""
    from byteps_tpu_torch import DistributedOptimizer, build_train_step
    from byteps_tpu_torch.common.tree import tree_leaves
    from byteps_tpu_torch.models import transformer as tfm
    monkeypatch.setattr(fa, "RESIDENT_VMEM_BUDGET", 0)
    cfg = tfm.get_config("tiny", attn_impl="flash")
    gen = torch.Generator().manual_seed(0)
    params = tfm.init_params(gen, cfg)
    batch = tfm.synthetic_batch(gen, 2, 128, cfg)
    opt = DistributedOptimizer(torch.optim.AdamW(tree_leaves(params),
                                                 lr=1e-3, weight_decay=1e-4))
    step = build_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt)
    fa.reset_launches()
    loss = float(step(params, batch))
    assert loss == loss and abs(loss) < 1e3
    assert fa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0, "flash_fwd_str": 4,
                           "flash_bwd_dq_str": 2, "flash_bwd_dkv_str": 2}


def _signs_input(n, device):
    """Normal floats with +-0.0, +-inf and NaNs of both signs mixed in."""
    gen = torch.Generator(device=device).manual_seed(n)
    x = torch.randn(n, generator=gen, device=device)
    specials = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                             float("nan"), -float("nan")], device=device)
    at = torch.randint(0, n, (min(n, 64),), generator=gen, device=device)
    x[at] = specials[torch.arange(at.numel(), device=device) % 6]
    return x


@pytest.mark.parametrize("n", [1048576, 845824, 4096 * 33, 5000, 100, 1])
def test_sign_kernels_match_plain(cuda_device, n):
    """Pack words and unpacked signs bit-identical to the plain versions,
    one launch each, on the flagship's bucket sizes and ragged ones."""
    x = _signs_input(n, cuda_device)
    before = dict(bp.launches)
    words = bp.pack_signs(x)
    signs = bp.unpack_signs(words, n)
    torch.cuda.synchronize()
    assert {k: bp.launches[k] - before[k] for k in before} == {
        "sign_pack": 1, "sign_unpack": 1}
    assert words.dtype == torch.int32 and words.shape == (bp.words_len(n),)
    assert torch.equal(words, bp.pack_signs_plain(x))
    assert torch.equal(signs, bp.unpack_signs_plain(words, n))
    assert torch.equal(signs, torch.where(x < 0, -1.0, 1.0))


def test_sign_unpack_rows_in_one_launch(cuda_device):
    n = 4096 * 3 + 11
    words = torch.stack([bp.pack_signs(_signs_input(n + r, cuda_device)[:n])
                         for r in range(4)])
    before = bp.launches["sign_unpack"]
    out = bp.unpack_signs(words, n)
    torch.cuda.synchronize()
    assert bp.launches["sign_unpack"] == before + 1
    assert torch.equal(out, bp.unpack_signs_plain(words, n))
    with pytest.raises(TypeError, match="int32"):
        bp.unpack_signs(words.float(), n)


def test_tiny_compressed_train_step_launches(cuda_device):
    """One train step of the tiny transformer with onebit + EF + Nesterov
    makes 2 packs and 4 unpacks per compressed bucket."""
    from byteps_tpu_torch import DistributedOptimizer, build_train_step
    from byteps_tpu_torch.common.tree import tree_leaves
    from byteps_tpu_torch.models import transformer as tfm
    from byteps_tpu_torch.ops import compressor as C
    cfg = tfm.get_config("tiny", attn_impl="flash")
    gen = torch.Generator().manual_seed(0)
    params = tfm.init_params(gen, cfg)
    batch = tfm.synthetic_batch(gen, 2, 128, cfg)
    comp = C.create({"compressor": "onebit", "ef": "vanilla",
                     "momentum": "nesterov"})
    pb = 64 * 1024
    opt = DistributedOptimizer(
        torch.optim.AdamW(tree_leaves(params), lr=1e-3, weight_decay=1e-4),
        inter_compressor=comp, partition_bytes=pb)
    sizes = C.reduce._bucket_sizes(tree_leaves(params), pb)
    buckets = sum(comp.payload_bytes(n) < 4 * n for n in sizes)
    assert buckets > 1
    step = build_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt)
    bp.reset_launches()
    loss = float(step(params, batch))
    assert loss == loss and abs(loss) < 1e3
    assert bp.launches == {"sign_pack": 2 * buckets,
                           "sign_unpack": 4 * buckets}


# The slice's coverage: every head dim the adapter sends to flash (a
# multiple of 8 up to 256, zero-padded to the next instantiated one),
# float16, and more B*H than one launch takes.
F32_GATE = (1e-4, 1e-5)
F32_O_GATE = (1e-4, 2e-5)
FP16_GATE = (2 ** -10, 1e-5)     # float16's own step, 8x the bf16 gate's
_GATES = {torch.float32: (F32_O_GATE, F32_GATE),
          torch.bfloat16: (BF16_GATE, BF16_GATE),
          torch.float16: (FP16_GATE, FP16_GATE)}


def _spy_plain(monkeypatch):
    """Count calls of every plain version: on CUDA tensors none may run."""
    calls = []
    for name in [n for n in dir(fa) if n.endswith("_plain")]:
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    return calls


def _adapter_vs_plain(b, h, s, d, dtype, streaming, monkeypatch,
                      run_dtype=None):
    """flash_attention_fn forward and backward on the card against the
    plain versions: O against the plain forward, dQ, dK, dV against the
    plain backward on the kernels' own O (and the plain LSE), each
    element held to its gate.  With ``run_dtype`` (a control) the kernels
    run on the inputs rounded to it, their outputs cast back to ``dtype``.
    Returns (worst ratios, launches, plain calls during the kernel run)."""
    from byteps_tpu_torch.models.transformer import flash_attention_fn
    if streaming:
        monkeypatch.setattr(fa, "RESIDENT_VMEM_BUDGET", 0)
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    run = [t.to(run_dtype or dtype).requires_grad_() for t in (q, k, v)]
    calls = _spy_plain(monkeypatch)
    fa.reset_launches()
    out = flash_attention_fn(*run, True)
    grads = torch.autograd.grad(out, run, do.to(run_dtype or dtype))
    out, grads = out.to(dtype), [g.to(dtype) for g in grads]
    torch.cuda.synchronize()
    ran, plain_calls = dict(fa.launches), list(calls)
    scale = d ** -0.5
    fold = [t.detach().reshape(b * h, s, d) for t in (q, k, v, do, out)]
    with torch.no_grad():
        o_p, lse_p = fa.flash_fwd_plain(*fold[:3], True, scale)
        dq_p, delta_p = fa.flash_bwd_dq_plain(*fold[:3], fold[4], lse_p,
                                              fold[3], True, scale)
        dk_p, dv_p = fa.flash_bwd_dkv_plain(*fold[:3], fold[3], lse_p,
                                            delta_p, True, scale)
    o_gate, g_gate = _GATES[dtype]
    worst = {"o": _worst(fold[4], o_p, o_gate)}
    for name, got, want in zip(("dq", "dk", "dv"), grads, (dq_p, dk_p, dv_p)):
        worst[name] = _worst(got.reshape(b * h, s, d), want, g_gate)
    return worst, ran, plain_calls


@pytest.mark.parametrize("family", ["resident", "streaming"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [8, 24, 40, 48, 56, 80, 96, 112, 256])
def test_adapter_runs_every_head_dim_on_the_kernels(cuda_device,
                                                     monkeypatch, d, dtype,
                                                     family):
    """A non-strict flash_attention_fn takes the kernels, forward and
    backward, at every head dim the JAX adapter runs flash at (D zero-padded
    to 16, 32, 64, 128 or 256) and in float32, bf16 and float16; no plain
    version runs, and every element passes the elementwise gates."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 128)
    streaming = family == "streaming"
    worst, ran, plain = _adapter_vs_plain(2, 2, 256, d, dtype, streaming,
                                          monkeypatch)
    on = ("flash_fwd_str", "flash_bwd_dq_str", "flash_bwd_dkv_str")
    off = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    if not streaming:
        on, off = off, on
    assert [ran[n] for n in on] == [1, 1, 1] and not any(ran[n] for n in off)
    assert plain == []
    assert all(w <= 1.0 for w in worst.values()), worst


def test_adapter_takes_more_batch_heads_than_one_launch(cuda_device,
                                                        monkeypatch):
    """B*H = 65,600 (above the grid's 65,535): two launches of each
    kernel, every element within the gates."""
    worst, ran, plain = _adapter_vs_plain(4100, 16, 64, 16, torch.bfloat16,
                                          False, monkeypatch)
    assert ran == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                   "flash_fwd_str": 0, "flash_bwd_dq_str": 0,
                   "flash_bwd_dkv_str": 0}
    assert plain == []
    assert all(w <= 1.0 for w in worst.values()), worst


def test_adapter_refuses_head_dims_above_256(cuda_device, monkeypatch):
    """Head dims above 256 are no longer refused: the adapter at D = 264,
    strict or not, runs the wide kernels (D padded to 384), forward and
    backward, within the bf16 gates."""
    from byteps_tpu_torch.models.transformer import flash_attention_fn
    x = torch.zeros(1, 2, 128, 264, device=cuda_device,
                    dtype=torch.bfloat16)
    for strict in (False, True):
        fa.reset_launches()
        out = flash_attention_fn(x, x, x, True, strict=strict)
        torch.cuda.synchronize()
        assert out.shape == x.shape and fa.launches["flash_fwd"] == 1
        assert fa.instance_launches == {"flash_fwd<bf16,384>": 1}
    worst, ran, plain = _adapter_vs_plain(1, 2, 128, 264, torch.bfloat16,
                                          False, monkeypatch)
    assert plain == [] and [ran[n] for n in ("flash_fwd", "flash_bwd_dq",
                                             "flash_bwd_dkv")] == [1, 1, 1]
    assert all(w <= 1.0 for w in worst.values()), worst


@pytest.mark.parametrize("family", ["resident", "streaming"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [264, 384, 512, 1024])
def test_adapter_runs_wide_head_dims_on_the_kernels(cuda_device,
                                                     monkeypatch, d, dtype,
                                                     family):
    """Head dims above 256 (padded to a multiple of 128, the wide kernels'
    column slices) in float32, bf16 and float16, both families: no plain
    version runs, one launch of each kernel at the padded head dim, and
    every element within the elementwise gates."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 128)
    streaming = family == "streaming"
    worst, ran, plain = _adapter_vs_plain(1, 2, 256, d, dtype, streaming,
                                          monkeypatch)
    names = STREAMING if streaming else RESIDENT
    assert [ran[n] for n in names] == [1, 1, 1] and sum(ran.values()) == 3
    tag = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}[dtype]
    assert fa.instance_launches == {
        f"{n}<{tag},{fa.kernel_head_dim(d)}>": 1 for n in names}
    assert plain == []
    assert all(w <= 1.0 for w in worst.values()), worst


RESIDENT = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
STREAMING = ("flash_fwd_str", "flash_bwd_dq_str", "flash_bwd_dkv_str")


@pytest.mark.parametrize("family", ["resident", "streaming"])
def test_float16_backward_long_contraction(cuda_device, monkeypatch,
                                           family):
    """float16 causal at S = 4096 through the kernels (the streaming ones
    in four splits), dQ, dK, dV and O held to float16's own step; dS
    enters its products scaled, so no float16 value overflows."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 1024)
    worst, ran, plain = _adapter_vs_plain(1, 2, 4096, 64, torch.float16,
                                          family == "streaming", monkeypatch)
    assert plain == [] and sum(ran.values()) == 3
    assert all(w <= 1.0 for w in worst.values()), worst


def test_float16_holds_its_own_step(cuda_device, monkeypatch):
    """float16 through the kernels within one float16 step (2^-10 |plain|
    + 1e-5, 8x the bf16 gate's) at D = 64 and 128, and a control, the same
    inputs rounded to bf16 through the bf16 kernels with the outputs cast
    to float16, missing it in every output: the gate tells float16
    arithmetic from bf16's."""
    for d in (64, 128):
        worst = _adapter_vs_plain(2, 2, 256, d, torch.float16, False,
                                  monkeypatch)[0]
        ctl = _adapter_vs_plain(2, 2, 256, d, torch.float16, False,
                                monkeypatch, run_dtype=torch.bfloat16)[0]
        assert all(w <= 1.0 for w in worst.values()), (d, worst)
        assert all(w > 1.0 for w in ctl.values()), (d, ctl)


@pytest.mark.parametrize("streaming", [False, True])
def test_batch_head_slices_are_bit_equal_to_one_launch(cuda_device,
                                                       monkeypatch,
                                                       streaming):
    """With MAX_LAUNCH_BH = 3, B*H = 7 runs as launches of 3, 3 and 1
    rows (offset pointers, one reused streaming workspace): O and the
    gradients bit-equal to one launch over all seven rows."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 128)
    q, k, v, do = _qkvdo(cuda_device, 7, 256, 64, torch.bfloat16)

    def run():
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.reset_launches()
        out = fa.flash_attention(*ins, True, None, 64, 64,
                                 streaming=streaming)
        grads = torch.autograd.grad(out, ins, do)
        torch.cuda.synchronize()
        return [out, *grads], dict(fa.launches)

    whole, ran = run()
    assert sum(ran.values()) == 3
    monkeypatch.setattr(fa, "MAX_LAUNCH_BH", 3)
    sliced, ran = run()
    assert sorted(ran.values()) == [0, 0, 0, 3, 3, 3]
    for a, b in zip(sliced, whole):
        assert torch.equal(a, b)


def test_entry_point_refuses_head_dims_above_256(cuda_device):
    """Head dims above 256 are no longer refused: flash_attention at
    D = 264 and 520 (padded to 384 and 640) runs the wide kernels and
    gives the plain forward and gradients, float32 to 1e-4 of the max."""
    for d in (264, 520):
        q, k, v, do = _qkvdo(cuda_device, 2, 128, d, torch.float32)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.reset_launches()
        out = fa.flash_attention(*ins, True, None, 64, 64)
        grads = torch.autograd.grad(out, ins, do)
        torch.cuda.synchronize()
        assert fa.launches["flash_fwd"] == 1 and out.shape == q.shape
        scale = d ** -0.5
        with torch.no_grad():
            o_p, lse_p = fa.flash_fwd_plain(q, k, v, True, scale)
            dq_p, delta = fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do,
                                                True, scale)
            dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                                True, scale)
        for got, ref in zip((out, *grads), (o_p, dq_p, dk_p, dv_p)):
            assert float((got - ref).abs().max()) <= 1e-4 * float(
                ref.abs().max())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [384, 512, 768, 896, 1024, 1152])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3),
                                       (torch.float16, 1e-3)])
def test_wide_kernels_match_plain(cuda_device, monkeypatch, causal, d, dtype,
                                  tol):
    """Each wide kernel, resident and streaming (3 splits, the last
    ragged), against its plain version on the same inputs, as
    test_kernels_match_plain holds the instantiated head dims.  In float32
    the backward runs as clusters of D / 128 CTAs, 8 at D = 1024 (at 768
    and 896 the last of 6 or 7 row owners holds a short share of the
    exchange); at 1152 (9 slices) as 5 CTAs of two slices each."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 128)
    q, k, v, do = _qkvdo(cuda_device, 3, 320, d, dtype)
    f = [t.float() for t in (q, k, v, do)]
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    o_p, lse_p = fa.flash_fwd_plain(*f[:3], causal, scale)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal, scale)
    dq_p, delta_p = fa.flash_bwd_dq_plain(*f[:3], o.float(), lse, f[3],
                                          causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(*f[:3], f[3], lse, delta, causal,
                                        scale)
    res = [("o", o, o_p), ("lse", lse, lse_p), ("dq", dq, dq_p),
           ("delta", delta, delta_p), ("dk", dk, dk_p), ("dv", dv, dv_p)]
    res += [(n + "_str", a, b) for n, a, b in
            _streaming_vs_plain(q, k, v, do, causal, scale)]
    torch.cuda.synchronize()
    tols = {"lse": 1e-6, "delta": 1e-5, "lse_str": 1e-6, "delta_str": 1e-5}
    for name, got, ref in res:
        err = float((got.float() - ref).abs().max())
        top = float(ref.abs().max())
        assert err <= tols.get(name, tol) * top, \
            f"{name}: max err {err} vs max {top}"


@pytest.mark.parametrize("d", [384, 512, 1152])
def test_wide_f32_backward_repeat_is_bit_identical(cuda_device, monkeypatch,
                                                   d):
    """The float32 wide backward sums the cluster's partials in rank order
    and its splits in split order, with no atomics: two calls of each of
    its four kernels give the same bits, causal and not."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 128)
    q, k, v, do = _qkvdo(cuda_device, 3, 320, d, torch.float32)
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, True, scale)

    def backward(causal):
        dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
        dq_s, delta_s = fa.flash_bwd_dq_str(q, k, v, o, lse, do, causal,
                                            scale)
        dk_s, dv_s = fa.flash_bwd_dkv_str(q, k, v, do, lse, delta, causal,
                                          scale)
        return dq, delta, dk, dv, dq_s, delta_s, dk_s, dv_s

    for causal in (False, True):
        first, second = backward(causal), backward(causal)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(first, second)):
            assert torch.equal(a, b), (causal, i)


@pytest.mark.parametrize("d", [384, 512, 1152])
def test_wide_f32_forward_repeat_is_bit_identical(cuda_device, monkeypatch,
                                                  d):
    """The float32 wide forward (clusters of 3 and 4 CTAs at D = 384 and
    512, 5 CTAs of two slices each at 1152) sums the cluster's partials in
    rank order and its splits in split order, with no atomics: two calls of
    each family give the same bits, causal and not.  With one split the
    streaming kernel gives the resident kernel's bits (the merge weighs the
    one partial by exp(0))."""
    q, k, v, _ = _qkvdo(cuda_device, 3, 320, d, torch.float32)
    scale = d ** -0.5
    for causal in (False, True):
        monkeypatch.setattr(fa, "_split_len", lambda s: 128)
        runs = [(*fa.flash_fwd(q, k, v, causal, scale),
                 *fa.flash_fwd_str(q, k, v, causal, scale))
                for _ in range(2)]
        monkeypatch.setattr(fa, "_split_len", lambda s: s)
        one = fa.flash_fwd_str(q, k, v, causal, scale)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(*runs)):
            assert torch.equal(a, b), (causal, i)
        assert torch.equal(one[0], runs[0][0]), causal
        assert torch.equal(one[1], runs[0][1]), causal


def test_wide_f32_forward_refuses_misaligned(cuda_device):
    """The float32 wide forward copies q, k and v in 16-byte pieces: a
    contiguous view that starts 4 bytes into its storage is refused by
    both families, not read wrongly."""
    flat = torch.zeros(2 * 128 * 384 + 1, device=cuda_device)
    q = flat[1:].view(2, 128, 384)
    ok = torch.zeros(2, 128, 384, device=cuda_device)
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_fwd(q, ok, ok, True, 0.05)
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_fwd_str(ok, ok, q, False, 0.05)


def _wide_owners(d, s):
    """The owner (cluster rank) of each of s rows in the float32 wide
    kernels and the 16-bit wide forward at head dim d: split_ctas CTAs,
    R = ceil(64 / CTAs) rows each."""
    n = d // fa.WIDE_COLS
    per = -(-n // 8)
    ctas = -(-n // per)
    return (torch.arange(s) % fa.TILE) // -(-fa.TILE // ctas), ctas


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [384, 512, 768, 1024, 1152])
def test_wide_f32_forward_lse_on_every_owner(cuda_device, monkeypatch, causal,
                                             d):
    """The owners of a tile's rows write its LSE (and, streaming, m and l):
    on the rows of every owner, resident and streaming (3 splits, the last
    ragged), LSE is within 1e-5 |plain| + 1e-6 of the plain version."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 128)
    q, k, v, _ = _qkvdo(cuda_device, 3, 320, d, torch.float32)
    scale = d ** -0.5
    _, want = fa.flash_fwd_plain(q, k, v, causal, scale)
    owners, ctas = _wide_owners(d, q.shape[1])
    for fwd in (fa.flash_fwd, fa.flash_fwd_str):
        _, lse = fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        ratio = ((lse - want).abs() / (want.abs() * 1e-5 + 1e-6)).amax(0)
        worst = {r: float(ratio[owners.to(ratio.device) == r].max())
                 for r in range(ctas)}
        assert all(w <= 1.0 for w in worst.values()), (fwd.__name__, worst)



_WIDE16 = [torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", _WIDE16)
@pytest.mark.parametrize("d", [384, 512, 1152])
def test_wide16_forward_repeat_is_bit_identical(cuda_device, monkeypatch, d,
                                                dtype):
    """The bf16 and float16 wide forward (clusters of 3 and 4 CTAs at
    D = 384 and 512, 5 CTAs of two slices each at 1152) sums the cluster's
    partials in rank order and its splits in split order, with no atomics:
    two calls of each family give the same bits, causal and not.  With one
    split the streaming kernel gives the resident kernel's bits (the merge
    weighs the one partial by exp(0) and divides by the same l)."""
    q, k, v, _ = _qkvdo(cuda_device, 3, 320, d, dtype)
    scale = d ** -0.5
    for causal in (False, True):
        monkeypatch.setattr(fa, "_split_len", lambda s: 128)
        runs = [(*fa.flash_fwd(q, k, v, causal, scale),
                 *fa.flash_fwd_str(q, k, v, causal, scale))
                for _ in range(2)]
        monkeypatch.setattr(fa, "_split_len", lambda s: s)
        one = fa.flash_fwd_str(q, k, v, causal, scale)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(*runs)):
            assert torch.equal(a, b), (causal, i)
        assert torch.equal(one[0], runs[0][0]), causal
        assert torch.equal(one[1], runs[0][1]), causal


@pytest.mark.parametrize("dtype", _WIDE16)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [384, 768, 1152])
def test_wide16_forward_lse_on_every_owner(cuda_device, monkeypatch, causal,
                                           d, dtype):
    """The owners of a tile's rows write its LSE (and, streaming, m and l),
    in the bf16 and float16 wide forward as in float32's: on the rows of
    every owner (3, 6 and 5 CTAs at D = 384, 768 and 1152), resident and
    streaming (3 splits, the last ragged), LSE is within
    1e-5 |plain| + 1e-6 of the plain version on the same inputs."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 128)
    q, k, v, _ = _qkvdo(cuda_device, 3, 320, d, dtype)
    scale = d ** -0.5
    _, want = fa.flash_fwd_plain(q.float(), k.float(), v.float(), causal,
                                 scale)
    owners, ctas = _wide_owners(d, q.shape[1])
    for fwd in (fa.flash_fwd, fa.flash_fwd_str):
        _, lse = fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        ratio = ((lse - want).abs() / (want.abs() * 1e-5 + 1e-6)).amax(0)
        worst = {r: float(ratio[owners.to(ratio.device) == r].max())
                 for r in range(ctas)}
        assert all(w <= 1.0 for w in worst.values()), (fwd.__name__, worst)


@pytest.mark.parametrize("dtype", _WIDE16)
def test_wide16_forward_refuses_misaligned(cuda_device, dtype):
    """The bf16 and float16 wide forward copies q, k and v in 16-byte
    pieces: a contiguous view that starts 2 bytes into its storage is
    refused by both families, not read wrongly."""
    flat = torch.zeros(2 * 128 * 384 + 1, device=cuda_device, dtype=dtype)
    q = flat[1:].view(2, 128, 384)
    ok = torch.zeros(2, 128, 384, device=cuda_device, dtype=dtype)
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_fwd(q, ok, ok, True, 0.05)
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_fwd_str(ok, q, ok, False, 0.05)


@pytest.mark.parametrize("dtype", _WIDE16)
@pytest.mark.parametrize("d", [384, 512, 1152])
def test_wide16_backward_repeat_is_bit_identical(cuda_device, monkeypatch, d,
                                                 dtype):
    """The bf16 and float16 wide backward (clusters of 3 and 4 CTAs at
    D = 384 and 512, 5 CTAs of two slices each at 1152) sums the cluster's
    partials in rank order and its splits in split order, with no atomics:
    two calls of each of its four kernels give the same bits, causal and
    not.  With one split the streaming kernels give the resident kernels'
    dQ, dK and dV bits (the sum passes add the one partial to zero and
    scale it as the resident kernels do)."""
    q, k, v, do = _qkvdo(cuda_device, 3, 320, d, dtype)
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, True, scale)

    def backward(causal):
        dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
        dq_s, delta_s = fa.flash_bwd_dq_str(q, k, v, o, lse, do, causal,
                                            scale)
        dk_s, dv_s = fa.flash_bwd_dkv_str(q, k, v, do, lse, delta, causal,
                                          scale)
        return dq, delta, dk, dv, dq_s, delta_s, dk_s, dv_s

    for causal in (False, True):
        monkeypatch.setattr(fa, "_split_len", lambda s: 128)
        first, second = backward(causal), backward(causal)
        monkeypatch.setattr(fa, "_split_len", lambda s: s)
        one = backward(causal)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(first, second)):
            assert torch.equal(a, b), (causal, i)
        for i in (0, 2, 3):  # dQ, dK, dV of one split against the resident
            assert torch.equal(one[4 + i], first[i]), (causal, i)


@pytest.mark.parametrize("dtype", _WIDE16)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [384, 768, 1152])
def test_wide16_backward_delta_on_every_owner(cuda_device, causal, d, dtype):
    """The resident 16-bit wide dQ writes delta = rowsum(dO * O) of each
    tile's rows from the rows' owners (3, 6 and 5 CTAs at D = 384, 768 and
    1152): on the rows of every owner it is within 1e-5 |plain| + 1e-6 of
    the plain version and equal, bit for bit, to the streaming family's
    delta pass (the same float64 sum)."""
    q, k, v, do = _qkvdo(cuda_device, 3, 320, d, dtype)
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    _, want = fa.flash_bwd_dq_plain(q.float(), k.float(), v.float(),
                                    o.float(), lse, do.float(), causal,
                                    scale)
    _, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, causal, scale)
    _, delta_s = fa.flash_bwd_dq_str(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    owners, ctas = _wide_owners(d, q.shape[1])
    ratio = ((delta - want).abs() / (want.abs() * 1e-5 + 1e-6)).amax(0)
    worst = {r: float(ratio[owners.to(ratio.device) == r].max())
             for r in range(ctas)}
    assert all(w <= 1.0 for w in worst.values()), worst
    assert torch.equal(delta, delta_s)


@pytest.mark.parametrize("dtype", _WIDE16)
def test_wide16_backward_refuses_misaligned(cuda_device, dtype):
    """The bf16 and float16 wide backward copies q, k, v and dO (and in
    dK/dV LSE and delta) in 16-byte pieces: a contiguous view that starts
    2 bytes (LSE: 4 bytes) into its storage is refused by each of the four
    kernels, not read wrongly."""
    flat = torch.zeros(2 * 128 * 384 + 1, device=cuda_device, dtype=dtype)
    bad = flat[1:].view(2, 128, 384)
    ok = torch.zeros(2, 128, 384, device=cuda_device, dtype=dtype)
    rows = torch.zeros(2, 128, device=cuda_device)
    bad_rows = torch.zeros(2 * 128 + 1, device=cuda_device)[1:].view(2, 128)
    calls = (
        lambda: fa.flash_bwd_dq(bad, ok, ok, ok, rows, ok, True, 0.05),
        lambda: fa.flash_bwd_dq_str(ok, ok, ok, ok, rows, bad, True, 0.05),
        lambda: fa.flash_bwd_dkv(ok, bad, ok, ok, rows, rows, True, 0.05),
        lambda: fa.flash_bwd_dkv_str(ok, ok, ok, ok, bad_rows, rows, False,
                                     0.05))
    for call in calls:
        with pytest.raises(RuntimeError, match="misaligned"):
            call()


_UNPACK_NS = [1, 100, 5000, 4096 * 33, 1048576, 1048576 - 3]


@pytest.mark.parametrize("n", _UNPACK_NS)
def test_sign_unpack_bit_identical(cuda_device, n):
    """sign_unpack gives the plain version's bits, one launch, at the
    bucket sizes and ragged ones."""
    words = bp.pack_signs(_signs_input(n, cuda_device))
    before = bp.launches["sign_unpack"]
    out = bp.unpack_signs(words, n)
    torch.cuda.synchronize()
    assert bp.launches["sign_unpack"] == before + 1
    assert torch.equal(out, bp.unpack_signs_plain(words, n))


@pytest.mark.parametrize("n", [4096 * 3 + 1, 4096 * 3 + 2, 4096 * 3 + 3])
def test_sign_unpack_unaligned_rows(cuda_device, n):
    """Three rows at n % 4 = 1, 2, 3: rows 1 and 2 start off a 16-byte
    boundary, where the wide stores must give way to scalar ones."""
    words = torch.stack([bp.pack_signs(_signs_input(n + r, cuda_device)[:n])
                         for r in range(3)])
    out = bp.unpack_signs(words, n)
    torch.cuda.synchronize()
    assert torch.equal(out, bp.unpack_signs_plain(words, n))


def test_prefetch_to_device_on_the_card(cuda_device):
    """utils.data.prefetch_to_device: batches copied from pinned host
    memory on a side stream arrive on the card intact, in order."""
    from byteps_tpu_torch.utils import data
    batches = [(torch.full((1024,), float(i)), torch.tensor([i]))
               for i in range(5)]
    got = list(data.prefetch_to_device(iter(batches), size=2))
    torch.cuda.synchronize()
    assert [int(b[1]) for b in got] == list(range(5))
    for (x, _), (want, _) in zip(got, batches):
        assert x.is_cuda and torch.equal(x.cpu(), want)
