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
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
def test_kernels_match_plain(cuda_device, causal, d, dtype, tol):
    """Each kernel against its plain version run in float32 on the same
    (dtype-rounded) inputs.  Tolerance relative to the reference's max: a
    float32 kernel differs only by summation order; a bf16 output also
    rounds once at 2^-8 relative."""
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
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for name, got, ref, t in (("o", o, o_p, tol), ("lse", lse, lse_p, 1e-6),
                              ("dq", dq, dq_p, tol),
                              ("delta", delta, delta_p, 1e-5),
                              ("dk", dk, dk_p, tol), ("dv", dv, dv_p, tol)):
        err = float((got.float() - ref).abs().max())
        top = float(ref.abs().max())
        assert err <= t * top, f"{name}: max err {err} vs max {top}"


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


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(2, 128, 64, device=cuda_device, dtype=torch.float16)
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
                           "flash_bwd_dkv": 2}


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
