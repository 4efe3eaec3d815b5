"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Each test is marked ``cuda`` and skips without a card (a CUDA kernel has
no CPU mode; the CPU tests hold the plain versions to the JAX package).
This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs on its own, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_cuda_kernels.py

Tolerances: f32 2e-5, bf16 2e-2 (bf16 inputs, f32 accumulation in another
order); the backward kernels' errors are relative to the plain version's
largest magnitude.
"""
import pytest
import torch

from autodist_tpu_torch.ops import flash_attention as tfa


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernel_matches_plain_version(dtype, tol):
    """The forward kernel vs its plain version at the lm1b decode shape,
    reading a strided layer view of a layer-stacked cache."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cache = torch.randn((32, 2, 256, 16, 64), generator=gen,
                        device="cuda").to(dtype)
    q = torch.randn((32, 1, 16, 64), generator=gen, device="cuda").to(dtype)
    cursor = torch.randint(0, 256, (32,), generator=gen, device="cuda")
    q_seg = torch.ones((32, 1), dtype=torch.int32, device="cuda")
    kv_seg = (torch.arange(256, device="cuda")[None] <= cursor[:, None]).int()
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_fwd(q, cache[:, 0], cache[:, 1], q_seg, kv_seg)
    assert tfa.flash_fwd.launches == before + 1
    ref, ref_lse = tfa.flash_fwd_reference(q, cache[:, 0], cache[:, 1],
                                           q_seg, kv_seg)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)


# (name, q rows, kv rows, causal, segments): the lm1b training shape, a
# length no tile divides (200 = 12.5 x 16 = 3.125 x 64, tileable by the
# JAX rule with 8-row blocks), fewer queries than keys, and segments with
# an empty query row
_BWD_CASES = [("train", 128, 128, True, False),
              ("ragged", 200, 200, True, False),
              ("uneven", 72, 200, False, False),
              ("segments", 128, 128, True, True)]


def _bwd_inputs(dtype, sq, sk, causal, segments):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn((4, sq, 16, 64), generator=gen, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((4, sk, 16, 64), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    segs = (None, None)
    if segments:
        seg = (torch.arange(sk, device="cuda") >= 50).int()[None].repeat(
            4, 1).contiguous()
        q_seg = seg[:, :sq].clone()
        q_seg[:, 9] = 7                  # an empty query row
        segs = (q_seg, seg)
    out, lse = tfa.flash_fwd_reference(q, k, v, *segs, causal=causal)
    return (q, k, v, do, lse, tfa.flash_bwd_delta(out, do)), segs


@pytest.mark.cuda
@pytest.mark.parametrize("case", _BWD_CASES, ids=[c[0] for c in _BWD_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkdv"])
def test_cuda_bwd_kernel_matches_plain_version(kernel, dtype, tol, case):
    """Each backward kernel vs its plain version; an empty query row gets
    a zero dQ."""
    _need_card()
    _, sq, sk, causal, segments = case
    args, segs = _bwd_inputs(dtype, sq, sk, causal, segments)
    fn = getattr(tfa, kernel)
    before = fn.launches
    got = fn(*args, *segs, causal=causal)
    assert fn.launches == before + 1
    want = getattr(tfa, kernel + "_reference")(*args, *segs, causal=causal)
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * scale
    if segments and kernel == "flash_bwd_dq":
        assert float(got[0][:, 9].float().abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_flash_attention_grads_go_through_the_kernels():
    """Autograd through flash_attention on a card launches the forward
    kernel once and each backward kernel once, with a non-contiguous dO,
    and matches the plain versions' gradients."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((2, 128, 16, 64), generator=gen, device="cuda")
               .requires_grad_() for _ in range(3))
    do = torch.randn((2, 16, 128, 64), generator=gen,
                     device="cuda").transpose(1, 2)   # strided dO
    kernels = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkdv)
    before = [f.launches for f in kernels]
    out = tfa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert [f.launches - b for f, b in zip(kernels, before)] == [1, 1, 1]
    with torch.no_grad():
        ref_out, lse = tfa.flash_fwd_reference(q, k, v, causal=True)
        args = (q, k, v, do.contiguous(), lse,
                tfa.flash_bwd_delta(ref_out, do))
        want = (tfa.flash_bwd_dq_reference(*args, causal=True),
                *tfa.flash_bwd_dkdv_reference(*args, causal=True))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)
