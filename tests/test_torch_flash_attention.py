"""autodist_tpu_torch flash attention vs the JAX package's.

The port's plain version of the CUDA forward kernel (the path CPU tensors
take) against the JAX Pallas kernel run in interpret mode on the CPU, as
tests/test_flash_attention.py runs it, on the same numpy inputs. The
kernel itself runs only on a card: the ``cuda``-marked test holds it
against the plain version there and skips here.

Tolerances: 2e-5 in float32 (the JAX package's flash-decode bound,
tests/test_decode.py — blocked online softmax reassociates the f32
reduction); 2e-2 in bfloat16 (8 mantissa bits, accumulation in another
order).
"""
import numpy as np
import pytest
import torch

from autodist_tpu.ops import attention as jattn
from autodist_tpu.ops import flash_attention as jfa
from autodist_tpu_torch.ops import attention as tattn
from autodist_tpu_torch.ops import flash_attention as tfa

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from contending with the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _segments(kind, b, s):
    if kind is None:
        return None
    if kind == "padding":     # BERT-style validity: 1 real, 0 padding
        seg = np.ones((b, s), np.int32)
        seg[0, s - 37:] = 0
        return seg
    # packed sequences: three documents per row
    seg = np.zeros((b, s), np.int32)
    seg[:, 40:] = 1
    seg[:, 90:] = 2
    return seg


@pytest.mark.parametrize("segments", [None, "padding", "packed"])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_and_lse_match_jax(causal, segments):
    b, s, h, d = 2, 128, 2, 32
    q, k, v = (_rand((b, s, h, d), seed=i) for i in range(3))
    seg = _segments(segments, b, s)
    segs = None if seg is None else (seg, seg)
    jout, jlse = jfa._fwd(*(np.transpose(x, (0, 2, 1, 3)) for x in (q, k, v)),
                          segs, causal, 64, 64)
    tseg = None if seg is None else _t(seg, torch.int32)
    out, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), tseg, tseg, causal)
    np.testing.assert_allclose(out.numpy(),
                               np.transpose(np.asarray(jout), (0, 2, 1, 3)),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=TOL, rtol=TOL)
    # the public op agrees with the JAX public op
    pub = tfa.flash_attention(_t(q), _t(k), _t(v), causal,
                              None if seg is None else seg)
    jpub = jfa.flash_attention(q, k, v, causal, seg)
    np.testing.assert_allclose(pub.numpy(), np.asarray(jpub),
                               atol=TOL, rtol=TOL)


def test_uneven_lengths_match_jax():
    q = _rand((1, 64, 2, 32), seed=0)
    k = _rand((1, 192, 2, 32), seed=1)
    v = _rand((1, 192, 2, 32), seed=2)
    out = tfa.flash_attention(_t(q), _t(k), _t(v), causal=False)
    ref = jfa.flash_attention(q, k, v, causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_empty_query_rows_emit_zero_output_and_lse():
    """A query whose segment matches no key: the kernel rule (0 output,
    lse 0) in both packages."""
    b, s, h, d = 1, 64, 2, 16
    q, k, v = (_rand((b, s, h, d), seed=i) for i in range(3))
    kv_seg = np.zeros((b, s), np.int32)
    q_seg = kv_seg.copy()
    q_seg[0, [3, 40]] = 5          # no key carries segment 5
    jout, jlse = jfa._fwd(*(np.transpose(x, (0, 2, 1, 3)) for x in (q, k, v)),
                          (q_seg, kv_seg), True, 32, 32)
    out, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), _t(q_seg, torch.int32),
                             _t(kv_seg, torch.int32), causal=True)
    assert float(out[0, [3, 40]].abs().max()) == 0.0
    assert float(lse[0, :, [3, 40]].abs().max()) == 0.0
    np.testing.assert_allclose(out.numpy(),
                               np.transpose(np.asarray(jout), (0, 2, 1, 3)),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_untileable_length_takes_the_reference_path(causal):
    """A length the JAX kernel cannot tile goes through
    reference_attention in both packages (the JAX contract, whose empty
    rows differ from the kernel's)."""
    q, k, v = (_rand((2, 12, 2, 16), seed=i) for i in range(3))
    seg = np.ones((2, 12), np.int32)
    seg[1, 9:] = 0
    launches = tfa.flash_fwd.launches
    out = tfa.flash_attention(_t(q), _t(k), _t(v), causal, seg)
    ref = jfa.flash_attention(q, k, v, causal, seg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    assert tfa.flash_fwd.launches == launches


def test_attn_fn_adapter_padding_mask_matches_jax():
    b, s, h, d = 2, 64, 2, 16
    q, k, v = (_rand((b, s, h, d), seed=i) for i in range(3))
    valid = np.ones((b, s), bool)
    valid[1, 50:] = False
    mask = valid[:, None, None, :]
    out = tfa.make_flash_attn_fn(causal=False)(_t(q), _t(k), _t(v),
                                                torch.as_tensor(mask))
    ref = jfa.make_flash_attn_fn(causal=False)(q, k, v, mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    with pytest.raises(ValueError, match="key-padding"):
        tfa.make_flash_attn_fn()(_t(q), _t(k), _t(v),
                                 torch.ones(b, 1, s, s, dtype=torch.bool))


def test_bfloat16_plain_version_matches_jax_kernel():
    import jax.numpy as jnp
    b, s, h, d = 1, 128, 2, 32
    q, k, v = (_rand((b, s, h, d), seed=i) for i in range(3))
    ref = jfa.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                for x in (q, k, v)), causal=True)
    out = tfa.flash_attention(*(_t(x, torch.bfloat16) for x in (q, k, v)),
                              causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_reference_attention_matches_jax():
    q, k, v = (_rand((2, 16, 2, 8), seed=i) for i in range(3))
    mask = np.tril(np.ones((16, 16), bool))[None, None]
    out = tattn.reference_attention(_t(q), _t(k), _t(v),
                                    torch.as_tensor(mask))
    ref = jattn.reference_attention(q, k, v, mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("flash", [False, True])
def test_cached_attention_matches_jax(flash):
    """Decode-shape attention against a KV cache: the port's reference
    and flash paths vs the JAX functions (the JAX flash function
    broadcasts the query to an 8-row block; the port passes Sq = 1)."""
    b, t, h, d = 4, 64, 2, 16
    q = _rand((b, h, d), seed=0)
    kc, vc = _rand((b, t, h, d), seed=1), _rand((b, t, h, d), seed=2)
    cursor = np.array([0, 5, 31, 63], np.int32)
    tfn = tattn.flash_cached_attention if flash else tattn.cached_attention
    jfn = jattn.flash_cached_attention if flash else jattn.cached_attention
    out = tfn(_t(q), _t(kc), _t(vc), torch.as_tensor(cursor))
    ref = jfn(q, kc, vc, cursor)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    # and across the two port paths
    other = (tattn.cached_attention if flash
             else tattn.flash_cached_attention)(_t(q), _t(kc), _t(vc),
                                                torch.as_tensor(cursor))
    np.testing.assert_allclose(out.numpy(), other.numpy(), atol=TOL,
                               rtol=TOL)


def test_cpu_tensors_take_the_plain_version_and_others_raise():
    q, k, v = (_t(_rand((1, 16, 1, 64), seed=i)) for i in range(3))
    before = tfa.flash_fwd.launches
    out, lse = tfa.flash_fwd(q, k, v)
    ref, ref_lse = tfa.flash_fwd_reference(q, k, v)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert tfa.flash_fwd.launches == before     # no kernel launched
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_fwd(*(x.to("meta") for x in (q, k, v)))
    with pytest.raises(ValueError, match="both"):
        tfa.flash_fwd(q, k, v, torch.zeros(1, 16, dtype=torch.int32), None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernel_matches_plain_version(dtype, tol):
    """On a card: the CUDA kernel vs its plain version at the lm1b decode
    shape, reading a strided layer view of a layer-stacked cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
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
