"""autodist_tpu_torch flash attention vs the JAX package's.

The port's plain versions of the CUDA kernels (the path CPU tensors take)
against the JAX Pallas kernels run in interpret mode on the CPU, as
tests/test_flash_attention.py runs them, on the same numpy inputs: the
forward (out, lse) and, through autograd, the gradients dq, dk, dv of the
backward kernels. The kernels themselves run only on a card:
tests/test_torch_cuda_kernels.py holds them against their plain versions
there.

Tolerances: 2e-5 in float32 (the JAX package's flash-decode bound,
tests/test_decode.py — blocked online softmax reassociates the f32
reduction; the gradients agree to ~1e-6); 2e-2 in bfloat16 (8 mantissa
bits, accumulation in another order).
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


# ------------------------------------------------------------- backward


def _jax_grads(q, k, v, do, causal, segment_ids, dtype=None):
    """dq, dk, dv of sum(flash_attention(q, k, v) * do) through the JAX
    Pallas kernels (interpret mode), as float32 numpy."""
    import jax
    import jax.numpy as jnp
    cast = (lambda x: jnp.asarray(x)) if dtype is None else \
        (lambda x: jnp.asarray(x, dtype))
    dot = cast(do)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal, segment_ids, 64, 64)
        return jnp.sum((out * dot).astype(jnp.float32))
    grads = jax.grad(loss, (0, 1, 2))(cast(q), cast(k), cast(v))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, do, causal, segment_ids, dtype=torch.float32):
    tq, tk, tv = (_t(x, dtype).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal, segment_ids)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(do, dtype))
    assert all(g.dtype == dtype for g in grads)
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("segments", [None, "packed"])
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_reference(causal, segments):
    """dq, dk, dv of the port's differentiable flash_attention (plain
    versions of the dQ and dK/dV kernels) vs the JAX kernels' grads
    (padding segments: test_padding_mask_matches_reference)."""
    b, s, h, d = 1, 128, 2, 32
    q, k, v, do = (_rand((b, s, h, d), seed=10 + i) for i in range(4))
    seg = _segments(segments, b, s)
    got = _port_grads(q, k, v, do, causal, seg)
    want = _jax_grads(q, k, v, do, causal, seg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


def test_uneven_lengths_grads_match_jax():
    """Sq != Sk, both tileable: 64 queries over 192 keys."""
    q, do = _rand((1, 64, 2, 32), seed=0), _rand((1, 64, 2, 32), seed=3)
    k, v = _rand((1, 192, 2, 32), seed=1), _rand((1, 192, 2, 32), seed=2)
    got = _port_grads(q, k, v, do, False, None)
    want = _jax_grads(q, k, v, do, False, None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_padding_mask_matches_reference(causal):
    """The attn_fn adapter's key-padding mask becomes segment ids in both
    packages: outputs and grads agree."""
    import jax
    import jax.numpy as jnp
    b, s, h, d = 2, 64, 2, 16
    q, k, v, do = (_rand((b, s, h, d), seed=20 + i) for i in range(4))
    valid = np.ones((b, s), bool)
    valid[1, 45:] = False
    mask = valid[:, None, None, :]
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tfa.make_flash_attn_fn(causal=causal)(tq, tk, tv,
                                                torch.as_tensor(mask))
    got = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    attn = jfa.make_flash_attn_fn(causal=causal)

    def loss(q, k, v):
        return jnp.sum(attn(q, k, v, mask) * do)
    want = jax.grad(loss, (0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(attn(q, k, v, mask)),
                               atol=TOL, rtol=TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bfloat16_grads_match_f32_reference(causal):
    """bf16 grads of the port vs the JAX kernels' bf16 grads (the same
    rounding points: dS rounded to k's dtype for dQ, P to dO's and dS to
    q's for dK/dV), at 2e-2."""
    import jax.numpy as jnp
    b, s, h, d = 1, 128, 2, 32
    q, k, v, do = (_rand((b, s, h, d), seed=30 + i) for i in range(4))
    got = _port_grads(q, k, v, do, causal, None, torch.bfloat16)
    want = _jax_grads(q, k, v, do, causal, None, jnp.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=2e-2)


def test_empty_query_rows_emit_zeros_with_zero_grads():
    """Query rows whose segment matches no key: 0 output and 0 grads (lse
    0 makes exp(NEG_INF - lse) vanish), and those rows' keys get nothing
    from them — as in the JAX kernels."""
    b, s, h, d = 1, 64, 2, 16
    q, k, v, do = (_rand((b, s, h, d), seed=40 + i) for i in range(4))
    kv_seg = np.zeros((b, s), np.int32)
    q_seg = kv_seg.copy()
    q_seg[0, [3, 40]] = 5
    got = _port_grads(q, k, v, do, True, (q_seg, kv_seg))
    assert float(np.abs(got[0][0, [3, 40]]).max()) == 0.0
    want = _jax_grads(q, k, v, do, True, (q_seg, kv_seg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_references_match_jax_bwd(causal):
    """flash_bwd_dq_reference / flash_bwd_dkdv_reference against the JAX
    ``_bwd`` (both Pallas backward kernels) on the same residuals, with
    packed segments and an empty query row."""
    b, s, h, d = 1, 128, 2, 32
    q, k, v, do = (_rand((b, s, h, d), seed=50 + i) for i in range(4))
    seg = _segments("packed", b, s)
    q_seg = seg.copy()
    q_seg[0, 7] = 9                      # no key carries segment 9
    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    tqs, tks = _t(q_seg, torch.int32), _t(seg, torch.int32)
    out, lse = tfa.flash_fwd(tq, tk, tv, tqs, tks, causal)
    delta = tfa.flash_bwd_delta(out, tdo)
    dq = tfa.flash_bwd_dq_reference(tq, tk, tv, tdo, lse, delta, tqs, tks,
                                    causal)
    dk, dv = tfa.flash_bwd_dkdv_reference(tq, tk, tv, tdo, lse, delta, tqs,
                                          tks, causal)
    bhsd = [np.transpose(x, (0, 2, 1, 3)) for x in (q, k, v)]
    res = (*bhsd, np.transpose(out.numpy(), (0, 2, 1, 3)),
           lse.numpy()[..., None], q_seg, seg)
    want = jfa._bwd(causal, 64, 64, res, do)
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    assert float(dq[0, 7].abs().max()) == 0.0
    # the CPU wrappers are the plain versions, and launch nothing
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkdv.launches)
    assert torch.equal(tfa.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, tqs,
                                        tks, causal), dq)
    assert all(torch.equal(a, b_) for a, b_ in zip(tfa.flash_bwd_dkdv(
        tq, tk, tv, tdo, lse, delta, tqs, tks, causal), (dk, dv)))
    assert (tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkdv.launches) == before
