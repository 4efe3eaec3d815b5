"""autodist_tpu_torch chunked softmax cross-entropy vs the JAX package's.

``ops/xent.py::chunked_softmax_xent`` (a ``torch.autograd.Function``)
against ``autodist_tpu/ops/xent.py`` on the same numpy inputs: values and
grads (x, w, b) for vocabularies the chunk does not divide (the clamped,
masked final chunk), out-of-vocab targets, bf16 activations, and the lean
lm1b head against the standard head.

Tolerances: 1e-5 in float32 for the values and grads (both run the same
f32 chunk math; observed ~1e-6 on the nll, ~1e-8 on the grads), 2e-2 for
bfloat16 activations (8 mantissa bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.ops.xent import chunked_softmax_xent as jax_xent
from autodist_tpu_torch.ops.xent import chunked_softmax_xent

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from contending with the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _head(n, d, vocab, seed, t_high=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(d, vocab) * 0.1).astype(np.float32)
    b = (rng.randn(vocab) * 0.1).astype(np.float32)
    t = rng.randint(0, t_high or vocab, (n,)).astype(np.int32)
    return x, w, b, t


def _both(x, w, b, t, chunk, jdtype=jnp.float32, tdtype=torch.float32):
    """(port nll, port grads, JAX nll, JAX grads) of mean(nll), as f32
    numpy."""
    jx, jw = jnp.asarray(x, jdtype), jnp.asarray(w, jdtype)
    jb, jt = jnp.asarray(b), jnp.asarray(t)
    jnll = jax_xent(jx, jw, jb, jt, chunk)
    jgrads = jax.grad(lambda x, w, b: jnp.mean(jax_xent(x, w, b, jt, chunk)),
                      (0, 1, 2))(jx, jw, jb)
    tx, tw = (torch.as_tensor(a).to(tdtype).requires_grad_() for a in (x, w))
    tb = torch.as_tensor(b).requires_grad_()
    nll = chunked_softmax_xent(tx, tw, tb, torch.as_tensor(t), chunk)
    grads = torch.autograd.grad(nll.mean(), (tx, tw, tb))
    assert [g.dtype for g in grads] == [tdtype, tdtype, torch.float32]
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return (nll.detach().numpy(), [g.float().numpy() for g in grads],
            f32(jnll), [f32(g) for g in jgrads])


@pytest.mark.parametrize("vocab,chunk", [(1000, 256), (1000, 1000),
                                         (777, 256), (512, 512)])
def test_matches_reference_fwd_and_grad(vocab, chunk):
    """nll and grads equal the JAX function's, including the ragged final
    chunk (777 = 3 x 256 + 9, read at the clamped offset 521)."""
    nll, grads, jnll, jgrads = _both(*_head(64, 32, vocab, seed=0), chunk)
    np.testing.assert_allclose(nll, jnll, atol=TOL, rtol=TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=TOL, rtol=TOL)


def test_matches_log_softmax_of_full_logits():
    """The chunked head is the standard head: log_softmax + gather over
    the full logits, in value and grads."""
    x, w, b, t = _head(48, 16, 300, seed=2)
    tx, tw, tb = (torch.as_tensor(a).requires_grad_() for a in (x, w, b))
    nll = chunked_softmax_xent(tx, tw, tb, torch.as_tensor(t), 128)
    logp = torch.log_softmax(tx @ tw + tb, dim=-1)
    ref = -logp.gather(1, torch.as_tensor(t).long()[:, None])[:, 0]
    torch.testing.assert_close(nll, ref, atol=TOL, rtol=TOL)
    for g, r in zip(torch.autograd.grad(nll.sum(), (tx, tw, tb)),
                    torch.autograd.grad(ref.sum(), (tx, tw, tb))):
        torch.testing.assert_close(g, r, atol=TOL, rtol=TOL)


def test_bf16_activations():
    """bf16 activations and weight (the LM's dtype) accumulate in f32; the
    grads come back in bf16 and agree with the JAX function's."""
    nll, grads, jnll, jgrads = _both(*_head(32, 16, 300, seed=1), 128,
                                     jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(nll, jnll, atol=2e-2, rtol=2e-2)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=2e-2, rtol=2e-2)


def test_out_of_vocab_target_clamps_like_reference():
    """Targets past the vocab clamp to its last id, as take_along_axis
    clamps in the JAX standard head; the port matches the JAX function."""
    x, w, b, t = _head(40, 16, 200, seed=3, t_high=260)
    assert (t >= 200).any()
    nll, grads, jnll, jgrads = _both(x, w, b, t, 64)
    np.testing.assert_allclose(nll, jnll, atol=TOL, rtol=TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, atol=TOL, rtol=TOL)
    clamped = chunked_softmax_xent(*(torch.as_tensor(a) for a in (x, w, b)),
                                   torch.as_tensor(np.minimum(t, 199)), 64)
    np.testing.assert_allclose(nll, clamped.numpy(), atol=0, rtol=0)


@pytest.mark.parametrize("attention", ["default", "flash"])
def test_lm_lean_head_matches_standard_loss(attention):
    """make_train_setup(lean_head=True) gives the standard head's loss and
    grads on the same params, as the JAX module's lean head does."""
    import dataclasses
    from autodist_tpu_torch.models import lm
    cfg = dataclasses.replace(lm.LMConfig.tiny(), vocab_size=333)
    lean, params, batch, _ = lm.make_train_setup(
        cfg, seq_len=16, batch_size=4, attention=attention, lean_head=True)
    std, _, _, _ = lm.make_train_setup(cfg, seq_len=16, batch_size=4,
                                       attention=attention, lean_head=False)
    names = ["lm_head.weight", "lm_head.bias", "embed.embedding",
             "layer_0.MultiHeadAttention_0.query.weight"]
    out = []
    for fn in (lean, std):
        p = {n: (t.clone().requires_grad_() if n in names else t)
             for n, t in params.items()}
        loss = fn(p, batch)
        out.append((loss, torch.autograd.grad(loss, [p[n] for n in names])))
    torch.testing.assert_close(out[0][0], out[1][0], atol=TOL, rtol=TOL)
    for g, r in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(g, r, atol=TOL, rtol=TOL)
