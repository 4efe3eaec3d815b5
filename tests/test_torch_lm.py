"""autodist_tpu_torch's lm1b model vs the JAX package's, on the same
parameters (the JAX init, converted with ``convert.params_from_jax``).

float32 on the CPU at ``LMConfig.tiny()``: logits, prefill (logits, k, v)
and decode_step agree at atol/rtol 1e-5 (the two frameworks sum in
different orders; observed error is ~1e-6), and greedy prefill plus five
cached decode steps give exactly the JAX tokens.
"""
import jax
import numpy as np
import pytest
import torch

from autodist_tpu.models import lm as jlm
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.models import lm as tlm
from autodist_tpu_torch.models.layers import apply

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from contending with the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cfg = jlm.LMConfig.tiny()
    _, jparams, batch, japply = jlm.make_train_setup(cfg, seq_len=16,
                                                     batch_size=4,
                                                     lean_head=False)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return cfg, jparams, tparams, batch, japply


def _inputs(cfg, b=3, p=6, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (b, p)).astype(np.int32)
    length = np.array([p, 1, 4][:b], np.int32)
    return toks, length


def test_conversion_covers_every_parameter(models):
    _, _, tparams, _, _ = models
    model = tlm.make_model(tlm.LMConfig.tiny())
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {n: tuple(t.shape) for n, t in tparams.items()}
    assert all(t.dtype == torch.float32 for t in tparams.values())


def test_lm1b_parameter_shapes_match_jax():
    """Full width, abstractly: every converted JAX lm1b parameter has the
    port's shape (no weights are materialized)."""
    cfg = jlm.LMConfig.lm1b()
    model = jlm.TransformerLM(cfg)
    abstract = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jax.numpy.zeros((1, 8), jax.numpy.int32))

    def as_zeros(a):
        return np.broadcast_to(np.zeros((), np.float32), a.shape)
    converted = params_from_jax(jax.tree_util.tree_map(as_zeros, abstract))
    port = tlm.make_model(tlm.LMConfig.lm1b())
    shapes = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert shapes == {n: tuple(t.shape) for n, t in converted.items()}
    assert sum(int(np.prod(s)) for s in shapes.values()) == 304259951


def test_logits_match_jax(models):
    cfg, jparams, tparams, batch, japply = models
    ids = batch["tokens"][:, :-1]
    ref = np.asarray(japply(jparams, ids))
    with torch.inference_mode():
        out = apply(tlm.make_model(tlm.LMConfig.tiny()), tparams,
                    torch.as_tensor(ids))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_prefill_matches_jax(models):
    cfg, jparams, tparams, _, _ = models
    toks, length = _inputs(cfg)
    jsetup = jlm.make_decode_setup(cfg, return_logits=True)
    jmodel = jlm.TransformerLM(cfg)
    jl, jk, jv = jmodel.apply(jparams, toks, length,
                              method=jlm.TransformerLM.prefill)
    with torch.inference_mode():
        tl, tk, tv = apply(tlm.make_model(tlm.LMConfig.tiny()), tparams,
                           torch.as_tensor(toks), torch.as_tensor(length),
                           method="prefill")
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    assert jsetup.max_len == cfg.max_seq_len


@pytest.mark.parametrize("decode_attn", ["reference", "flash"])
def test_decode_step_matches_jax(models, decode_attn):
    """One cached step on random caches: a dead slot writes nothing, the
    live ones write their row at the cursor; logits and both caches
    agree with the JAX step (the JAX flash step runs the Pallas kernel in
    interpret mode)."""
    cfg, jparams, tparams, _, _ = models
    rng = np.random.RandomState(1)
    b = 3
    shape = (b, cfg.num_layers, cfg.max_seq_len, cfg.num_heads,
             cfg.d_model // cfg.num_heads)
    kc = rng.randn(*shape).astype(np.float32)
    vc = rng.randn(*shape).astype(np.float32)
    token = rng.randint(0, cfg.vocab_size, (b,)).astype(np.int32)
    cursor = np.array([0, 17, cfg.max_seq_len - 1], np.int32)
    alive = np.array([True, False, True])
    jmodel = jlm.TransformerLM(cfg, decode_attn=decode_attn)
    jl, jk, jv = jmodel.apply(jparams, token, kc, vc, cursor, alive,
                              method=jlm.TransformerLM.decode_step)
    tk, tv = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    with torch.inference_mode():
        tl, tk2, tv2 = apply(
            tlm.make_model(tlm.LMConfig.tiny(), decode_attn=decode_attn),
            tparams, torch.as_tensor(token), tk, tv,
            torch.as_tensor(cursor), torch.as_tensor(alive),
            method="decode_step")
    assert tk2 is tk and tv2 is tv           # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(tk.numpy()[1], kc[1])   # dead slot


def jax_greedy(japply, jparams, prompts, n, width=32):
    """Greedy generation by full recompute through the JAX model: all
    prompts right-padded into one [len(prompts), width] batch under one
    jit, reading each row's logits at its last real position (causal
    attention makes the padding invisible there)."""
    fn = jax.jit(japply)
    seqs = [list(map(int, p)) for p in prompts]
    out = [[] for _ in prompts]
    for _ in range(n):
        ids = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
        logits = np.asarray(fn(jparams, ids))
        for i, s in enumerate(seqs):
            nxt = int(np.argmax(logits[i, len(s) - 1]))
            out[i].append(nxt)
            s.append(nxt)
    return out


@pytest.mark.parametrize("decode_attn", ["reference", "flash"])
def test_greedy_prefill_and_decode_match_jax_tokens(models, decode_attn):
    """prefill + 5 cached decode steps through the port's decode setup ==
    greedy full recompute through the JAX model, token for token."""
    cfg, jparams, tparams, _, japply = models
    setup = tlm.make_decode_setup(tlm.LMConfig.tiny(),
                                  decode_attn=decode_attn)
    prompts = [[5, 9], [17, 3, 21, 8], [1]]
    plen = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), max(plen)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    with torch.inference_mode():
        pre = setup.prefill_fn(tparams, {"tokens": torch.as_tensor(toks),
                                         "length": torch.as_tensor(plen)})
        dstate = setup.init_dstate(len(prompts), device="cpu")
        dstate.update(k=pre["k"].clone(), v=pre["v"].clone(),
                      token=pre["next_token"],
                      cursor=torch.as_tensor(plen),
                      alive=torch.ones(len(prompts), dtype=torch.bool))
        generated = [[int(t)] for t in dstate["token"]]
        for _ in range(5):
            out = setup.decode_fn(tparams, dstate)
            dstate["token"] = out["next_token"]
            dstate["cursor"] = dstate["cursor"] + 1
            for i in range(len(prompts)):
                generated[i].append(int(out["next_token"][i]))
    assert generated == jax_greedy(japply, jparams, prompts, 6)


def test_init_dstate_follows_the_entry_points_device_rule(monkeypatch):
    """``init_dstate`` builds the cache where it is told; with no device it
    takes the entry points' default, cuda, and raises when no card is
    visible rather than build a CPU cache under a CUDA runner."""
    setup = tlm.make_decode_setup(tlm.LMConfig.tiny())
    dstate = setup.init_dstate(2, device="cpu")
    assert set(dstate) == {"k", "v", "token", "cursor", "alive"}
    assert all(t.device.type == "cpu" for t in dstate.values())
    assert dstate["k"].shape[0] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup.init_dstate(2)


@pytest.mark.parametrize("device,want", [
    ("cpu", "cpu"), (torch.device("cpu"), "cpu"), (None, RuntimeError),
    ("cuda", RuntimeError), ("meta", ValueError)])
def test_resolve_device_rule_without_a_card(monkeypatch, device, want):
    """The rule ``init_dstate`` and ``AutoDist`` share: the CPU only when
    asked for, cuda by default, which raises when no card is visible, and
    no other device type."""
    from autodist_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if isinstance(want, str):
        assert resolve_device(device) == torch.device(want)
    else:
        with pytest.raises(want):
            resolve_device(device)
