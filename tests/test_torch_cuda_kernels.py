"""The port's CUDA kernels against their plain PyTorch versions, and its
fused supersteps (one CUDA graph a superstep, with a host-PS carry, a
clip chain or the health sentinel's guards too) against its per-step
loop, and a sharded checkpoint's save and restore, on a card.

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
    variant = tfa._fwd_variant(dtype)
    by_variant = tfa.flash_fwd.launches_by_variant.get(variant, 0)
    out, lse = tfa.flash_fwd(q, cache[:, 0], cache[:, 1], q_seg, kv_seg)
    assert tfa.flash_fwd.launches == before + 1
    assert tfa.flash_fwd.launches_by_variant[variant] == by_variant + 1
    ref, ref_lse = tfa.flash_fwd_reference(q, cache[:, 0], cache[:, 1],
                                           q_seg, kv_seg)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)


# (name, q rows, kv rows, causal, segments, strided): the lm1b training
# shape, a length no tile divides (200 = 12.5 x 16 = 3.125 x 64, tileable
# by the JAX rule with 8-row blocks), fewer queries than keys, segments
# with an empty query row, q, k, v, dO as strided views (slices of one
# [B, S, 4, H, D] tensor: d contiguous, rows 16-byte aligned), and BERT's
# non-causal key padding (a row of 64 real keys skips whole 64-row tiles)
_BWD_CASES = [("train", 128, 128, True, None, False),
              ("ragged", 200, 200, True, None, False),
              ("uneven", 72, 200, False, None, False),
              ("segments", 128, 128, True, "empty row", False),
              ("strided", 200, 200, True, None, True),
              ("padding", 128, 128, False, "padding", False)]


def _bwd_inputs(dtype, sq, sk, causal, segments, strided=False):
    gen = torch.Generator(device="cuda").manual_seed(0)
    if strided:
        qkvo = torch.randn((4, sq, 4, 16, 64), generator=gen,
                           device="cuda").to(dtype)
        q, k, v, do = qkvo.unbind(2)
        assert not q.is_contiguous()
    else:
        q, do = (torch.randn((4, sq, 16, 64), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((4, sk, 16, 64), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
    segs = (None, None)
    if segments == "empty row":
        seg = (torch.arange(sk, device="cuda") >= 50).int()[None].repeat(
            4, 1).contiguous()
        q_seg = seg[:, :sq].clone()
        q_seg[:, 9] = 7                  # an empty query row
        segs = (q_seg, seg)
    elif segments == "padding":          # BERT's key padding: 1 real, 0 pad
        lengths = torch.tensor([64, 128, 100, 70], device="cuda")
        seg = (torch.arange(sk, device="cuda")[None]
               < lengths[:, None]).int()
        segs = (seg, seg)
    out, lse = tfa.flash_fwd_reference(q, k, v, *segs, causal=causal)
    return (q, k, v, do, lse, tfa.flash_bwd_delta(out, do)), segs


@pytest.mark.cuda
@pytest.mark.parametrize("case", _BWD_CASES, ids=[c[0] for c in _BWD_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkdv"])
def test_cuda_bwd_kernel_matches_plain_version(kernel, dtype, tol, case):
    """Each backward kernel, in the design its rule picks, vs its plain
    version; an empty query row gets a zero dQ."""
    _need_card()
    _, sq, sk, causal, segments, strided = case
    args, segs = _bwd_inputs(dtype, sq, sk, causal, segments, strided)
    fn = getattr(tfa, kernel)
    before = fn.launches
    variant = (tfa._dq_variant if kernel == "flash_bwd_dq"
               else tfa._dkdv_variant)(dtype)
    by_variant = fn.launches_by_variant.get(variant, 0)
    got = fn(*args, *segs, causal=causal)
    assert fn.launches == before + 1
    assert fn.launches_by_variant[variant] == by_variant + 1
    want = getattr(tfa, kernel + "_reference")(*args, *segs, causal=causal)
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * scale
    if segments == "empty row" and kernel == "flash_bwd_dq":
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


# (name, q rows, kv rows, causal): the training shape, a length no tile
# divides and fewer queries than keys
_FWD_CASES = [("train", 128, 128, True), ("ragged", 200, 200, True),
              ("uneven", 72, 200, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [False, True],
                         ids=["plain", "segments+empty row"])
@pytest.mark.parametrize("case", _FWD_CASES, ids=[c[0] for c in _FWD_CASES])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_forward_designs_match_plain_version(dtype, tol, case, segments):
    """The forward in the design its rule picks vs its plain version: out
    and lse, ragged edges, segments, and an empty query row giving 0 and
    lse 0."""
    _need_card()
    _, sq, sk, causal = case
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn((4, sq, 16, 64), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((4, sk, 16, 64), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    segs = (None, None)
    if segments:
        seg = (torch.arange(sk, device="cuda") >= 50).int()[None].repeat(
            4, 1).contiguous()
        q_seg = seg[:, :sq].clone()
        q_seg[:, 9] = 7                  # an empty query row
        segs = (q_seg, seg)
    variant = tfa._fwd_variant(dtype)
    by_variant = tfa.flash_fwd.launches_by_variant.get(variant, 0)
    out, lse = tfa.flash_fwd(q, k, v, *segs, causal=causal)
    assert tfa.flash_fwd.launches_by_variant[variant] == by_variant + 1
    ref, ref_lse = tfa.flash_fwd_reference(q, k, v, *segs, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    if segments:
        assert float(out[:, 9].float().abs().max()) == 0.0
        assert float(lse[:, :, 9].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_at_the_tp_lm_shape(dtype, tol):
    """The three kernels at tp_lm's causal shape under 2-way tensor
    parallelism, [2, 1024, 8, 64] (16 key tiles, the causal skip over
    them), against their plain versions: out and lse, dQ, dK and dV
    (the backward's errors relative to the plain version's largest
    magnitude)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = (torch.randn((2, 1024, 8, 64), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    before = [fn.launches for fn in tfa.COUNTED]
    out, lse = tfa.flash_fwd(q, k, v, causal=True)
    ref, ref_lse = tfa.flash_fwd_reference(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    delta = tfa.flash_bwd_delta(ref, do)
    args = (q, k, v, do, ref_lse, delta)
    got = (tfa.flash_bwd_dq(*args, causal=True),
           *tfa.flash_bwd_dkdv(*args, causal=True))
    want = (tfa.flash_bwd_dq_reference(*args, causal=True),
            *tfa.flash_bwd_dkdv_reference(*args, causal=True))
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * scale
    assert [fn.launches for fn in tfa.COUNTED] == [n + 1 for n in before]


@pytest.mark.cuda
def test_pipe_lm_block_with_flash_matches_plain_attention():
    """One pipe_lm block at TPLMConfig.flagship's width and the pipeline's
    microbatch shape [2, 1024, 1024] in bf16, the flash kernels in its
    ``attn_fn`` slot against the same block with the plain causal
    attention: the output and the gradients of the input and of every
    block parameter within 2e-2 of the plain block's largest magnitude;
    each kernel launched once."""
    _need_card()
    from autodist_tpu_torch.models import pipe_lm
    cfg = pipe_lm.TPLMConfig.flagship(num_layers=1)
    params = pipe_lm.init_params(cfg, seed=0)
    block = {n[len(pipe_lm.BLOCKS):]: t[0].cuda().requires_grad_()
             for n, t in params.items() if n.startswith(pipe_lm.BLOCKS)}
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((2, 1024, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16).requires_grad_()
    dout = torch.randn((2, 1024, cfg.d_model), generator=gen,
                       device="cuda").to(torch.bfloat16)
    flash = tfa.make_flash_attn_fn(causal=True)
    inputs = [x] + list(block.values())
    before = [fn.launches for fn in tfa.COUNTED]
    got = pipe_lm._block(block, x, torch.bfloat16, "model", flash)
    got_grads = torch.autograd.grad(got, inputs, dout)
    assert [fn.launches for fn in tfa.COUNTED] == [n + 1 for n in before]
    want = pipe_lm._block(block, x, torch.bfloat16, "model")
    want_grads = torch.autograd.grad(want, inputs, dout)
    for g, w in zip((got,) + got_grads, (want,) + want_grads):
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= 2e-2 * scale


@pytest.mark.cuda
def test_cuda_bf16_grads_go_through_the_tensor_core_kernels():
    """Autograd through flash_attention in bf16 with a strided dO: the
    forward, dQ and dK/dV all run their tensor-core designs, and the
    gradients match the plain versions (2e-2 of max|ref|)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((2, 128, 16, 64), generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.randn((2, 16, 128, 64), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2)   # strided dO
    kernels = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkdv)
    variants = ("mma.sync bf16",) * 3
    before = [f.launches_by_variant.get(n, 0)
              for f, n in zip(kernels, variants)]
    out = tfa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert [f.launches_by_variant[n] - b for f, n, b
            in zip(kernels, variants, before)] == [1, 1, 1]
    with torch.no_grad():
        ref_out, lse = tfa.flash_fwd_reference(q, k, v, causal=True)
        args = (q, k, v, do.contiguous(), lse,
                tfa.flash_bwd_delta(ref_out, do))
        want = (tfa.flash_bwd_dq_reference(*args, causal=True),
                *tfa.flash_bwd_dkdv_reference(*args, causal=True))
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= 2e-2 * scale


# ------------------------------------------- fused supersteps (CUDA graphs)


def _lm_runner(n_batches=8, builder=None, optimizer=None, sentinel=None):
    """A 2-layer lm at head width 64 (the kernels' width) in bf16 with
    flash attention, on the card, under ``builder()`` (default
    ``AllReduce()``), ``optimizer`` (default Adam at 1e-3) and
    ``sentinel`` (the health sentinel's policy), and its batches."""
    import functools

    import numpy as np

    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    cfg = lm.LMConfig(vocab_size=128, d_model=128, num_layers=2,
                      num_heads=2, mlp_dim=256, max_seq_len=64,
                      dtype=torch.bfloat16)
    loss_fn, params, example, _ = lm.make_train_setup(
        cfg, seq_len=64, batch_size=4, attention="flash", lean_head=True)
    rng = np.random.RandomState(0)
    batches = [{"tokens": rng.randint(0, 128, (4, 65)).astype(np.int32)}
               for _ in range(n_batches)]

    def build():
        adt.reset()
        ad = adt.AutoDist(strategy_builder=(builder or strategy.AllReduce)())
        runner = ad.build(loss_fn, optimizer or functools.partial(
            torch.optim.Adam, lr=1e-3), params, example, sentinel=sentinel)
        runner.init(params)
        return runner
    return build, batches, cfg


@pytest.mark.cuda
def test_cuda_superstep_graph_matches_the_per_step_loop():
    """fit(fuse_steps=4) replays one captured CUDA graph a superstep: bit
    for bit the per-step loop in deterministic mode, 4x fewer dispatches,
    and each kernel counted once a layer a microstep (the replays' and the
    capture's warm-up microstep)."""
    _need_card()
    import autodist_tpu_torch as adt
    build, batches, cfg = _lm_runner()
    torch.use_deterministic_algorithms(True)
    try:
        runner = build()
        want = [float(m["loss"]) for m in runner.fit(iter(batches))]
        want_params = {n: t.clone() for n, t in
                       runner.gather_params().items()}
        runner = build()
        before = tfa.launch_counts()
        got = [float(m["loss"]) for m in runner.fit(
            iter(batches), fuse_steps=4, metrics_every=2)]
        dstep = runner.distributed_step
        assert dstep.dispatches == 2 and len(dstep._graphs) == 1
        assert got == want
        for n, t in runner.gather_params().items():
            assert torch.equal(t, want_params[n]), n
        micro = len(batches) + dstep.warmup_microsteps
        for name, by in tfa.launch_counts().items():
            assert by["mma.sync bf16"] - before[name].get(
                "mma.sync bf16", 0) == cfg.num_layers * micro, name
        # donate=False replays the same graph and leaves the state as it was
        from autodist_tpu_torch.data.prefetch import stack_batches
        placed = runner._remapper.remap_feed_stack(stack_batches(batches[:4]))
        kept = {n: t.clone() for n, t in runner.state.params.items()}
        new, _ = dstep.run_multi(runner.state, placed, donate=False)
        assert len(dstep._graphs) == 1
        for n, t in runner.state.params.items():
            assert torch.equal(t, kept[n]), n
        assert any(not torch.equal(new.params[n], kept[n]) for n in kept)
    finally:
        torch.use_deterministic_algorithms(False)
        adt.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("remat,compute_dtype", [
    ("full", "f32"), ("dots", "f32"), (None, "bf16")])
def test_cuda_superstep_under_remat_and_the_tier_matches_per_step(
        remat, compute_dtype):
    """Remat (each layer its own recompute unit) and the bf16 tier inside
    a captured superstep: fit(fuse_steps=4) bit for bit the per-step
    loop of the same plan in deterministic mode; under remat the forward
    kernel launches twice a layer a microstep (the recomputed forward),
    the backward kernels once."""
    _need_card()
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy

    def builder():
        b = strategy.AllReduce(compute_dtype=compute_dtype)
        return strategy.WithRemat(b, remat) if remat else b
    build, batches, cfg = _lm_runner(builder=builder)
    torch.use_deterministic_algorithms(True)
    try:
        runner = build()
        want = [float(m["loss"]) for m in runner.fit(iter(batches))]
        want_params = {n: t.clone() for n, t in
                       runner.gather_params().items()}
        runner = build()
        before = tfa.launch_counts()
        got = [float(m["loss"]) for m in runner.fit(iter(batches),
                                                    fuse_steps=4)]
        dstep = runner.distributed_step
        assert dstep.dispatches == 2 and got == want
        for n, t in runner.gather_params().items():
            assert torch.equal(t, want_params[n]), n
        micro = len(batches) + dstep.warmup_microsteps
        for name, by in tfa.launch_counts().items():
            per = 2 if remat and name == "flash_fwd" else 1
            assert by["mma.sync bf16"] - before[name].get(
                "mma.sync bf16", 0) == per * cfg.num_layers * micro, name
    finally:
        torch.use_deterministic_algorithms(False)
        adt.reset()


@pytest.mark.cuda
def test_cuda_step_fn_superstep_matches_its_per_step_loop():
    """build_step's opaque step (its own SGD over the lm's params, a
    ``convert.FlaxParams`` inside the state) fused k = 4 over two
    supersteps, bit for bit its per-step loop in deterministic mode."""
    _need_card()
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    cfg = lm.LMConfig(vocab_size=128, d_model=128, num_layers=2,
                      num_heads=2, mlp_dim=256, max_seq_len=64,
                      dtype=torch.bfloat16)
    loss_fn, params, example, _ = lm.make_train_setup(
        cfg, seq_len=64, batch_size=4, attention="flash", lean_head=True)

    def step_fn(state, batch):
        p = {n: t.detach().requires_grad_() for n, t in
             state["params"].items()}
        loss = loss_fn(p, batch)
        grads = torch.autograd.grad(loss, list(p.values()))
        return ({"params": {n: w - 0.1 * g for (n, w), g in
                            zip(state["params"].items(), grads)},
                 "count": state["count"] + 1}, {"loss": loss.detach()})
    state = {"params": params, "count": torch.zeros((), dtype=torch.int32)}
    _, batches, _ = _lm_runner()
    got = {}
    torch.use_deterministic_algorithms(True)
    try:
        for fuse in (1, 4):
            adt.reset()
            runner = adt.AutoDist(strategy_builder=strategy.AllReduce()) \
                .build_step(step_fn, state, example)
            runner.init(state)
            hist = runner.fit(iter(batches), fuse_steps=fuse)
            final = runner.gather_params()
            got[fuse] = ([float(m["loss"]) for m in hist],
                         {n: t.clone() for n, t in final["params"].items()},
                         int(final["count"]))
    finally:
        torch.use_deterministic_algorithms(False)
        adt.reset()
    assert got[4][0] == got[1][0] and got[4][2] == got[1][2] == 8
    for n, t in got[1][1].items():
        assert torch.equal(got[4][1][n], t), n


@pytest.mark.cuda
@pytest.mark.parametrize("builder", ["PS", "UnevenPartitionedPS",
                                     "Parallax"])
def test_cuda_superstep_with_a_ps_carry_matches_the_per_step_loop(builder):
    """DLRM tiny with its host-PS variables in the device carry:
    fit(fuse_steps=4) replays one graph a superstep, holds the store off
    the wire until the gather writes the carry back once, and agrees with
    the per-step loop (whose Adam runs on the host CPU, the carry's on
    the card; the pairs densify by a scatter-add on the card instead of
    ``np.add.at``) within 1e-6, in deterministic mode."""
    _need_card()
    import functools

    import numpy as np

    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import dlrm
    cfg = dlrm.DLRMConfig.tiny()
    loss_fn, params, example, _ = dlrm.make_train_setup(cfg, batch_size=16)
    batches = [dlrm.make_train_setup(cfg, batch_size=16, seed=s)[2]
               for s in range(1, 9)]

    def build():
        adt.reset()
        ad = adt.AutoDist(strategy_builder=getattr(strategy, builder)())
        runner = ad.build(loss_fn, functools.partial(torch.optim.Adam,
                                                     lr=1e-2),
                          params, example)
        runner.init(params)
        return runner
    torch.use_deterministic_algorithms(True)
    try:
        runner = build()
        want = [float(m["loss"]) for m in runner.fit(iter(batches))]
        want_params = {n: t.clone() for n, t in
                       runner.gather_params().items()}
        runner = build()
        store = runner.distributed_step.ps_store
        got = [float(m["loss"]) for m in runner.fit(
            iter(batches), fuse_steps=4, metrics_every=2)]
        dstep = runner.distributed_step
        assert dstep.dispatches == 2 and len(dstep._graphs) == 1
        assert (store.stats["pulls"], store.stats["pushes"]) == (1, 0)
        got_params = runner.gather_params()
        assert store.stats["pushes"] == 1
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        for n, t in got_params.items():
            torch.testing.assert_close(t, want_params[n], rtol=0,
                                       atol=1e-6, msg=n)
    finally:
        torch.use_deterministic_algorithms(False)
        adt.reset()


@pytest.mark.cuda
def test_cuda_superstep_with_the_clip_chain_matches_the_per_step_loop():
    """The imagenet example's ``chain(clip_by_global_norm(1.0),
    SGD(momentum=0.9))``: its norm and choice stay on the card, so one
    captured graph holds them, bit for bit the per-step loop in
    deterministic mode."""
    _need_card()
    import functools

    import autodist_tpu_torch as adt
    from autodist_tpu_torch import optim
    chain = optim.chain(optim.clip_by_global_norm(1.0), functools.partial(
        torch.optim.SGD, lr=0.1, momentum=0.9))
    build, batches, _ = _lm_runner(optimizer=chain)
    torch.use_deterministic_algorithms(True)
    try:
        runner = build()
        want = [float(m["loss"]) for m in runner.fit(iter(batches))]
        want_state = {n: t.clone() for n, t in
                      runner.state.opt_state["trace"].items()}
        want_params = {n: t.clone() for n, t in
                       runner.gather_params().items()}
        runner = build()
        got = [float(m["loss"]) for m in runner.fit(
            iter(batches), fuse_steps=4, metrics_every=2)]
        assert runner.distributed_step.dispatches == 2
        assert got == want
        for n, t in runner.gather_params().items():
            assert torch.equal(t, want_params[n]), n
        for n, t in runner.state.opt_state["trace"].items():
            assert torch.equal(t, want_state[n]), n
    finally:
        torch.use_deterministic_algorithms(False)
        adt.reset()


@pytest.mark.cuda
def test_cuda_guarded_superstep_skips_the_faulted_microstep(monkeypatch):
    """The sentinel's guards inside a captured superstep: a NaN gradient at
    step 2 (read from the step counter on the card, inside the graph)
    gives the stacked verdicts [1, 1, 0, 1, 1, 1, 1, 1] over two
    replays, discards that microstep's update on the card, and matches
    the guarded per-step loop bit for bit (deterministic mode), with as
    many dispatches and readbacks as the unguarded fused run."""
    _need_card()
    import json

    import autodist_tpu_torch as adt
    monkeypatch.setenv("ADT_GRAD_FAULT_PLAN", json.dumps(
        {"faults": [{"var": "final_ln.weight", "mode": "nan", "step": 2}]}))
    build, batches, cfg = _lm_runner(sentinel=True)
    build_plain, _, _ = _lm_runner()
    torch.use_deterministic_algorithms(True)
    try:
        runner = build()
        assert "final_ln.weight" in runner.distributed_step.model_item.params
        want = [float(m["loss"]) for m in runner.fit(iter(batches))]
        want_params = {n: t.clone() for n, t in
                       runner.gather_params().items()}
        runner = build()
        hist = runner.fit(iter(batches), fuse_steps=4, metrics_every=2)
        oks = [int(m["sentinel"]["ok"]) for m in hist]
        assert oks == [1, 1, 0, 1, 1, 1, 1, 1]
        assert [float(m["loss"]) for m in hist] == want
        for n, t in runner.gather_params().items():
            assert torch.equal(t, want_params[n]), n
        assert runner.step_stats()["sentinel"]["skips"] == 1
        dispatches = runner.distributed_step.dispatches
        readbacks = runner.readbacks
        plain = build_plain()
        plain.fit(iter(batches), fuse_steps=4, metrics_every=2)
        assert (plain.distributed_step.dispatches, plain.readbacks) == (
            dispatches, readbacks)
    finally:
        torch.use_deterministic_algorithms(False)
        adt.reset()


@pytest.mark.cuda
def test_cuda_sharded_save_and_restore(tmp_path):
    """``ShardedSaver`` on ``cuda:0``: a save after two steps, two more
    steps, a restore; the params and Adam moments come back bit-equal,
    on the card, and the next steps repeat the losses after the save
    (deterministic mode)."""
    _need_card()
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.checkpoint import ShardedSaver
    build, batches, _ = _lm_runner()
    torch.use_deterministic_algorithms(True)
    try:
        runner = build()
        for b in batches[:2]:
            runner.run(b)
        saver = ShardedSaver(str(tmp_path))
        saver.save(runner)
        kept = {n: t.clone() for n, t in runner.gather_params().items()}
        mu = {n: t.clone() for n, t in runner.state.opt_state["mu"].items()}
        after = [float(runner.run(b)["loss"]) for b in batches[2:4]]
        _, step = saver.restore(runner)
        assert step == 2
        for n, t in runner.gather_params().items():
            assert t.is_cuda and torch.equal(t, kept[n]), n
        for n, t in runner.state.opt_state["mu"].items():
            assert torch.equal(t, mu[n]), n
        assert [float(runner.run(b)["loss"]) for b in batches[2:4]] == after
    finally:
        torch.use_deterministic_algorithms(False)
        adt.reset()


@pytest.mark.cuda
def test_cuda_a_failed_capture_raises():
    """A step that reads a value back to the host cannot be captured: the
    superstep raises, and nothing runs the eager loop instead."""
    _need_card()
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy

    def step_fn(state, batch):
        w = state["w"] * 0.5
        if float(w.sum()) > 1e30:       # a readback
            w = w * 0
        return {"w": w}, {"loss": w.sum()}
    adt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce())
    state = {"w": torch.ones(8)}
    runner = ad.build_step(step_fn, state, {"x": torch.zeros(2)})
    runner.init(state)
    with pytest.raises(RuntimeError, match="capturing"):
        runner.run_superstep({"x": torch.zeros((4, 2))})
    adt.reset()


@pytest.mark.cuda
def test_cuda_prefetcher_stages_through_pinned_buffers():
    """On the card the prefetcher copies from reused pinned buffers on a
    side stream; the batches it yields are the host batches, on the card,
    and pass through the runner's feed untouched."""
    _need_card()
    import numpy as np

    from autodist_tpu_torch.data import DevicePrefetcher
    build, batches, _ = _lm_runner()
    runner = build()
    pf = DevicePrefetcher(iter(batches), runner, depth=2, stack=2)
    items = list(pf)
    assert len(items) == 4 and pf._ring is not None
    bufs = [b for slot, _ in pf._ring._slots for b in slot if b is not None]
    assert bufs and all(b.is_pinned() for b in bufs)
    for i, item in enumerate(items):
        t = item["tokens"]
        assert t.device.type == "cuda" and t.shape == (2, 4, 65)
        np.testing.assert_array_equal(
            t.cpu().numpy(), np.stack([b["tokens"] for b in
                                       batches[2 * i:2 * i + 2]]))
        assert runner.remapper.remap_feed_stack(item)["tokens"] is t
    import autodist_tpu_torch as adt
    adt.reset()
