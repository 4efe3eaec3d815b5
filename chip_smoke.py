#!/usr/bin/env python3
"""Chip smoke for autodist_tpu_torch: the port's main paths on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
nvcc and PyTorch for CUDA. Phases, each fatal on failure (exit code 1, no
result line):

1. build every CUDA kernel of the paths from ``autodist_tpu_torch/csrc``
   (one nvcc per source, started together) and print the card;
2. hold each kernel against its plain PyTorch version at the shapes the
   main paths give it and time the kernel, the plain version and one
   PyTorch library call computing the same function: the forward at the
   decode shape (f32 at 2e-5, the JAX package's flash-decode bound; bf16
   at 2e-2 atol/rtol: bf16 inputs, f32 accumulation in another order),
   then at the training shape [64, 128, 16, 64] and a smaller shape with
   segments and an empty query row (out and lse, the same bounds), and the
   two backward kernels at those two shapes (f32 2e-5, bf16 2e-2, each as
   an error relative to the plain version's largest magnitude);
3. serve lm1b at full width in bf16 through the entry points a user calls
   (``AutoDist(...).build`` -> ``Runner.init`` -> ``DecodeEngine`` with
   ``decode_attn="flash"``): 64 prompts of mixed lengths through 32 slots;
   every future resolves, no errors, and the kernel ran exactly 8 times a
   decode step;
4. the same model in f32: flash decode and reference decode give the same
   tokens, and both equal greedy full recompute;
5. train lm1b at full width in bf16 (seq 128, batch 64, lean head, flash
   attention) through ``AutoDist(...).build`` -> ``Runner.init`` ->
   ``Runner.run``: 2 warm-up and 10 timed Adam steps on one random batch;
   every loss finite, the last below the first, each of the three kernels
   launched 8 times a step, the f32 master params moved; then a device
   profile of 3 more steps;
6. the same model in f32 at batch 8: 3 Adam steps with flash attention and
   3 with the reference attention from the same init agree in loss and
   params.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""
import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense rates): memory rate, and
# the dense bf16 tensor-core rate
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12

DECODE_SLOTS, DECODE_T, HEADS, HEAD_DIM, LAYERS = 32, 256, 16, 64, 8
TRAIN_BATCH, TRAIN_SEQ = 64, 128
KERNEL_SOURCES = {
    "flash_fwd": ("autodist_tpu_torch/csrc/flash_fwd.cu",
                  "autodist_tpu/ops/flash_attention.py:97"),
    "flash_bwd_dq": ("autodist_tpu_torch/csrc/flash_bwd.cu",
                     "autodist_tpu/ops/flash_attention.py:213"),
    "flash_bwd_dkdv": ("autodist_tpu_torch/csrc/flash_bwd.cu",
                       "autodist_tpu/ops/flash_attention.py:252"),
}


def fail(msg):
    print("chip_smoke FAILED: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail("nvidia-smi: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters, repeats=5):
    """Device time of one ``fn()`` call: the median over ``repeats`` runs
    of the mean over ``iters`` calls (CUDA events), after two warm-up
    calls."""
    import statistics
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def record(name, max_abs_err, ms, plain_ms, library_ms, t_bytes, t_ops):
    """One entry of the kernels' JSON line (launches filled in later)."""
    source, replaces = KERNEL_SOURCES[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def check_rel(name, got, want, tol):
    """Kernel vs plain version, the error relative to the plain version's
    largest magnitude."""
    err = max_err(got, want)
    scale = float(want.float().abs().max())
    print("  %-44s max_abs_err %.3e, / max|ref| %.3e = %.3e (tol %.0e)"
          % (name, err, scale, err / max(scale, 1e-30), tol))
    if not err <= tol * scale:
        fail("%s disagrees with the plain version (max err %.3e, max|ref| "
             "%.3e)" % (name, err, scale))
    return err


def check_close(name, got, want, tol):
    import torch
    err = max_err(got, want)
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    print("  %-44s max_abs_err %.3e (tol %.0e)" % (name, err, tol))
    if not ok:
        fail("%s disagrees with the plain version (max err %.3e)"
             % (name, err))
    return err


# ------------------------------------------------------------- phase 2


def decode_inputs(dtype, seed):
    """A full-size layer-stacked KV cache [slots, layers, T, H, D], one
    query per slot, cursors spread over [0, T-1] with both ends present."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (DECODE_SLOTS, LAYERS, DECODE_T, HEADS, HEAD_DIM)
    k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = torch.randn((DECODE_SLOTS, HEADS, HEAD_DIM), generator=gen,
                    device="cuda").to(dtype)
    cursor = torch.randint(0, DECODE_T, (DECODE_SLOTS,), generator=gen,
                           device="cuda")
    cursor[0], cursor[1] = 0, DECODE_T - 1
    return q, k, v, cursor.int()


def segs_for(cursor):
    import torch
    q_seg = torch.ones((cursor.shape[0], 1), dtype=torch.int32,
                       device=cursor.device)
    kv_seg = (torch.arange(DECODE_T, device=cursor.device)[None, :]
              <= cursor[:, None]).int()
    return q_seg, kv_seg


def kernel_phase(card):
    """Kernel vs plain version; returns the flash_fwd record (without its
    main-path launch count). ``card`` tags the timing line."""
    import torch
    import torch.nn.functional as F
    from autodist_tpu_torch.ops import flash_attention as fa

    errs = []
    print("phase 2: flash_fwd vs flash_fwd_reference")
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        tag = str(dtype).replace("torch.", "")
        q, k, v, cursor = decode_inputs(dtype, seed=1)
        q_seg, kv_seg = segs_for(cursor)
        layer = 3
        out, lse = fa.flash_fwd(q[:, None], k[:, layer], v[:, layer], q_seg,
                                kv_seg)
        ref, ref_lse = fa.flash_fwd_reference(q[:, None], k[:, layer],
                                              v[:, layer], q_seg, kv_seg)
        torch.cuda.synchronize()
        errs.append(check_close("decode %s out [32,1,256,16,64]" % tag,
                                out, ref, tol))
        check_close("decode %s lse" % tag, lse, ref_lse, tol)

        gen = torch.Generator(device="cuda").manual_seed(2)
        shape = (8, 256, HEADS, HEAD_DIM)   # [B, S, H, D] = [8,16,256,64]
        pq, pk, pv = (torch.randn(shape, generator=gen, device="cuda")
                      .to(dtype) for _ in range(3))
        seg = (torch.arange(256, device="cuda") >= 100).int()[None].repeat(
            8, 1).contiguous()
        q_empty = seg.clone()
        q_empty[:, 5] = 7                   # an id no key carries
        for name, segs in (("causal", None), ("causal+segments", (seg, seg)),
                           ("causal+empty row", (q_empty, seg))):
            qs, ks = segs if segs is not None else (None, None)
            out, lse = fa.flash_fwd(pq, pk, pv, qs, ks, causal=True)
            ref, ref_lse = fa.flash_fwd_reference(pq, pk, pv, qs, ks,
                                                  causal=True)
            torch.cuda.synchronize()
            errs.append(check_close("prefill %s %s" % (tag, name), out, ref,
                                    tol))
            check_close("prefill %s %s lse" % (tag, name), lse, ref_lse, tol)
            if name == "causal+empty row":
                if bool(out[:, 5].float().abs().max() != 0) or \
                        bool(lse[:, :, 5].abs().max() != 0):
                    fail("an empty query row did not give 0 output, 0 lse")
                print("  empty query row: output 0, lse 0")

    # timing at the decode shape, bf16, rotating over the 8 layers' cache
    # slices as the main path does (268 MB per cache half > the 50 MB L2)
    q, k, v, cursor = decode_inputs(torch.bfloat16, seed=3)
    q_seg, kv_seg = segs_for(cursor)
    q1 = q[:, None]
    mask = (torch.arange(DECODE_T, device="cuda")[None, :]
            <= cursor[:, None])[:, None, None, :]      # [B,1,1,T]
    qh = q1.transpose(1, 2)                             # [B,H,1,D]
    kh = [k[:, i].transpose(1, 2) for i in range(LAYERS)]
    vh = [v[:, i].transpose(1, 2) for i in range(LAYERS)]

    def over_layers(f):
        def run():
            for i in range(LAYERS):
                f(i)
        return run

    launches_before = fa.flash_fwd.launches
    ms = cuda_time_ms(over_layers(lambda i: fa.flash_fwd(
        q1, k[:, i], v[:, i], q_seg, kv_seg)), 20) / LAYERS
    plain_ms = cuda_time_ms(over_layers(lambda i: fa.flash_fwd_reference(
        q1, k[:, i], v[:, i], q_seg, kv_seg)), 5) / LAYERS
    library_ms = cuda_time_ms(over_layers(
        lambda i: F.scaled_dot_product_attention(qh, kh[i], vh[i],
                                                 attn_mask=mask)), 20) / LAYERS
    fa.flash_fwd.launches = launches_before  # comparison launches do not count

    live_rows = int((cursor.long() + 1).sum())
    itemsize = 2
    bytes_moved = (2 * live_rows * HEADS * HEAD_DIM * itemsize    # K, V
                   + 2 * DECODE_SLOTS * HEADS * HEAD_DIM * itemsize  # q, o
                   + DECODE_SLOTS * HEADS * 4                       # lse
                   + DECODE_SLOTS * (1 + DECODE_T) * 4)             # seg ids
    flops = 4 * live_rows * HEADS * HEAD_DIM
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print("  decode bf16 [32,1,256,16,64] (%d live rows): kernel %.4f ms, "
          "plain %.4f ms, sdpa %.4f ms, bound %.4f ms (%s) [%s]"
          % (live_rows, ms, plain_ms, library_ms, bound_ms,
             "bytes" if t_bytes >= t_ops else "operations", card))
    return record("flash_fwd", max(errs), ms, plain_ms, library_ms, t_bytes,
                  t_ops)


def bwd_kernel_phase(card):
    """Both backward kernels vs their plain versions, and the forward kernel
    at the training shape (whose out and lse feed them) vs its own; returns
    the two backward records (without main-path launch counts) and the
    forward's numbers at the training shape."""
    import torch
    import torch.nn.functional as F
    from autodist_tpu_torch.ops import flash_attention as fa

    print("phase 2b: flash_fwd at the training shape, flash_bwd_dq, "
          "flash_bwd_dkdv vs their plain versions")
    errs = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkdv": []}
    train_shape = (TRAIN_BATCH, TRAIN_SEQ, HEADS, HEAD_DIM)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        tag = str(dtype).replace("torch.", "")
        gen = torch.Generator(device="cuda").manual_seed(4)
        train = [torch.randn(train_shape, generator=gen, device="cuda")
                 .to(dtype) for _ in range(4)]
        small = [torch.randn((8, 256, HEADS, HEAD_DIM), generator=gen,
                             device="cuda").to(dtype) for _ in range(4)]
        seg = (torch.arange(256, device="cuda") >= 100).int()[None].repeat(
            8, 1).contiguous()
        q_empty = seg.clone()
        q_empty[:, 5] = 7                   # an id no key carries
        for name, (q, k, v, do), segs in (
                ("train [64,128,16,64] causal", train, (None, None)),
                ("[8,256,16,64] causal+segments+empty row", small,
                 (q_empty, seg))):
            out, lse = fa.flash_fwd(q, k, v, *segs, causal=True)
            ref, ref_lse = fa.flash_fwd_reference(q, k, v, *segs,
                                                  causal=True)
            torch.cuda.synchronize()
            errs["flash_fwd"].append(max(
                check_close("out %s %s" % (tag, name), out, ref, tol),
                check_close("lse %s %s" % (tag, name), lse, ref_lse, tol)))
            delta = fa.flash_bwd_delta(out, do)
            args = (q, k, v, do, lse, delta, *segs)
            dq = fa.flash_bwd_dq(*args, causal=True)
            dk, dv = fa.flash_bwd_dkdv(*args, causal=True)
            dq_ref = fa.flash_bwd_dq_reference(*args, causal=True)
            dk_ref, dv_ref = fa.flash_bwd_dkdv_reference(*args, causal=True)
            torch.cuda.synchronize()
            errs["flash_bwd_dq"].append(check_rel(
                "dq %s %s" % (tag, name), dq, dq_ref, tol))
            for g, r, what in ((dk, dk_ref, "dk"), (dv, dv_ref, "dv")):
                errs["flash_bwd_dkdv"].append(check_rel(
                    "%s %s %s" % (what, tag, name), g, r, tol))
            if segs[0] is not None:
                if bool(dq[:, 5].float().abs().max() != 0):
                    fail("an empty query row did not get a 0 gradient")
                print("  empty query row: dq 0")

    # timing at the training shape, bf16 causal (4 x 16.8 MB of inputs, so
    # L2 holds at most part of them, as for a layer of the main path)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(train_shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa.flash_bwd_delta(out, do)
    args = (q, k, v, do, lse, delta)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkdv.launches)
    ms = {"flash_bwd_dq": cuda_time_ms(
              lambda: fa.flash_bwd_dq(*args, causal=True), 20),
          "flash_bwd_dkdv": cuda_time_ms(
              lambda: fa.flash_bwd_dkdv(*args, causal=True), 20)}
    plain = {"flash_bwd_dq": cuda_time_ms(
                 lambda: fa.flash_bwd_dq_reference(*args, causal=True), 3),
             "flash_bwd_dkdv": cuda_time_ms(
                 lambda: fa.flash_bwd_dkdv_reference(*args, causal=True), 3)}
    fwd_before = fa.flash_fwd.launches
    fwd_ms = cuda_time_ms(lambda: fa.flash_fwd(q, k, v, causal=True), 20)
    fwd_plain_ms = cuda_time_ms(
        lambda: fa.flash_fwd_reference(q, k, v, causal=True), 3)
    fa.flash_fwd.launches = fwd_before
    fa.flash_bwd_dq.launches, fa.flash_bwd_dkdv.launches = before
    # library yardstick: the backward of SDPA (its own fused kernel, which
    # computes dq, dk and dv together), asked for each kernel's outputs
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    doh = do.transpose(1, 2)
    library = {"flash_bwd_dq": cuda_time_ms(lambda: torch.autograd.grad(
                   oh, (qh,), doh, retain_graph=True), 20),
               "flash_bwd_dkdv": cuda_time_ms(lambda: torch.autograd.grad(
                   oh, (kh, vh), doh, retain_graph=True), 20)}

    sdpa_fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), 20)

    n = TRAIN_BATCH * TRAIN_SEQ * HEADS * HEAD_DIM      # elements a tensor
    rows = TRAIN_BATCH * HEADS * TRAIN_SEQ              # lse / delta rows
    live = TRAIN_BATCH * HEADS * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2  # causal
    # forward: q, k, v read once, out and lse written once; s and p.v
    fwd_bytes = (3 * n + n) * 2 + rows * 4
    fwd_flops = 2 * 2 * live * HEAD_DIM
    fwd = record("flash_fwd", max(errs["flash_fwd"]), fwd_ms, fwd_plain_ms,
                 sdpa_fwd_ms, fwd_bytes / H100_BYTES_PER_S * 1e3,
                 fwd_flops / H100_BF16_FLOPS * 1e3)
    print("  flash_fwd bf16 [64,128,16,64] causal (the training shape): "
          "kernel %.4f ms, plain %.4f ms, sdpa %.4f ms, bound %.4f ms (%s: "
          "%.1f MB, %.2f GFLOP) [%s]"
          % (fwd_ms, fwd_plain_ms, sdpa_fwd_ms, fwd["bound_ms"],
             fwd["bound_by"], fwd_bytes / 1e6, fwd_flops / 1e9, card))
    work = {  # (bytes: inputs read once + outputs written once, flops)
        "flash_bwd_dq": ((4 * n + n) * 2 + 2 * rows * 4,
                         3 * 2 * live * HEAD_DIM),    # s, dp, dq products
        "flash_bwd_dkdv": ((4 * n + 2 * n) * 2 + 2 * rows * 4,
                           4 * 2 * live * HEAD_DIM)}  # s, dp, dv, dk
    records = []
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOPS * 1e3
        rec = record(name, max(errs[name]), ms[name], plain[name],
                     library[name], t_bytes, t_ops)
        print("  %s bf16 [64,128,16,64] causal: kernel %.4f ms, plain %.4f "
              "ms, sdpa backward %.4f ms, bound %.4f ms (%s: %.1f MB, "
              "%.2f GFLOP) [%s]"
              % (name, rec["ms"], rec["plain_ms"], rec["library_ms"],
                 rec["bound_ms"], rec["bound_by"], nbytes / 1e6,
                 flops / 1e9, card))
        records.append(rec)
    return records, fwd


# ------------------------------------------------------------- phase 3/4


def device_profile(run, label):
    """Run ``run()`` under torch.profiler and print where the device time
    went: busy share of the window and the top kernels. Only device events
    (kernels, copies, fills) count, their overlaps merged: the CPU ops the
    profiler records also carry their kernels' time, and summing both
    would count it twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print("  device profile: not measured (the profiler saw no device "
              "time)")
        return
    busy, end = 0.0, float("-inf")
    by_name = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += stop - start
        tot[1] += 1
    total = sum(t for t, _ in by_name.values())
    print("  device profile over %s: window %.1f ms, device busy %.1f ms "
          "(%.1f%%, idle %.1f%%)" % (
              label, window_us / 1e3, busy / 1e3,
              100 * busy / window_us, 100 * (1 - busy / window_us)))
    for key, (dev, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:10]:
        print("    %6.2f%% of device time  %5d calls  %s"
              % (100 * dev / total, count, key[:90]))


def serve(cfg, loss_fn, params, batch, decode_attn, dcfg, prompts,
          profile_prompts=None):
    """Build -> init -> DecodeEngine through the public entry points;
    returns (results, engine stats, wall seconds, flash_fwd launches in
    the timed run, runner)."""
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.serving.decode import DecodeEngine

    adt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce())
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, batch)
    runner.init(params)
    engine = DecodeEngine(runner, lm.make_decode_setup(cfg, decode_attn),
                          dcfg)
    try:
        engine.warmup()
        torch.cuda.synchronize()
        from autodist_tpu_torch.ops import flash_attention as fa
        fa.flash_fwd.launches = 0
        t0 = time.perf_counter()
        futures = [engine.submit(p) for p in prompts]
        results = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fa.flash_fwd.launches
        stats = engine.stats()
        if profile_prompts:
            def submit_all():
                for f in [engine.submit(p) for p in profile_prompts]:
                    f.result(timeout=600)
            device_profile(submit_all, "%d prompts" % len(profile_prompts))
    finally:
        engine.close()
    return results, stats, wall, launches, runner


def train_runner(cfg, batch_size, attention):
    """Build -> init through the public entry points; returns (runner,
    init params on the host, batch)."""
    import torch
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import lm
    loss_fn, params, batch, _ = lm.make_train_setup(
        cfg, seq_len=TRAIN_SEQ, batch_size=batch_size, seed=0,
        attention=attention, lean_head=True)
    adt.reset()
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce())
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=1e-3),
                      params, batch)
    runner.init(params)
    return runner, params, batch


def train_flops_per_step(cfg, n_params):
    """Closed-form training FLOPs of one step: 6 x tokens x (parameters
    outside the two embedding tables, lm_head included) plus the attention
    products, 12 x layers x seq x d_model per token (PaLM's count, which
    ignores the causal half)."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    dense = n_params - (cfg.vocab_size + cfg.max_seq_len) * cfg.d_model
    return 6 * tokens * dense + 12 * cfg.num_layers * TRAIN_SEQ * \
        cfg.d_model * tokens


def train_phase(card):
    """Phase 5: lm1b full width, bf16, lean head, flash attention. Returns
    the launches of each kernel over the phase's steps."""
    import math
    import statistics
    import torch
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.ops import flash_attention as fa
    print("phase 5: lm1b full width (bf16, seq %d, batch %d, lean head, "
          "flash) through AutoDist -> Runner.init -> Runner.run"
          % (TRAIN_SEQ, TRAIN_BATCH))
    cfg = lm.LMConfig.lm1b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    runner, params, batch = train_runner(cfg, TRAIN_BATCH, "flash")
    torch.cuda.synchronize()
    n_params = sum(int(p.numel()) for p in params.values())
    print("  %d parameters (random, seed 0), setup %.1f s"
          % (n_params, time.perf_counter() - t0))
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkdv)
    for kern in kernels:
        kern.launches = 0
    warmup, timed = 2, 10
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(warmup + timed):
        t0 = time.perf_counter()
        metrics = runner.run(batch)      # sync: reads the loss back
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = {k.__name__: k.launches for k in kernels}
    steps = warmup + timed
    print("  losses: %s" % " ".join("%.4f" % x for x in losses))
    if not all(math.isfinite(x) for x in losses):
        fail("training: a loss is not finite: %r" % (losses,))
    if not losses[-1] < losses[0]:
        fail("training: the loss did not fall (%.4f -> %.4f)"
             % (losses[0], losses[-1]))
    for name, n in launches.items():
        if n != cfg.num_layers * steps:
            fail("training: %s launched %d times over %d steps (want %d)"
                 % (name, n, steps, cfg.num_layers * steps))
    final = runner.gather_params()
    if any(t.dtype != torch.float32 for t in final.values()):
        fail("training: the master params are not all float32")
    moved = [n for n in ("embed.embedding",
                         "layer_0.MultiHeadAttention_0.query.weight",
                         "layer_%d.Dense_1.weight" % (cfg.num_layers - 1),
                         "final_ln.weight",
                         "lm_head.weight")
             if not torch.equal(final[n].cpu(), params[n])]
    if len(moved) != 5:
        fail("training: some params did not move (moved: %r)" % moved)
    p50 = statistics.median(times[warmup:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops_per_step(cfg, n_params)
    print("  %d steps: step p50 %.2f ms (min %.2f, max %.2f), %.0f tokens/s, "
          "%.1f examples/s, %.2f TFLOP/step, MFU %.2f%% of %.0f TFLOP/s bf16, "
          "peak memory %.2f GB, launches %s [%s]"
          % (timed, p50 * 1e3, min(times[warmup:]) * 1e3,
             max(times[warmup:]) * 1e3, tokens / p50, TRAIN_BATCH / p50,
             flops / 1e12, 100 * flops / p50 / H100_BF16_FLOPS,
             H100_BF16_FLOPS / 1e12, torch.cuda.max_memory_allocated() / 1e9,
             launches, card))
    stats = runner.step_stats()
    print("  step_stats: first_step_s %s steady_median_s %s goodput %s"
          % (stats["first_step_s"], stats["steady_median_s"],
             stats["goodput"]))

    def three_steps():
        for _ in range(3):
            runner.run(batch)
    device_profile(three_steps, "3 training steps")
    return launches


def train_parity_phase():
    """Phase 6: lm1b full width in f32, batch 8: 3 Adam steps with flash
    attention (the three kernels) vs 3 with the reference attention."""
    import torch
    from autodist_tpu_torch.models import lm
    print("phase 6: lm1b full width (f32, seq %d, batch 8): flash vs "
          "reference attention, 3 Adam steps each" % TRAIN_SEQ)
    cfg = lm.LMConfig.lm1b()
    steps, lr = 3, 1e-3
    got = {}
    for attention in ("flash", "default"):
        runner, _, batch = train_runner(cfg, 8, attention)
        losses = [float(runner.run(batch)["loss"]) for _ in range(steps)]
        got[attention] = (losses, runner.gather_params())
        print("  %-8s losses %s" % (attention,
                                    " ".join("%.6f" % x for x in losses)))
    (lf, pf), (lr_, pr) = got["flash"], got["default"]
    for a, b in zip(lf, lr_):
        if abs(a - b) > 1e-4 * abs(b):
            fail("training parity: losses differ (%r vs %r)" % (lf, lr_))
    # Adam moves every element by up to lr a step whatever its gradient's
    # size, so an element whose gradient is at the rounding-noise level
    # (the key biases' gradient is zero analytically) may step either way:
    # each element is held to 2 x steps x lr, and the mean to 1e-6
    worst, total, count = 0.0, 0.0, 0
    for name in pf:
        d = (pf[name] - pr[name]).abs()
        worst = max(worst, float(d.max()))
        total += float(d.double().sum())
        count += d.numel()
    mean = total / count
    print("  params after %d steps: max |flash - reference| %.3e (bound "
          "%.0e), mean %.3e (bound 1e-06)" % (steps, worst,
                                              2 * steps * lr, mean))
    if worst > 2 * steps * lr or mean > 1e-6:
        fail("training parity: params differ beyond the bounds")


def main():
    if not os.path.isdir(os.path.join(HERE, "autodist_tpu_torch", "csrc")):
        fail("autodist_tpu_torch/ is not beside chip_smoke.py — run it from "
             "a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA "
             "card")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print("device: %s | nvidia-smi: %s | torch %s cuda %s"
          % (kind, card, torch.__version__, torch.version.cuda), flush=True)

    # phase 1 — build every kernel of the path, all nvcc runs together
    from autodist_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    try:
        cuda_build.build()
    except RuntimeError as e:
        fail(str(e))
    print("phase 1: built %s in %.1f s" % (", ".join(cuda_build.KERNELS),
                                           time.perf_counter() - t0))
    for name, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("  %s: %s" % (name, line.strip()))

    records = {"flash_fwd": kernel_phase(card)}
    bwd_records, fwd_train = bwd_kernel_phase(card)
    for rec in bwd_records:
        records[rec["name"]] = rec

    # phase 3 — lm1b at full width, bf16, flash decode
    import numpy as np
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.serving.decode import DecodeConfig
    print("phase 3: lm1b full width (bf16) through AutoDist -> Runner -> "
          "DecodeEngine(decode_attn='flash')")
    cfg = lm.LMConfig.lm1b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    loss_fn, params, batch, _ = lm.make_train_setup(cfg, seq_len=64,
                                                    batch_size=8, seed=0)
    n_params = sum(int(p.numel()) for p in params.values())
    print("  %d parameters (random, seed 0), init %.1f s"
          % (n_params, time.perf_counter() - t0))
    rng = np.random.RandomState(0)
    lengths = [1 + (i * 37) % 64 for i in range(64)]
    lengths[0], lengths[1] = 1, 64
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lengths]
    dcfg = DecodeConfig(slots=32, max_new_tokens=32, prefill_len=64)
    results, stats, wall, launches, _ = serve(cfg, loss_fn, params, batch,
                                              "flash", dcfg, prompts,
                                              profile_prompts=prompts[:32])
    steps = stats["steps"]
    if stats["errors"] != 0 or stats["completed"] != len(prompts):
        fail("serving: %d errors, %d of %d completed"
             % (stats["errors"], stats["completed"], len(prompts)))
    for r, p in zip(results, prompts):
        toks = np.asarray(r["tokens"])
        if toks.shape != (32,) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size or r["prompt_len"] != len(p):
            fail("serving: a result has the wrong shape or ids: %r" % (r,))
    if launches != cfg.num_layers * steps or steps == 0:
        fail("flash_fwd launched %d times over %d decode steps (want %d)"
             % (launches, steps, cfg.num_layers * steps))
    serve_launches = launches
    generated = sum(len(r["tokens"]) for r in results)
    print("  %d prompts, %d tokens in %.3f s: %.1f tokens/s, %d decode "
          "steps, token p50 %.3f ms p99 %.3f ms, flash_fwd launches %d "
          "(= %d x %d steps) [%s]"
          % (len(prompts), generated, wall, generated / wall, steps,
             stats["token_p50_ms"], stats["token_p99_ms"], launches,
             cfg.num_layers, steps, card))

    # phase 4 — f32 parity: flash vs reference decode vs greedy recompute
    print("phase 4: lm1b full width (f32): flash vs reference decode")
    cfg32 = lm.LMConfig.lm1b()
    prompts8 = prompts[:8]
    dcfg8 = DecodeConfig(slots=8, max_new_tokens=8, prefill_len=64)
    got = {}
    for attn in ("flash", "reference"):
        res, st, _, _, runner = serve(cfg32, loss_fn, params, batch, attn,
                                      dcfg8, prompts8)
        if st["errors"] != 0 or st["completed"] != len(prompts8):
            fail("parity %s: %d errors, %d completed"
                 % (attn, st["errors"], st["completed"]))
        got[attn] = [list(map(int, r["tokens"])) for r in res]
    if got["flash"] != got["reference"]:
        fail("flash and reference decode differ: %r vs %r"
             % (got["flash"], got["reference"]))
    from autodist_tpu_torch.models.layers import apply
    model32 = lm.make_model(cfg32)
    dev_params = runner.gather_params()
    with torch.inference_mode():
        for p, toks in zip(prompts8[:4], got["flash"][:4]):
            ids = list(map(int, p))
            want = []
            for _ in range(len(toks)):
                logits = apply(model32, dev_params,
                               torch.tensor([ids], device="cuda"))
                want.append(int(torch.argmax(logits[0, -1])))
                ids.append(want[-1])
            if want != toks:
                fail("decode diverged from greedy recompute: %r vs %r"
                     % (toks, want))
    print("  8 prompts: flash == reference token for token; 4 checked "
          "against greedy full recompute")

    train_launches = train_phase(card)
    train_parity_phase()

    # flash_fwd runs on both main paths, serving (decode) and training, the
    # backward kernels in training. Each record's top-level numbers are its
    # first path's; "by_path" gives each path's launches, times and bound
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    fwd = records["flash_fwd"]
    by_path = {"flash_fwd": {"serve": (serve_launches, fwd),
                             "train": (train_launches["flash_fwd"],
                                       fwd_train)}}
    for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
        by_path[name] = {"train": (train_launches[name], records[name])}
    for name, rec in records.items():
        rec["by_path"] = {path: dict({"launches": n},
                                     **{key: r[key] for key in timed})
                          for path, (n, r) in by_path[name].items()}
        rec["launches"] = sum(n for n, _ in by_path[name].values())
    fwd["max_abs_err"] = max(fwd["max_abs_err"], fwd_train["max_abs_err"])

    import autodist_tpu_torch as adt
    adt.reset()
    print("card: %s" % card_line())
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
