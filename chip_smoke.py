#!/usr/bin/env python3
"""Chip smoke for autodist_tpu_torch: the port's main path on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
nvcc and PyTorch for CUDA. Phases, each fatal on failure (exit code 1, no
result line):

1. build every CUDA kernel of the path from ``autodist_tpu_torch/csrc``
   (one nvcc per source, started together) and print the card;
2. hold each kernel against its plain PyTorch version at the shapes the
   main path gives it (f32 at 2e-5, the JAX package's flash-decode bound;
   bf16 at 2e-2 atol/rtol: bf16 inputs, f32 accumulation in another
   order) and time the kernel, the plain version and one PyTorch library
   call computing the same function;
3. serve lm1b at full width in bf16 through the entry points a user calls
   (``AutoDist(...).build`` -> ``Runner.init`` -> ``DecodeEngine`` with
   ``decode_attn="flash"``): 64 prompts of mixed lengths through 32 slots;
   every future resolves, no errors, and the kernel ran exactly 8 times a
   decode step;
4. the same model in f32: flash decode and reference decode give the same
   tokens, and both equal greedy full recompute.

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
    return {"name": "flash_fwd", "route": "cuda",
            "source": "autodist_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "autodist_tpu/ops/flash_attention.py:97",
            "launches": 0, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


# ------------------------------------------------------------- phase 3/4


def device_profile(engine, prompts):
    """Serve ``prompts`` again under torch.profiler and print where the
    device time went: busy share of the window and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in [engine.submit(p) for p in prompts]:
            f.result(timeout=600)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if dev > 0:
            rows.append((dev, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        print("  device profile: not measured (the profiler saw no device "
              "time)")
        return
    print("  device profile over %d prompts: window %.1f ms, device busy "
          "%.1f ms (%.1f%%, idle %.1f%%)" % (
              len(prompts), window_us / 1e3, busy / 1e3,
              100 * busy / window_us, 100 * (1 - busy / window_us)))
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        print("    %6.2f%% of device time  %5d calls  %s"
              % (100 * dev / busy, count, key[:90]))


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
            device_profile(engine, profile_prompts)
    finally:
        engine.close()
    return results, stats, wall, launches, runner


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

    record = kernel_phase(card)

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
    record["launches"] = launches
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

    import autodist_tpu_torch as adt
    adt.reset()
    print("card: %s" % card_line())
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
