"""Multi-process jobs for the port's data-parallel tests, with no JAX.

The tests (``tests/test_torch_collectives.py``,
``tests/test_torch_data_parallel.py``, ``tests/test_torch_checkpoint.py``,
``tests/test_torch_fused.py``, ``tests/test_torch_zero.py``,
``tests/test_torch_partitioned.py``, ``tests/test_torch_overlap.py``,
``tests/test_torch_compute_tier.py``, ``tests/test_torch_recsys.py``,
``tests/test_torch_ps.py``, ``tests/test_torch_sparse.py``,
``tests/test_torch_optimizers.py``, ``tests/test_torch_fused_ps.py``,
``tests/test_torch_async_ps.py``, ``tests/test_torch_launch.py``) compute their JAX references in the pytest process and hand numpy arrays
to :func:`launch`, which starts
``world`` processes with the ``spawn`` start method. Each process joins a
gloo group made from a ``FileStore`` in the test's temporary directory
(no TCP port, so parallel test workers cannot clash), runs one job of
:data:`JOBS` on one torch thread and writes its result as a pickle of
numpy arrays; :func:`launch` returns the results in rank order. This
module imports torch and the port only: the spawned processes import it
and nothing of the tests.
"""
import functools
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LR = 1e-3


def launch(job: str, world: int, tmpdir, payload, device: str = "cpu"):
    """Run ``JOBS[job](payload, device)`` on ``world`` gloo ranks; returns
    each rank's result. A failure in any rank raises here with its
    traceback."""
    tmpdir = str(tmpdir)
    store = os.path.join(tmpdir, "store_%s" % job)
    if os.path.exists(store):
        os.remove(store)
    mp.start_processes(_entry, args=(job, world, store, payload, device,
                                     tmpdir),
                       nprocs=world, start_method="spawn")
    out = []
    for rank in range(world):
        with open(os.path.join(tmpdir, "%s_%d.pkl" % (job, rank)), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, job, world, store, payload, device, tmpdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        result = JOBS[job](payload, device)
        with open(os.path.join(tmpdir, "%s_%d.pkl" % (job, rank)), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _np(tree):
    from torch.utils import _pytree as pytree
    return pytree.tree_map(
        lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
        else t, tree)


def _t(tree, device):
    from torch.utils import _pytree as pytree
    return pytree.tree_map(
        lambda a: torch.as_tensor(a).to(device)
        if isinstance(a, np.ndarray) else a, tree)


# -------------------------------------------------------------- the jobs


def compressor_job(payload, device):
    """Each case's compressor (or the int8 two-phase all-reduce) on this
    rank's row of ``x`` and ``state``; returns ``{case: (reduced,
    new_state)}``. ``armed`` cases arm the int8 compressors' two-phase
    reduce over the default group, as ``bucket_reduce`` does."""
    from autodist_tpu_torch.kernel.synchronization import compressor as C
    from autodist_tpu_torch.kernel.synchronization.synchronizer import \
        all_reduce_sum
    from autodist_tpu_torch.parallel import collectives
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for case in payload:
        x = torch.as_tensor(case["x"][rank]).to(device)
        state = case.get("state")
        state = _t({k: v[rank] for k, v in state.items()}
                   if isinstance(state, dict) else
                   (state[rank] if state is not None else None), device)
        if case["compressor"] == "int8_block_all_reduce":
            out[case["name"]] = (collectives.int8_block_all_reduce(
                x, None, world), None)
            continue
        comp = C.create(case["compressor"], case.get("var_name", ""))
        if case.get("armed"):
            comp.ring_axes = ((None, world),)
        reduced, new_state = comp.reduce(x, state, all_reduce_sum)
        out[case["name"]] = (reduced, new_state)
    return _np(out)


TOWER_VOCAB, TOWER_DIM = 100_000, 16


def tower_setup(named: bool, batch_size: int, vocab: int = TOWER_VOCAB,
                tied: bool = False):
    """A DLRM-ish tower (the JAX sparse-wire tests' model): one lookup
    table, its rows through a dense head, squared error. ``named`` routes
    the lookup through ``embedding_lookup(name=...)``; ``tied`` also
    reads the table in the head (a dense use)."""
    from autodist_tpu_torch.ops.embedding import embedding_lookup
    rng = np.random.RandomState(0)
    params = {"emb.table": torch.from_numpy(
        (rng.randn(vocab, TOWER_DIM) * 0.1).astype(np.float32)),
        "head.weight": torch.from_numpy(
            (rng.randn(1, TOWER_DIM) * 0.1).astype(np.float32))}

    def loss_fn(p, batch):
        rows = embedding_lookup(p["emb.table"], torch.as_tensor(batch["ids"]),
                                name="emb.table" if named else None)
        pred = (rows @ p["head.weight"].t())[:, 0]
        if tied:
            pred = pred + (rows @ p["emb.table"][:TOWER_DIM]).sum(-1)
        return torch.mean((pred - torch.as_tensor(batch["y"])) ** 2)
    batch = {"ids": rng.randint(0, vocab, (batch_size,)).astype(np.int32),
             "y": rng.randn(batch_size).astype(np.float32)}
    return loss_fn, params, batch, None


def _setup(model: str, seq_len: int, batch_size: int, attention: str):
    from autodist_tpu_torch.models import bert, dlrm, lm, ncf
    if model in ("tower", "tower_unnamed"):
        return tower_setup(model == "tower", batch_size)
    if model == "ncf":
        return ncf.make_train_setup(ncf.NCFConfig.tiny(),
                                    batch_size=batch_size)
    if model in ("dlrm", "dlrm_wide"):
        return dlrm.make_train_setup(
            dlrm.DLRMConfig.tiny(wide=model == "dlrm_wide"),
            batch_size=batch_size)
    if model == "lm":
        return lm.make_train_setup(lm.LMConfig.tiny(), seq_len=seq_len,
                                   batch_size=batch_size,
                                   attention=attention, lean_head=True)
    return bert.make_train_setup(bert.BertConfig.tiny(), seq_len=seq_len,
                                 batch_size=batch_size, attention=attention)


def builder(spec):
    """The strategy builder a payload names: ``spec`` is a dict with
    ``builder`` (a class of ``autodist_tpu_torch.strategy``, default
    ``AllReduce``), its keyword arguments under ``strategy`` and an
    optional ``remat`` policy (``WithRemat`` around it)."""
    from autodist_tpu_torch import strategy
    b = getattr(strategy, spec.get("builder", "AllReduce"))(
        **spec.get("strategy", {}))
    if spec.get("remat"):
        b = strategy.WithRemat(b, spec["remat"])
    return b


def make_optimizer(spec=None):
    """The optimizer a payload names: ``None`` is Adam at ``LR``; else a
    dict with the ``torch.optim`` class name under ``cls``, its keywords
    under ``kw`` and an optional ``clip`` bound (``optim.chain`` of
    ``optim.clip_by_global_norm`` and the class)."""
    from autodist_tpu_torch import optim
    if spec is None:
        return functools.partial(torch.optim.Adam, lr=LR)
    factory = functools.partial(getattr(torch.optim, spec["cls"]),
                                **spec.get("kw", {}))
    if spec.get("clip") is not None:
        return optim.chain(optim.clip_by_global_norm(spec["clip"]), factory)
    return factory


def train_job(payload, device):
    """Each run of ``payload`` (a list) in turn: ``Runner.run`` steps of
    the port's plan (``builder``) on the global batches, from the given
    init, under the payload's ``optimizer`` (:func:`make_optimizer`), or
    one ``fit(fuse_steps=k)`` over them with ``fuse_steps`` given.
    Returns, for each run, the losses, an ``evaluate`` of the first batch
    before the steps, the final params, the optimizer state (as the port
    keeps it, and as the JAX saver flattens it: ``opt_jax``), the bucket
    keys and members, the sparse-wire tables, the ``sync_state`` keys,
    the runner's step count and, with host-PS variables, the store's
    names, counters and digest."""
    return [_train_one(run, device) for run in payload]


def _train_one(payload, device):
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import convert
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.telemetry import spans as tel
    tel.reset()
    world = dist.get_world_size()
    loss_fn, _, example, _ = _setup(payload["model"], payload["seq_len"],
                                    payload["batch_size"],
                                    payload["attention"])
    init = {n: torch.as_tensor(v) for n, v in payload["init"].items()}
    spec = ResourceSpec.from_dict({"nodes": [{
        "address": "127.0.0.1", "chief": True,
        "cpus": list(range(world))}]})
    ad = adt.AutoDist(strategy_builder=builder(payload), resource_spec=spec,
                      device=device)
    runner = ad.build(loss_fn, make_optimizer(payload.get("optimizer")),
                      init, payload.get("example", example))
    runner.init(init)
    dstep = runner.distributed_step
    evaluated = runner.evaluate(payload["batches"][:1])["loss"]
    if payload.get("fuse_steps", 1) > 1:
        losses = [float(m["loss"]) for m in runner.fit(
            iter(payload["batches"]), fuse_steps=payload["fuse_steps"])]
    else:
        losses = [float(runner.run(b)["loss"]) for b in payload["batches"]]
    state = runner.state
    opt = dstep.gather_opt_state(state)
    item = dstep.model_item
    out = {"losses": losses, "eval": float(evaluated),
           "params": _np(runner.gather_params()),
           "opt": _np(dict(opt)),
           "opt_jax": convert.opt_state_to_jax(opt, item.flax_shapes,
                                               item.optimizer_spec),
           "dispatches": dstep.dispatches,
           "buckets": [(b.key, list(b.var_names)) for b in dstep.buckets],
           "sparse_wire": sorted(dstep.sparse_wire),
           "sync_state": {k: sorted(v) for k, v in state.sync_state.items()},
           "steps": runner.step_stats()["steps"],
           "stored": {n: int(t.numel()) for n, t in state.params.items()},
           "stored_mu": {n: int(t.numel())
                         for n, t in state.opt_state.get("mu", {}).items()},
           "zero_shards": {n: int(z["mu"]["v"].numel()) for n, z in
                           state.sync_state.get("zero", {}).items()
                           if "mu" in z},
           "metadata": {k: v for k, v in dstep.metadata.items()
                        if isinstance(v, (bool, int, float, str, list))
                        or v is None},
           "counters": {k: v for k, v in tel.counters().items()
                        if k.startswith(("zero.", "overlap.", "sync.",
                                         "ps."))},
           "overlap_log": list(dstep.overlap_log)}
    infos = dstep.model_item.var_infos
    store = dstep.ps_store
    out.update(
        ps_jax_names=sorted(infos[n].collective_name for n in dstep.ps_names),
        sparse_wire_jax=sorted(infos[n].collective_name
                               for n in dstep.sparse_wire),
        stats=({k: store.stats[k] for k in ("pulls", "pushes",
                                            "bytes_pulled", "bytes_pushed")}
               if store is not None else None),
        ps_applies=store.stats["applies"] if store is not None else None,
        ps_digest=store.mirror_digest() if store is not None else None)
    adt.reset()
    return out


def ckpt_job(payload, device):
    """Checkpoints at N ranks, one payload (``train_job``'s keys and four
    batches): (1) restore ``jax_path`` (a JAX package checkpoint) and
    take step 3; (2) from ``init``, 2 steps, save into ``dir`` (rank 0
    writes), steps 3 and 4, restore the save and steps 3 and 4 again; (3)
    ``ADT_AUTO_RESUME`` over an empty directory, then over ``dir``.
    Returns each part's losses, params, saved paths and states."""
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.telemetry import spans as tel
    from autodist_tpu_torch.convert import FlaxParams
    world = dist.get_world_size()
    loss_fn, params, example, _ = _setup(payload["model"],
                                         payload["seq_len"],
                                         payload["batch_size"],
                                         payload["attention"])
    # the attention projections' flax shapes, which the files are in
    init = FlaxParams({n: torch.as_tensor(v)
                       for n, v in payload["init"].items()},
                      flax_shapes=params.flax_shapes)
    b = payload["batches"]
    spec = ResourceSpec.from_dict({"nodes": [{
        "address": "127.0.0.1", "chief": True,
        "cpus": list(range(world))}]})
    ad = adt.AutoDist(strategy_builder=builder(payload), resource_spec=spec,
                      device=device)
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=LR),
                      init, example)
    out = {}
    runner.init(init)
    _, step = Saver(payload["jax_dir"]).restore(runner)
    out["from_jax"] = {"step": step,
                       "sync_state": _np(runner.state.sync_state),
                       "loss": float(runner.run(b[2])["loss"]),
                       "params": _np(runner.gather_params())}
    runner.init(init)
    losses = [float(runner.run(x)["loss"]) for x in b[:2]]
    saver = Saver(payload["dir"])
    path = saver.save(runner)
    saves = tel.counters().get("ckpt.saves", 0.0)
    saved_sync = _np(runner.state.sync_state)
    losses += [float(runner.run(x)["loss"]) for x in b[2:]]
    final = _np(runner.gather_params())
    _, step = saver.restore(runner, os.path.join(payload["dir"], "ckpt-2"))
    restored_sync = _np(runner.state.sync_state)
    again = [float(runner.run(x)["loss"]) for x in b[2:]]
    out["own"] = {"losses": losses, "path": path, "saves": saves,
                  "step": step, "params": final, "again": again,
                  "params_again": _np(runner.gather_params()),
                  "saved_sync": saved_sync, "restored_sync": restored_sync}
    os.environ["ADT_AUTO_RESUME"] = "1"
    try:
        os.environ["ADT_CKPT_DIR"] = payload["empty_dir"]
        try:
            runner.init(init)
            out["resume_empty"] = "started fresh"
        except RuntimeError as e:
            out["resume_empty"] = str(e)
        os.environ["ADT_CKPT_DIR"] = payload["dir"]
        runner.init(init)
        out["resume_step"] = runner.state.step
    finally:
        del os.environ["ADT_AUTO_RESUME"], os.environ["ADT_CKPT_DIR"]
    adt.reset()
    return out


def ckpt_cross_job(payload, device):
    """Checkpoints of sharded plans across the packages, each case of
    ``payload`` (a list; ``train_job``'s keys, a ``builder``, four
    batches, ``jax_dir`` holding a JAX package checkpoint at step 2 and
    an empty ``dir``): restore the JAX checkpoint, gather the state in
    the JAX layout (flat ``{JAX name: numpy}`` as the files hold it) and
    take step 3; then from ``init`` take 2 steps and save into ``dir``
    (rank 0 writes). Returns each case's gathered files, step-3 loss and
    params, and the saved path."""
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import convert
    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.convert import FlaxParams
    from autodist_tpu_torch.resource_spec import ResourceSpec
    world = dist.get_world_size()
    out = []
    for case in payload:
        loss_fn, params, example, _ = _setup(case["model"], case["seq_len"],
                                             case["batch_size"],
                                             case["attention"])
        init = FlaxParams({n: torch.as_tensor(v)
                           for n, v in case["init"].items()},
                          flax_shapes=params.flax_shapes)
        spec = ResourceSpec.from_dict({"nodes": [{
            "address": "127.0.0.1", "chief": True,
            "cpus": list(range(world))}]})
        ad = adt.AutoDist(strategy_builder=builder(case), resource_spec=spec,
                          device=device)
        runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=LR),
                          init, example)
        dstep, item = runner.distributed_step, runner.distributed_step.model_item
        runner.init(init)
        _, step = Saver(case["jax_dir"]).restore(runner)
        files = {
            ".params.npz": convert.params_to_jax(runner.gather_params(),
                                                 item.flax_shapes),
            ".opt.npz": convert.opt_state_to_jax(
                dstep.gather_opt_state(runner.state), item.flax_shapes),
            ".sync.npz": convert.sync_state_to_jax(
                dstep.gather_sync_state(runner.state), item.var_infos,
                item.flax_shapes)}
        got = {"step": step, "files": files,
               "loss": float(runner.run(case["batches"][2])["loss"]),
               "params": _np(runner.gather_params()),
               "stored": {n: int(t.numel())
                          for n, t in runner.state.params.items()}}
        runner.init(init)
        for b in case["batches"][:2]:
            runner.run(b)
        got["path"] = Saver(case["dir"]).save(runner)
        out.append(got)
        adt.reset()
    return out


def fused_job(payload, device):
    """``fit(fuse_steps, metrics_every)`` of the port's AllReduce plan on
    the global batches from the given init; returns the losses, the
    final params, the dispatches and the runner's readbacks."""
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.resource_spec import ResourceSpec
    world = dist.get_world_size()
    loss_fn, _, example, _ = _setup(payload["model"], payload["seq_len"],
                                    payload["batch_size"],
                                    payload["attention"])
    init = {n: torch.as_tensor(v) for n, v in payload["init"].items()}
    spec = ResourceSpec.from_dict({"nodes": [{
        "address": "127.0.0.1", "chief": True,
        "cpus": list(range(world))}]})
    ad = adt.AutoDist(strategy_builder=strategy.AllReduce(),
                      resource_spec=spec, device=device)
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=LR),
                      init, example)
    runner.init(init)
    hist = runner.fit(iter(payload["batches"]),
                      fuse_steps=payload["fuse_steps"],
                      metrics_every=payload["metrics_every"])
    out = {"losses": [float(m["loss"]) for m in hist],
           "params": _np(runner.gather_params()),
           "dispatches": runner.distributed_step.dispatches,
           "readbacks": runner.readbacks}
    adt.reset()
    return out


ASYNC_BUILDERS = {
    "PSAsync": ("PS", {"sync": False}),
    "PSAsyncLB": ("PSLoadBalancing", {"sync": False}),
    "PSAsyncPart": ("PartitionedPS", {"sync": False}),
    "PSStale": ("PS", {"staleness": 2}),
}

# the group's collectives, counted while the async cases run
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "reduce_scatter_tensor", "broadcast", "barrier", "all_to_all",
                "all_gather_object", "broadcast_object_list", "send", "recv")


def _count_collectives() -> list:
    """Wrap the default group's collectives with a call counter; returns
    the one-element list it counts in."""
    calls = [0]
    for name in _COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None or getattr(fn, "_counted", False):
            continue

        def counted(*a, _fn=fn, **kw):
            calls[0] += 1
            return _fn(*a, **kw)
        counted._counted = True
        setattr(dist, name, counted)
    return calls


def async_job(payload, device):
    """Each case of ``payload["cases"]`` in turn (``ASYNC_BUILDERS``),
    on the coordination service at ``payload["ports"][case]``, as a two
    host job (rank 0 the chief ``127.0.0.1``, rank 1 ``localhost``):
    ``Runner.run`` steps on the JAX ``tests/dist_driver.py`` MLP. An async
    case ends with every push queued, every owner queue drained and a
    save (``PSAsyncPart``, under Adam); a stale case records, after each
    step, how far this rank was ahead of the slowest on the service.
    Returns each case's losses, ownership, counters, collective calls
    and, for the stale case, the gaps, the barrier spans and the mirror
    digest."""
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.runtime.coordination import CoordinationClient
    from autodist_tpu_torch.telemetry import spans as tel
    from autodist_tpu_torch import strategy
    rank = dist.get_rank()
    os.environ["ADT_NUM_PROCESSES"] = "2"
    os.environ["ADT_PS_MIRROR_CHECK_EVERY"] = "2"
    if rank:
        os.environ["ADT_WORKER"] = "localhost"
    spec = ResourceSpec.from_dict({"nodes": [
        {"address": "127.0.0.1", "chief": True, "cpus": [0]},
        {"address": "localhost", "cpus": [0]}]})
    batch = payload["batch"]

    def loss_fn(p, b):
        h = torch.tanh(torch.as_tensor(b["x"]) @ p["w1"] + p["b1"])
        return torch.mean((h @ p["w2"] - torch.as_tensor(b["y"])) ** 2)
    init = {n: torch.as_tensor(v) for n, v in payload["init"].items()}
    calls = _count_collectives()
    out = {}
    for case in payload["cases"]:
        port = payload["ports"][case]
        os.environ["ADT_COORDSVC_PORT"] = str(port)
        tel.reset()
        tel.configure("1")
        cls, kw = ASYNC_BUILDERS[case]
        opt = (functools.partial(torch.optim.Adam, lr=1e-2)
               if case == "PSAsyncPart" else
               functools.partial(torch.optim.SGD, lr=0.1))
        ad = adt.AutoDist(strategy_builder=getattr(strategy, cls)(**kw),
                          resource_spec=spec, device=device)
        runner = ad.build(loss_fn, opt, init, batch)
        runner.init(init)
        dstep = runner.distributed_step
        store = dstep.ps_store
        coord = CoordinationClient("127.0.0.1", port)
        calls0 = calls[0]
        losses, gaps = [], []
        for _ in range(payload["steps"]):
            losses.append(float(runner.run(batch)["loss"]))
            if not dstep.metadata["async"]:
                gaps.append(runner.step_stats()["steps"] - coord.min_step())
        res = {"losses": losses, "gaps": gaps,
               "async": dstep.metadata["async"],
               "staleness": dstep.metadata["staleness"],
               "replicas": dstep.num_replicas,
               "serving": store.serving,
               "pacing": runner._coord is not None}
        if store.serving:
            # every push queued, then every owner's queue empty, before
            # any process reads the published state
            dstep.flush_ps()
            coord.barrier(case + "/pushed", 2)
            store.drain()
            coord.barrier(case + "/drained", 2)
            if case == "PSAsyncPart":
                Saver(payload["ckpt_dir"]).save(runner)
            coord.barrier(case + "/saved", 2)
            res["owned"] = [h for h, g in store._serve_groups.items()
                            if g["owned"]]
            res["applied"] = store.applied_total()
            res["collectives"] = calls[0] - calls0
        else:
            dstep.flush_ps()
            res["digest"] = store.mirror_digest()
        spans = tel.get_recorder().summary()
        res["barrier_spans"] = int(spans.get("runner.barrier",
                                             {}).get("count", 0))
        res["counters"] = {k: v for k, v in tel.counters().items()
                           if k.startswith(("sync.", "ps."))}
        coord.close()
        adt.reset()
        tel.configure(None)
        out[case] = res
    return out


def broadcast_bytes_job(payload, device):
    """``server_starter.broadcast_bytes`` of each byte string of
    ``payload`` from rank 0 (the other ranks pass None); returns what
    this rank received."""
    from autodist_tpu_torch.runtime import server_starter
    rank = dist.get_rank()
    return [server_starter.broadcast_bytes(p if rank == 0 else None)
            for p in payload]


JOBS = {"compressors": compressor_job, "train": train_job, "ckpt": ckpt_job,
        "ckpt_cross": ckpt_cross_job, "fused": fused_job, "async": async_job,
        "broadcast_bytes": broadcast_bytes_job}
