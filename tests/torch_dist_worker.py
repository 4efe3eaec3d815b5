"""Multi-process jobs for the port's data-parallel tests, with no JAX.

The tests (``tests/test_torch_collectives.py``,
``tests/test_torch_data_parallel.py``, ``tests/test_torch_checkpoint.py``,
``tests/test_torch_fused.py``, ``tests/test_torch_zero.py``,
``tests/test_torch_partitioned.py``, ``tests/test_torch_overlap.py``,
``tests/test_torch_compute_tier.py``, ``tests/test_torch_recsys.py``,
``tests/test_torch_ps.py``, ``tests/test_torch_sparse.py``,
``tests/test_torch_optimizers.py``, ``tests/test_torch_fused_ps.py``,
``tests/test_torch_async_ps.py``, ``tests/test_torch_launch.py``,
``tests/test_torch_tensor_parallel.py``, ``tests/test_torch_sentinel.py``,
``tests/test_torch_pipeline_parallel.py``,
``tests/test_torch_sequence_parallel.py``,
``tests/test_torch_expert_parallel.py``,
``tests/test_torch_schedules.py``,
``tests/test_torch_sharded_checkpoint.py``,
``tests/test_torch_serving_dist.py``, ``tests/test_torch_mesh_storage.py``,
``tests/test_torch_serving_mesh.py``) compute their JAX references in
the pytest process and hand numpy arrays
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


MLP_RULES = [(r"fc1/w$", {1: "model"}), (r"fc1/b$", {0: "model"}),
             (r"fc2/w$", {0: "model"})]


def mlp_loss(p, batch):
    """The JAX tensor-parallel tests' MLP (``tests/test_tensor_parallel.py``
    ``_mlp_loss``) over the port's ``parallel/tensor.py``."""
    from autodist_tpu_torch.parallel import tensor
    h = torch.relu(tensor.column_parallel_dense(
        torch.as_tensor(batch["x"]), p["fc1/w"], p["fc1/b"]))
    y = tensor.row_parallel_dense(h, p["fc2/w"], p["fc2/b"])
    return ((y - torch.as_tensor(batch["y"])) ** 2).mean()


def tp_job(payload, device):
    """Each case of ``payload`` (a list) on this rank: ``"ops"`` — the
    vocab-parallel embed, logits and xent with the vocab sharded over
    every rank (the mesh's model axis), and the xent's gradient on this
    rank's logits; ``"train"`` — ``TensorParallel(tp)`` over the MLP or
    ``tp_lm`` (``cfg``: ``TPLMConfig.tiny`` keywords) from ``init``, Adam
    at ``lr`` over ``batches`` (``freeze``: a variable kept frozen;
    ``save_dir``: a checkpoint saved after the steps). Returns each
    case's values."""
    return [_tp_case(case, device) for case in payload]


def _tp_case(case, device):
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.checkpoint import Saver
    from autodist_tpu_torch.convert import jax_named
    from autodist_tpu_torch.models import tp_lm
    from autodist_tpu_torch.parallel import mesh, tensor
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.telemetry import spans as tel
    world, rank = dist.get_world_size(), dist.get_rank()
    if case["kind"] == "ops":
        m = mesh.ProcessMesh({"model": world}, rank)
        m.build_groups()
        table = torch.as_tensor(case["table"])
        rows = table.shape[0] // world
        shard = table[rank * rows:(rank + 1) * rows]
        logits = tensor.vocab_parallel_logits(torch.as_tensor(case["x"]),
                                              shard).requires_grad_()
        with mesh.bind(m):
            emb = tensor.vocab_parallel_embed(shard, case["ids"])
            nll = tensor.vocab_parallel_xent(logits, case["targets"])
            grad, = torch.autograd.grad(nll.sum(), logits)
        return {"emb": _np(emb), "nll": _np(nll), "grad": _np(grad),
                "logits": _np(logits)}
    tel.reset()
    params = jax_named({n: torch.as_tensor(v)
                        for n, v in case["init"].items()})
    if case["model"] == "mlp":
        loss_fn, rules = mlp_loss, MLP_RULES
    else:
        loss_fn = tp_lm.make_loss(tp_lm.TPLMConfig.tiny(**case["cfg"]))
        rules = tp_lm.tp_rules()
    spec = ResourceSpec.from_dict({"nodes": [{
        "address": "127.0.0.1", "chief": True,
        "cpus": list(range(world))}]})
    ad = adt.AutoDist(strategy_builder=strategy.TensorParallel(
        case["tp"], rules), resource_spec=spec, device=device)
    freeze = case.get("freeze")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam,
                                                 lr=case["lr"]),
                      params, case["batches"][0],
                      trainable_filter=(lambda n: n != freeze)
                      if freeze else None)
    runner.init(params)
    dstep = runner.distributed_step
    losses = [float(runner.run(b)["loss"]) for b in case["batches"]]
    out = {"losses": losses, "params": _np(runner.gather_params()),
           "mp_axes": {n: lay.mp_axes for n, lay in dstep.mp_layouts.items()},
           "local_shapes": {n: tuple(t.shape)
                            for n, t in runner.state.params.items()},
           "opt_shapes": {n: tuple(t.shape) for n, t in
                          runner.state.opt_state["mu"].items()},
           "metadata": {k: dstep.metadata[k] for k in
                        ("mesh", "model_parallel", "buckets")},
           "stats": runner.step_stats(),
           "coords": dict(dstep.mesh.coords)}
    if case.get("save_dir"):
        out["saved"] = Saver(case["save_dir"]).save(runner)
    adt.reset()
    return out


def lin_loss(p, batch):
    """The JAX sentinel tests' linear problem (``tests/test_sentinel.py``
    ``_problem``)."""
    x, y = torch.as_tensor(batch["x"]), torch.as_tensor(batch["y"])
    return ((x @ p["w"] + p["b"] - y) ** 2).mean()


def big_loss(p, batch):
    """The JAX sentinel tests' sharded-storage problem."""
    x, y = torch.as_tensor(batch["x"]), torch.as_tensor(batch["y"])
    return (((x @ p["big"]) @ p["w"] - y) ** 2).mean()


def pinned(schedule: str = "auto", spec: str = "AUTO"):
    """``AllReduce()`` with every synchronizer's ``schedule`` (and
    ``spec``) pinned, as a user picks an all-reduce schedule."""
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.strategy.base import StrategyBuilder

    class Pinned(StrategyBuilder):
        def build(self, model_item, resource_spec):
            plan = strategy.AllReduce(all_reduce_spec=spec).build(
                model_item, resource_spec)
            for node in plan.node_config:
                if node.synchronizer is not None:
                    node.synchronizer.schedule = schedule
            return plan
    return Pinned()


def _case_runner(case, device):
    """Build -> init one case of the sentinel, schedule and sharded jobs:
    ``loss`` (``lin``, ``big``, ``mlp`` or ``tp_lm``), the builder
    (``pinned`` schedule, ``tp`` degree, or :func:`builder`'s keys), the
    optimizer (:func:`make_optimizer`), ``sentinel``, the resource spec's
    ``hosts`` (one node a host, the ranks split evenly) and ``init``.
    A gradient fault ``plan`` is in the environment for the build."""
    import json as _json
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.convert import jax_named
    from autodist_tpu_torch.models import tp_lm
    from autodist_tpu_torch.resource_spec import ResourceSpec
    world = dist.get_world_size()
    hosts = case.get("hosts", ["127.0.0.1"])
    per = world // len(hosts)
    spec = ResourceSpec.from_dict({"nodes": [
        dict({"address": h, "cpus": list(range(per))},
             **({"chief": True} if i == 0 else {}))
        for i, h in enumerate(hosts)]})
    loss_fn = {"lin": lin_loss, "big": big_loss, "mlp": mlp_loss}.get(
        case["loss"])
    rules = MLP_RULES
    if case["loss"] == "tp_lm":
        loss_fn = tp_lm.make_loss(tp_lm.TPLMConfig.tiny())
        rules = tp_lm.tp_rules()
    if "schedule" in case:
        b = pinned(case["schedule"], case.get("spec", "AUTO"))
    elif "tp" in case:
        b = strategy.TensorParallel(case["tp"], rules)
    else:
        b = builder(case)
    params = jax_named({n: torch.as_tensor(v)
                        for n, v in case["init"].items()})
    if case.get("plan"):
        os.environ["ADT_GRAD_FAULT_PLAN"] = _json.dumps(
            {"faults": case["plan"]})
    try:
        ad = adt.AutoDist(strategy_builder=b, resource_spec=spec,
                          device=device)
        runner = ad.build(loss_fn, make_optimizer(case.get("optimizer")),
                          params, case["batches"][0],
                          sentinel=case.get("sentinel", False))
    finally:
        os.environ.pop("ADT_GRAD_FAULT_PLAN", None)
    runner.init(params)
    return runner


def _verdicts(metrics):
    v = metrics.get("sentinel")
    return None if v is None else {k: float(t) for k, t in v.items()}


def sentinel_job(payload, device):
    """Each case of ``payload`` (:func:`_case_runner`'s keys, ``batches``):
    ``Runner.run`` over the batches; returns the losses, each step's
    verdict, the gathered params and whether the ranks' params are
    bit-equal."""
    import autodist_tpu_torch as adt
    out = []
    for case in payload:
        runner = _case_runner(case, device)
        ms = [runner.run(b) for b in case["batches"]]
        params = runner.gather_params()
        flat = torch.cat([t.reshape(-1) for t in params.values()])
        ref = flat.clone()
        dist.broadcast(ref, src=0)
        out.append({"losses": [float(m["loss"]) for m in ms],
                    "verdicts": [_verdicts(m) for m in ms],
                    "params": _np(params),
                    "ranks_equal": bool(torch.equal(flat, ref)),
                    "metadata": {k: runner.distributed_step.metadata[k]
                                 for k in ("sentinel_guards",
                                           "partitioned", "zero_sharded",
                                           "model_parallel")}})
        adt.reset()
    return out


def schedule_job(payload, device):
    """Each case of ``payload``: ``"psum"`` — this rank's row of ``x``
    summed by ``collectives.rhd_psum``, ``collectives.hierarchical_psum``
    over the ``hosts`` (a host a rank) and the ring; ``"train"`` —
    :func:`sentinel_job`'s run under a pinned ``schedule``."""
    from autodist_tpu_torch.parallel import collectives, mesh
    from autodist_tpu_torch.kernel.synchronization.synchronizer import \
        all_reduce_sum
    rank, world = dist.get_rank(), dist.get_world_size()
    out = []
    for case in payload:
        if case["kind"] == "psum":
            x = torch.as_tensor(case["x"][rank]).to(device)
            hg = mesh.HostGroups(case["hosts"], rank)
            out.append({"rhd": _np(collectives.rhd_psum(x, None, world)),
                        "hier": _np(collectives.hierarchical_psum(x, hg)),
                        "ring": _np(all_reduce_sum(x)),
                        "groups": (hg.n_inter, hg.n_intra)})
        else:
            res = sentinel_job([case], device)[0]
            out.append(res)
    return out


def sharded_job(payload, device):
    """Sharded checkpoints at N ranks, each case of ``payload``
    (:func:`_case_runner`'s keys, ``batches``): ``restore`` (a checkpoint
    base path, read by ``ShardedSaver``), then ``steps`` steps, then a
    save into ``save_dir`` when given, then ``more`` steps. Returns the
    losses, the gathered params and optimizer state after the restore
    (or the init) and after the steps, the state in the JAX layout, and
    the saved path and this rank's file bytes."""
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import convert
    from autodist_tpu_torch.checkpoint import ShardedSaver
    out = []
    for case in payload:
        runner = _case_runner(case, device)
        dstep = runner.distributed_step
        item = dstep.model_item
        res = {}

        def jax_state():
            # copies: on the CPU a tensor's numpy() shares its memory,
            # which the next steps update in place
            opt = dstep.gather_opt_state(runner.state)
            return {"params": {n: t.detach().cpu().numpy().copy() for n, t
                               in runner.gather_params().items()},
                    "opt_jax": convert.opt_state_to_jax(
                        opt, item.flax_shapes, item.optimizer_spec,
                        item.jax_names)}
        if case.get("restore"):
            saver = ShardedSaver(os.path.dirname(case["restore"]))
            _, res["restored_step"] = saver.restore(runner, case["restore"])
            res["restored"] = jax_state()
        batches = case["batches"]
        steps = case.get("steps", 0)
        res["losses"] = [float(runner.run(b)["loss"])
                         for b in batches[:steps]]
        if case.get("save_dir"):
            saver = ShardedSaver(case["save_dir"])
            res["saved"] = saver.save(runner)
            res["at_save"] = jax_state()
        res["more"] = [float(runner.run(b)["loss"])
                       for b in batches[steps:steps + case.get("more", 0)]]
        res["final"] = jax_state()
        res["local_shapes"] = {n: tuple(t.shape)
                               for n, t in runner.state.params.items()}
        out.append(res)
        adt.reset()
    return out


def pp_job(payload, device):
    """Each case of ``payload`` (a list) on this rank, the pipe axis over
    every rank unless a case says otherwise: ``"ppermute"`` — forward
    and gradient of ``sum(ppermute(x, perm) * w)`` for each ``perm``;
    ``"gpipe"`` / ``"interleaved"`` — the loss ``sum(y ** 2)`` of the
    primitive over ``ws`` (this rank's slice) and ``x`` and its
    gradients, with ``remat`` the saved-tensor bytes with and without
    ``remat_chunks``; ``"1f1b"`` — ``pipeline_loss_1f1b``'s loss and its
    gradients, and the stash's slots and peak; ``"train"`` —
    :func:`_pp_train`. Returns each case's values."""
    from autodist_tpu_torch.parallel import mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    out = []
    for case in payload:
        if case["kind"] == "train":
            out.append(_pp_train(case, device))
            continue
        m = mesh.ProcessMesh({"pipe": world}, rank)
        m.build_groups()
        with mesh.bind(m):
            out.append(_pp_primitive(case, rank, world))
    return out


def _pp_block(w, h):
    return torch.tanh(h @ w)


def _pp_primitive(case, rank, world):
    from autodist_tpu_torch.parallel import pipeline
    from autodist_tpu_torch.telemetry import spans as tel
    kind = case["kind"]
    if kind == "ppermute":
        x = torch.as_tensor(case["x"][rank]).requires_grad_()
        w = torch.as_tensor(case["w"][rank])
        res = []
        for perm in case["perms"]:
            y = pipeline.ppermute(x, perm)
            g, = torch.autograd.grad((y * w).sum(), x)
            res.append({"y": _np(y), "g": _np(g)})
        return res
    per = case["ws"].shape[0] // world
    ws = torch.as_tensor(case["ws"][rank * per:(rank + 1) * per]
                         ).requires_grad_()
    x = torch.as_tensor(case["x"]).requires_grad_()

    def stage_fn(w, h):
        return pipeline.stacked_scan(_pp_block, w, h)
    M = case["M"]
    if kind == "1f1b":
        hw = torch.as_tensor(case["hw"]).requires_grad_()
        tel.reset()

        def head_fn(hp, h, y):
            return ((h @ hp - y) ** 2).mean()
        loss = pipeline.pipeline_loss_1f1b(stage_fn, head_fn, ws, hw, x,
                                           torch.as_tensor(case["y"]), M)
        dws, dhw, dx = torch.autograd.grad(loss, (ws, hw, x))
        gauges = tel.gauges()
        return {"loss": _np(loss), "dstage": _np(dws), "dhead": _np(dhw),
                "dx": _np(dx), "stash_slots": gauges["pp.stash_slots"],
                "stash_peak": gauges["pp.stash_peak"]}

    def run(remat=False):
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            if kind == "gpipe":
                y = pipeline.pipeline_apply(stage_fn, ws, x, M)
            else:
                y = pipeline.pipeline_apply_interleaved(
                    stage_fn, ws, x, M, case["V"], remat_chunks=remat)
            loss = (y ** 2).sum()
        dws, dx = torch.autograd.grad(loss, (ws, x))
        return {"y": _np(y), "loss": _np(loss), "dstage": _np(dws),
                "dx": _np(dx), "saved_bytes": saved[0],
                "stages": pipeline.num_stages()}
    res = run()
    if case.get("remat"):
        res["remat"] = run(remat=True)
    return res


def _pp_train(case, device):
    """``PipelineParallel(pp, tp, n_microbatches, schedule)`` over
    ``pipe_lm`` (``TPLMConfig.tiny(num_layers=layers)``) from ``init``,
    Adam at ``lr`` and ``eps`` over ``batches``; ``sentinel`` with a gradient fault
    ``plan`` on the ranks ``plan_ranks`` (every rank by default); a
    ``ShardedSaver`` restore of ``restore_dir`` before the steps (none
    run then) or a save into ``save_dir`` after them."""
    import json as _json
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.checkpoint import ShardedSaver
    from autodist_tpu_torch.convert import jax_named
    from autodist_tpu_torch.models import pipe_lm
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.telemetry import spans as tel
    world = dist.get_world_size()
    tel.reset()
    sched, pp, tp, M = case["schedule"], case["pp"], case["tp"], case["M"]
    cfg = pipe_lm.TPLMConfig.tiny(num_layers=case["layers"])
    model_axis = "model" if tp > 1 else None
    loss_fn = pipe_lm.make_loss(
        cfg, M, schedule=sched, virtual_stages=2,
        pp_shards=pp if sched == "interleaved" else 0)
    params = jax_named({n: torch.as_tensor(v)
                        for n, v in case["init"].items()})
    spec = ResourceSpec.from_dict({"nodes": [{
        "address": "127.0.0.1", "chief": True,
        "cpus": list(range(world))}]})
    ad = adt.AutoDist(strategy_builder=strategy.PipelineParallel(
        pp_shards=pp, tp_shards=tp, n_microbatches=M, schedule=sched,
        mp_rules=pipe_lm.pp_rules(model_axis=model_axis)),
        resource_spec=spec, device=device)
    if case.get("plan") and dist.get_rank() in case.get(
            "plan_ranks", range(world)):
        os.environ["ADT_GRAD_FAULT_PLAN"] = _json.dumps(
            {"faults": case["plan"]})
    try:
        runner = ad.build(loss_fn, functools.partial(
            torch.optim.Adam, lr=case["lr"], eps=case["eps"]),
                          params, case["batches"][0],
                          mp_meta={"pp_schedule": sched,
                                   "pp_microbatches": M},
                          sentinel=case.get("sentinel", False))
    finally:
        os.environ.pop("ADT_GRAD_FAULT_PLAN", None)
    runner.init(params)
    dstep = runner.distributed_step
    restored = None
    if case.get("restore_dir"):
        _, restored = ShardedSaver(case["restore_dir"]).restore(runner)
    metrics = [runner.run(b) for b in case["batches"]] \
        if restored is None else []
    gathered = runner.gather_params()
    flat = torch.cat([t.reshape(-1) for t in gathered.values()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    out = {"losses": [float(mt["loss"]) for mt in metrics],
           "verdicts": [_verdicts(mt) for mt in metrics],
           "params": _np(gathered),
           "ranks_equal": bool(torch.equal(flat, ref)),
           "mp_axes": {n: lay.mp_axes for n, lay in dstep.mp_layouts.items()},
           "local_shapes": {n: tuple(t.shape)
                            for n, t in runner.state.params.items()},
           "opt_shapes": {n: tuple(t.shape) for n, t in
                          runner.state.opt_state["mu"].items()},
           "mesh": dict(dstep.mesh.axes), "coords": dict(dstep.mesh.coords),
           "counters": tel.counters(), "restored_step": restored}
    if case.get("save_dir"):
        out["saved"] = ShardedSaver(case["save_dir"]).save(runner)
    adt.reset()
    return out


def _counted(name):
    from autodist_tpu_torch.telemetry import spans as tel
    return tel.counters().get(name, 0.0)


def sp_job(payload, device):
    """Each case of ``payload`` (a list) on this rank, the seq axis over
    every rank for the primitives: ``"ring"`` / ``"ulysses"`` — the
    attention of this rank's chunks of ``q``, ``k``, ``v`` (``causal``;
    ``mask`` for Ulysses through ``make_attn_fn``), the gradients of
    ``sum(out ** 2)`` and the permutes counted in the forward and the
    backward (``expect_error``: Ulysses' ``ValueError`` text instead);
    ``"shift"`` — ``shift_left`` of this rank's chunk of ``tokens`` (int)
    and of ``x`` (float, with the gradient of ``sum(y * w)``);
    ``"wmean"`` — ``global_weighted_mean`` and ``global_mean`` of
    this rank's chunks and the gradient of the former; ``"train"`` —
    :func:`_mp_train`. Returns each case's values."""
    return [_mp_train(case, device) if case["kind"] == "train"
            else _sp_primitive(case) for case in payload]


def _sp_primitive(case):
    from autodist_tpu_torch.ops import attention
    from autodist_tpu_torch.parallel import mesh, sequence
    rank, world = dist.get_rank(), dist.get_world_size()
    m = mesh.ProcessMesh({"seq": world}, rank)
    m.build_groups()

    def chunk(a):
        t = torch.as_tensor(a)
        c = t.shape[1] // world
        return t[:, rank * c:(rank + 1) * c].clone()
    kind = case["kind"]
    with mesh.bind(m):
        if kind in ("ring", "ulysses"):
            q, k, v = [chunk(case[n]).requires_grad_() for n in "qkv"]
            if case.get("expect_error"):
                try:
                    attention.ulysses_attention(q, k, v)
                except ValueError as e:
                    return {"error": str(e)}
                return {"error": None}
            sends = _counted("sp.p2p_sends")
            if case.get("mask") is not None:
                fn = attention.make_attn_fn(kind, causal=case["causal"])
                out = fn(q, k, v, torch.as_tensor(case["mask"]))
            elif kind == "ring":
                out = attention.ring_attention(q, k, v, causal=case["causal"])
            else:
                out = attention.ulysses_attention(q, k, v,
                                                  causal=case["causal"])
            fwd = _counted("sp.p2p_sends") - sends
            grads = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
            bwd = _counted("sp.p2p_sends") - sends - fwd
            return {"out": _np(out), "grads": _np(list(grads)),
                    "fwd_sends": fwd, "bwd_sends": bwd,
                    "offset": sequence.position_offset(q.shape[1]),
                    "size": sequence.axis_size("seq")}
        if kind == "shift":
            tokens = chunk(case["tokens"])
            x = chunk(case["x"]).requires_grad_()
            y = sequence.shift_left(x)
            g, = torch.autograd.grad((y * chunk(case["w"])).sum(), x)
            return {"tokens": _np(sequence.shift_left(tokens)),
                    "y": _np(y), "g": _np(g)}
        vals = chunk(case["values"]).requires_grad_()
        wm = sequence.global_weighted_mean(vals, chunk(case["weights"]))
        g, = torch.autograd.grad(wm, vals)
        return {"wmean": _np(wm), "mean": _np(sequence.global_mean(vals)),
                "g": _np(g)}


def ep_job(payload, device):
    """Each case of ``payload`` (a list) on this rank, the expert axis
    over every rank for the primitive: ``"moe"`` — ``moe_ffn`` of this
    rank's rows of ``x`` with its slice of the expert stacks at
    ``capacity_factor``, the gradients of ``sum(out ** 2)`` (``x``, the
    router, this rank's ``w1``) and the all-to-all bytes; ``"train"`` —
    :func:`_mp_train`. Returns each case's values."""
    from autodist_tpu_torch.parallel import expert, mesh
    rank, world = dist.get_rank(), dist.get_world_size()
    out = []
    for case in payload:
        if case["kind"] == "train":
            out.append(_mp_train(case, device))
            continue
        m = mesh.ProcessMesh({"expert": world}, rank)
        m.build_groups()
        x = torch.as_tensor(case["x"])
        rows = x.shape[0] // world
        x = x[rank * rows:(rank + 1) * rows].clone().requires_grad_()
        per = case["w1"].shape[0] // world
        w = {n: torch.as_tensor(case[n][rank * per:(rank + 1) * per]
                                ).clone().requires_grad_()
             for n in ("w1", "b1", "w2", "b2")}
        router = torch.as_tensor(case["router_w"]).requires_grad_()
        before = _counted("ep.a2a_bytes")
        with mesh.bind(m):
            y, aux = expert.moe_ffn(x, router, w["w1"], w["b1"], w["w2"],
                                    w["b2"],
                                    capacity_factor=case["capacity_factor"])
            gx, gr, gw1 = torch.autograd.grad((y ** 2).sum(),
                                              (x, router, w["w1"]))
        out.append({"y": _np(y), "aux": _np(aux), "gx": _np(gx),
                    "grouter": _np(gr), "gw1": _np(gw1),
                    "a2a_bytes": _counted("ep.a2a_bytes") - before})
    return out


def seq_keys_loss(p, batch):
    """The JAX ``test_seq_keys_exempt_non_sequence_leaves`` loss: tokens
    [B, S] through a per-position feature, scaled per example by the mean
    of ``class_weights`` [B, C] (dim 1 classes, not a sequence)."""
    feat = torch.as_tensor(batch["tokens"])[..., None].float() @ \
        torch.ones((1, 8))
    pred = feat @ p["w"]
    w = torch.as_tensor(batch["class_weights"]).mean(dim=1)
    return ((pred ** 2).mean(dim=(1, 2)) * w).mean()


def _mp_setup(case):
    """(loss_fn, params, rules) of a training case's ``model``: ``lm``
    (``make_sp_train_setup``), ``tp_lm`` (``make_train_setup(attention=
    ...)``), ``moe_lm`` or ``seq_keys`` (:func:`seq_keys_loss`), with the
    case's config keywords; the params from the JAX package's numpy tree
    ``init``."""
    import dataclasses
    from autodist_tpu_torch import convert
    from autodist_tpu_torch.models import lm, moe_lm, tp_lm
    model, init = case["model"], case["init"]
    if model == "lm":
        cfg = dataclasses.replace(lm.LMConfig.tiny(), **case["cfg"])
        loss_fn = lm.make_sp_train_setup(
            cfg, seq_len=case["seq_len"], batch_size=8,
            attention=case["attention"])[0]
        return loss_fn, convert.params_from_jax(init), None
    if model == "tp_lm":
        loss_fn = tp_lm.make_loss(tp_lm.TPLMConfig.tiny(**case["cfg"]),
                                  attention=case["attention"])
        return loss_fn, convert.tp_lm_params_from_jax(init), \
            tp_lm.tp_rules()
    if model == "moe_lm":
        loss_fn = moe_lm.make_loss(moe_lm.MoEConfig.tiny(**case["cfg"]),
                                   aux_coef=case.get("aux_coef"))
        return loss_fn, convert.moe_lm_params_from_jax(init), \
            moe_lm.ep_rules()
    return seq_keys_loss, convert.jax_named(
        {n: torch.as_tensor(v) for n, v in init.items()}), None


def _mp_train(case, device):
    """A builder of ``autodist_tpu_torch.strategy`` (``builder``, its
    keywords ``kw``; ``rules`` the model's mp rules) over the case's
    model (:func:`_mp_setup`), Adam at ``lr`` and ``eps`` over
    ``batches`` (``frozen``: a name suffix kept frozen); ``expect_error``:
    the first step's ``ValueError`` text instead; a ``ShardedSaver`` save into ``save_dir`` after the steps.
    Returns the losses, the gathered params, whether every rank gathered
    the same, the layouts, each rank's shapes and mesh place, the
    counters, the first batch's shard on this rank."""
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.checkpoint import ShardedSaver
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.telemetry import spans as tel
    world = dist.get_world_size()
    tel.reset()
    loss_fn, params, rules = _mp_setup(case)
    kw = dict(case.get("kw", {}))
    if rules is not None:
        kw["mp_rules"] = rules
    spec = ResourceSpec.from_dict({"nodes": [{
        "address": "127.0.0.1", "chief": True,
        "cpus": list(range(world))}]})
    ad = adt.AutoDist(strategy_builder=getattr(strategy, case["builder"])(
        **kw), resource_spec=spec, device=device)
    frozen = case.get("frozen")
    runner = ad.build(loss_fn, functools.partial(
        torch.optim.Adam, lr=case["lr"], eps=case["eps"]), params,
        case["batches"][0],
        trainable_filter=(lambda n: not n.endswith(frozen))
        if frozen else None)
    runner.init(params)
    dstep = runner.distributed_step
    if case.get("expect_error"):
        try:
            runner.run(case["batches"][0])
            err = None
        except ValueError as e:
            err = str(e)
        adt.reset()
        return {"error": err}
    losses = [float(runner.run(b)["loss"]) for b in case["batches"]]
    gathered = runner.gather_params()
    flat = torch.cat([t.reshape(-1) for t in gathered.values()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    out = {"losses": losses, "params": _np(gathered),
           "ranks_equal": bool(torch.equal(flat, ref)),
           "mp_axes": {n: lay.mp_axes for n, lay in dstep.mp_layouts.items()},
           "local_shapes": {n: tuple(t.shape)
                            for n, t in runner.state.params.items()},
           "opt_shapes": {n: tuple(t.shape) for n, t in
                          runner.state.opt_state["mu"].items()},
           "mesh": dict(dstep.mesh.axes), "coords": dict(dstep.mesh.coords),
           "counters": tel.counters(),
           "shard": _np(runner.remapper.remap_feed(case["batches"][0])),
           "sparse_wire": sorted(dstep.sparse_wire)}
    if case.get("save_dir"):
        out["saved"] = ShardedSaver(case["save_dir"]).save(runner)
    adt.reset()
    return out


# ------------------------------------------------------------ serving


def scorer_fns():
    """``tests/test_serving.py``'s embedding scorer in torch: the loss, and
    a serve_fn with one per-example leaf (``score``) and two scalars — a
    float mean and an int max — that reduce over the ranks."""
    def loss_fn(p, batch):
        feat = p["emb"][torch.as_tensor(batch["ids"]).long()]
        pred = feat @ p["w"] + p["b"]
        return torch.mean((pred - torch.as_tensor(batch["y"])) ** 2)

    def serve_fn(p, batch):
        ids = torch.as_tensor(batch["ids"])
        score = p["emb"][ids.long()] @ p["w"] + p["b"]
        return {"score": score, "mean": torch.mean(score),
                "top": torch.max(ids)}
    return loss_fn, serve_fn


def _serve_runner(builder_name, loss_fn, params, batch, device,
                  optimizer=True):
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.resource_spec import ResourceSpec
    world = dist.get_world_size()
    spec = ResourceSpec.from_dict({"nodes": [{
        "address": "127.0.0.1", "chief": True,
        "cpus": list(range(world))}]})
    ad = adt.AutoDist(strategy_builder=getattr(strategy, builder_name)(),
                      resource_spec=spec, device=device)
    runner = ad.build(loss_fn, make_optimizer() if optimizer else None,
                      params, batch)
    runner.init(params)
    return runner


def _serve_engine_case(case, device):
    """``InferenceEngine`` at N ranks under ``case["builder"]``: the chief
    runs each request group of ``case["groups"]`` (the follower's loop
    serves them); every rank first calls ``Runner.predict`` and
    ``WrappedSession.predict`` on the whole batch (SPMD, the default
    group); the default buckets and a non-multiple bucket's error."""
    from autodist_tpu_torch.runtime.runner import WrappedSession
    from autodist_tpu_torch.serving import InferenceEngine, ServingConfig
    rank = dist.get_rank()
    loss_fn, serve_fn = scorer_fns()
    params = {n: torch.as_tensor(v) for n, v in case["params"].items()}
    runner = _serve_runner(case["builder"], loss_fn, params, case["batch"],
                           device)
    feats = {"ids": case["batch"]["ids"]}
    out = {"predict": runner.predict(feats, serve_fn),
           "session": WrappedSession(runner).predict(feats, serve_fn)}
    requests = case["requests"]
    try:
        InferenceEngine(runner, serve_fn, requests[0],
                        ServingConfig(buckets=(3,)))
    except ValueError as e:
        out["bad_bucket"] = str(e)
    default = InferenceEngine(runner, serve_fn, requests[0])
    out["default_buckets"] = list(default.buckets)
    default.close()
    engine = InferenceEngine(runner, serve_fn, requests[0],
                             ServingConfig(buckets=tuple(case["buckets"])))
    engine.warmup()
    if rank == 0:
        out["groups"] = [engine.run_batch(requests[:n])[0]
                         for n in case["groups"]]
        out["rows"] = engine.predict(requests[:3])
        engine.close()
    else:
        try:
            engine.run_batch(requests[:1])
        except ValueError as e:
            out["follower_run_batch"] = str(e)
        out["followed"] = engine.follow(timeout=120)
    out["batches"] = engine.stats["batches"]
    out["refreshes"] = engine.stats["snapshot_refreshes"]
    return _np(out)


def _serve_decode_case(case, device):
    """``DecodeEngine`` at N ranks on lm.tiny from the converted JAX init:
    the chief submits ``case["prompts"]`` (caps, EOS) and collects the
    tokens; every rank's stats; an indivisible slot count's error."""
    from autodist_tpu_torch.convert import params_from_jax
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.serving.decode import DecodeConfig, DecodeEngine
    rank = dist.get_rank()
    cfg = lm.LMConfig.tiny()
    loss_fn, _, batch, _ = lm.make_train_setup(cfg, seq_len=16,
                                               batch_size=8)
    params = params_from_jax(case["jax_params"])
    runner = _serve_runner("AllReduce", loss_fn, params, batch, device,
                           optimizer=False)
    setup = lm.make_decode_setup(cfg, case["decode_attn"])
    out = {}
    try:
        DecodeEngine(runner, setup, DecodeConfig(slots=3, prefill_len=8))
    except ValueError as e:
        out["bad_slots"] = str(e)
    engine = DecodeEngine(runner, setup, DecodeConfig(
        slots=8, max_new_tokens=8, prefill_len=8, eos_id=case["eos_id"]))
    engine.warmup()
    if rank == 0:
        futures = [engine.submit(p, max_new_tokens=m)
                   for p, m in zip(case["prompts"], case["caps"])]
        out["results"] = [f.result(timeout=120) for f in futures]
        engine.close()
    else:
        try:
            engine.submit(case["prompts"][0])
        except ValueError as e:
            out["follower_submit"] = str(e)
        out["followed"] = engine.follow(timeout=120)
        engine.close()
    out["stats"] = {k: v for k, v in engine.stats().items()
                    if isinstance(v, (int, float)) or v is None}
    out["cache_slots"] = int(engine._dev_k.shape[0])
    return _np(out)


def _serve_batcher_case(case, device):
    """``MicroBatcher`` at N ranks: four client threads on the chief
    submit ``case["requests"]`` concurrently; then, with the chief's
    dispatches held, a queue builds and ``preemption.drain_serving`` on
    the chief sheds it and stops the follower's loop."""
    import threading
    from autodist_tpu_torch.runtime import preemption
    from autodist_tpu_torch.serving import (InferenceEngine, MicroBatcher,
                                            ServingConfig, ServingUnavailable)
    rank = dist.get_rank()
    loss_fn, serve_fn = scorer_fns()
    params = {n: torch.as_tensor(v) for n, v in case["params"].items()}
    runner = _serve_runner(case["builder"], loss_fn, params, case["batch"],
                           device)
    requests = case["requests"]
    engine = InferenceEngine(runner, serve_fn, requests[0], ServingConfig(
        buckets=(2, 8), max_delay_ms=5.0)).warmup()
    mb = MicroBatcher(engine)
    out = {}
    if rank != 0:
        try:
            mb.submit(requests[0])
        except ValueError as e:
            out["follower_submit"] = str(e)
        out["followed"] = engine.follow(timeout=120)
        out["drained"] = mb.drain()
        return _np(out)
    rows = [None] * len(requests)

    def client(lo):
        for i in range(lo, len(requests), 4):
            rows[i] = mb.submit(requests[i]).result(timeout=60)["score"]
    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out["rows"] = rows
    out["stats"] = {k: mb.stats()[k] for k in ("requests", "fan_out",
                                                "batches", "errors", "shed")}
    hold = threading.Event()
    real_run = engine.run_batch

    def held(reqs):
        hold.wait(timeout=60)
        return real_run(reqs)
    engine.run_batch = held
    first = mb.submit(requests[0])
    while mb.queue_depth():
        threading.Event().wait(0.005)
    threading.Event().wait(0.1)     # the worker is inside the held run
    queued = [mb.submit(r) for r in requests[1:6]]
    threading.Timer(0.2, hold.set).start()
    out["shed"] = preemption.drain_serving(retry_after_s=2.5)
    out["first"] = first.result(timeout=60)["score"]
    typed = []
    for f in queued:
        try:
            f.result(timeout=10)
            typed.append(None)
        except ServingUnavailable as e:
            typed.append(e.retry_after_s)
    out["typed"] = typed
    try:
        mb.submit(requests[0])
    except ServingUnavailable as e:
        out["late"] = e.retry_after_s
    out["plane_stopped"] = engine._plane.stopped
    return _np(out)


def _serve_storage_case(case, device):
    """Serving over stored shards: the sentinel tests' sharded-storage
    problem under ``PartitionedAR()`` (each rank stores half of ``big``,
    gathered whole on the engine's group for each dispatch), and the
    tensor-parallel MLP under ``TensorParallel(2)``, served under its
    model axis by ``Runner.predict`` on every rank (each rank's slices,
    the axis bound), and its decode program built."""
    from autodist_tpu_torch.serving import InferenceEngine, ServingConfig
    rank = dist.get_rank()
    runner = _case_runner(dict(loss="big", init=case["big"],
                               batches=[case["big_batch"]],
                               builder="PartitionedAR"), device)

    def serve_fn(p, batch):
        return {"y": (torch.as_tensor(batch["x"]) @ p["big"]) @ p["w"]}
    xs = case["big_batch"]["x"]
    engine = InferenceEngine(runner, serve_fn, {"x": xs[0]},
                             ServingConfig(buckets=(4, 8))).warmup()
    out = {"stored": list(runner.state.params["big"].shape)}
    if rank == 0:
        out["y"] = engine.run_batch([{"x": x} for x in xs[:5]])[0]["y"]
        engine.close()
    else:
        engine.follow(timeout=120)
    import autodist_tpu_torch as adt
    adt.reset()
    runner = _case_runner(dict(loss="mlp", tp=2, init=case["mlp"],
                               batches=[case["mlp_batch"]]), device)
    dstep = runner.distributed_step
    out["tp_y"] = runner.predict({"x": case["mlp_batch"]["x"]},
                                 mlp_serve)["y"]
    out["tp_w1"] = list(runner.state.params["fc1/w"].shape)
    out["decode_local"] = dstep.decode_program(
        mlp_loss, {"token": torch.zeros(4, dtype=torch.int32)},
        slots=4) is not None
    return _np(out)


def mlp_serve(p, batch):
    """The tensor-parallel MLP's output (:func:`mlp_loss`'s prediction)."""
    from autodist_tpu_torch.parallel import tensor
    h = torch.relu(tensor.column_parallel_dense(
        torch.as_tensor(batch["x"]), p["fc1/w"], p["fc1/b"]))
    return {"y": tensor.row_parallel_dense(h, p["fc2/w"], p["fc2/b"])}



def _serve_faults_case(case, device):
    """Failures at N ranks under ``PS()``, every rank refreshing the
    snapshot at each dispatch (``snapshot_max_age_s=0``, one degraded
    batch): the follower's store pull fails at its 3rd and 4th pulls —
    the chief's 2nd request group then serves the follower's last
    snapshot, the 3rd sheds typed on every rank, the 4th recovers; a
    request that is not the feed's tree fails on every rank, and the
    next group serves."""
    from autodist_tpu_torch.serving import (InferenceEngine, ServingConfig,
                                            ServingUnavailable)
    rank = dist.get_rank()
    loss_fn, serve_fn = scorer_fns()
    params = {n: torch.as_tensor(v) for n, v in case["params"].items()}
    runner = _serve_runner("PS", loss_fn, params, case["batch"], device)
    dstep = runner.distributed_step
    if rank != 0:
        real_pull, pulls = dstep.pull_ps, []

        def pull():
            pulls.append(1)
            if len(pulls) in (3, 4):
                raise OSError("coordination service unreachable")
            return real_pull()
        dstep.pull_ps = pull
    requests = case["requests"]
    engine = InferenceEngine(runner, serve_fn, requests[0], ServingConfig(
        buckets=(4,), snapshot_max_age_s=0.0, degraded_batches=1)).warmup()
    out = {}
    if rank == 0:
        got = []
        for group in ([requests[:3]] * 4 + [[{"user": np.int64(0)}]]
                      + [requests[:3]]):
            try:
                got.append(engine.run_batch(group)[0]["score"])
            except ServingUnavailable as e:
                got.append("shed: %s" % e)
            except Exception as e:  # noqa: BLE001 — recorded
                got.append("error: %s" % type(e).__name__)
        out["got"] = got
        engine.close()
    else:
        out["followed"] = engine.follow(timeout=120)
    out["stats"] = dict(engine.stats)
    return _np(out)


# ------------------------------------ sharded storage beside a mesh axis


def storage_plan(base, zero=(), ps=(), part=None):
    """``base`` (a ``StrategyBuilder``) with its plan's nodes edited as a
    user pins storage: the variables in ``zero`` on
    ``ZeroShardedSynchronizer``, those in ``ps`` on host-resident PS, and
    each of ``part`` (``{name: partitioner}``) partitioned, each shard on
    the plain AllReduce."""
    from autodist_tpu_torch.strategy.base import (AllReduceSynchronizer,
                                                  PSSynchronizer,
                                                  StrategyBuilder, VarConfig,
                                                  ZeroShardedSynchronizer)
    part = dict(part or {})

    class Pinned(StrategyBuilder):
        def build(self, model_item, resource_spec):
            plan = base.build(model_item, resource_spec)
            for node in plan.node_config:
                n = node.var_name
                if n in zero:
                    node.synchronizer = ZeroShardedSynchronizer()
                elif n in ps:
                    node.synchronizer = PSSynchronizer(
                        reduction_destination="127.0.0.1")
                elif n in part:
                    node.partitioner = part[n]
                    node.part_configs = [
                        VarConfig(var_name="%s/part_%d" % (n, i),
                                  synchronizer=AllReduceSynchronizer())
                        for i in range(node.num_shards)]
            return plan
    return Pinned()


def _mesh_builder(case):
    """The case's base builder (``TensorParallel``, ``PipelineParallel``,
    ``ExpertParallel`` or ``SequenceParallelAR`` with ``kw``) under its
    storage pins, and the loss: ``tp_lm``, ``tp_lm`` with the ring
    attention, ``pipe_lm`` or ``moe_lm`` at their tiny configs (``lm``:
    ``TensorParallel`` with no rule, and no loss)."""
    from autodist_tpu_torch import strategy
    from autodist_tpu_torch.models import moe_lm, pipe_lm, tp_lm
    model, kw, loss_fn = case["model"], dict(case.get("kw", {})), None
    if model == "lm":
        kw["mp_rules"] = []         # the model axis shards nothing
    elif model == "pipe_lm":
        cfg = pipe_lm.TPLMConfig.tiny(num_layers=case["layers"])
        loss_fn = pipe_lm.make_loss(cfg, kw["n_microbatches"],
                                    schedule=kw["schedule"])
        kw["mp_rules"] = pipe_lm.pp_rules(model_axis=None)
    elif model == "moe_lm":
        loss_fn = moe_lm.make_loss(moe_lm.MoEConfig.tiny(**case["cfg"]),
                                   aux_coef=0.0)
        kw["mp_rules"] = moe_lm.ep_rules()
    else:
        loss_fn = tp_lm.make_loss(tp_lm.TPLMConfig.tiny(),
                                  attention=case.get("attention"))
        if case["builder"] == "TensorParallel":
            kw["mp_rules"] = tp_lm.tp_rules()
    base = getattr(strategy, case["builder"])(**kw)
    return storage_plan(base, case.get("zero", ()), case.get("ps", ()),
                        case.get("part")), loss_fn


def _mesh_train(case, device):
    """Adam at ``lr``/``eps`` over ``batches`` from ``init`` (the JAX
    names) under :func:`_mesh_builder`'s plan, per step or (``fuse``) as
    one fused superstep; a ``ShardedSaver`` save into ``save_dir`` after
    the steps. Returns the losses, the gathered
    params and optimizer state (the JAX saver's names), the layouts each
    rank stores, its ZeRO moments' shard size, the wire counters and the
    PS store's names."""
    import autodist_tpu_torch as adt
    from autodist_tpu_torch import convert
    from autodist_tpu_torch.checkpoint import ShardedSaver
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.telemetry import spans as tel
    world = dist.get_world_size()
    tel.reset()
    b, loss_fn = _mesh_builder(case)
    params = convert.jax_named({n: torch.as_tensor(v)
                                for n, v in case["init"].items()})
    spec = ResourceSpec.from_dict({"nodes": [{
        "address": "127.0.0.1", "chief": True,
        "cpus": list(range(world))}]})
    meta = ({"pp_schedule": case["kw"]["schedule"],
             "pp_microbatches": case["kw"]["n_microbatches"]}
            if case["model"] == "pipe_lm" else None)
    runner = adt.AutoDist(strategy_builder=b, resource_spec=spec,
                          device=device).build(
        loss_fn, functools.partial(torch.optim.Adam, lr=case["lr"],
                                   eps=case["eps"]),
        params, case["batches"][0], mp_meta=meta)
    runner.init(params)
    dstep = runner.distributed_step
    if case.get("fuse"):
        # one fused superstep over the batches: the host-PS variables in
        # the device carry, written back at the gathers below
        losses = [float(m["loss"]) for m in runner.fit(
            iter(case["batches"]), fuse_steps=len(case["batches"]))]
    else:
        losses = [float(runner.run(b)["loss"]) for b in case["batches"]]
    item = dstep.model_item
    opt = dstep.gather_opt_state(runner.state)
    zero = runner.state.sync_state.get("zero", {})
    out = {"losses": losses, "params": _np(runner.gather_params()),
           "opt_jax": convert.opt_state_to_jax(
               opt, item.flax_shapes, item.optimizer_spec, item.jax_names),
           "mesh": dict(dstep.mesh.axes), "coords": dict(dstep.mesh.coords),
           "partitioned": {n: tuple(runner.state.params[n].shape)
                           for n in dstep.layouts},
           "zero_shard": {n: tuple(zero[n]["mu"]["v"].shape)
                          for n in sorted(zero)},
           "ps": sorted(dstep.ps_names),
           "metadata": {k: dstep.metadata[k] for k in
                        ("zero_sharded", "partitioned", "ps_host_resident",
                         "model_parallel", "zero_rs_bytes_per_step")},
           "counters": {k: v for k, v in tel.counters().items()
                        if k.startswith("zero.")}}
    if case.get("save_dir"):
        out["saved"] = ShardedSaver(case["save_dir"]).save(runner)
    adt.reset()
    return out


def tp_serve_fn(cfg):
    """The last position's logits of ``tp_lm`` over the whole vocabulary:
    under a bound model axis each rank's vocab columns are put in place
    and summed over the axis (an all-gather in user code)."""
    from autodist_tpu_torch.models import tp_lm
    from autodist_tpu_torch.parallel import mesh

    def serve(p, batch):
        logits = tp_lm.forward(p, torch.as_tensor(batch["tokens"]),
                               cfg)[:, -1]
        b = mesh.binding("model")
        if b is not None:
            v = logits.shape[-1]
            full = logits.new_zeros(logits.shape[0], v * b.size)
            full[:, b.index * v:(b.index + 1) * v] = logits
            logits = mesh.psum(full, "model")
        return {"logits": logits}
    return serve


def moe_serve_fn(cfg):
    """The last position's logits of ``moe_lm`` (its experts routed over
    a bound expert axis)."""
    from autodist_tpu_torch.models import moe_lm

    def serve(p, batch):
        return {"logits": moe_lm.forward(
            p, torch.as_tensor(batch["tokens"]), cfg)[0][:, -1]}
    return serve


def _mesh_runner(case, device, loss_fn, params, batch):
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.resource_spec import ResourceSpec
    world = dist.get_world_size()
    spec = ResourceSpec.from_dict({"nodes": [{
        "address": "127.0.0.1", "chief": True,
        "cpus": list(range(world))}]})
    b, _ = _mesh_builder(case)
    # the host store keeps its variables' optimizer state: a PS plan
    # takes the optimizer it trained under
    runner = adt.AutoDist(strategy_builder=b, resource_spec=spec,
                          device=device).build(
        loss_fn, make_optimizer() if case.get("ps") else None, params,
        batch)
    runner.init(params)
    return runner


def _mesh_engine(case, device):
    """``InferenceEngine`` under the case's mesh plan over ``tp_lm`` or
    ``moe_lm`` from ``init``: the chief runs each group of ``requests``
    (its followers' loops serve them); every rank's rows a dispatch, its
    batch index and dispatch count."""
    from autodist_tpu_torch import convert
    from autodist_tpu_torch.models import moe_lm, tp_lm
    from autodist_tpu_torch.serving import InferenceEngine, ServingConfig
    rank = dist.get_rank()
    params = convert.jax_named({n: torch.as_tensor(v)
                                for n, v in case["init"].items()})
    if case["model"] == "moe_lm":
        cfg = moe_lm.MoEConfig.tiny(**case["cfg"])
        serve, loss_fn = moe_serve_fn(cfg), moe_lm.make_loss(cfg)
    else:
        cfg = tp_lm.TPLMConfig.tiny()
        serve, loss_fn = tp_serve_fn(cfg), tp_lm.make_loss(cfg)
    runner = _mesh_runner(case, device, loss_fn, params,
                          case["batch"])
    engine = InferenceEngine(runner, serve, case["requests"][0],
                             ServingConfig(buckets=case["buckets"]))
    out = {"replicas": runner.remapper.num_replicas,
           "batch_index": runner.remapper.replica_info.rank,
           "ps": sorted(runner.distributed_step.ps_names)}
    if rank == 0:
        out["groups"] = [engine.run_batch(case["requests"][:n])[0]
                         for n in case["groups"]]
        engine.close()
    else:
        out["followed"] = engine.follow(timeout=120)
    out["batches"] = engine.stats["batches"]
    out["refreshes"] = engine.stats["snapshot_refreshes"]
    return _np(out)


def _mesh_decode(case, device):
    """``DecodeEngine`` on lm.tiny under ``TensorParallel(tp, [])`` (the
    model axis shards nothing): the chief submits the prompts; every
    rank's slots and steps."""
    from autodist_tpu_torch.convert import params_from_jax
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.serving.decode import DecodeConfig, DecodeEngine
    rank = dist.get_rank()
    cfg = lm.LMConfig.tiny()
    loss_fn, _, batch, _ = lm.make_train_setup(cfg, seq_len=16,
                                               batch_size=8)
    params = params_from_jax(case["jax_params"])
    runner = _mesh_runner(case, device, loss_fn, params, batch)
    engine = DecodeEngine(runner, lm.make_decode_setup(cfg, "flash"),
                          DecodeConfig(slots=8, max_new_tokens=8,
                                       prefill_len=8))
    engine.warmup()
    out = {}
    if rank == 0:
        futures = [engine.submit(p, max_new_tokens=m)
                   for p, m in zip(case["prompts"], case["caps"])]
        out["results"] = [f.result(timeout=120) for f in futures]
        engine.close()
    else:
        out["followed"] = engine.follow(timeout=120)
        engine.close()
    out["steps"] = engine.stats_local["steps"]
    out["cache_slots"] = int(engine._dev_k.shape[0])
    return _np(out)


MESH_CASES = {"train": _mesh_train, "engine": _mesh_engine,
              "decode": _mesh_decode}


def mesh_job(payload, device):
    """Each case of ``payload`` (a list) in the same processes, in turn:
    ``{"name", "kind": train | engine | decode, ...}``; returns ``{name:
    this rank's result}``."""
    import autodist_tpu_torch as adt
    out = {}
    for case in payload:
        out[case["name"]] = MESH_CASES[case["kind"]](case, device)
        adt.reset()
    return out


SERVE_CASES = {"engine": _serve_engine_case, "decode": _serve_decode_case,
               "faults": _serve_faults_case,
               "batcher": _serve_batcher_case,
               "storage": _serve_storage_case}


def serve_job(payload, device):
    """Each case of ``payload`` (a list) in the same processes, in turn:
    ``{"name", "kind": engine | decode | batcher, ...}``; returns ``{name:
    this rank's result}``."""
    import autodist_tpu_torch as adt
    out = {}
    for case in payload:
        out[case["name"]] = SERVE_CASES[case["kind"]](case, device)
        adt.reset()
    return out


JOBS = {"compressors": compressor_job, "train": train_job, "ckpt": ckpt_job,
        "ckpt_cross": ckpt_cross_job, "fused": fused_job, "async": async_job,
        "broadcast_bytes": broadcast_bytes_job, "tp": tp_job,
        "sentinel": sentinel_job, "schedule": schedule_job,
        "sharded": sharded_job, "pp": pp_job, "sp": sp_job, "ep": ep_job,
        "serve": serve_job, "mesh": mesh_job}
