"""Shared cases of the program-pass parity tests
(``test_torch_lowered_program``, ``test_torch_memory_report``,
``test_torch_program_lints``): the MLP of ``tests/test_hlo_analysis.py``
in both packages from the same seeded numpy values, runners of either
package on one, two or eight ranks, and :func:`fake_world`, which makes
this process every rank of a job of N on torch's ``fake`` process-group
backend: each collective completes at once and moves nothing, so a
recording of a rank's program (which never runs a collective) needs no
peer process.
"""
import contextlib
import functools

import numpy as np
import torch
import torch.distributed as dist

LR = 1e-3
MLP_BATCH = {"x": np.random.RandomState(1).randn(32, 64).astype(np.float32),
             "y": np.random.RandomState(2).randn(32, 32).astype(np.float32)}


def spec_dict(n):
    return {"nodes": [{"address": "127.0.0.1", "chief": True,
                       "cpus": list(range(n))}]}


def mlp_values(seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": (rng.randn(64, 128) * 0.1).astype(np.float32),
            "b1": np.zeros((128,), np.float32),
            "w2": (rng.randn(128, 32) * 0.1).astype(np.float32),
            "b2": np.zeros((32,), np.float32)}


def mlp_port(seed=0):
    """(loss, params) of the port's MLP."""
    from autodist_tpu_torch.convert import jax_named

    def loss_fn(p, b):
        h = torch.tanh(torch.as_tensor(b["x"]) @ p["w1"] + p["b1"])
        return torch.mean(((h @ p["w2"] + p["b2"])
                           - torch.as_tensor(b["y"])) ** 2)
    return loss_fn, jax_named({n: torch.tensor(v)
                               for n, v in mlp_values(seed).items()})


def mlp_jax(seed=0):
    """(loss, params) of the JAX package's MLP (test_hlo_analysis's)."""
    import jax.numpy as jnp

    def loss_fn(p, b):
        h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
        return jnp.mean(((h @ p["w2"] + p["b2"]) - b["y"]) ** 2)
    return loss_fn, {n: jnp.asarray(v) for n, v in mlp_values(seed).items()}


@contextlib.contextmanager
def fake_world(n):
    """This process as every rank of a job of ``n`` on the ``fake``
    backend (rank 0's view); the group is gone on the way out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        import autodist_tpu_torch as adt
        adt.reset()
        dist.destroy_process_group()


def port_runner(loss_fn, params, batch, builder, n=1, **build_kw):
    """A port Runner over ``n`` ranks (the job of :func:`fake_world` when
    ``n > 1``), built and initialized on the CPU."""
    import autodist_tpu_torch as adt
    from autodist_tpu_torch.resource_spec import ResourceSpec
    adt.reset()
    ad = adt.AutoDist(resource_spec=ResourceSpec.from_dict(spec_dict(n)),
                      strategy_builder=builder, device="cpu")
    runner = ad.build(loss_fn, functools.partial(torch.optim.Adam, lr=LR),
                      params, batch, **build_kw)
    runner.init(params)
    return runner


def jax_runner(loss_fn, params, batch, builder, n=None):
    """A JAX Runner on ``n`` of the session's virtual devices (all eight
    when None)."""
    import optax
    import autodist_tpu as jadt
    from autodist_tpu.resource_spec import ResourceSpec as JSpec
    jadt.reset()
    kw = {} if n is None else {"resource_spec": JSpec.from_dict(spec_dict(n))}
    ad = jadt.AutoDist(strategy_builder=builder, **kw)
    runner = ad.build(loss_fn, optax.adam(LR), params, batch)
    runner.init(params)
    return runner


def one_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from contending with the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return n
