"""The liveness memory report of the step recorded as a program
(``analysis/memory.py``, ``Runner.memory_report``) against its closed
form and against the JAX package's report, on the CPU.

- (e) The MLP of ``tests/test_hlo_analysis.py`` (Adam, one replica): the
  estimate equals its closed form exactly. The arguments are the params
  P, Adam's count and moments (4 + 2P) and the batch; the donated step's
  only unaliased output is the 4-byte loss; its temporaries peak in the
  Adam update, where the gradients and the two bias-corrected moments
  (3P) and one 4-byte scalar are live — the backward's activations (the
  tanh output and the residual, live at its start) are freed by then,
  because the program is the eager step (ROADMAP C). Un-donated, the
  outputs (params, count, moments, loss) add in full. Hand-written
  programs give their known peaks.
- The report against JAX's for the same MLP: the same keys; arguments
  and outputs equal but for the JAX step counter (a 4-byte device scalar
  the port keeps on the host, ``TrainState.step``), the aliases equal
  but for it; under ZeroSharded at two ranks, a rank's arguments hold
  the moments' shards and the per-class collective bytes are JAX's; the
  temporaries differ by design (XLA fuses the update).
- The budget gate (ADT501 at a 1-byte budget, none at the spec's) and
  ADT503 on the fused ``donate=False`` superstep, as in JAX.
"""
import pytest
import torch

import torch_program_cases as C
from autodist_tpu import strategy as jS
from autodist_tpu_torch import strategy
from autodist_tpu_torch.analysis import memory, program

P = 4 * (64 * 128 + 128 + 128 * 32 + 32)        # MLP params, f32
BATCH = 4 * (32 * 64 + 32 * 32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = C.one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reports():
    loss, params = C.mlp_port()
    jloss, jparams = C.mlp_jax()
    out = {}
    r = C.port_runner(loss, params, C.MLP_BATCH, strategy.AllReduce())
    out["text"] = r.lowered_text(C.MLP_BATCH, donate=True)
    out["port"] = {d: r.memory_report(C.MLP_BATCH, donate=d)
                   for d in (True, False)}
    out["fused"] = {d: r.memory_report(C.MLP_BATCH, fuse_steps=2, donate=d)
                    for d in (True, False)}
    out["tiny_budget"] = r.memory_report(C.MLP_BATCH, hbm_budget_bytes=1)
    with C.fake_world(2):
        rz = C.port_runner(loss, params, C.MLP_BATCH, strategy.ZeroSharded(),
                           n=2)
        out["zero"] = rz.memory_report(C.MLP_BATCH)
    jr = C.jax_runner(jloss, jparams, C.MLP_BATCH, jS.AllReduce(), n=1)
    out["jax"] = {d: jr.memory_report(C.MLP_BATCH, donate=d)
                  for d in (True, False)}
    out["jax_fused"] = jr.memory_report(C.MLP_BATCH, fuse_steps=2,
                                        donate=False)
    jz = C.jax_runner(jloss, jparams, C.MLP_BATCH, jS.ZeroSharded(), n=2)
    out["jax_zero"] = jz.memory_report(C.MLP_BATCH)
    import autodist_tpu as jadt
    jadt.reset()
    return out


# ------------------------------------------------------------------ (e)


def test_mlp_estimate_equals_closed_form(reports):
    args = P + (4 + 2 * P) + BATCH
    temp = 3 * P + 4
    est = reports["port"][True]["estimate"]
    assert (est["args_bytes"], est["output_bytes"], est["aliased_bytes"],
            est["peak_temp_bytes"]) == (args, 3 * P + 4 + 4, 3 * P + 4, temp)
    assert reports["port"][True]["peak_hbm_bytes"] == args + 4 + temp
    assert est["outputs_by_label"] == {"params": P, "opt_state": 2 * P + 4,
                                       "metrics": 4}
    nodonate = reports["port"][False]
    assert nodonate["estimate"]["aliased_bytes"] == 0
    assert nodonate["peak_hbm_bytes"] == args + (3 * P + 4 + 4) + temp


def test_activations_live_at_the_start_of_the_backward(reports):
    """The sweep's live temporaries just before the first backward op:
    the tanh output h [32, 128] and the residual [32, 32] (f32), and the
    4-byte seed of the backward — the activations the closed form's
    backward phase holds."""
    prog = program.parse_program_text(reports["text"])
    entry = prog.entry
    keep = ({a.storage for a in entry.args}
            | {r.storage for r in entry.results})
    first_bwd = next(st.lineno for st in entry.statements if st.backward)
    live = {}
    events = [(st.lineno, sto, n) for st in entry.statements
              for sto, n in zip(st.storages, st.alloc_bytes) if n]
    events += [(f.lineno, f.storage, -f.nbytes) for f in entry.frees]
    for lineno, sto, n in sorted(events):
        if lineno >= first_bwd:
            break
        if sto in keep:
            continue
        if n > 0:
            live[sto] = n
        else:
            live.pop(sto, None)
    assert sorted(live.values()) == sorted([4 * 32 * 128, 4 * 32 * 32, 4])


FIXTURES = [
    # a temporary, a view of it, its free, then a second temporary
    ("""program @t fuse_steps=1 donate=false rank=0 ranks=1 device=cpu
arg %0 params['w'] : f32[16] s0 +64
arg %1 batch['x'] : f32[8] s1 +32
%2 = aten.mul.Tensor(%0, %0) : f32[16] s2 +64
%3 = aten.view.default(%2) : f32[4,4] s2
%4 = aten.add.Tensor(%3, %3) : f32[4,4] s3 +64
free s2 64
%5 = aten.sum.default(%4) : f32[] s4 +4
free s3 64
result %5 metrics['loss']
end
""", 96, 4, 0, 128),
    # the donated in-place update: the result aliases the argument
    ("""program @t fuse_steps=1 donate=true rank=0 ranks=1 device=cpu
arg %0 params['w'] : f32[16] s0 +64 donated
%1 = aten.mul.Tensor(%0, %0) : f32[16] s1 +64
%0 = aten.add_.Tensor(%0, %1) : f32[16] s0
free s1 64
result %0 params['w']
end
""", 64, 64, 64, 64),
    # a storage never freed stays live to the end
    ("""program @t fuse_steps=1 donate=false rank=0 ranks=1 device=cpu
arg %0 params['w'] : bf16[8] s0 +16
%1 = aten._to_copy.default(%0) : f32[8] s1 +32
%2 = aten.mul.Tensor(%1, %1) : f32[8] s2 +32
free s2 32
%3 = aten.sum.default(%1) : f32[] s3 +4
result %3 metrics['loss']
end
""", 16, 4, 0, 64),
]


@pytest.mark.parametrize("text,args,outs,aliased,temp", FIXTURES)
def test_hand_written_programs_give_known_peaks(text, args, outs, aliased,
                                                temp):
    est = memory.estimate_from_text(text)
    assert (est.args_bytes, est.output_bytes, est.aliased_bytes,
            est.peak_temp_bytes) == (args, outs, aliased, temp)
    assert est.peak_hbm_bytes == args + outs - aliased + temp


# ------------------------------------------------------------ vs JAX


@pytest.mark.parametrize("donate", (True, False))
def test_report_matches_jax_but_the_step_counter(reports, donate):
    got, want = reports["port"][donate], reports["jax"][donate]
    assert set(got) == set(want)
    assert set(got["estimate"]) == set(want["estimate"])
    assert set(got["collectives"]) == set(want["collectives"])
    g, w = got["estimate"], want["estimate"]
    assert g["args_bytes"] + 4 == w["args_bytes"]
    assert g["output_bytes"] + 4 == w["output_bytes"]
    assert g["aliased_bytes"] + (4 if donate else 0) == w["aliased_bytes"]
    assert got["budget_bytes"] == want["budget_bytes"]


def test_zero_sharded_report_per_rank(reports):
    """ZeroSharded at two ranks: a rank's arguments are the whole params,
    Adam's count, this rank's half of each moment with each variable's
    own count, and half the batch; the collectives per class are JAX's."""
    g = reports["zero"]["estimate"]
    assert g["args_bytes"] == P + 4 + 2 * (P // 2) + 4 * 4 + BATCH // 2
    assert reports["zero"]["collectives"]["per_class_payload_bytes"] == \
        reports["jax_zero"]["collectives"]["per_class_payload_bytes"]


def test_budget_and_donation_diagnostics_as_jax(reports):
    def codes(rep):
        return [d.code for d in rep["diagnostics"]]
    assert codes(reports["port"][True]) == []
    assert reports["port"][True]["utilization"] < 0.01
    assert codes(reports["tiny_budget"]) == ["ADT501"]
    assert codes(reports["fused"][True]) == []
    assert codes(reports["fused"][False]) == ["ADT503"] == \
        codes(reports["jax_fused"])
    assert memory.donation_diagnostics(reports["text"], fuse_steps=1) == []
