"""The lints of the step recorded as a program (``analysis/lowered.py``,
``analysis/numerics.py``, ``analysis/memory.py``'s ADT503,
``analysis/program.py``'s ADT510/511) against the JAX package's, on the
CPU, and the ``--programs`` mode of the plan CLI against the JAX CLI's.

- (c) Each seeded hazard gives the same code in both packages: ADT405,
  406, 407, 408, 409, 503, 510, 511, 601, 602, 603 and 605. The port's
  hazards are real recordings of steps that carry them (a loss that
  gathers a model-parallel weight whole, reads ``.item()``, issues a
  collective on one model rank only, all-reduces in bf16, round-trips a
  weight through bf16 or returns a bf16 loss; a one-variable overlapped
  plan; a fused ``donate=False`` superstep), or, for the cross-program
  codes, a real program beside a copy with two collectives swapped, a
  group changed or a dtype changed. The JAX hazards are the JAX tests'
  own (``tests/test_analysis.py``, ``test_overlap.py``,
  ``test_numerics.py``, ``test_hlo_analysis.py``) or the same mutation of
  a real JAX lowering. ADT407 is reached through a rank-dependent
  collective: the port records the program at each rank of the mesh.
- Honest builds lint clean in both packages (the MLP under AllReduce at
  N = 2, per step and fused).
- (d) ``--programs`` gives the JAX CLI's exit codes (0 on a clean
  train/eval pair, 1 on a reordered eval, with ADT510) and its JSON keys.

The N = 2 programs are recorded in this process on torch's ``fake``
backend (``tests/torch_program_cases.py``).
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_program_cases as C
from autodist_tpu import strategy as jS
from autodist_tpu.analysis import cli as jcli
from autodist_tpu.analysis import hlo as jhlo
from autodist_tpu.analysis import lowered as jlowered
from autodist_tpu.analysis import numerics as jnumerics
from autodist_tpu_torch import strategy
from autodist_tpu_torch.analysis import cli, numerics, program
from autodist_tpu_torch.convert import jax_named
from autodist_tpu_torch.parallel import mesh as mesh_lib
from test_numerics import EVAL_BF16, TEXT_MUTATIONS, TRAIN_F32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = C.one_thread()
    yield
    torch.set_num_threads(n)


def codes(diags):
    return sorted({d.code for d in diags})


# --------------------------------------------------------- port hazards

W_RULES = [(r"^w$", {0: "model"})]
W_BATCH = {"x": np.random.RandomState(3).randn(4, 16).astype(np.float32)}


def _w_params():
    return jax_named({"w": torch.tensor(
        np.random.RandomState(4).randn(8, 16).astype(np.float32))})


def loss_full_gather(p, b):
    """Gathers the model-parallel weight whole (ADT405)."""
    shard = p["w"].detach().contiguous()
    axis = mesh_lib.binding("model")
    full = shard.new_empty((shard.shape[0] * axis.size, shard.shape[1]))
    dist.all_gather_into_tensor(full, shard, group=axis.group)
    return torch.mean(torch.as_tensor(b["x"]) @ full.t()) + p["w"].sum() * 0


def loss_rank_branch(p, b):
    """A collective on model rank 0 only (ADT407)."""
    y = torch.as_tensor(b["x"]) @ p["w"].t()
    if mesh_lib.binding("model").index == 0:
        y = mesh_lib.psum(y, "model")
    return torch.mean(y)


def loss_item(p, b):
    """A host read in the step (ADT406; ADT408 in a fused microstep)."""
    h = torch.tanh(torch.as_tensor(b["x"]) @ p["w1"] + p["b1"])
    scale = float(torch.as_tensor(b["y"]).abs().mean().item()) + 1.0
    return torch.mean(((h @ p["w2"] + p["b2"]) - b["y"]) ** 2) / scale


def loss_bf16_sum(p, b):
    """A bf16 all-reduce of many elements (ADT601)."""
    h = torch.as_tensor(b["x"]) @ p["w1"]
    s = h.detach().to(torch.bfloat16).sum(0)
    dist.all_reduce(s)
    return torch.mean(h) + s.float().mean() * 0


def loss_roundtrip(p, b):
    """The f32 master through bf16 and back (ADT602)."""
    w = p["w1"].to(torch.bfloat16).to(torch.float32)
    return torch.mean((torch.as_tensor(b["x"]) @ w) ** 2)


def loss_bf16_return(p, b):
    """The loss returned in bf16 (ADT603)."""
    return torch.mean(torch.as_tensor(b["x"]) @ p["w1"]).to(torch.bfloat16)


def _swap_collectives(text):
    """``text`` with its first two collective lines of different payloads
    swapped: a drifted eval build."""
    lines = text.splitlines(True)
    idx = [i for i, ln in enumerate(lines) if "{collective=" in ln]
    first = idx[0]
    second = next(i for i in idx[1:] if lines[i].split("payload=")[1]
                  != lines[first].split("payload=")[1])
    lines[first], lines[second] = lines[second], lines[first]
    return "".join(lines)


@pytest.fixture(scope="module")
def port():
    out = {}
    loss, params = C.mlp_port()
    batch = C.MLP_BATCH
    r = C.port_runner(loss_item, params, batch, strategy.AllReduce())
    out["ADT406"] = r.lint_lowered(batch)
    out["ADT408"] = r.lint_lowered(batch, fuse_steps=2)
    for code, fn in (("ADT602", loss_roundtrip), ("ADT603", loss_bf16_return)):
        out[code] = C.port_runner(fn, params, batch,
                                  strategy.AllReduce()).lint_lowered(batch)
    r = C.port_runner(loss, params, batch, strategy.AllReduce())
    out["ADT503"] = r.memory_report(batch, fuse_steps=2,
                                    donate=False)["diagnostics"]
    with C.fake_world(2):
        r = C.port_runner(loss, params, batch, strategy.AllReduce(), n=2)
        out["clean"] = r.lint_lowered(batch) + r.lint_lowered(
            batch, fuse_steps=2) + r.lint_schedules(batch, fuse_steps=2)
        out["train"] = r.lowered_text(batch)
        out["eval"] = r.lowered_text(batch, program="eval")
        out["ADT601"] = C.port_runner(loss_bf16_sum, params, batch,
                                      strategy.AllReduce(),
                                      n=2).lint_lowered(batch)
        w1 = jax_named({"w": torch.tensor(np.random.RandomState(0).randn(
            4, 2).astype(np.float32))})
        b1 = {"x": np.random.RandomState(1).randn(8, 4).astype(np.float32),
              "y": np.random.RandomState(2).randn(8, 2).astype(np.float32)}
        out["ADT409"] = C.port_runner(
            lambda p, b: torch.mean((torch.as_tensor(b["x"]) @ p["w"]
                                     - torch.as_tensor(b["y"])) ** 2),
            w1, b1, strategy.AllReduce(chunk_size=1, overlap=True),
            n=2).lint_lowered(b1)
        out["overlap_clean"] = C.port_runner(
            loss, params, batch, strategy.AllReduce(chunk_size=1,
                                                    overlap=True),
            n=2).lint_lowered(batch)
        for code, fn in (("ADT405", loss_full_gather),
                         ("ADT407", loss_rank_branch)):
            out[code] = C.port_runner(
                fn, _w_params(), W_BATCH,
                strategy.TensorParallel(2, W_RULES), n=2
            ).lint_lowered(W_BATCH)
    out["ADT510"] = program.compare_schedules(
        out["train"], _swap_collectives(out["train"]), "train", "eval")
    out["ADT511"] = program.compare_schedules(
        out["train"], out["eval"].replace("group=[0,1]", "group=[1,0]"),
        "train", "eval")
    out["ADT605"] = numerics.lint_programs({
        "train": out["train"],
        "eval": out["eval"].replace("dtype=f32", "dtype=bf16")})
    return out


# ---------------------------------------------------------- JAX hazards

_J405 = """
  func.func @main(%arg0: tensor<4x16xf32>) -> tensor<8x16xf32> {
    %0 = "stablehlo.all_gather"(%arg0) : (tensor<4x16xf32>) -> tensor<8x16xf32>
    return %0 : tensor<8x16xf32>
  }
"""
_J406 = 'x = "stablehlo.custom_call"() {call_target_name = "SendToHost"}'
_J407 = """
  %1 = "stablehlo.if"(%pred) ({
    %2 = "stablehlo.all_reduce"(%arg0) : (tensor<4xf32>) -> tensor<4xf32>
    stablehlo.return %2 : tensor<4xf32>
  }, {
    stablehlo.return %arg0 : tensor<4xf32>
  }) : (tensor<i1>) -> tensor<4xf32>
"""
_J408 = """
b:f32[] = while[
  cond_jaxpr={ lambda ; a:f32[]. let
      c:bool[] = lt a 1.0
    in (c,) }
  body_jaxpr={ lambda ; a:f32[]. let
      d:f32[] = outfeed a
    in (d,) }
] x
"""
_J409 = """
    %0 = "stablehlo.all_reduce"(%g0) : tensor<64xf32>
    %1 = "stablehlo.all_reduce"(%g1) : tensor<64xf32>
"""


def _jax_swap(text):
    """test_hlo_analysis's reorder: the first two collective blocks of a
    real lowering swapped."""
    sched = jhlo.collective_schedule(text)
    lines = text.splitlines(True)

    def block(c):
        start = end = c.lineno - 1
        while "}) :" not in lines[end]:
            end += 1
        return "".join(lines[start:end + 1])
    b1, b2 = block(sched[0]), block(sched[1])
    return text.replace(b1, "@@TMP@@").replace(b2, b1).replace("@@TMP@@",
                                                               b2)


@pytest.fixture(scope="module")
def jax():
    jloss, jparams = C.mlp_jax()
    r = C.jax_runner(jloss, jparams, C.MLP_BATCH, jS.AllReduce(), n=2)
    train = r.lowered_text(C.MLP_BATCH)
    evaluation = r.lowered_text(C.MLP_BATCH, program="eval")
    mutations = {name: text for name, text, _, _ in TEXT_MUTATIONS}
    out = {
        "train": train, "eval": evaluation,
        "ADT405": jlowered.lint_lowered_text(
            _J405, mp_full_shapes={"w": (8, 16)}),
        "ADT406": jlowered.lint_lowered_text(_J406),
        "ADT407": jlowered.lint_lowered_text(_J407),
        "ADT408": jlowered.lint_lowered_text(_J408),
        "ADT409": jlowered.lint_lowered_text(_J409, overlap_armed=True),
        "ADT503": r.memory_report(C.MLP_BATCH, fuse_steps=2,
                                  donate=False)["diagnostics"],
        "ADT510": jhlo.compare_schedules(train, _jax_swap(train), "train",
                                         "eval"),
        "ADT511": jhlo.compare_schedules(
            train, evaluation.replace("dense<[[0, 1]]>", "dense<[[1, 0]]>"),
            "train", "eval"),
        "ADT601": jnumerics.lint_text(mutations["bf16_psum"]),
        "ADT602": jnumerics.lint_text(mutations["master_roundtrip"]),
        "ADT603": jnumerics.lint_text(mutations["half_loss_returned"]),
        "ADT605": jnumerics.compare_schedule_dtypes(TRAIN_F32, EVAL_BF16),
        "clean": r.lint_lowered(C.MLP_BATCH)
        + r.lint_schedules(C.MLP_BATCH, fuse_steps=2),
    }
    import autodist_tpu as jadt
    jadt.reset()
    return out


# ------------------------------------------------------------------ (c)


@pytest.mark.parametrize("code", ["ADT405", "ADT406", "ADT407", "ADT408",
                                  "ADT409", "ADT503", "ADT510", "ADT511",
                                  "ADT601", "ADT602", "ADT603", "ADT605"])
def test_seeded_hazard_gives_the_jax_code(port, jax, code):
    assert code in codes(port[code]), port[code]
    assert code in codes(jax[code]), jax[code]
    if code not in ("ADT510", "ADT511", "ADT605"):
        # a seeded step gives nothing else of its code's family (the
        # cross-program checks are given their programs' other findings)
        family = {c for c in codes(port[code]) if c[:5] == code[:5]}
        assert family <= {code, "ADT406"}, port[code]


def test_honest_builds_lint_clean_in_both(port, jax):
    assert port["clean"] == [] and jax["clean"] == []
    assert port["overlap_clean"] == []
    # the per-step program of the seeded .item() is ADT406, not ADT408;
    # its fused program is ADT408, not ADT406
    assert "ADT408" not in codes(port["ADT406"])
    assert "ADT406" not in codes(port["ADT408"])


def test_rank_programs_compare_by_collective_sequence(port):
    """ADT407's comparison alone: the same program at two ranks is
    clean; one rank with a collective less is flagged."""
    from autodist_tpu_torch.analysis.lowered import compare_ranks
    text = port["train"]
    assert compare_ranks({0: text, 1: text}) == []
    lines = [ln for ln in text.splitlines() if "{collective=" not in ln
             or "payload=4 " not in ln]
    diags = compare_ranks({0: text, 1: "\n".join(lines)})
    assert codes(diags) == ["ADT407"] and "rank 1" in diags[0].message


# ------------------------------------------------------------------ (d)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue()


def _keys(doc):
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in doc.items()
                if k not in ("outputs_by_label",)}
    if isinstance(doc, list):
        return [_keys(doc[0])] if doc else []
    return None


def test_programs_cli_matches_jax(port, jax, tmp_path):
    for pkg, main, data in (("port", cli.main, port),
                            ("jax", jcli.main, jax)):
        d = tmp_path / pkg
        d.mkdir()
        (d / "train.txt").write_text(data["train"])
        (d / "eval.txt").write_text(data["eval"])
        swapped = (_swap_collectives(data["train"]) if pkg == "port"
                   else _jax_swap(data["train"]))
        (d / "reordered.txt").write_text(swapped)
    results = {}
    for pkg, main in (("port", cli.main), ("jax", jcli.main)):
        d = tmp_path / pkg
        clean = _run(main, ["--programs", str(d / "train.txt"),
                            str(d / "eval.txt"), "--format", "json"])
        bad = _run(main, ["--programs", str(d / "train.txt"),
                          str(d / "reordered.txt")])
        results[pkg] = (clean[0], json.loads(clean[1]), bad)
    (rc, doc, bad), (jrc, jdoc, jbad) = results["port"], results["jax"]
    assert rc == jrc == 0 and doc["errors"] == jdoc["errors"] == 0
    assert _keys(doc) == _keys(jdoc)
    assert doc["programs"][0]["collectives"] == \
        jdoc["programs"][0]["collectives"] == 5
    assert bad[0] == jbad[0] == 1
    assert "ADT510" in bad[1] and "ADT510" in jbad[1]
