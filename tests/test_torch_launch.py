"""The port's launch tools (``repro_torch.launch``: specs, roofline,
dryrun, report, fill_experiments) and the abstract shapes they need
(``models.model.abstract_params`` / ``abstract_cache``,
``optim.abstract_opt_state``) against the JAX package's, on the CPU.

The reference's launch modules force 512 host devices when imported, so
every call into them runs in one subprocess for the whole file (``python
tests/test_torch_launch.py OUT``), which writes its results to a JSON
file; the one JAX compile is the reference's ``lower_compile`` of a
reduced llama3.2-1b train step on a (1, 1) mesh.  The port's dry-run
traces on ``meta`` tensors; here it is held against the same steps run
on CPU tensors under the same counter (the plain versions forced on
both), against hand counts and against its own decomposition.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ASSIGNED, SHAPES, ShapeConfig, get_config
from repro_torch.configs.base import shape_applicable
from repro_torch.core import tree
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import fill_experiments, report
from repro_torch.launch import roofline as RL
from repro_torch.launch.specs import input_specs
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.optim import OptConfig, abstract_opt_state, init_opt_state
from torch_threads import one_thread  # noqa: F401 (one thread)

SMALL_TRAIN = ShapeConfig("small", 32, 2, "train")
SPEC_ARCHS = ("llama3.2-1b", "whisper-tiny", "llama-3.2-vision-90b",
              "mamba2-780m")
COLLECTIVE_GROUPS = (2, 4, 16)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def hlo_line(kind: str, g: int) -> str:
    """One collective of the optimized HLO's text, over ``g`` devices."""
    groups = "{{" + ",".join(str(i) for i in range(g)) + "}}"
    attr = (f"source_target_pairs={{{{0,1}},{{1,0}}}}"
            if kind == "collective-permute" else f"replica_groups={groups}")
    return (f"  %{kind}.7 = bf16[64,1024]{{1,0}} {kind}(bf16[64,1024]{{1,0}} "
            f"%p0), channel_id=3, {attr}")


def _leaves(t) -> dict:
    return {p: [list(x.shape), str(x.dtype).removeprefix("torch.")]
            for p, x in tree.leaves_with_paths(t)}


# ---------------------------------------------------------------------------
# the reference, in a subprocess
# ---------------------------------------------------------------------------

def _reference_main(out_path: str, cells_path: str) -> None:
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    from repro.launch import dryrun as RD      # forces 512 host devices
    import jax

    from repro.configs import SHAPES as RS
    from repro.configs import get_config as rget
    from repro.configs.base import ShapeConfig as RShape
    from repro.configs.base import shape_applicable as rapplicable
    from repro.launch import report as RR
    from repro.launch import roofline as RRL
    from repro.launch import specs as RSP
    from repro.models import model as RM
    from repro.optim import OptConfig as ROpt
    from repro.optim import abstract_opt_state as r_abstract_opt_state
    from repro.sharding import Annotated, make_mesh

    def leaves(t) -> dict:
        paths = jax.tree_util.tree_flatten_with_path(
            t, is_leaf=lambda x: isinstance(x, Annotated))[0]
        return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path): [list(x.shape),
                                          np.dtype(x.dtype).name]
                for path, x in paths}

    mesh = make_mesh((1, 1), ("data", "model"))
    out = {"params": {}, "cache": {}, "active": {}, "model_flops": {},
           "specs": {}, "opt": {}, "collective": {}}
    for arch in ASSIGNED:
        cfg = rget(arch)
        out["params"][arch] = leaves(RM.abstract_params(cfg))
        out["active"][arch] = RRL.active_param_count(cfg)
        out["model_flops"][arch] = [
            RRL.model_flops(cfg, tokens=4096 * 256, training=True),
            RRL.model_flops(cfg, tokens=32, training=False)]
        for name in ("decode_32k", "long_500k"):
            shape = RS[name]
            if rapplicable(cfg, shape)[0]:
                out["cache"][f"{arch}/{name}"] = leaves(RM.abstract_cache(
                    cfg, shape.global_batch, shape.seq_len,
                    long_context=shape.seq_len >= 262144))
    for arch in SPEC_ARCHS:
        cfg = rget(arch)
        for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if rapplicable(cfg, RS[name])[0]:
                out["specs"][f"{arch}/{name}"] = leaves(
                    RSP.input_specs(cfg, RS[name], mesh))
    llama = RM.abstract_params(rget("llama3.2-1b"))
    for kind in ("sgd", "momentum", "adamw"):
        out["opt"][kind] = leaves(r_abstract_opt_state(ROpt(kind=kind),
                                                       llama))
    s = SMALL_TRAIN
    out["arg_bytes"] = RD.lower_compile(
        rget("llama3.2-1b").reduced(),
        RShape(s.name, s.seq_len, s.global_batch, s.kind), mesh, ROpt(),
        want_text=False)["arg_bytes"]
    for kind in KINDS:
        for g in COLLECTIVE_GROUPS:
            out["collective"][f"{kind}/{g}"] = RRL.collective_bytes(
                hlo_line(kind, g))[kind]
    with open(cells_path) as fh:
        cells = json.load(fh)
    out["tables"] = {"dryrun": RR.dryrun_table(cells["reg"]),
                     "roofline": RR.roofline_table(cells["reg"]),
                     "bft": RR.bft_table(cells["bft"])}
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    print("REFERENCE_DONE")


# ---------------------------------------------------------------------------
# the port, in the test process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cells():
    """Cells of the port's dry-run for the report: a traced cell, a
    skipped one, a failed one, and the BFT steps of a reduced model."""
    reg = [D.run_cell("whisper-tiny", "decode_32k"),
           D.run_cell("llama3.2-1b", "long_500k"),
           {"arch": "gemma3-1b", "shape": "train_4k", "mesh": "1xH100",
            "error": "out of memory on the way"}]
    with pytest.MonkeyPatch.context() as mp:      # a reduced model
        mp.setattr(D, "get_config", lambda a: get_config(a).reduced())
        bft = [D.run_bft_cells("llama3.2-1b", n=4, f=1, global_batch=4,
                               seq_len=8),
               {"arch": "whisper-tiny", "error": "attends to a context"}]
    return json.loads(json.dumps({"reg": reg, "bft": bft}))


@pytest.fixture(scope="module")
def ref(cells, tmp_path_factory):
    d = tmp_path_factory.mktemp("launch_ref")
    with open(d / "cells.json", "w") as fh:
        json.dump(cells, fh)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(d / "ref.json"),
         str(d / "cells.json")],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0 and "REFERENCE_DONE" in proc.stdout, \
        proc.stderr[-4000:]
    with open(d / "ref.json") as fh:
        return json.load(fh)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_abstract_params_match_reference(ref, arch):
    cfg = get_config(arch)
    got = M.abstract_params(cfg)
    assert all(t.is_meta for t in tree.leaves(got))
    assert _leaves(got) == ref["params"][arch]
    small = _leaves(M.abstract_params(cfg.reduced()))
    assert small == _leaves(M.init_train(cfg.reduced(), 0, "cpu"))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_abstract_cache_matches_reference(ref, arch):
    cfg = get_config(arch)
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES[name]
        key = f"{arch}/{name}"
        if not shape_applicable(cfg, shape)[0]:
            assert key not in ref["cache"]
            continue
        got = M.abstract_cache(cfg, shape.global_batch, shape.seq_len,
                               long_context=shape.seq_len >= 262144)
        assert _leaves(got) == ref["cache"][key]
    small = cfg.reduced()
    assert _leaves(M.abstract_cache(small, 2, 40)) == _leaves(
        M.allocate_cache(small, 2, 40, "cpu"))


@pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
def test_abstract_opt_state_matches_reference(ref, kind):
    params = M.abstract_params(get_config("llama3.2-1b"))
    got = abstract_opt_state(OptConfig(kind=kind), params)
    assert all(t.is_meta for t in tree.leaves(got))
    assert _leaves(got) == ref["opt"][kind]
    small = M.init_train(get_config("llama3.2-1b").reduced(), 0, "cpu")
    assert _leaves(abstract_opt_state(OptConfig(kind=kind), small)) == \
        _leaves(init_opt_state(OptConfig(kind=kind), small))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_active_params_and_model_flops_match_reference(ref, arch):
    cfg = get_config(arch)
    assert RL.active_param_count(cfg) == ref["active"][arch]
    assert [RL.model_flops(cfg, tokens=4096 * 256, training=True),
            RL.model_flops(cfg, tokens=32, training=False)] == \
        ref["model_flops"][arch]


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_input_specs_match_reference(ref, arch):
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        key = f"{arch}/{name}"
        if not shape_applicable(cfg, shape)[0]:
            continue
        got = _leaves(input_specs(cfg, shape))
        assert got == ref["specs"][key], key


def test_arg_bytes_match_reference_compile(ref):
    got = D.lower_compile(get_config("llama3.2-1b").reduced(), SMALL_TRAIN)
    assert got["arg_bytes"] == ref["arg_bytes"]


# the steps of reduced models on meta tensors and on CPU tensors under
# the same counter, the plain versions forced on both
COUNT_ARCHS = ("llama3.2-1b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
               "whisper-tiny")


def _materialize(specs, cfg) -> dict:
    """The specs' inputs as CPU tensors: seeded weights, tokens and
    contexts, zero optimizer state and cache."""
    g = torch.Generator().manual_seed(1)

    def fill(t):
        if not t.is_meta:
            return t
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, t.shape, generator=g,
                                 dtype=t.dtype)
        return torch.randn(t.shape, generator=g).to(t.dtype)

    out = {k: M.map_params(fill, v) for k, v in specs.items()}
    out["params"] = M.init_train(cfg, 0, "cpu")
    if "opt_state" in out:
        out["opt_state"] = init_opt_state(OptConfig(), out["params"])
    if "cache" in out:
        out["cache"] = M.map_params(lambda t: torch.zeros(
            t.shape, dtype=t.dtype), specs["cache"])
    return out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", COUNT_ARCHS)
def test_meta_counts_equal_cpu_counts(arch, kind):
    cfg = get_config(arch).reduced()
    shape = ShapeConfig(kind, 40 if kind == "decode" else 32, 2, kind)
    specs = input_specs(cfg, shape)
    step = D.step_for(cfg, kind, OptConfig(), impl="torch")
    _, meta = D.count_step(step, D.step_args(specs, kind), "meta")
    real = _materialize(specs, cfg)
    _, cpu = D.count_step(step, D.step_args(real, kind), "cpu")
    for key in ("flops", "flops_by_dtype", "bytes", "arg_bytes",
                "out_bytes", "temp_bytes", "peak_bytes"):
        assert meta[key] == cpu[key], key
    assert meta["flops"] > 0 and meta["temp_bytes"] > 0


def test_dense_prefill_flops_equal_hand_count():
    """One dense layer's prefill: its projections, MLP, K6 (causal) and
    the last position's unembed, 2 FLOPs a multiply-add."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              num_layers=1)
    B, S = 3, 48
    D_, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    F, V = cfg.d_ff, cfg.vocab_size
    gemms = 2 * B * S * D_ * (H * hd + 2 * K * hd) + 2 * B * S * H * hd * D_
    gemms += 3 * 2 * B * S * D_ * F + 2 * B * D_ * V
    attention = 4 * B * H * hd * (S * (S + 1) // 2)
    got = D.lower_compile(cfg, ShapeConfig("p", S, B, "prefill"))
    assert got["flops"] == gemms + attention
    assert got["kernels"]["flash_attention"] == {
        "calls": 1, "flops": attention,
        "bytes": (2 * B * S * H * hd + 2 * B * S * K * hd) * 2}


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "gemma3-1b"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_decomposition_equals_full_trace(arch, kind):
    cfg = get_config(arch).reduced()
    shape = ShapeConfig(kind, 32, 2, kind)
    full = D.lower_compile(cfg, shape)
    dec = D.cost_by_decomposition(cfg, shape)
    assert dec["method"] == "period_decomposition"
    assert dec["flops"] == full["flops"]


def test_prefill_32k_uses_k6_shape_only_form():
    """At llama3.2-1b's prefill_32k the dry-run's temporaries stay below
    one layer's (B, H, S, S) f32 score matrix, which K6 never makes (the
    plain version's blocks would be counted)."""
    res = D.run_cell("llama3.2-1b", "prefill_32k")
    cfg, shape = get_config("llama3.2-1b"), SHAPES["prefill_32k"]
    scores = shape.global_batch * cfg.num_heads * shape.seq_len ** 2 * 4
    assert res["full"]["temp_bytes"] < scores
    assert res["full"]["kernels"]["flash_attention"]["calls"] == \
        cfg.num_layers
    assert res["cost_method"] == "full_trace" and res["mesh"] == "1xH100"
    assert res["fits_hbm"] == (res["full"]["peak_bytes"] <= RL.HBM_PER_CARD)


def test_meta_wrappers_count_no_launches_and_refuse_the_others():
    ops.reset_launch_counts()
    x = torch.empty((5, 1000), device="meta")
    assert ops.pairwise_relmax(x).shape == (5, 5)
    assert ops.batched_pairwise_relmax(x[None]).shape == (1, 5, 5)
    assert ops.sketch(x[0], 7).shape == (256,)
    q = torch.empty((2, 16, 4, 16), dtype=torch.bfloat16, device="meta")
    assert ops.flash_attention(q, q, q).shape == q.shape
    assert sum(ops.launch_counts().values()) == 0
    with pytest.raises(NotImplementedError, match="dry-run"):
        ops.batched_sketch(x, 7)
    with pytest.raises(NotImplementedError, match="dry-run"):
        ops.coded_encode(torch.empty((2, 5), device="meta"), x)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_aux_bitwise_bincount_formula(arch, seed):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    params = moe.init_moe(cfg, gen, "cpu")
    x = torch.randn((3, 32, cfg.d_model), generator=gen)
    _, aux = moe.moe(params, x, cfg)
    probs, idx, *_ = moe.routing(params, x.reshape(-1, cfg.d_model), cfg)
    E = cfg.moe.num_experts
    frac = torch.bincount(idx.reshape(-1), minlength=E).to(
        torch.float32) / idx.numel()
    assert torch.equal(aux, E * torch.sum(frac * probs.mean(dim=0)))


@pytest.mark.parametrize("g", COLLECTIVE_GROUPS)
@pytest.mark.parametrize("kind", KINDS)
def test_ring_bytes_match_reference(ref, kind, g):
    nbytes = 64 * 1024 * 2
    got = RL.ring_bytes(kind, nbytes, 2 if kind == "collective-permute"
                        else g)
    assert got == ref["collective"][f"{kind}/{g}"]


def test_report_tables_match_reference(ref, cells):
    assert report.dryrun_table(cells["reg"]) == \
        ref["tables"]["dryrun"].replace("fits 16G", "fits 80G")
    assert report.roofline_table(cells["reg"]) == ref["tables"]["roofline"]
    assert report.bft_table(cells["bft"]) == ref["tables"]["bft"]


def test_fill_experiments_and_dryrun_main(tmp_path, capsys):
    out = tmp_path / "cells"
    D.main(["--arch", "whisper-tiny", "--shape", "decode_32k,long_500k",
            "--out", str(out)])
    cell = json.loads((out / "whisper-tiny_decode_32k_single.json")
                      .read_text())
    assert cell["fits_hbm"] and cell["chips"] == 1
    assert set(cell["full"]) >= {
        "compile_s", "flops", "bytes", "collective_bytes",
        "collective_detail", "collective_counts", "arg_bytes", "out_bytes",
        "temp_bytes", "peak_bytes", "flops_by_dtype"}
    assert set(cell["roofline"]) >= {"compute_s", "memory_s", "dominant",
                                     "roofline_fraction"}
    skipped = json.loads((out / "whisper-tiny_long_500k_single.json")
                         .read_text())
    assert "skipped" in skipped
    D.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--out",
            str(out)])
    assert "[skip]" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        D.main(["--mesh", "multi", "--out", str(out)])

    doc = tmp_path / "EXPERIMENTS.md"
    doc.write_text("# x\n\n## Dry-run\n\n<!-- DRYRUN_TABLE -->\nold\n"
                   "<!-- DRYRUN_TABLE_END -->\n\n## Roofline\n\n"
                   "<!-- ROOFLINE_TABLE -->\nold\n\n## End\n")
    fill_experiments.main(["--dir", str(out), "--file", str(doc)])
    text = doc.read_text()
    cells_ = report.load(str(out))
    assert report.dryrun_table(cells_) in text
    assert report.roofline_table(cells_) in text
    assert "old" not in text and text.endswith("## End\n")
    assert "filled: 1 cells, 1 skips, 0 errors, 0 bft" in \
        capsys.readouterr().out
    report.main(["--dir", str(out)])
    assert "fits 80G" in capsys.readouterr().out
    report.main(["--dir", str(out), "--kind", "summary"])
    row = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("| whisper-tiny |")]
    assert len(row) == 1 and " fits, " in row[0] and row[0].endswith(
        " m | skip |")


def test_bft_cells_summary_and_context_refusal(cells):
    table = report.summary_table(cells["reg"], cells["bft"]).splitlines()
    assert table[0].endswith("| BFT fast / check / identify |")
    assert table[2].startswith("| llama3.2-1b | — | — | — | skip | ")
    assert table[3] == "| gemma3-1b | ERROR | — | — | — | — |"
    assert table[4].startswith("| whisper-tiny |")
    assert table[4].endswith("| ERROR |")
    modes = cells["bft"][0]
    assert [modes[m]["replication"] for m in ("fast", "check",
                                               "identify")] == [1, 2, 3]
    assert modes["assumed"] == "honest"
    assert modes["check"]["kernels"]["sketch"]["calls"] > 0
    assert modes["identify"]["kernels"]["pairwise_relmax_batched"][
        "calls"] > 0
    with pytest.raises(ValueError, match="context"):
        D.run_bft_cells("whisper-tiny")


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
