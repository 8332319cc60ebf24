"""The port's sharding rules and meshes (``repro_torch.sharding``,
``repro_torch.launch.mesh``) against the JAX package's, and the
dry-run's collectives (``launch.dryrun.run_bft_cells(mesh="workers")``)
against a hand count, on the CPU.

``spec_for`` is held equal to the reference's on every leaf of every
assigned arch's ``repro.models.model.abstract_params`` (its logical
names and shapes), under ``PARAM_RULES``, the trainer's TP-only rules
and ``ACT_RULES``, at the 16x16, 2x16x16, 8x4x16 and 8x1 meshes given
as axis sizes (the reference reads a mesh's ``axis_names`` and
``devices.shape``, so no device is needed).  The dry-run traces one
rank's BFT steps on ``meta`` tensors under a ``fake`` process group;
its collective bytes must equal, by leaf, an all-reduce of every f32
gradient leaf and of the loss (fast; check without a fault), an
all-gather of the (n, k) sketches (check) and of every leaf's (n, d)
gradients (full detection, identify), priced by ``roofline.ring_bytes``
over n ranks, and 0 at n = 1.
"""

import jax
import numpy as np
import pytest

from repro import sharding as RS
from repro.configs import ASSIGNED as R_ASSIGNED
from repro.configs import get_config as r_get_config
from repro.models import model as RM
from repro.train.trainer import _tp_only_rules as r_tp_only_rules
from repro_torch import sharding as S
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as LM
from repro_torch.launch import report
from repro_torch.launch import roofline as RL
from repro_torch.models import model as M
from torch_threads import one_thread  # noqa: F401 (one thread)

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "8x4x16": (("pod", "data", "model"), (8, 4, 16)),
          "8x1": (("data", "model"), (8, 1))}
RULES = {"param": (RS.PARAM_RULES, S.PARAM_RULES),
         "tp_only": (r_tp_only_rules(), S.tp_only_rules()),
         "act": (RS.ACT_RULES, S.ACT_RULES)}
# activation leaves: (logical names, shape)
ACTS = [(("batch", "seq", "embed"), (32, 4096, 2048)),
        (("batch", "seq", "heads_forced"), (16, 128, 36)),
        (("batch", "seq", "heads"), (16, 128, 36)),
        (("batch", "decode_seq", "kv"), (2, 524288, 8)),
        (("batch", "seq", "vocab"), (3, 7, 128256)),
        (("batch", None, "experts"), (8, 4, 16)),
        ((None, "ssm_inner"), (5, 3072))]


def ref_mesh(names, sizes):
    """The reference's view of a mesh: axis names and a device array's
    shape."""
    return type("Mesh", (), {"axis_names": names,
                             "devices": np.empty(sizes)})


def annotated_leaves(arch: str) -> list:
    tree_ = RM.abstract_params(r_get_config(arch))
    return jax.tree.leaves(tree_,
                           is_leaf=lambda x: isinstance(x, RS.Annotated))


def test_rule_tables_are_the_references():
    assert S.PARAM_RULES == RS.PARAM_RULES
    assert S.ACT_RULES == RS.ACT_RULES
    assert S.FORCE_SHARD == RS.FORCE_SHARD
    assert S.tp_only_rules() == r_tp_only_rules()
    assert S.tp_only_rules()["embed"] is None and \
        S.PARAM_RULES["embed"] == "data"


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("arch", R_ASSIGNED)
def test_spec_for_equals_the_references(arch, rules):
    ref_rules, port_rules = RULES[rules]
    leaves = annotated_leaves(arch)
    cases = [(a.logical, a.shape) for a in leaves]
    if rules == "act":
        cases += ACTS
    assert leaves
    sharded = 0
    for name, (names, sizes) in MESHES.items():
        rmesh, pmesh = ref_mesh(names, sizes), S.MeshShape(names, sizes)
        for logical, shape in cases:
            want = tuple(RS.spec_for(logical, rmesh, shape, ref_rules))
            assert S.spec_for(logical, pmesh, shape, port_rules) == want, \
                (arch, name, logical, shape)
            # without a shape: no divisibility fallback
            assert S.spec_for(logical, pmesh, None, port_rules) == tuple(
                RS.spec_for(logical, rmesh, None, ref_rules))
            sharded += any(x is not None for x in want)
    assert sharded > 0


@pytest.mark.parametrize("arch", R_ASSIGNED)
def test_param_bytes_and_count(arch):
    """Over the port's ``abstract_params`` (meta tensors) as the
    reference's over its ``Annotated`` tree."""
    ref = RM.abstract_params(r_get_config(arch))
    port = M.abstract_params(get_config(arch))
    assert S.param_count(port) == RS.param_count(ref)
    assert S.param_bytes(port) == RS.param_bytes(ref)


def test_meshes():
    """The production meshes as shapes; the worker mesh over a ``fake``
    process group of world 8, whose axis sizes ``spec_for`` reads as the
    8x1 shape's; the 4 x 2 mesh forms over the same world, and a
    world-size mismatch raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert LM.make_production_mesh().shape == {"data": 16, "model": 16}
    pods = LM.make_production_mesh(multi_pod=True)
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert LM.make_pod_worker_mesh().shape == {"pod": 8, "data": 4,
                                               "model": 16}
    with pytest.raises(RuntimeError, match="initialized process group"):
        LM.make_worker_mesh(8)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = LM.make_worker_mesh(8)
        assert S.mesh_axis_sizes(mesh) == {"data": 8, "model": 1}
        assert S.mesh_axis_sizes(LM.make_worker_mesh(4, model=2)) == {
            "data": 4, "model": 2}
        with pytest.raises(ValueError, match="world of 8"):
            LM.make_worker_mesh(4)
        for a in annotated_leaves("llama3.2-1b"):
            assert S.spec_for(a.logical, mesh, a.shape) == S.spec_for(
                a.logical, S.MeshShape(*MESHES["8x1"]), a.shape)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the dry-run's collectives
# ---------------------------------------------------------------------------

B, SEQ_LEN = 8, 8


@pytest.fixture(scope="module")
def workers(monkeypatch_module):
    """run_bft_cells of reduced llama3.2-1b on the workers mesh at n = 8
    (f = 2) and n = 1 (f = 0), and on one card."""
    monkeypatch_module.setattr(D, "get_config",
                               lambda a: get_config(a).reduced())
    return {key: D.run_bft_cells("llama3.2-1b", n=n, f=f, global_batch=B,
                                 seq_len=SEQ_LEN, mesh=mesh)
            for key, n, f, mesh in ((8, 8, 2, "workers"),
                                    (1, 1, 0, "workers"),
                                    ("single", 8, 2, "single"))}


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def hand_count(n: int) -> dict:
    """Each step's bytes on the wire for one rank, by leaf."""
    sizes = [t.numel() for t in tree.leaves(
        M.abstract_params(get_config("llama3.2-1b").reduced()))]

    def ar(nbytes):
        return RL.ring_bytes("all-reduce", nbytes, n) if n > 1 else 0.0

    def ag(nbytes):
        return RL.ring_bytes("all-gather", nbytes, n) if n > 1 else 0.0

    grads = sum(ar(4 * d) for d in sizes)       # the f32 gradient sum
    leaves = sum(ag(n * 4 * d) for d in sizes)  # every leaf's (n, d)
    loss = ar(4)
    return {"fast": grads + loss,
            "check": ag(n * 256 * 4) + grads + loss,
            "check_full": leaves + grads + loss,
            "identify": leaves + loss}


def test_dryrun_collectives_equal_the_hand_count(workers):
    leaves = len(tree.leaves(M.abstract_params(
        get_config("llama3.2-1b").reduced())))
    for n in (8, 1):
        cell, want = workers[n], hand_count(n)
        assert cell["mesh"] == f"{n}x1 data,model" and cell["chips"] == n
        for mode, wire in want.items():
            m = cell[mode]
            assert m["collective_bytes"] == wire, (n, mode)
            assert m["roofline"]["collective_s"] == wire / RL.NVLINK_BYTES_S
            ar, ag = (m["collective_counts"][k] for k in ("all-reduce",
                                                         "all-gather"))
            assert ar == (1 if mode == "identify" else leaves + 1), mode
            assert ag == {"fast": 0, "check": 1}.get(mode, leaves), mode
    assert workers[8]["fast"]["roofline"]["collective_s"] > 0
    assert workers[1]["identify"]["collective_bytes"] == 0.0
    single = workers["single"]
    assert all(single[m]["collective_bytes"] == 0.0 and not any(
        single[m]["collective_counts"].values()) for m in want)


def test_workers_mesh_runs_one_worker_a_rank(workers):
    """Rank 0 computes one worker's gradient where the one-card trace
    computes every member's: its FLOPs are a member's share."""
    eight, single = workers[8], workers["single"]
    for mode in ("fast", "identify"):
        assert 0 < eight[mode]["flops"] < single[mode]["flops"]
    k = eight["check"]["kernels"]
    assert k["sketch"]["calls"] == len(tree.leaves(M.abstract_params(
        get_config("llama3.2-1b").reduced())))
    assert eight["identify"]["kernels"]["pairwise_relmax_batched"]["calls"] \
        == single["identify"]["kernels"]["pairwise_relmax_batched"]["calls"]


def test_report_and_main_name_the_collectives(workers, tmp_path, capsys):
    table = report.bft_collectives_table([workers[8]]).splitlines()
    assert len(table) == 2 + 4
    assert table[2].startswith("| llama3.2-1b | 8x1 data,model | fast | 12 ")
    assert " | 0 | 0.0MiB | " in table[2]
    with pytest.raises(SystemExit, match="--bft"):
        D.main(["--mesh", "workers", "--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        D.main(["--mesh", "multi", "--out", str(tmp_path)])
