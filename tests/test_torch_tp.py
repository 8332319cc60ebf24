"""The port's ``model`` axis above 1 (tensor and expert parallelism
inside each BFT worker) against the JAX package's, on the CPU.

The reference trains in one subprocess with eight host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) on the mesh
(4, 2): n = 4 workers on ``data``, each worker's leaves placed over
``model`` by ``tree_specs(..., tp_only_rules())``; this file is that
script too (``python tests/test_torch_tp.py OUT_DIR NAME...``).  The
port runs the same scenarios from the same initial parameters as
W = 2 x ``model`` = 2 gloo ranks (``launch.train.spawn``, one thread
each).  Held: every control quantity exactly, losses within 1e-4
relative, final parameters within 1e-4 * (1 + max|p|) per leaf, every
rank's gathered parameters bitwise rank 0's.  Scenarios: reduced
llama3.2-1b in f32, deterministic under sign_flip, filter with krum,
the kv fallback (one kv head over two ranks: wk's columns cut a head);
reduced phi3.5-moe (4 experts, 2 a rank), randomized under noise.

Beside them, with no reference run: the annotated trees and their
specs against the reference's, the shard form of the sketch and the
split vote against the whole leaf's, the noise attack's shards, and
checkpoints written at ``model`` = 2 restored at 1 and the reverse.

The helpers take a scenario table (``scen``, this file's by default):
``test_torch_tp_ssm.py`` runs its own through them.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_trainer import assert_same_control
from test_torch_trainer import rank_server  # noqa: F401 (its teardown)
from test_torch_trainer import summary
from torch_threads import one_thread  # noqa: F401 (one thread)

N, F = 4, 1
SEQ, BATCH = 16, 8
OPT = dict(kind="momentum", peak_lr=0.05, warmup_steps=2, total_steps=40,
           grad_clip=1.0)

# name -> (arch, config overrides, mode, attack, byzantine workers, seed,
#          filter, steps)
SCENARIOS = {
    "tp_deterministic": ("llama3.2-1b", {}, "deterministic", "sign_flip",
                         [1], 3, "median", 3),
    "tp_filter_krum": ("llama3.2-1b", {}, "filter", "sign_flip", [2], 1,
                       "krum", 3),
    "tp_kv_fallback": ("llama3.2-1b", {"num_kv_heads": 1}, "deterministic",
                       "sign_flip", [3], 5, "median", 3),
    "tp_moe_randomized": ("phi3.5-moe-42b-a6.6b", {}, "randomized", "noise",
                          [1], 4, "median", 3),
}
MODEL = 2


def cfg_of(get_config, name, scen=SCENARIOS):
    arch, over = scen[name][:2]
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **over)


def new_trainer(pkg, name, make, scen=SCENARIOS):
    arch, _, mode, attack, byz, seed, filt, _ = scen[name]
    tc = pkg["TrainerConfig"](seq_len=SEQ, global_batch=BATCH, log_every=0,
                              filter_name=filt)
    mask = np.zeros(N, bool)
    mask[byz] = True
    bft = pkg["BFTConfig"](n=N, f=F, mode=mode, q=0.5, p_assumed=0.6,
                           seed=seed)
    return make(cfg_of(pkg["get_config"], name, scen),
                pkg["OptConfig"](**OPT),
                bft, tc, pkg["AttackConfig"](attack, 0.6, 5.0), mask)


# ---------------------------------------------------------------------------
# the reference, in a subprocess
# ---------------------------------------------------------------------------

def _reference_main(out_dir, names, scen=SCENARIOS) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    import jax

    from repro.configs import get_config
    from repro.core.randomized import BFTConfig
    from repro.optim import OptConfig
    from repro.sharding import make_mesh
    from repro.train import AttackConfig, StepConfig, Trainer, TrainerConfig

    mesh = make_mesh((N, MODEL), ("data", "model"))
    pkg = dict(get_config=get_config, TrainerConfig=TrainerConfig,
               BFTConfig=BFTConfig, OptConfig=OptConfig,
               AttackConfig=AttackConfig)

    def flat(params):
        paths = jax.tree_util.tree_flatten_with_path(params)[0]
        return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path): np.asarray(leaf)
                for path, leaf in paths}

    for name in names:
        def make(cfg, opt, bft, tc, attack, mask):
            return Trainer(cfg, opt, bft, mesh, tc, attack=attack,
                           sc=StepConfig(worker_axes=("data",)),
                           true_byzantine=mask)

        tr = new_trainer(pkg, name, make, scen)
        init = flat(tr.params)
        tr.run(scen[name][-1])
        with open(os.path.join(out_dir, f"{name}.json"), "w") as fh:
            json.dump(summary(tr), fh)
        np.savez(os.path.join(out_dir, f"{name}.npz"),
                 **{f"init/{k}": v for k, v in init.items()},
                 **{f"final/{k}": v for k, v in flat(tr.params).items()})
    print("REFERENCE_DONE")


@pytest.fixture(scope="module", autouse=True)
def ref_proc(tmp_path_factory):
    """The reference's runs, started when the module starts, so the
    tests that need none run while it computes."""
    out = tmp_path_factory.mktemp("tp_ref")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out),
         *SCENARIOS], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc):
    proc, out = ref_proc
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0 and "REFERENCE_DONE" in stdout, \
        stderr[-4000:]
    res = {}
    for name in SCENARIOS:
        with open(out / f"{name}.json") as fh:
            res[name] = (json.load(fh), dict(np.load(out / f"{name}.npz")))
    return res


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

def port_job(name, out, *, model=MODEL, params=None, actions=None,
             ckpt=None, detection="sketch", scen=SCENARIOS):
    from repro_torch.configs import get_config
    from repro_torch.core.randomized import BFTConfig
    from repro_torch.launch.train import Job
    from repro_torch.optim import OptConfig
    from repro_torch.train import AttackConfig, StepConfig, TrainerConfig

    pkg = dict(get_config=get_config, TrainerConfig=TrainerConfig,
               BFTConfig=BFTConfig, OptConfig=OptConfig,
               AttackConfig=AttackConfig)

    def make(cfg, opt, bft, tc, attack, mask):
        if ckpt:
            tc = dataclasses.replace(tc, checkpoint_dir=ckpt,
                                     checkpoint_every=2)
        return Job(cfg, opt, bft, tc, attack,
                   StepConfig(detection=detection), mask,
                   actions=actions or (("run", scen[name][-1]),),
                   device="cpu", backend="gloo", params=params, out=out,
                   keep_params=True, threads=1, timeout_s=120, model=model)

    return new_trainer(pkg, name, make, scen)


def template(name, scen=SCENARIOS):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    return M.abstract_params(cfg_of(get_config, name, scen))


def init_from(name, arrays, tmp_path, scen=SCENARIOS) -> str:
    from repro_torch.core import tree

    tpl = template(name, scen)
    init = tree.unflatten(tpl, [
        torch.from_numpy(np.array(arrays[f"init/{p}"]))
        for p, _ in tree.leaves_with_paths(tpl)])
    path = tmp_path / "init.pt"
    torch.save(init, path)
    return str(path)


def params_close(name, leaves, arrays, prefix="final",
                 scen=SCENARIOS) -> None:
    from repro_torch.core import tree

    paths = [p for p, _ in tree.leaves_with_paths(template(name, scen))]
    for path, leaf in zip(paths, leaves):
        want = arrays[f"{prefix}/{path}"]
        err = float(np.abs(leaf.numpy() - want).max())
        mag = float(np.abs(want).max())
        assert err <= 1e-4 * (1.0 + mag), (path, err, mag)


def run_port(name, ref, tmp_path, scen=SCENARIOS, model=MODEL):
    """Scenario ``name`` at W = 2 x ``model`` from the reference's initial
    parameters, held against the reference run."""
    from repro_torch.launch.train import spawn

    summ, arrays = ref[name]
    results = spawn(port_job(name, str(tmp_path), model=model,
                             params=init_from(name, arrays, tmp_path, scen),
                             scen=scen),
                    (N // 2) * model)
    r0 = results[0]
    for r in results:
        assert r["agree"] and r["model"] == model
        assert model == 1 or r["model_counts"]["all_reduce"] > 0
        assert r["main"] == r0["main"]
        assert all(torch.equal(a, b) for a, b in
                   zip(r["params"]["main"], r0["params"]["main"]))
    assert [r["model_rank"] for r in results] == list(range(model)) * (
        N // 2)
    assert_same_control(r0["main"], summ)
    params_close(name, r0["params"]["main"], arrays, scen=scen)
    return results, summ


# ---------------------------------------------------------------------------
# no reference run needed: these run while the reference computes
# ---------------------------------------------------------------------------

def _ref_mesh(names, sizes):
    return type("Mesh", (), {"axis_names": names,
                             "devices": np.empty(sizes)})


MESHES = {"4x2": (("data", "model"), (4, 2)),
          "2x4": (("data", "model"), (2, 4)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _arches():
    from repro_torch.configs import ASSIGNED

    return list(ASSIGNED)


@pytest.mark.parametrize("arch", _arches())
def test_annotated_tree_is_the_references(arch):
    """Every leaf of ``annotated_params``: the reference's shape, logical
    names, dtype and initializer, in the same leaf order."""
    import jax

    from repro import sharding as RS
    from repro.configs import get_config as r_get_config
    from repro.models import model as RM
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model as M

    ref = jax.tree.leaves(RM.abstract_params(r_get_config(arch)),
                          is_leaf=lambda x: isinstance(x, RS.Annotated))
    port = tree.leaves(M.annotated_params(get_config(arch)))
    assert len(port) == len(ref)
    for a, b in zip(ref, port):
        assert (tuple(a.shape), tuple(a.logical), np.dtype(a.dtype).name,
                a.init) == (b.shape, b.logical,
                            str(b.dtype).replace("torch.", ""), b.init)


def _spec_leaves(t) -> list:
    """The placements of a ``tree_specs`` tree in leaf order (each leaf
    a tuple)."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _spec_leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in _spec_leaves(v)]
    return [t]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", _arches())
def test_tree_specs_are_the_references(arch, mesh):
    """``tree_specs`` under ``tp_only_rules`` equal the reference's, and
    ``tree_shardings`` / ``tree_structs`` give each rank's slice."""
    import jax

    from repro import sharding as RS
    from repro.configs import get_config as r_get_config
    from repro.models import model as RM
    from repro_torch import sharding as S
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model as M

    names, sizes = MESHES[mesh]
    rules = S.tp_only_rules()
    ref = jax.tree.leaves(
        RS.tree_specs(RM.abstract_params(r_get_config(arch)),
                      _ref_mesh(names, sizes), rules),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    ann = M.annotated_params(get_config(arch))
    pmesh = S.MeshShape(names, sizes)
    port = _spec_leaves(S.tree_specs(ann, pmesh, rules))
    assert [tuple(p) for p in ref] == port
    last = {n: s - 1 for n, s in zip(names, sizes)}
    for a, pl, st in zip(tree.leaves(ann), tree.leaves(S.tree_shardings(
            ann, pmesh, rules, last)), tree.leaves(S.tree_structs(
                ann, pmesh, rules, last))):
        assert st.is_meta and tuple(st.shape) == pl.local_shape
        full = torch.empty(a.shape, device="meta")
        assert tuple(pl.take(full).shape) == pl.local_shape
        if pl.sharded:
            j = pl.split_dim
            assert pl.index[j] == pl.parts[j] - 1 == sizes[-1] - 1


def test_worker_mesh_has_both_axes():
    """A 4 x 2 mesh over a ``fake`` process group of world 8: global rank
    d * 2 + m sits at (d, m); ``Ranks.of`` takes both axes; a world-size
    mismatch still raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import sharding as S
    from repro_torch.launch import mesh as LM
    from repro_torch.train.ranks import ModelAxis, Ranks

    dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
    try:
        mesh = LM.make_worker_mesh(4, model=2)
        assert S.mesh_axis_sizes(mesh) == {"data": 4, "model": 2}
        assert S.mesh_coordinate(mesh) == {"data": 2, "model": 1}
        r = Ranks.of(mesh, "cpu")
        assert (r.world, r.rank) == (4, 2)
        assert isinstance(r.model, ModelAxis)
        assert (r.model.world, r.model.rank, r.model.shape) == (
            2, 1, {"model": 2})
        with pytest.raises(ValueError, match="world of 8"):
            LM.make_worker_mesh(2, model=2)
    finally:
        dist.destroy_process_group()


def test_constrain_checks_the_shard_shape():
    from repro_torch import sharding as S

    tp = S.MeshShape(("model",), (2,))
    x = torch.zeros(3, 5, 64)
    assert S.constrain(x, tp, ("batch", "seq", "vocab"), (3, 5, 128)) is x
    assert S.constrain(x, tp, ("batch", "seq", "embed")) is x
    with pytest.raises(ValueError, match="a rank holds"):
        S.constrain(x, tp, ("batch", "seq", "vocab"), (3, 5, 64))
    # a dim the axis does not divide stays whole
    assert S.constrain(torch.zeros(3, 5, 7), tp,
                       ("batch", "seq", "vocab")).shape[-1] == 7
    with pytest.raises(ValueError, match="heads_forced"):
        S.constrain(torch.zeros(2, 4, 2), tp,
                    ("batch", None, "heads_forced"), (2, 4, 3))
    assert S.constrain_here(x, ("batch", "seq", "vocab"), (9, 9, 9)) is x
    with S.set_mesh(tp):
        assert S.ambient_mesh() is tp
        with pytest.raises(ValueError):
            S.constrain_here(x, ("batch", "seq", "vocab"), (3, 5, 64))
    assert S.ambient_mesh() is None


class _Axis:
    """One rank of a model axis of ``world`` in this process: its
    collectives leave the operand as it is (the test sums or maxes the
    ranks' operands itself)."""

    def __init__(self, rank, world, placements):
        self.rank, self.world, self.placements = rank, world, placements
        self.shape = {"model": world}

    def all_reduce_sum(self, t):
        return t

    all_reduce_max = all_reduce_sum


# (shape, the dim split over 2 ranks); odd widths, a middle dim, dim 0
SKETCH_CASES = [((3, 10, 14), 2), ((6, 7), 0), ((2, 4, 9, 6), 1),
                ((1, 1030), 1), ((4, 257), 0)]


@pytest.mark.parametrize("shape,dim", SKETCH_CASES)
@pytest.mark.parametrize("k", [256, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_shard_sketch_sums_to_the_whole_leafs(shape, dim, k, dtype):
    """The shards' plain K4s shard form (``ops.sketch_shard``) of an f32
    or bf16 leaf sums to the reference's sketch of the whole flat leaf
    (its ``iota``; a bf16 leaf's f32 cast) within 1e-6 relative, and a
    bf16 block sketches bitwise as its f32 cast; ``sketch_tree`` over a
    model axis likewise."""
    import jax.numpy as jnp

    from repro.core import detection as RD
    from repro_torch import sharding as S
    from repro_torch.core import detection as D
    from repro_torch.kernels import ops

    rng = np.random.default_rng(sum(shape) + k)
    leaf = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)
    full = leaf.float().numpy()
    key = 0x1234567
    want = np.asarray(RD.hash_sign_sketch(jnp.asarray(full.reshape(-1)),
                                          key, k))
    logical = tuple("ffn" if i == dim else None for i in range(len(shape)))
    ann = S.Annotated(shape, logical, dtype)
    mesh = S.MeshShape(("model",), (2,))
    got = np.zeros(k, np.float32)
    for m in range(2):
        pl = S.placement_of(ann, mesh, S.tp_only_rules(), {"model": m})
        assert pl.split_dim == dim
        block, cfull, c0 = D.shard_block(pl.take(leaf).contiguous(), pl)
        part = ops.sketch_shard(block, key, k, cfull, c0)
        assert torch.equal(part, ops.sketch_shard(block.float(), key, k,
                                                  cfull, c0))
        got += part.numpy()
    scale = 1.0 + np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale

    # a tree of a split and a replicated leaf, over two ranks
    tree_full = {"a": leaf,
                 "b": torch.from_numpy(rng.standard_normal(11).astype(
                     np.float32)).to(dtype)}
    ann_t = {"a": ann, "b": S.Annotated((11,), ("norm",), dtype)}
    whole = D.sketch_tree(tree_full, key, k).numpy()
    total = np.zeros(k, np.float32)
    for m in range(2):
        pls = S.tree_shardings(ann_t, mesh, S.tp_only_rules(),
                               {"model": m})
        local = {n: pls[n].take(t).contiguous() for n, t in
                 tree_full.items()}
        axis = _Axis(m, 2, [pls["a"], pls["b"]])
        total += D.sketch_tree(local, key, k, axis=axis).numpy()
    assert np.abs(total - whole).max() <= 1e-6 * (1 + np.abs(whole).max())


def test_split_vote_is_the_whole_leafs():
    """K3 on each shard, maxed over the ranks: bitwise the whole leaf's
    (G, r, r) maxima, so the winners, the faulty flags and each shard's
    voted value are the whole leaf's vote, bitwise."""
    from repro_torch.kernels import ops
    from repro_torch.train.steps import vote_leaf

    rng = np.random.default_rng(7)
    G, r, d = 2, 3, 26
    reps = torch.from_numpy(rng.standard_normal((G, r, d)).astype(
        np.float32))
    reps[:, 1] = reps[:, 0]
    reps[0, 2, 20] += 1.0            # group 0: row 2 differs in shard 1
    reps[1, 2] = reps[1, 0]
    reps[1, 0, 3] -= 2.0             # group 1: row 0 differs in shard 0
    want_v, want_f = vote_leaf(reps, 1e-5)
    shards = reps.split(d // 2, dim=-1)
    rel = torch.maximum(*[ops.batched_pairwise_relmax(s) for s in shards])
    assert torch.equal(rel, ops.batched_pairwise_relmax(reps))

    class Max(_Axis):
        def all_reduce_max(self, t):
            return t.copy_(rel)

    parts = [vote_leaf(s.contiguous(), 1e-5, axis=Max(m, 2, None))
             for m, s in enumerate(shards)]
    assert torch.equal(torch.cat([v for v, _ in parts]), want_v)
    assert all(torch.equal(f, want_f) for _, f in parts)
    assert want_f.tolist() == [[False, False, True], [True, False, False]]


def test_noise_attack_shards_are_the_whole_draw():
    from repro_torch import sharding as S
    from repro_torch.core import byzantine, prngkey

    ann = {"w": S.Annotated((6, 10), (None, "ffn"), torch.float32),
           "v": S.Annotated((8, 3), ("vocab", None), torch.float32),
           "s": S.Annotated((5,), ("norm",), torch.float32)}
    rng = np.random.default_rng(0)
    full = {n: torch.from_numpy(rng.standard_normal(a.shape).astype(
        np.float32)) for n, a in ann.items()}
    key = prngkey.PRNGKey(11)
    want = byzantine.apply_attack(full, "noise", key, 5.0)
    mesh = S.MeshShape(("model",), (2,))
    got = []
    for m in range(2):
        pls = S.tree_shardings(ann, mesh, S.tp_only_rules(), {"model": m})
        local = {n: pls[n].take(t) for n, t in full.items()}
        got.append(byzantine.apply_attack(
            local, "noise", key, 5.0,
            placements=[pls[n] for n in sorted(pls)]))
    assert torch.equal(torch.cat([g["w"] for g in got], 1), want["w"])
    assert torch.equal(torch.cat([g["v"] for g in got], 0), want["v"])
    assert all(torch.equal(g["s"], want["s"]) for g in got)


@pytest.mark.parametrize("first,second", [(2, 1), (1, 2)])
def test_checkpoint_restores_at_another_model(first, second, tmp_path):
    """Written at ``model`` = first (one checkpoint layout, gathered by
    rank 0), restored at ``model`` = second from step 2: control as the
    uninterrupted run's, parameters within 1e-5 * (1 + max|p|)."""
    from repro_torch.launch.train import spawn

    name = "tp_deterministic"
    ckpt = str(tmp_path / "ckpt")
    a_out, b_out = tmp_path / "a", tmp_path / "b"
    a_out.mkdir()
    b_out.mkdir()
    (a,) = spawn(port_job(name, str(a_out), model=first, ckpt=ckpt,
                          actions=(("run", 4),)), first)[:1]
    shutil.rmtree(os.path.join(ckpt, "step_00000004"))
    (b,) = spawn(port_job(name, str(b_out), model=second, ckpt=ckpt,
                          actions=(("restart", 4),)), second)[:1]
    assert b["resumed"] == 2
    assert b["restarted"]["history"] == a["main"]["history"][2:] or all(
        x["step"] == y["step"] and abs(x["loss"] - y["loss"]) <= 1e-5 * abs(
            y["loss"]) for x, y in zip(b["restarted"]["history"],
                                       a["main"]["history"][2:]))
    for key in ("identified", "active", "kappa", "f_t"):
        assert b["restarted"][key] == a["main"][key]
    for x, y in zip(b["params"]["restarted"], a["params"]["main"]):
        assert float((x - y).abs().max()) <= 1e-5 * (
            1.0 + float(y.abs().max()))


def test_full_detection_split_over_model(tmp_path):
    """Paper-faithful detection (each leaf's gradients gathered and held
    against the group's mean, the flags OR'ed over the leaves and, for a
    split leaf, over ``model``): W = 2 x model = 2 against W = 4 x 1,
    control equal, parameters within 1e-5 * (1 + max|p|)."""
    from repro_torch.launch.train import spawn

    runs = {}
    for model in (1, 2):
        out = tmp_path / f"m{model}"
        out.mkdir()
        runs[model] = spawn(port_job("tp_deterministic", str(out),
                                     model=model, detection="full"),
                            (N // 2) * 2)[0]
    a, b = runs[2], runs[1]
    assert a["main"]["identified"] == b["main"]["identified"]
    assert a["main"]["identified"][1]
    assert_same_control(a["main"], b["main"])
    for x, y in zip(a["params"]["main"], b["params"]["main"]):
        assert float((x - y).abs().max()) <= 1e-5 * (
            1.0 + float(y.abs().max()))


def test_dryrun_tp_equals_a_ranks_step(tmp_path):
    """``launch.dryrun`` ``--mesh tp``: rank 0's fast step traced on meta
    under a ``fake`` group of world 2 equals a real rank's fast step at
    model = 2 counted on the CPU (the kernels' plain versions, traced as
    such): FLOPs, bytes and the collectives of each axis; a split it
    cannot run (a context model, a misaligned ssm split) is reported as
    skipped."""
    from repro_torch.configs import get_config
    from repro_torch.core.assignment import fast_assignment
    from repro_torch.data import worker_batches
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.train import spawn

    job = port_job("tp_moe_randomized", str(tmp_path),
                   actions=(("run", 1), ("count_fast", None)))
    r0 = spawn(job, MODEL)[0]
    card = r0["count_fast"]
    meta = D.run_bft_cells(
        job.cfg.name, N, F, global_batch=BATCH, seq_len=SEQ, opt=job.opt,
        mesh="tp", model=MODEL, cfg=job.cfg, data_ranks=1,
        active=card["active"], modes=("fast",), impl="torch")["fast"]
    assert card["staged_bytes"] == 0
    for key in ("flops", "collective_by_axis", "collective_result_bytes",
                "kernels"):
        assert meta[key] == card[key], key
    # on meta (as on a card) the rank's rows of tokens and labels are
    # copied to the device; a CPU rank reads them in place
    wb = worker_batches({"tokens": np.zeros((BATCH, SEQ), np.int32),
                         "labels": np.zeros((BATCH, SEQ), np.int32)},
                        fast_assignment(np.asarray(card["active"])))
    assert meta["bytes"] - card["bytes"] == sum(
        v.astype(np.int32).nbytes for v in wb.values())
    assert meta["collective_by_axis"]["model"] > 0
    skipped = D.run_bft_cells("whisper-tiny", 4, 1, global_batch=8,
                              seq_len=16, mesh="tp", model=2)
    assert "item 7b" in skipped["skipped"]
    misaligned = D.run_bft_cells(
        "mamba2-780m", 4, 1, global_batch=8, seq_len=16, mesh="tp",
        model=32, cfg=get_config("mamba2-780m").reduced())
    assert "misaligned" in misaligned["skipped"]


# ---------------------------------------------------------------------------
# against the reference (last: its subprocess runs meanwhile)
# ---------------------------------------------------------------------------

def test_deterministic_sign_flip(ref, tmp_path):
    _, summ = run_port("tp_deterministic", ref, tmp_path)
    assert summ["identified"][1] and sum(summ["identified"]) == 1


def test_filter_krum(ref, tmp_path):
    run_port("tp_filter_krum", ref, tmp_path)


def test_kv_fallback_one_kv_head(ref, tmp_path):
    """K = 1 over two ranks: wk's columns cut the head; each rank gathers
    them, and their gradient is summed over model."""
    from repro_torch.configs import get_config

    cfg = cfg_of(get_config, "tp_kv_fallback")
    assert cfg.num_kv_heads % MODEL and (cfg.num_kv_heads * cfg.head_dim) \
        % MODEL == 0
    _, summ = run_port("tp_kv_fallback", ref, tmp_path)
    assert summ["identified"][3]


def test_moe_randomized_noise(ref, tmp_path):
    """Four experts, two a rank: the router's logits gathered, the
    combine summed over model; the noise attack's shards."""
    _, summ = run_port("tp_moe_randomized", ref, tmp_path)
    assert any("identified" in h for h in summ["history"])


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2:])
