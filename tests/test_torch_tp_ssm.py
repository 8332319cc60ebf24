"""The port's ``model`` axis on the mamba and hybrid families and on a
split that cuts a query head (``heads_forced``), against the JAX
package's, on the CPU.

The reference trains once, in one subprocess with eight host devices on
the mesh (4, 2) (``test_torch_tp._reference_main``; this file is that
script too: ``python tests/test_torch_tp_ssm.py OUT_DIR NAME...``):
reduced mamba2-780m, randomized under sign_flip; reduced jamba cut to 5
layers (mamba + mlp, mamba + moe and attn + mlp layers), deterministic;
reduced llama3.2-1b with 3 query heads and 1 kv head, whose wq columns
a model axis of 2 splits inside head 1.  The port runs each scenario
from the same initial parameters at W = 2 gloo ranks x ``model`` = 2
and x 1, each held to that one run: control exactly, losses within
1e-4 relative, final parameters within 1e-4 * (1 + max|p|) per leaf,
every rank's gathered parameters bitwise rank 0's.

Beside them, with no reference run: ``require_splittable`` on the
assigned archs, the padded head groups, the split gated RMSNorm and the
split forward and gradients (a rank with no head among them) against
the unsplit ones in ``model`` gloo ranks, a mamba checkpoint written at
``model`` = 2 restored at 1, and the ``--mesh tp`` dry-run of reduced
mamba2 against a counted CPU rank step.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_tp as T
from test_torch_trainer import assert_same_control
from test_torch_trainer import rank_server  # noqa: F401 (its teardown)
from torch_threads import one_thread  # noqa: F401 (one thread)

# name -> (arch, config overrides, mode, attack, byzantine workers, seed,
#          filter, steps)
SCENARIOS = {
    "tp_mamba_randomized": ("mamba2-780m", {}, "randomized", "sign_flip",
                            [1], 2, "median", 3),
    "tp_jamba_deterministic": ("jamba-v0.1-52b", {"num_layers": 5},
                               "deterministic", "sign_flip", [0], 2,
                               "median", 3),
    "tp_heads_forced": ("llama3.2-1b", {"num_heads": 3, "num_kv_heads": 1},
                        "deterministic", "sign_flip", [3], 5, "median", 3),
}


@pytest.fixture(scope="module", autouse=True)
def ref_proc(tmp_path_factory):
    """The reference's runs, started when the module starts, so the
    tests that need none run while it computes."""
    out = tmp_path_factory.mktemp("tp_ssm_ref")
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
# no reference run needed: these run while the reference computes
# ---------------------------------------------------------------------------

SPLITS = [("mamba2-780m", m) for m in (2, 4, 8, 16)] + [
    ("jamba-v0.1-52b", m) for m in (2, 4, 8, 16)] + [
    ("starcoder2-7b", 8), ("starcoder2-7b", 16), ("gemma3-1b", 8),
    ("gemma3-1b", 16), ("llama4-maverick-400b-a17b", 16)]


@pytest.mark.parametrize("arch,model", SPLITS)
def test_require_splittable_passes(arch, model):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import require_splittable

    require_splittable(get_config(arch), model)


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_require_splittable_refuses_a_context(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import require_splittable

    with pytest.raises(ValueError, match="item 7b"):
        require_splittable(get_config(arch), 2)


@pytest.mark.parametrize("over,model,match", [
    ({}, 32, "misaligned"),                   # d_inner 128 / 32, 16 heads
    ({"n_groups": 2}, 2, "groups")])
def test_require_splittable_refuses_a_misaligned_ssm(over, model, match):
    """Reduced mamba2 (d_inner 128, 16 heads of 8): at model 32
    ``spec_for`` would split d_inner and keep the heads whole; two groups
    of B and C are refused; either raises, in the layer too."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.transformer import require_splittable

    cfg = get_config("mamba2-780m").reduced()
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **over))
    with pytest.raises(ValueError, match=match):
        require_splittable(cfg, model)
    assert match in ssm.split_error(cfg, model)
    assert ssm.split_error(cfg, 3) is None      # nothing splits: whole


@pytest.mark.parametrize("H,tp,want", [
    (36, 8, [(0, 5), (5, 5), (10, 5), (15, 5), (20, 5), (25, 5), (30, 5),
             (35, 1)]),
    (4, 16, [(0, 1), (1, 1), (2, 1), (3, 1)] + [(4, 0)] * 12),
    (40, 16, [(3 * r, 3) for r in range(13)] + [(39, 1), (40, 0),
                                                (40, 0)]),
    (32, 4, [(0, 8), (8, 8), (16, 8), (24, 8)])])
def test_head_group_is_the_references_padding(H, tp, want):
    """ceil(H / tp) heads a rank in order, the trailing groups short or
    empty: starcoder2-7b at 8, gemma3-1b and llama4-maverick at 16,
    jamba at 4."""
    from repro_torch.models.attention import head_group

    got = [head_group(H, tp, r) for r in range(tp)]
    assert got == want and sum(n for _, n in got) == H


def test_local_kv_heads_of_a_ragged_group():
    """Query heads read kv head h // G: a run inside one group shares its
    kv head, whole aligned groups keep theirs, a group that straddles
    two takes one kv head a query head."""
    from repro_torch.models.attention import _local_kv_heads

    k = torch.arange(8.0).reshape(1, 1, 8, 1)
    for first, Hl, G, want in ((0, 5, 9, [0]), (5, 5, 9, [0, 0, 0, 0, 1]),
                               (6, 3, 2, [3, 3, 4]), (4, 4, 2, [2, 3]),
                               (3, 2, 5, [0]), (39, 1, 5, [7])):
        kk, vv = _local_kv_heads(k, k, first, Hl, G)
        assert kk.flatten().tolist() == want and torch.equal(kk, vv)


def _rank_main(rank, world, port, out, fn, args):
    """One of ``world`` gloo ranks of a model axis (W = 1) on one thread:
    ``fn(axis, mesh, *args)`` under ``sharding.set_mesh``, its result
    saved to ``out/rank<r>.pt``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.sharding import set_mesh
    from repro_torch.train import ranks as R

    torch.set_num_threads(1)
    R.init("gloo", rank, world, init_method=f"tcp://localhost:{port}",
           timeout_s=120)
    mesh = make_worker_mesh(1, world, device_type="cpu")
    ax = R.Ranks.of(mesh, "cpu").model
    with set_mesh(ax):
        res = fn(ax, mesh, *args)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def on_ranks(world, out, fn, *args) -> list:
    from repro_torch.launch.train import free_port, start_ranks

    start_ranks(_rank_main, (world, free_port(), str(out), fn, args), world)
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


def _split_norm(ax, mesh, x, scale, g_out):
    from repro_torch.models.layers import rmsnorm

    n = x.shape[-1] // ax.world
    xs = x.narrow(-1, ax.rank * n, n).clone().requires_grad_(True)
    ss = scale.narrow(0, ax.rank * n, n).clone().requires_grad_(True)
    y = rmsnorm({"scale": ss}, xs, 1e-6, width=x.shape[-1])
    y.backward(g_out.narrow(-1, ax.rank * n, n))
    return y.detach(), xs.grad, ss.grad


@pytest.mark.parametrize("world", [2, 4])
def test_split_gated_rmsnorm_is_the_whole(world, tmp_path):
    """``layers.rmsnorm`` over a dim split over ``model``: each rank's
    slice of the output, of x's gradient and of the scale's gradient
    (each rank's part of it) equal the whole norm's within 1e-6
    relative; the sum of squares crosses the ranks in f32, forward and
    backward."""
    from repro_torch.models.layers import rmsnorm

    rng = np.random.default_rng(world)
    x = torch.from_numpy(rng.standard_normal((3, 5, 96)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 96).astype(np.float32))
    g_out = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    xw, sw = x.clone().requires_grad_(True), scale.clone().requires_grad_(
        True)
    y = rmsnorm({"scale": sw}, xw, 1e-6)
    y.backward(g_out)
    parts = on_ranks(world, tmp_path, _split_norm, x, scale, g_out)
    for got, want in ((torch.cat([p[0] for p in parts], -1), y.detach()),
                      (torch.cat([p[1] for p in parts], -1), xw.grad),
                      (torch.cat([p[2] for p in parts]), sw.grad)):
        assert float((got - want).abs().max()) <= 1e-6 * (
            1.0 + float(want.abs().max()))
    # the local mean alone is not the whole norm
    local = rmsnorm({"scale": scale[:96 // world]}, x[..., :96 // world])
    assert float((local - y.detach()[..., :96 // world]).abs().max()) > 1e-3


def _split_loss(ax, mesh, cfg, seed):
    """A rank's ``train_loss`` on its shards and every leaf's gradient,
    gathered over ``model``."""
    from repro_torch.core import tree
    from repro_torch.models import convert
    from repro_torch.models import model as M

    pls = convert.placements(cfg, mesh)
    local = convert.shard_params(M.init_train(cfg, seed, "cpu"), pls)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree.leaves(local)]
    loss, _ = M.train_loss(tree.unflatten(local, leaves),
                           _batch(cfg, seed), cfg)
    loss.backward()
    grads = convert.gather_params(tree.unflatten(local, [
        t.grad for t in leaves]), pls, ax)
    return float(loss), [t for t in tree.leaves(grads)]


def _batch(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    return {"tokens": tok, "labels": torch.roll(tok, -1, 1)}


# name -> (arch, overrides, model): the mamba mixer at 2 and 4 ranks; the
# hybrid; wq cut inside a head; gemma3-style with one query head, so rank
# 1 holds none (and its qk-norm, local and global layers); 5 heads over 4
# ranks (2, 2, 1, 0 heads)
FORWARD = {"mamba_2": ("mamba2-780m", {}, 2),
           "mamba_4": ("mamba2-780m", {}, 4),
           "jamba_2": ("jamba-v0.1-52b", {"num_layers": 5}, 2),
           "cut_head_2": ("llama3.2-1b", {"num_heads": 3,
                                          "num_kv_heads": 1}, 2),
           "no_head_2": ("gemma3-1b", {"num_heads": 1, "num_kv_heads": 1}, 2),
           "ragged_4": ("llama3.2-1b", {"num_heads": 5, "num_kv_heads": 1},
                        4)}


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_split_forward_and_gradients_are_the_unsplit(name, tmp_path):
    """The loss of a rank's shards under the model axis and every leaf's
    gathered gradient against the unsplit model's, in f32: loss within
    1e-6, gradients within 1e-5 * (1 + max|g|)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model as M
    from repro_torch.models.attention import head_group

    arch, over, world = FORWARD[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **over)
    params = M.init_train(cfg, 3, "cpu")
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree.leaves(params)]
    loss, _ = M.train_loss(tree.unflatten(params, leaves), _batch(cfg, 3),
                           cfg)
    loss.backward()
    results = on_ranks(world, tmp_path, _split_loss, cfg, 3)
    for got_loss, grads in results:
        assert abs(got_loss - float(loss)) <= 1e-6 * abs(float(loss))
        for (path, _), g, w in zip(tree.leaves_with_paths(params), grads,
                                   leaves):
            assert float((g - w.grad).abs().max()) <= 1e-5 * (
                1.0 + float(w.grad.abs().max())), path
    if name.startswith("no_head"):
        assert head_group(cfg.num_heads, world, world - 1)[1] == 0


def test_mamba_checkpoint_restores_at_model_1(tmp_path):
    """A mamba run written at ``model`` = 2 (gathered, one layout) and
    restored at 1 from step 2: control as the uninterrupted run's,
    parameters within 1e-5 * (1 + max|p|)."""
    import shutil

    from repro_torch.launch.train import spawn

    name = "tp_mamba_randomized"
    ckpt = str(tmp_path / "ckpt")
    a_out, b_out = tmp_path / "a", tmp_path / "b"
    a_out.mkdir()
    b_out.mkdir()
    a = spawn(T.port_job(name, str(a_out), model=2, ckpt=ckpt,
                         actions=(("run", 4),), scen=SCENARIOS), 2)[0]
    shutil.rmtree(os.path.join(ckpt, "step_00000004"))
    b = spawn(T.port_job(name, str(b_out), model=1, ckpt=ckpt,
                         actions=(("restart", 4),), scen=SCENARIOS), 1)[0]
    assert b["resumed"] == 2
    assert len(b["restarted"]["history"]) == 2
    for x, y in zip(b["restarted"]["history"], a["main"]["history"][2:]):
        assert set(x) == set(y) and x["step"] == y["step"]
        assert abs(x["loss"] - y["loss"]) <= 1e-5 * abs(y["loss"])
    for key in ("identified", "active", "kappa", "f_t"):
        assert b["restarted"][key] == a["main"][key]
    for x, y in zip(b["params"]["restarted"], a["params"]["main"]):
        assert float((x - y).abs().max()) <= 1e-5 * (
            1.0 + float(y.abs().max()))


# the dry-run traces honest workers: the mamba scenario with none
# Byzantine, so the counted step tampers with no gradient either
HONEST = {"tp_mamba_honest": SCENARIOS["tp_mamba_randomized"][:4] + (
    [],) + SCENARIOS["tp_mamba_randomized"][5:]}


def test_dryrun_tp_mamba_equals_a_ranks_step(tmp_path):
    """``launch.dryrun`` ``--mesh tp`` on reduced mamba2: rank 0's fast
    step traced on meta at model = 2 equals a real rank's fast step
    counted on the CPU: FLOPs, collectives by axis and their bytes, the
    kernels; bytes up to the rank's batch rows, which meta copies to the
    device."""
    from repro_torch.core.assignment import fast_assignment
    from repro_torch.data import worker_batches
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.train import spawn

    job = T.port_job("tp_mamba_honest", str(tmp_path),
                     actions=(("run", 1), ("count_fast", None)),
                     scen=HONEST)
    card = spawn(job, T.MODEL)[0]["count_fast"]
    meta = D.run_bft_cells(
        job.cfg.name, T.N, T.F, global_batch=T.BATCH, seq_len=T.SEQ,
        opt=job.opt, mesh="tp", model=T.MODEL, cfg=job.cfg, data_ranks=1,
        active=card["active"], modes=("fast",), impl="torch")["fast"]
    for key in ("flops", "collective_by_axis", "collective_result_bytes",
                "kernels"):
        assert meta[key] == card[key], key
    wb = worker_batches({"tokens": np.zeros((T.BATCH, T.SEQ), np.int32),
                         "labels": np.zeros((T.BATCH, T.SEQ), np.int32)},
                        fast_assignment(np.asarray(card["active"])))
    assert meta["bytes"] - card["bytes"] == sum(
        v.astype(np.int32).nbytes for v in wb.values())
    assert meta["collective_by_axis"]["model"] > 0


# ---------------------------------------------------------------------------
# against the reference (last: its subprocess runs meanwhile)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", [2, 1])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_split_run_is_the_references(name, model, ref, tmp_path):
    """The scenario at W = 2 x ``model`` against the reference's (4, 2)
    run: control exact, losses within 1e-4, parameters within
    1e-4 * (1 + max|p|), the ranks' gathered parameters bitwise alike."""
    _, summ = T.run_port(name, ref, tmp_path, scen=SCENARIOS, model=model)
    byz = SCENARIOS[name][4]
    if SCENARIOS[name][2] == "deterministic":
        assert all(summ["identified"][w] for w in byz)
        assert sum(summ["identified"]) == len(byz)


if __name__ == "__main__":
    T._reference_main(sys.argv[1], sys.argv[2:], SCENARIOS)
