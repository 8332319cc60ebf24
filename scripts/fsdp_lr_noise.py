#!/usr/bin/env python3
"""Where the FSDP tests' parameter gate would miss at a larger lr, and
why: the mamba2-780m (data 2, model 2) scenario of
``tests/test_torch_fsdp.py`` (reduced config, f32, three AdamW steps
with the clip active) at AdamW peak lr 1e-3 and at the tests' 3e-4, on
the CPU.

Per leaf it prints the largest parameter gap after the three steps,
over 1 + max|p| (the tests' gate is 1e-4), between the JAX package's
jitted step on four host devices and

  - ``split``: the port's four gloo ranks (``pjit_step`` on a mesh),
  - ``one``: the port's one-process step (no mesh, nothing split),

and the gap between those two; beside them the first step's gradient
gap to the reference's (``jax.grad`` of its ``train_loss``) of the
split's backward (``train_loss`` on each rank's blocks and rows, the
gradients reduce-scattered and summed as the train step does, then
gathered) and of the one-process backward, over the leaf's largest
gradient, and, at the element of the largest ``split`` gap, that
element's reference gradient and the split's gradient gap against
AdamW's eps.  Where an element's gradient lies under eps, AdamW's first
updates are about lr * g / eps, so a gradient gap of a share of eps
moves the element by that share of the lr.

    PYTHONPATH=src python scripts/fsdp_lr_noise.py [LR ...]

(default 1e-3 3e-4; the readings also go to
``chiprun_out/fsdp_lr_noise.json``).  It runs the reference in
subprocesses (``tests/test_torch_fsdp.py OUT mamba_2x2 --lr LR``, and
this file with ``--jax-grads OUT``).
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = "mamba_2x2"


def _flat(params) -> dict:
    import jax
    import numpy as np

    paths = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in paths}


def jax_grads(out_dir: str) -> None:
    """The reference's gradient of ``train_loss`` at the scenario's
    initial parameters and batch (one host device), to
    ``out_dir/grads.npz``."""
    import jax
    import numpy as np

    from repro.configs import get_config
    from repro.models import model as RM

    import test_torch_fsdp as T

    cfg = T.cfg_of(get_config, NAME)
    seed = T.SCENARIOS[NAME][3]
    params = RM.init(cfg, jax.random.PRNGKey(seed))
    tokens, labels = T.host_batch(cfg.vocab_size, seed)
    grads = jax.jit(jax.grad(lambda p: RM.train_loss(
        p, {"tokens": tokens, "labels": labels}, cfg)[0]))(params)
    np.savez(os.path.join(out_dir, "grads.npz"), **_flat(grads))


def _run(args: list, env: dict) -> None:
    proc = subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-4000:])


def _grad_rank(rank: int, world: int, port: int, out: str,
               init_path: str) -> None:
    """One gloo rank of the scenario's split: the first step's
    gradients as the train step makes them, gathered, to
    ``out/grads.pt`` from rank 0."""
    import torch
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch.mesh import make_step_mesh
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.train import pjit_step
    from repro_torch.train import ranks as R

    import test_torch_fsdp as T

    torch.set_num_threads(1)
    R.init("gloo", rank, world, init_method=f"tcp://localhost:{port}",
           timeout_s=120)
    pod, data, model = T.SCENARIOS[NAME][2]
    mesh = R.StepMesh(make_step_mesh(data, model, pod, device_type="cpu"),
                      "cpu")
    cfg = T.cfg_of(get_config, NAME)
    pls = convert.placements(cfg, mesh.mesh, rules=sharding.PARAM_RULES)
    params = convert.shard_params(torch.load(init_path), pls)
    mesh.placements = tree.leaves(pls)
    tokens, labels = (torch.from_numpy(a) for a in T.host_batch(
        cfg.vocab_size, T.SCENARIOS[NAME][3]))
    batch = {"tokens": mesh.local_rows(tokens),
             "labels": mesh.local_rows(labels)}
    req = [p.detach().requires_grad_() for p in tree.leaves(params)]
    with sharding.set_mesh(mesh):
        loss, _ = M.train_loss(tree.unflatten(params, req), batch, cfg)
        grads = pjit_step.sync_grads(list(torch.autograd.grad(
            loss, req, materialize_grads=True)), mesh)
    full = convert.gather_params(tree.unflatten(params, grads), pls, mesh)
    if rank == 0:
        torch.save(tree.leaves(full), os.path.join(out, "grads.pt"))
    dist.destroy_process_group()


def split_grads(init, out: pathlib.Path) -> list:
    import torch

    from repro_torch.launch.train import free_port, start_ranks

    import test_torch_fsdp as T

    shape = T.SCENARIOS[NAME][2]
    world = shape[0] * shape[1] * shape[2]
    init_path = str(out / "grad_init.pt")
    torch.save(init, init_path)
    start_ranks(_grad_rank, (world, free_port(), str(out), init_path),
                world)
    return torch.load(out / "grads.pt")


def port_one(cfg, init, opt: dict, steps: int):
    """The port's one-process steps from ``init``: (final leaves, the
    first step's gradients)."""
    import torch

    from repro_torch.core import tree
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import pjit_step

    import test_torch_fsdp as T

    tokens, labels = (torch.from_numpy(a) for a in T.host_batch(
        cfg.vocab_size, T.SCENARIOS[NAME][3]))
    batch = {"tokens": tokens, "labels": labels}
    req = [p.detach().clone().requires_grad_() for p in tree.leaves(init)]
    loss, _ = M.train_loss(tree.unflatten(init, req), batch, cfg)
    grads = torch.autograd.grad(loss, req, materialize_grads=True)
    params = tree.tree_map(torch.clone, init)
    cfg_opt = OptConfig(**opt)
    state = init_opt_state(cfg_opt, params)
    step = pjit_step.make_train_step(cfg, cfg_opt)
    for i in range(steps):
        params, state, _ = step(params, state, batch, i)
    return tree.leaves(params), grads


def main(lrs) -> int:
    import numpy as np
    import torch

    import test_torch_fsdp as T
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch.train import stop_rank_server
    from repro_torch.optim import OptConfig

    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")])}
    cfg = T.cfg_of(get_config, NAME)
    eps = OptConfig().eps
    paths = [p for p, _ in tree.leaves_with_paths(T._template(cfg))]
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        _run([__file__, "--jax-grads", str(tmp)], env)
        g_ref = dict(np.load(tmp / "grads.npz"))
        for lr in lrs:
            out = tmp / f"lr{lr}"
            out.mkdir()
            _run([str(ROOT / "tests" / "test_torch_fsdp.py"), str(out), NAME,
                  "--lr", str(lr)], env)
            arrays = dict(np.load(out / f"{NAME}.npz"))
            init = T._init_tree(cfg, arrays)
            opt = dict(T.OPT, peak_lr=lr)
            split = T.run_ranks(NAME, init, out, opt=opt)[0]["params"]
            one, grads = port_one(cfg, T._init_tree(cfg, arrays), opt,
                                  T.STEPS)
            sgrads = split_grads(T._init_tree(cfg, arrays), out)
            rows = {}
            for path, s, o, g, sg in zip(paths, split, one, grads, sgrads):
                want = arrays[f"final/{path}"]
                scale = 1.0 + float(np.abs(want).max())
                d = np.abs(s.numpy() - want)
                gr = g_ref[path]
                gmax = float(np.abs(gr).max()) or 1.0
                at = np.unravel_index(int(d.argmax()), d.shape)
                rows[path] = {
                    "split": float(d.max()) / scale,
                    "one": float(np.abs(o.numpy() - want).max()) / scale,
                    "split_vs_one": float((s - o).abs().max()) / scale,
                    "grad_gap": float(np.abs(g.numpy() - gr).max()) / gmax,
                    "split_grad_gap": float(np.abs(
                        sg.numpy() - gr).max()) / gmax,
                    "grad_at_worst_over_max": float(abs(gr[at])) / gmax,
                    "grad_at_worst_over_eps": float(abs(gr[at])) / eps,
                    "split_grad_gap_at_worst_over_eps": float(abs(
                        sg.numpy()[at] - gr[at])) / eps}
            worst = max(rows, key=lambda p: rows[p]["split"])
            report[str(lr)] = {"leaves": rows, "worst_leaf": worst,
                               **{k: max(r[k] for r in rows.values())
                                  for k in ("split", "one", "split_vs_one",
                                            "grad_gap", "split_grad_gap")}}
            print(f"lr {lr}: largest gap over 1 + max|p| (gate 1e-4): "
                  f"split {report[str(lr)]['split']:.3e}, one process "
                  f"{report[str(lr)]['one']:.3e}, split vs one process "
                  f"{report[str(lr)]['split_vs_one']:.3e}; first "
                  f"gradients against the reference's at most "
                  f"{report[str(lr)]['split_grad_gap']:.3e} (split) and "
                  f"{report[str(lr)]['grad_gap']:.3e} (one process) of a "
                  f"leaf's largest")
            for path, r in sorted(rows.items(),
                                  key=lambda kv: -kv[1]["split"])[:6]:
                print(f"  {path}: split {r['split']:.3e}, one "
                      f"{r['one']:.3e}, split vs one "
                      f"{r['split_vs_one']:.3e}; gradient gap split "
                      f"{r['split_grad_gap']:.3e}, one {r['grad_gap']:.3e};"
                      f" at the worst element the reference's gradient is "
                      f"{r['grad_at_worst_over_max']:.3e} of the leaf's "
                      f"largest, {r['grad_at_worst_over_eps']:.3g} x eps, "
                      f"the split's off it by "
                      f"{r['split_grad_gap_at_worst_over_eps']:.3g} x eps")
    stop_rank_server()
    dest = ROOT / "chiprun_out" / "fsdp_lr_noise.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "tests"))
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--jax-grads"]:
        jax_grads(sys.argv[2])
        sys.exit(0)
    torch_lrs = [float(x) for x in sys.argv[1:]] or [1e-3, 3e-4]
    sys.exit(main(torch_lrs))
