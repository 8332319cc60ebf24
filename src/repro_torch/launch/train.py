"""Training launcher of the port.

Instantiates the BFT trainer for a registered dense, MoE, Mamba2 or
hybrid architecture (``--arch llama3.2-1b``, ``--arch
phi3.5-moe-42b-a6.6b``, ``--arch mamba2-780m``, ``--arch
jamba-v0.1-52b``) and runs it with checkpointing, restart and the
randomized reactive-redundancy protocol live.

The n workers run as W ranks of a ``torch.distributed`` group over the
``data`` axis (``launch.mesh.make_worker_mesh``, ``train.ranks``), each
rank running its n/W workers, as the reference runs one worker a
device.  By default W is the largest count of visible cards that
divides n (one NCCL rank a card); ``--nproc 1``, and the default on the
CPU, runs all n workers in this process with no process group.
``--model M`` splits each worker over M ranks (tensor and expert
parallel, the dense and MoE decoders): the world is W x M ranks, global
rank d * M + m, one NCCL rank a card or gloo ranks sharing one.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama3.2-1b --steps 50 --mode randomized --f 2 \\
        --byz 2,5 --ckpt-dir runs/run1
    # restart after an interruption:
    PYTHONPATH=src python -m repro_torch.launch.train ... --restore
    # a reduced model on the CPU, 4 gloo ranks of 2 workers:
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --nproc 4 --steps 20
    # two gloo ranks sharing one card (operands staged through the host):
    PYTHONPATH=src python -m repro_torch.launch.train --nproc 2 \\
        --backend gloo ...
    # each worker split over 2 ranks: 2 x 2 NCCL ranks on four cards
    PYTHONPATH=src python -m repro_torch.launch.train --nproc 2 \
        --model 2 ...
    # under torchrun (RANK, WORLD_SIZE, LOCAL_RANK from the environment):
    PYTHONPATH=src torchrun --nproc-per-node 4 -m \\
        repro_torch.launch.train --arch llama3.2-1b ...

The flags are the reference's (``repro.launch.train``); ``--workers``
is the worker count n, ``--nproc`` the rank count W, ``--backend`` the
process group's backend (nccl on the card, gloo on the CPU by default),
``--device`` the device, ``--model`` the ranks of a worker.
``rank_main`` is one rank's body: this
launcher, the tests and ``chip_smoke.py`` spawn it with a ``Job``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.core.randomized import BFTConfig
from repro_torch.optim import OptConfig
from repro_torch.train import AttackConfig, StepConfig, Trainer, TrainerConfig
from repro_torch.train import ranks as R


@dataclasses.dataclass
class Job:
    """One training run as every rank runs it.

    ``actions``: ("run", steps), ("restart", total steps): a second
    trainer restores the latest checkpoint and runs to the total,
    ("check_fault", seed): a
    check step on the current state with a Byzantine worker in a replica
    group, which must find the fault and leave the parameters and
    optimizer state bitwise unchanged (its launches are kept apart from
    the training's), or ("launch", the launcher's
    parsed flags): the launcher's restore, run and summary, or
    ("all_reduce_bw", bytes): an f32 all-reduce of that size timed (the
    median of 5 after 2 warm-ups) and its bus bandwidth, 2 (W-1)/W bytes
    over the seconds.  ``params``:
    the path of a ``torch.save``'d parameter tree (CPU) to start from,
    else random from ``tc.seed``.  ``out``: a directory for each rank's result
    (``rank<r>.pt``).  ``keep_params``: the results carry the final
    parameter leaves (whole, gathered over the model axis) and their
    checksums (``params_sum``).  ``leaves_on``: with ``keep_params``, the
    leaves on this global rank only (a model that fills a card cannot
    bring every rank's home), the checksums on every rank.  ``plant``:
    after the run, one ulp changed on the last rank must fail
    ``Ranks.agree``.  ``model``: the ranks of a worker (the world is W x
    ``model``).  ``impl``: the trainer's (``"torch"``, the kernels' plain
    versions)."""

    cfg: Any
    opt: OptConfig
    bft: BFTConfig
    tc: TrainerConfig
    attack: AttackConfig
    sc: StepConfig
    true_byzantine: np.ndarray
    actions: tuple = (("run", 1),)
    device: str = "cuda"
    backend: str = "nccl"
    init_method: str = "env://"
    timeout_s: float = R.TIMEOUT_S
    params: str | None = None
    out: str | None = None
    keep_params: bool = False
    leaves_on: int | None = None
    plant: bool = False
    threads: int = 0
    model: int = 1
    impl: str | None = None


def free_port() -> int:
    """A free TCP port on localhost for the ranks' rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def summary(tr) -> dict:
    st = tr.state
    return {"history": tr.history, "identified": st.identified.tolist(),
            "active": st.active.tolist(), "meter": st.meter.state_dict(),
            "overall": st.meter.overall, "kappa": st.kappa, "f_t": st.f_t}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_fault(tr, seed: int) -> dict:
    """A check step whose replica groups hold a Byzantine worker, on the
    trainer's state: the fault found, params and state unchanged."""
    from repro_torch.core.assignment import check_assignment
    from repro_torch.data import global_batch_for_step, worker_batches

    n, byz = tr.bft.n, np.flatnonzero(tr.true_byz)
    rng = np.random.default_rng(seed)
    while True:
        a = check_assignment(np.ones(n, bool), tr.bft.f, rng)
        if (a.group_of_worker[byz] >= 0).any():
            break
    batch = global_batch_for_step(
        tr.cfg, global_batch=tr.tc.global_batch, seq_len=tr.tc.seq_len,
        step=tr.state.step, seed=tr.tc.seed)
    before = R.checksums(tr.params, tr.opt_state)
    _, _, m = tr._step_fn("check", a)(
        tr.params, tr.opt_state, worker_batches(batch, a), a.weight,
        tr.true_byz, a.group_of_worker, tr.key, tr.state.step)
    after = R.checksums(tr.params, tr.opt_state)
    return {"any_fault": bool(m["any_fault"]),
            "unchanged": bool(torch.equal(before, after))}


def _plant(tr) -> dict:
    """One ulp changed in the first parameter element on the last rank:
    ``agree`` must fail; restored, it must pass again."""
    from repro_torch.core import tree

    words = R._words(tree.leaves(tr.params)[0])
    last = tr.ranks.rank == tr.ranks.world - 1
    if last:
        words[0] += 1
    caught = not tr.ranks.agree(tr.params, tr.opt_state)
    table = tr.ranks.disagree.tolist()
    if last:
        words[0] -= 1
    return {"caught": caught, "table": table,
            "restored": tr.ranks.agree(tr.params, tr.opt_state)}


def _all_reduce_bw(ranks, nbytes: int, device) -> dict:
    import statistics

    buf = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    times = []
    for i in range(7):
        _sync(device)
        t0 = time.perf_counter()
        ranks.all_reduce_sum(buf)
        _sync(device)
        if i >= 2:
            times.append(time.perf_counter() - t0)
    s = statistics.median(times)
    w = ranks.world
    return {"bytes": buf.numel() * 4, "seconds": s,
            "busbw": 2 * (w - 1) / w * buf.numel() * 4 / s}


def _count_fast(tr, device) -> dict:
    """One fast step on ``tr``'s state under the dry-run's counter, its
    state restored after: what a rank of this mesh computes and moves in
    a fast step, to hold the meta trace (``launch.dryrun``) against."""
    from repro_torch.core import tree
    from repro_torch.core.assignment import fast_assignment
    from repro_torch.data import global_batch_for_step, worker_batches
    from repro_torch.launch.dryrun import count_step

    a = fast_assignment(tr.state.active)
    batch = global_batch_for_step(
        tr.cfg, global_batch=tr.tc.global_batch, seq_len=tr.tc.seq_len,
        step=tr.state.step, seed=tr.tc.seed)
    keep = [t.clone() for t in tree.leaves(tr.params)
            + tree.leaves(tr.opt_state)]
    axes = [tr.ranks] + ([tr.ranks.model] if tr.ranks.model else [])
    staged0 = sum(x.counts["staged_bytes"] for x in axes)
    args = (tr.params, tr.opt_state, worker_batches(batch, a), a.weight,
            tr.true_byz & tr.state.active, tr.key, tr.state.step)
    _sync(device)
    _, res = count_step(tr._step_fn("fast", a), args, device.type,
                        group=tr.ranks.world)
    _sync(device)
    for t, k in zip(tree.leaves(tr.params) + tree.leaves(tr.opt_state),
                    keep):
        t.copy_(k)
    del keep
    res["staged_bytes"] = sum(x.counts["staged_bytes"] for x in axes) - \
        staged0             # beside the count, which leaves them out
    res["active"] = tr.state.active.tolist()
    return res


def run_job(job: Job, mesh, device: torch.device) -> tuple[dict, Any]:
    """The actions of ``job`` on this rank: (result, the last trainer)."""
    from repro_torch.core import tree
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    init = None if job.params is None else torch.load(job.params)

    def new():
        params = None if init is None else M.map_params(
            lambda x: x.to(device, copy=True), init)
        return Trainer(job.cfg, job.opt, job.bft, job.tc, attack=job.attack,
                       sc=job.sc, true_byzantine=job.true_byzantine,
                       device=device, params=params, mesh=mesh,
                       impl=job.impl)

    ops.reset_launch_counts()
    tr, tr_b, resumed = new(), None, None
    walls, sums, probes, aside, extra = [], [], [], [], {}

    def steps(t, k):
        for _ in range(k):
            _sync(device)
            t0 = time.perf_counter()
            t.run(1)
            _sync(device)
            walls.append(time.perf_counter() - t0)
            sums.append(R.checksums(t.params, t.opt_state).cpu())

    action_s = []
    for act, arg in job.actions:
        t_act = time.perf_counter()
        if act == "run":
            steps(tr, arg)
        elif act == "restart":
            tr_b = new()
            resumed = tr_b.restore_latest()
            steps(tr_b, arg - (resumed or 0))
        elif act == "check_fault":
            before = ops.launch_counts()
            probes.append(_check_fault(tr_b or tr, arg))
            probes[-1]["launches"] = {k: v - before[k] for k, v in
                                      ops.launch_counts().items()}
        elif act == "launch":
            _run(tr, arg)
        elif act == "all_reduce_bw":
            extra["all_reduce_bw"] = _all_reduce_bw(tr.ranks, arg, device)
        elif act == "model_all_reduce_bw":
            extra["model_all_reduce_bw"] = _all_reduce_bw(tr.ranks.model,
                                                          arg, device)
        elif act == "count_fast":
            before = ops.launch_counts()
            extra["count_fast"] = _count_fast(tr_b or tr, device)
            aside.append({k: v - before[k] for k, v in
                          ops.launch_counts().items()})
        else:
            raise ValueError(f"unknown action {act!r}")
        action_s.append((act, time.perf_counter() - t_act))
    last = tr_b or tr
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None         # before the gathers
    full = {"main": tr.full_params() if job.keep_params else None,
            "restarted": tr_b.full_params() if job.keep_params and tr_b
            else None}
    # the training's launches: the probes' own are kept apart
    aside += [p["launches"] for p in probes]
    launches = {k: v - sum(a[k] for a in aside)
                for k, v in ops.launch_counts().items()}
    result = {
        "rank": last.ranks.rank, "world": last.ranks.world,
        "backend": last.ranks.backend, "device": str(device),
        "staged": last.ranks.staged, "main": summary(tr),
        "restarted": summary(tr_b) if tr_b else None, "resumed": resumed,
        "walls": walls, "checksums": sums, "check_fault": probes,
        "action_s": action_s,
        "launches": launches, "counts": dict(last.ranks.counts),
        "model": job.model, "model_rank": last.ranks.model.rank
        if last.ranks.model else 0,
        "model_counts": dict(last.ranks.model.counts)
        if last.ranks.model else None,
        "agree": last.ranks.agree(last.params, last.opt_state),
        "peak_bytes": peak, **extra}
    if job.plant:
        result["plant"] = _plant(last)
    if job.keep_params:
        result["params_sum"] = {k: None if v is None else
                                R.checksums(v).cpu() for k, v in full.items()}
    if job.keep_params and job.leaves_on in (None, _global_rank()):
        result["params"] = {
            k: None if v is None else [t.detach().cpu()
                                       for t in tree.leaves(v)]
            for k, v in full.items()}
    return result, last


def _global_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def rank_main(rank: int, world: int, job: Job,
              local_rank: int | None = None) -> tuple[dict, Any]:
    """One rank: join the process group (``job.backend``,
    ``job.init_method``), build the worker mesh on this rank's device,
    run ``job`` and write the result to ``job.out``; returns (result,
    trainer).  Spawned by ``spawn`` (``torch.multiprocessing``) or run
    under torchrun."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_worker_mesh

    if job.threads:
        torch.set_num_threads(job.threads)
    device = R.rank_device(job.backend, job.device,
                           rank if local_rank is None else local_rank)
    R.init(job.backend, rank, world, init_method=job.init_method,
           timeout_s=job.timeout_s, device=device)
    if world % job.model:
        raise ValueError(f"a model axis of {job.model} does not divide a "
                         f"world of {world}")
    mesh = make_worker_mesh(world // job.model, job.model,
                            device_type=device.type)
    result, trainer = run_job(job, mesh, device)
    if job.out:
        torch.save(result, os.path.join(job.out, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return result, trainer


def _spawned(rank: int, world: int, job: Job) -> None:
    rank_main(rank, world, job)


def start_ranks(fn, args: tuple, world: int) -> None:
    """``fn(rank, *args)`` in ``world`` processes, forked from a fork
    server that has imported torch and the trainer and nothing else (no
    CUDA, no thread pools), so a rank starts without importing torch
    again; a rank that raises ends them all and raises here."""
    import multiprocessing

    import torch.multiprocessing as mp

    multiprocessing.set_forkserver_preload(["torch", "repro_torch.train"])
    mp.start_processes(fn, args=args, nprocs=world, join=True,
                       start_method="forkserver")


def stop_rank_server() -> None:
    """Stop the fork server ``start_ranks`` started and the resource
    tracker it started with it, and reap both: they outlive the ranks
    until the caller exits, so a caller that must leave no process
    behind calls this when its last ranks are done.  The next
    ``start_ranks`` starts them anew."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def spawn(job: Job, world: int) -> list[dict] | None:
    """Run ``job`` as ``world`` ranks on localhost (``start_ranks``).
    Returns the ranks' results when ``job.out`` is set."""
    job = dataclasses.replace(
        job, init_method=f"tcp://localhost:{free_port()}")
    start_ranks(_spawned, (world, job), world)
    if not job.out:
        return None
    return [torch.load(os.path.join(job.out, f"rank{r}.pt"))
            for r in range(world)]


def default_nproc(n: int, device: str, model: int = 1) -> int:
    """The reference takes every device: one rank a visible card, the
    largest count W of data ranks that divides n with W x ``model``
    cards; 1 on the CPU."""
    if torch.device(device).type == "cpu":
        return 1
    cards = max(1, torch.cuda.device_count() // model)
    return max(w for w in range(1, cards + 1) if n % w == 0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="paper-smalllm", choices=list_configs())
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--mode", default="randomized",
                    choices=["randomized", "deterministic", "draco",
                             "filter", "none"])
    ap.add_argument("--filter", dest="filter_name", default="median")
    ap.add_argument("--f", type=int, default=1)
    ap.add_argument("--q", type=float, default=-1.0,
                    help="fault-check probability; <0 -> adaptive (§4.3)")
    ap.add_argument("--detection", default="sketch", choices=["sketch", "full"])
    ap.add_argument("--selective", action="store_true")
    ap.add_argument("--workers", type=int, default=8,
                    help="BFT workers n")
    ap.add_argument("--nproc", type=int, default=0,
                    help="ranks W on the data axis (0: one a visible card "
                         "that divides n; 1 on the CPU); 1 runs every "
                         "worker in this process")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks a worker is split over (tensor and expert "
                         "parallel); the world is nproc x model")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "nccl", "gloo"],
                    help="auto: nccl on the card, gloo on the CPU; gloo "
                         "lets ranks share one card")
    ap.add_argument("--byz", default="",
                    help="comma list of Byzantine ranks (simulation)")
    ap.add_argument("--attack", default="sign_flip")
    ap.add_argument("--p-tamper", type=float, default=0.6)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help='"cuda" (the default) or "cpu"')
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    workers = args.workers
    device = args.device or "cuda"
    byz = [int(x) for x in args.byz.split(",") if x]
    trainer_args = (
        cfg,
        OptConfig(kind="adamw", peak_lr=args.lr, warmup_steps=20,
                  total_steps=max(100, args.steps)),
        BFTConfig(n=workers, f=args.f, mode=args.mode,
                  q=None if args.q < 0 else args.q,
                  p_assumed=args.p_tamper, selective=args.selective,
                  seed=args.seed),
        TrainerConfig(
            seq_len=args.seq_len,
            global_batch=args.global_batch or 4 * workers,
            seed=args.seed,
            checkpoint_dir=args.ckpt_dir or None,
            checkpoint_every=args.ckpt_every if args.ckpt_dir else 0,
            filter_name=args.filter_name,
            log_every=10,
        ),
        AttackConfig(kind=args.attack if byz else "none",
                     p_tamper=args.p_tamper),
        StepConfig(detection=args.detection),
        np.isin(np.arange(workers), byz))
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    model = max(1, args.model)
    if torchrun and int(os.environ["WORLD_SIZE"]) % model:
        raise SystemExit(f"--model {model} does not divide the world "
                         f"{os.environ['WORLD_SIZE']}")
    nproc = int(os.environ["WORLD_SIZE"]) // model if torchrun else (
        args.nproc or default_nproc(workers, device, model))
    if workers % nproc:
        raise SystemExit(f"--nproc {nproc} does not divide --workers "
                         f"{workers}")
    backend = args.backend if args.backend != "auto" else (
        "gloo" if torch.device(device).type == "cpu" else "nccl")
    print(f"[launch] {cfg.name}: {workers} workers on {device}"
          + ("" if nproc * model == 1 and not torchrun else
             f" as {nproc} x {model} {backend} ranks, "
             f"{workers // nproc} workers a data rank"))

    if nproc * model == 1 and not torchrun:
        trainer = Trainer(*trainer_args[:4], attack=trainer_args[4],
                          sc=trainer_args[5], true_byzantine=trainer_args[6],
                          device=args.device)
        _run(trainer, args)
        return
    # CPU ranks share the host's cores
    threads = max(1, (os.cpu_count() or 1) // (nproc * model)) \
        if torch.device(device).type == "cpu" else 0
    job = Job(*trainer_args, device=device, backend=backend,
              actions=(("launch", args),), threads=threads, model=model)
    if torchrun:
        rank_main(int(os.environ["RANK"]), nproc * model,
                  dataclasses.replace(job, init_method="env://"),
                  local_rank=int(os.environ.get("LOCAL_RANK", 0)))
    else:
        spawn(job, nproc * model)
        stop_rank_server()


def _run(trainer, args) -> None:
    """The launcher's run: restore if asked, train to ``--steps``, and
    the summary line (rank 0's alone under ranks)."""
    first = trainer.ranks is None or trainer.ranks.rank == 0
    if args.restore:
        step = trainer.restore_latest()
        if first:
            print(f"[launch] restored step {step}")
    trainer.run(max(0, args.steps - trainer.state.step))
    st = trainer.state
    if first:
        print(
            f"[launch] done: loss={trainer.history[-1]['loss']:.4f} "
            f"eff={st.meter.overall:.3f} κ={st.kappa} "
            f"identified={sorted(np.flatnonzero(st.identified).tolist())}"
        )


if __name__ == "__main__":
    main()
