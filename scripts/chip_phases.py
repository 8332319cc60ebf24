#!/usr/bin/env python3
"""Some of ``chip_smoke.py``'s phases alone on the card, after its
first phase (the card's name and power limit, the kernels' build):

    python3 scripts/chip_phases.py split          # phase_engine_split
    python3 scripts/chip_phases.py kernels split train dryrun mamba moe
    python3 scripts/chip_phases.py tp             # phase_train_tp's (b)
    python3 scripts/chip_phases.py tp_ssm         # its mamba, jamba runs
    python3 scripts/chip_phases.py tp_dtype       # mamba's split in f32
    python3 scripts/chip_phases.py tp_round tp_plain
    python3 scripts/chip_phases.py fsdp           # FSDP + TP, four cards
    python3 scripts/chip_phases.py fsdp_f32       # its float32 cells
    python3 scripts/chip_phases.py fsdp_a         # phase_train_fsdp
    python3 scripts/chip_phases.py fsdp_round     # the bf16 misses' cause
    python3 scripts/chip_phases.py long           # long_500k's decode
    python3 scripts/chip_phases.py long_a         # phase_long_decode

``kernels`` runs ``phase_kernels`` and ``phase_stream_kernels``;
``split`` the trials split over every visible card (with two or more,
each kernel launched on a card that is not current); ``train``,
``mamba`` and ``moe`` ``phase_train`` on the llama3.2-1b, mamba2-780m
and phi3.5-moe cells; ``mamba_full`` the mamba2-780m cell at all 48
layers (the script cuts it to 8); ``dryrun`` ``phase_dryrun``; ``tp``
``phase_train_tp``'s (b) alone, the training cells split over the model
axis with one NCCL rank a card (llama3.2-1b at model 2 x W 2 and model
4, phi3.5-moe at one layer with model 4, mamba2-780m at model 2 x W 2
and model 4 with its updates held to its f32 one-process run, jamba at
5 layers with model 4 against its plain versions' split run: four
cards; its readings also go to
``chiprun_out/chip_phases_tp.json``), ``tp_ssm`` the mamba2-780m and
jamba runs of (b) alone, and ``tp_a`` the phase's one-card part (a);
``tp_dtype`` (``tp_dtype``) the mamba2-780m cell of (b) at model 2 x W 2
as four gloo ranks on one card, against the one-process run, with the
config in bfloat16, in float32, and in bfloat16 with the out
projection's partial products summed in f32
(``chiprun_out/chip_phases_tp_dtype.json``); ``tp_round`` the
one-process run of that cell against itself with one rounding of the
split's added (``tp_round``); ``tp_plain`` ``tp_run``'s plain-versions
reference on one card (TRAIN at RANKS_CUT layers, two gloo ranks,
model 2), the route (b) takes for jamba.  ``fsdp`` runs
``chip_smoke.FSDP_CARDS``, the plain steps with FSDP + TP (``train.pjit_step``
on a (data, model) mesh) with one NCCL rank a card: llama3.2-1b at full
width at data 2 x model 2 and data 4 x model 1 and phi3.5-moe at one
layer at 2 x 2 against the one-process run (three AdamW train steps at
16 x 256, a prefill and eight teacher-forced decode steps), starcoder2-7b
at full width at 2 x 2 against its plain versions' split run; each
rank's walls and peak (against the dry-run's meta trace of the same
rank's step), collective bytes by axis, bus bandwidth, K6 at each cell's
rank shape (``chiprun_out/chip_phases_fsdp.json``), and llama3.2-1b's
and phi3.5-moe's 2 x 2 cells again with the config in float32 on both
sides, under the same gates; ``fsdp_f32`` those two float32 cells
alone; ``fsdp_a`` the
script's one-card phase (``phase_train_fsdp``: two gloo ranks sharing
the card at data 2); ``fsdp_round`` (``fsdp_round``) the
one-process bf16 runs of ``chip_smoke.FSDP_ANCHORED``'s cells and of
llama3.2-1b at data 4 with the split's rounding emulated, nothing split
(``round_runs``: each weight gradient formed as the split over ``data``
forms it, ``round_step``, from one forward or from each part's own;
in the 2 x 2 cells also the model axis's rounding, ``model_halves``),
held to the one-process run under the four-card gates and to the
float32 run under the anchored ones
(``chiprun_out/chip_phases_fsdp_round.json``).  ``long`` runs
``chip_smoke.LONG_CARDS``, ``long_500k``'s decode with the KV cache's
524,288 positions split over ``data`` and batch 1 on every rank, one
NCCL rank a card: gemma3-1b at data 4 and at data 2 x model 2 (which
cuts its kv head), mamba2-780m at data 4, jamba at 8 layers at 2 x 2,
each against its one-process decode on one card
(``chiprun_out/chip_phases_long.json``); ``long_a`` the script's
one-card phase (``phase_long_decode``: gemma3-1b as two gloo ranks at
data 2).
Run from the root of a checkout; the phases print their readings and
raise on a failed check.
"""
import contextlib
import pathlib
import sys
import time

PHASES = ("kernels", "split", "train", "dryrun", "mamba", "mamba_full",
          "moe", "tp", "tp_ssm", "tp_a", "tp_dtype", "tp_round",
          "tp_plain", "fsdp", "fsdp_f32", "fsdp_a", "fsdp_round", "long",
          "long_a")


def _f32_out_rank(rank: int, world: int, job) -> None:
    """A split run's rank whose mamba out projection forms each rank's
    partial product in f32 and rounds once, after the sum over
    ``model`` (as one process rounds its whole product once)."""
    import torch.nn.functional as F

    from repro_torch.launch import train as launch
    from repro_torch.models import parallel, ssm
    from repro_torch.models.layers import dtype_of, rmsnorm

    whole = ssm._gate_out

    def gate_out(params, y, z, cfg, ax=None):
        if ax is None:
            return whole(params, y, z, cfg)
        y = y * F.silu(z.float())
        y = rmsnorm({"scale": params["norm"]}, y.to(dtype_of(cfg)),
                    cfg.norm_eps, width=ssm.dims(cfg)[0])
        out = y.float() @ params["out"].float()
        return parallel.reduce(out, ax).to(dtype_of(cfg))

    ssm._gate_out = gate_out
    launch.rank_main(rank, world, job)


def tp_round(C, torch, seed, mask) -> dict:
    """MAMBA_TRAIN's one-process run in bfloat16 against the same run
    whose mamba out projection forms the products of d_inner's two
    halves apart, each rounded to bfloat16, and rounds their f32 sum
    again: the rounding a model axis of 2 adds to that product, with
    nothing split.  Each leaf's ||halves - one|| / ||one's update||
    (``train_run_diffs``)."""
    import torch.nn.functional as F

    from repro_torch.core import tree
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.models.layers import dtype_of, rmsnorm

    spec = C.MAMBA_TRAIN
    cfg, opt, tc, attack, _ = C.train_cfg_objects(spec)
    job = C.ranks_job(torch, cfg, opt, tc, attack, spec, seed, mask,
                      device="cuda", actions=(("run", spec["steps"]),))
    whole = ssm._gate_out

    def gate_out(params, y, z, cfg, ax=None):
        y = y * F.silu(z.float())
        y = rmsnorm({"scale": params["norm"]}, y.to(dtype_of(cfg)),
                    cfg.norm_eps)
        h, w = y.shape[-1] // 2, params["out"]
        out = (y[..., :h] @ w[:h]).float() + (y[..., h:] @ w[h:]).float()
        return out.to(dtype_of(cfg))

    one = C.one_process_run(torch, job)
    ssm._gate_out = gate_out
    try:
        two = C.one_process_run(torch, job)
    finally:
        ssm._gate_out = whole
    init = [x.detach().cpu() for x in tree.leaves(
        M.init_train(cfg, tc.seed, "cuda"))]
    n_p = one["n_params"]
    d = C.train_run_diffs(torch, init, two["final"][:n_p], two["history"],
                          one["final"][:n_p], one["history"], cfg)
    ctl = [[{k: v for k, v in r.items() if k != "loss"} for r in x]
           for x in (one["history"], two["history"])]
    print(f"tp_round bfloat16: one process, the out product in two "
          f"rounded halves, vs one process: control equal "
          f"{ctl[0] == ctl[1]}, {C.train_diff_text(d, C.RANKS_UPDATE_REL)};"
          f" per leaf {[round(x, 6) for x in d['update_rel']]}", flush=True)
    return dict(control_equal=ctl[0] == ctl[1], update_rel=d["update_rel"],
                update_rel_max=d["update_rel_max"],
                worst_leaf=d["worst_leaf"], loss0_rel=d["loss0_rel"],
                drop_rel=d["drop_rel"])


def round_step(parts: int, drop: bool = False, micro: bool = False):
    """A ``pjit_step.make_train_step`` whose gradients are formed as a
    split over ``parts`` data ranks forms them, with nothing split: each
    part's share of the global loss (its rows' cross-entropy,
    ``models.model.token_nll``, over the global token count, and 1 /
    parts of the MoE aux) differentiated alone, each share's gradient
    rounded to the leaf's dtype by autograd, the shares summed in f32 in
    part order and cast to the leaf's dtype once, as
    ``DataAxis.reduce_scatter_sum`` and ``all_reduce_ordered`` sum the
    ranks' partials.  The shares read one forward of the whole batch, or
    with ``micro`` each its own forward of its rows, the products at a
    data rank's shapes (a dense model's: a replayed MoE routing is the
    whole batch's).  ``drop`` leaves the last part's share out of every
    leaf (the emulated ``chip_smoke.dropped_partial``).  The layers run
    without remat (their gradients are bitwise those with it), so the
    graph can be read once a part."""
    import dataclasses

    import torch

    from repro_torch.core import tree
    from repro_torch.models import model as M
    from repro_torch.optim import opt_update

    def make(cfg, opt):
        fwd = dataclasses.replace(cfg, remat=False)

        def train_step(params, opt_state, batch, step):
            req = [p.detach().requires_grad_() for p in tree.leaves(params)]
            denom = torch.clamp((batch["labels"] >= 0).sum(), min=1)
            rows = batch["tokens"].shape[0] // parts

            def share_of(i, whole):
                if whole is None:
                    cut = {k: v[i * rows:(i + 1) * rows]
                           for k, v in batch.items()}
                    logits, _, aux = M.forward(M.layer_views(
                        tree.unflatten(params, req), fwd), cut, fwd)
                    nll = M.token_nll(logits, cut["labels"], fwd)[0]
                else:
                    nll, aux = whole
                    nll = nll[i * rows:(i + 1) * rows]
                return nll.sum() / denom + M.MOE_AUX_COEF * aux / parts

            whole = None
            if not micro:
                logits, _, aux = M.forward(M.layer_views(
                    tree.unflatten(params, req), fwd), batch, fwd)
                whole = (M.token_nll(logits, batch["labels"], fwd)[0], aux)
                del logits
            total, loss = None, None
            used = parts - 1 if drop else parts
            for i in range(parts):
                share = share_of(i, whole)
                loss = share.detach() if loss is None else \
                    loss + share.detach()
                if i >= used:
                    continue
                g = torch.autograd.grad(
                    share, req, retain_graph=micro is False and i < used - 1,
                    materialize_grads=True)
                total = [x.float() for x in g] if total is None else [
                    a + x.float() for a, x in zip(total, g)]
            grads = [g.to(p.dtype) for g, p in zip(total, req)]
            del req, whole
            params, opt_state, om = opt_update(
                opt, tree.unflatten(params, grads), opt_state, params, step)
            return params, opt_state, {"loss": loss, **om}

        return train_step

    return make


@contextlib.contextmanager
def model_halves(n: int):
    """The rounding a model axis of ``n`` adds to a dense or MoE
    decoder's products, with nothing split: attention's q / k / v and a
    dense MLP's gate / up formed from ``n`` copies of their input, each
    copy's columns those of one model rank (its heads, its ffn slice),
    so autograd rounds each copy's input gradient (a rank's partial) to
    bf16 before the copies' f32 sum, cast once (``parallel.copy``'s
    backward); wo's and down's products formed by the ranks' row blocks,
    each rounded to bf16, summed in f32 and cast once (``parallel.reduce``);
    the unembed's input gradient from each rank's vocab columns likewise.
    Attention itself runs on every head at once (each head alone), the
    MoE experts as one process runs them (an expert split sums one
    token's choices exactly: at most one partial is nonzero a choice);
    the vocab-split loss's f32 sums are not emulated."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    class Copies(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return tuple(x.view_as(x) for _ in range(n))

        @staticmethod
        def backward(ctx, *gs):
            out = gs[0].to(torch.float32, copy=True)
            for g in gs[1:]:
                out = out + g.float()
            return out.to(gs[0].dtype)

    def cols(w, r):
        c = w.shape[-1] // n
        return w[..., r * c:(r + 1) * c]

    def rows_sum(x, w):
        c, y = w.shape[0] // n, None
        for r in range(n):
            part = (x[..., r * c:(r + 1) * c] @ w[r * c:(r + 1) * c]).float()
            y = part if y is None else y + part
        return y.to(x.dtype)

    real = (A.output_proj, A.self_attention, T.mlp, M.unembed)

    def output_proj(params, o):
        return rows_sum(o.reshape(*o.shape[:2], -1), params["wo"])

    def self_attention(p, h, cfg, positions, *, causal, window, impl=None):
        if A.heads_split(p, cfg):
            return real[1](p, h, cfg, positions, causal=causal,
                           window=window, impl=impl)
        qs, ks, vs = [], [], []
        for r, x in enumerate(Copies.apply(h)):
            pr = dict(p, wq=cols(p["wq"], r), wk=cols(p["wk"], r),
                      wv=cols(p["wv"], r))
            qs.append(A.project_q(pr, x, cfg, positions))
            k, v = A.project_kv(pr, x, cfg, positions)
            ks.append(k)
            vs.append(v)
        q, k, v = (torch.cat(t, dim=2) for t in (qs, ks, vs))
        o = A.blockwise_attention(q, k, v, causal=causal, window=window,
                                  impl=impl)
        return output_proj(p, o), (k, v)

    def mlp(params, x, d_ff=None):
        if d_ff is not None and params["gate"].shape[-1] != d_ff:
            return real[2](params, x, d_ff)
        hs = []
        for r, xr in enumerate(Copies.apply(x)):
            g = xr @ cols(params["gate"], r)
            hs.append(F.silu(g.to(torch.float32)).to(xr.dtype)
                      * (xr @ cols(params["up"], r)))
        return rows_sum(torch.cat(hs, dim=-1), params["down"])

    def unembed(params, x, cfg):
        w = params["tokens"].T if cfg.tie_embeddings else params["head"]
        if w.shape[-1] != cfg.vocab_size:
            return real[3](params, x, cfg)
        return torch.cat([xr.to(torch.float32) @ cols(w, r).to(torch.float32)
                          for r, xr in enumerate(Copies.apply(x))], dim=-1)

    A.output_proj, A.self_attention, T.mlp, M.unembed = (
        output_proj, self_attention, mlp, unembed)
    try:
        yield
    finally:
        A.output_proj, A.self_attention, T.mlp, M.unembed = real


#: the cells ``fsdp_round`` runs: FSDP_ANCHORED's, and llama3.2-1b at data
#: 4, whose split (data only) it is held against
ROUND_CELLS = ("llama3.2-1b data 4 x model 1",)


def round_runs(cfg, spec) -> dict:
    """``fsdp_round``'s emulations of a cell's split, by name: (the
    ``round_step``, whether ``model_halves`` adds the model axis's
    rounding).  "round" the data axis's partial gradients from one
    forward; "micro" each from its own forward of the part's rows (dense
    models); "+tp" with the model axis's rounding (model above 1)."""
    parts, model = spec["data"], spec["model"]
    runs = {"round": (round_step(parts), False)}
    if cfg.moe is None:
        runs["micro"] = (round_step(parts, micro=True), False)
    if model > 1:
        for k in list(runs):
            runs[k + "+tp"] = (runs[k][0], True)
    return runs


def fsdp_round(C, torch) -> dict:
    """The bf16 cells of ``C.FSDP_ANCHORED`` (and ROUND_CELLS) in one
    process, from the same initial parameters on the same batch (the
    MoE routing recorded by the first run and replayed by the others,
    the decode fed the first's tokens): the plain run ("one"), the
    emulations of the split's rounding (``round_runs``: each weight
    gradient formed as the split over ``data`` forms it, from one
    forward or from each part's; with the model axis's rounding added,
    ``model_halves``), the run in float32 from the bf16 initial
    parameters cast to f32 ("f32"), and the most faithful emulation
    (the last of ``round_runs``) with the last part's share dropped
    ("drop").  Each emulation against one with the four-card gates'
    measures (each leaf's ||x - one|| / ||one - init||, the losses'
    relative gap, the prefill's and the decode's logits over
    FSDP_LOGITS_REL * (1 + max|logits|), the tokens held); then
    FSDP_ANCHORED's three measures with the most faithful emulation as
    the split and drop as the losses' and logits' plant
    (``anchored_updates``, ``anchored_losses``, ``anchored_logits``)."""
    out = {}
    for label, spec, _ in C.FSDP_CARDS:
        if label not in C.FSDP_ANCHORED + ROUND_CELLS:
            continue
        t0 = time.perf_counter()
        cfg = C.cell_cfg(spec)
        tape = C.RoutingTape() if cfg.moe is not None else None
        one = C.fsdp_one(torch, spec, tape, keep_last=True)
        runs = {"one": one}
        kw = dict(replay=True, forced=one["serve"][2])
        emulated = round_runs(cfg, spec)
        for name, (make, tp) in emulated.items():
            with model_halves(spec["model"]) if tp else \
                    contextlib.nullcontext():
                runs[name] = C.fsdp_one(torch, spec, tape, **kw,
                                        make_step=make)
        best = list(emulated)[-1]
        runs["f32"] = C.fsdp_one(torch, spec, tape, **kw, f32=True)
        with model_halves(spec["model"]) if emulated[best][1] else \
                contextlib.nullcontext():
            runs["drop"] = C.fsdp_one(
                torch, spec, tape, **kw, make_step=round_step(
                    spec["data"], drop=True, micro="micro" in best))
        losses = {k: [h["loss"] for h in r["history"]]
                  for k, r in runs.items()}
        vs_one = {}
        for name in emulated:
            rel = []
            for p0, a, b in zip(one["init"], runs[name]["final"],
                                one["final"]):
                p0, a, b = (t.to("cuda").float() for t in (p0, a, b))
                moved = float((b - p0).norm())
                rel.append(float((a - b).norm()) / moved if moved else 0.0)
            vs_one[name] = dict(
                update_rel=rel, update_rel_max=max(rel),
                loss_rel=max(abs(a - b) / abs(b) for a, b in zip(
                    losses[name], losses["one"])),
                **C.serve_measure(runs[name]["serve"], one["serve"]))
        sums = []
        for p0, a, b, b0, c in zip(one["init"], runs[best]["final"],
                                   one["final"], one["prev"],
                                   runs["f32"]["final"]):
            p0, a, b, b0, c = (t.to("cuda").float() for t in
                               (p0, a, b, b0, c))
            sums.append([float((a - c).square().sum()),
                         float((b - c).square().sum()),
                         float((a - (b - b0) - c).square().sum()),
                         float((c - p0).square().sum())])
        res = dict(
            vs_one=vs_one, best=best,
            anchored=dict(
                updates=C.anchored_updates(sums),
                losses=C.anchored_losses(losses[best], losses["one"],
                                         losses["f32"], losses["drop"]),
                logits=C.anchored_logits(runs[best]["serve"], one["serve"],
                                         runs["f32"]["serve"],
                                         runs["drop"]["serve"])),
            losses=losses)
        if tape is not None:
            res.update(flips=tape.flips, choices=tape.choices)
        res["seconds"] = time.perf_counter() - t0
        out[label] = res
        for name, r in vs_one.items():
            print(f"fsdp_round {label} {name}: one process with the split's "
                  f"rounding emulated vs one process: updates within "
                  f"{r['update_rel_max']:.4f} (limit {C.RANKS_UPDATE_REL}), "
                  f"losses {r['loss_rel']:.3e} (limit {C.TP_LOSS_REL}), "
                  f"logits {r['logits_err_over_tol']:.3f} of the limit, "
                  f"tokens held {r['tokens_held']}/{r['tokens']}; per leaf "
                  f"{[round(x, 4) for x in r['update_rel']]}", flush=True)
        print(f"fsdp_round {label}: {best} anchored to the f32 run (its "
              f"excess / drop's): " + ", ".join(
                  f"{k} {m['excess_max']:.4g} / {m['planted_excess_max']:.4g}"
                  for k, m in res["anchored"].items())
              + (f"; {res['flips']} of {res['choices']} routing choices "
                 f"flip" if tape is not None else "")
              + f"; {res['seconds']:.1f} s", flush=True)
        del one, runs
    return out


def tp_dtype(C, torch, seed, mask) -> dict:
    """MAMBA_TRAIN at model 2 x W 2 as four gloo ranks on this card
    against the one-process run of the same job: for each of bfloat16,
    float32 and bfloat16 with ``_f32_out_rank``, the control, the
    identified workers and each leaf's ||split - one|| / ||one's
    update|| (``train_run_diffs``); and each bfloat16 run's update
    p_final - p_init against the float32 one-process run's, per leaf
    ||upd - upd_f32|| / ||upd_f32||."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.core import tree
    from repro_torch.launch import train as launch
    from repro_torch.models import model as M

    spec, W, model = C.MAMBA_TRAIN, 2, 2
    out, finals = {}, {}

    def upd_rel(a, a0, b, b0):
        rel = []
        for x, x0, y, y0 in zip(a, a0, b, b0):
            x, x0, y, y0 = (t.cuda().float() for t in (x, x0, y, y0))
            if bool((y != y0).any()):
                rel.append(float(((x - x0) - (y - y0)).norm()
                                 / (y - y0).norm()))
        return rel

    for dt, variants in (("bfloat16", ("as is", "f32 out partials")),
                         ("float32", ("as is",))):
        cfg, opt, tc, attack, _ = C.train_cfg_objects(spec)
        cfg = dataclasses.replace(cfg, dtype=dt)
        job = C.ranks_job(torch, cfg, opt, tc, attack, spec, seed, mask,
                          device="cuda", backend="gloo", keep_params=True,
                          model=model, actions=(("run", spec["steps"]),))
        init = [x.detach().cpu() for x in tree.leaves(
            M.init_train(cfg, tc.seed, "cuda"))]
        t0 = time.perf_counter()
        one = C.one_process_run(torch, job)
        n_p = one["n_params"]
        finals[dt, "one"] = (one["final"][:n_p], init)
        print(f"tp_dtype {dt}: the one-process run "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for var in variants:
            d = pathlib.Path(tempfile.mkdtemp(prefix="ranks_",
                                              dir=C.ROOT / "build"))
            t0 = time.perf_counter()
            try:
                j = dataclasses.replace(
                    job, out=str(d),
                    init_method=f"tcp://localhost:{launch.free_port()}")
                fn = _f32_out_rank if var != "as is" else launch._spawned
                launch.start_ranks(fn, (W * model, j), W * model)
                res = [torch.load(d / f"rank{r}.pt")
                       for r in range(W * model)]
            finally:
                shutil.rmtree(d, ignore_errors=True)
            hist = res[0]["main"]["history"]
            ctl = [[{k: v for k, v in r.items() if k != "loss"} for r in
                    x["main"]["history"]] for x in res]
            diffs = C.train_run_diffs(torch, init, res[0]["params"]["main"],
                                      hist, one["final"][:n_p],
                                      one["history"], cfg)
            finals[dt, var] = (res[0]["params"]["main"], init)
            key = f"{dt}, {var}"
            out[key] = dict(
                control_equal=all(c == ctl[0] for c in ctl) and ctl[0] == [
                    {k: v for k, v in r.items() if k != "loss"}
                    for r in one["history"]],
                identified=sorted(w for r in hist
                                  for w in r.get("identified", [])),
                loss_rel=max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                             for a, b in zip(hist, one["history"])),
                update_rel=diffs["update_rel"],
                update_rel_max=diffs["update_rel_max"],
                worst_leaf=diffs["worst_leaf"],
                ranks_agree=all(r["agree"] for r in res),
                seconds=time.perf_counter() - t0)
            print(f"tp_dtype {key}: split vs one process: control equal "
                  f"{out[key]['control_equal']}, identified "
                  f"{out[key]['identified']}, losses rel diff "
                  f"{out[key]['loss_rel']:.3e}, "
                  f"{C.train_diff_text(diffs, C.RANKS_UPDATE_REL)}; per "
                  f"leaf {[round(x, 6) for x in diffs['update_rel']]}; "
                  f"{out[key]['seconds']:.1f} s", flush=True)
        del one
    ref, ref0 = finals["float32", "one"]
    for (dt, var), (a, a0) in finals.items():
        if dt == "bfloat16":
            r = upd_rel(a, a0, ref, ref0)
            out[f"bfloat16 {var} update vs float32 one process"] = r
            print(f"tp_dtype bfloat16 {var}: each leaf's update against "
                  f"the float32 one-process run's, ||upd - upd_f32|| / "
                  f"||upd_f32||: {min(r):.4f}..{max(r):.4f} "
                  f"({[round(x, 4) for x in r]})", flush=True)
    return out


def main(which) -> int:
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as C

    unknown = sorted(set(which) - set(PHASES))
    if unknown or not which:
        print(f"chip_phases: name phases among {PHASES}, got {which}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(C.SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    checks = []
    try:
        C.phase_card(torch)
        t0 = time.perf_counter()
        if "kernels" in which:
            C.phase_kernels(torch)
            C.phase_stream_kernels(torch)
        if "split" in which:
            C.phase_engine_split(torch)
        if "train" in which:
            C.phase_train(torch, C.TRAIN, "train")
        if "dryrun" in which:
            C.phase_dryrun(torch, None)
        if "mamba" in which:
            C.phase_train(torch, C.MAMBA_TRAIN, "mamba_train")
        if "mamba_full" in which:
            C.phase_train(torch, dict(C.MAMBA_TRAIN, layers=None),
                          "mamba_train")
        if "moe" in which:
            C.phase_train(torch, C.MOE_TRAIN, "moe_train")
        if {"fsdp", "fsdp_f32", "fsdp_a"} & set(which):
            import json

            out = {}
            if "fsdp_a" in which:
                out["a"] = C.phase_train_fsdp(torch)[2]
            if "fsdp" in which or "fsdp_f32" in which:
                out["cards"] = C.fsdp_cards(
                    torch, None if "fsdp" in which else C.FSDP_F32_CELLS)
            path = root / "chiprun_out" / (
                "chip_phases_fsdp.json" if "fsdp_f32" not in which else
                "chip_phases_fsdp_f32.json")
            path.parent.mkdir(exist_ok=True)
            path.write_text(json.dumps(out, indent=1, default=str))
            if "cards" in out:
                # held after every phase asked for has run
                checks.append(out["cards"])
        if {"long", "long_a"} & set(which):
            import json

            out = {}
            if "long_a" in which:
                out["a"] = C.phase_long_decode(torch)[1]
            if "long" in which:
                out["cards"] = C.long_cards(torch)
            path = root / "chiprun_out" / "chip_phases_long.json"
            path.parent.mkdir(exist_ok=True)
            path.write_text(json.dumps(out, indent=1, default=str))
            if "cards" in out:
                checks.append(out["cards"])
        if "fsdp_round" in which:
            import json

            out = fsdp_round(C, torch)
            path = root / "chiprun_out" / "chip_phases_fsdp_round.json"
            path.parent.mkdir(exist_ok=True)
            path.write_text(json.dumps(out, indent=1, default=str))
        if {"tp", "tp_ssm", "tp_a", "tp_dtype", "tp_round",
                "tp_plain"} & set(which):
            import json

            import numpy as np

            from repro_torch.launch import train as launch

            spec = C.TRAIN
            seed = C.train_seed(spec["n"], spec["f"], spec["byz"])
            mask = np.isin(np.arange(spec["n"]), spec["byz"])
            out = {}
            try:
                if "tp_a" in which:
                    out["a"] = C.phase_train_tp(torch, spec)[2]
                if "tp_dtype" in which:
                    out["dtype"] = tp_dtype(C, torch, seed, mask)
                if "tp_round" in which:
                    out["round"] = tp_round(C, torch, seed, mask)
                if "tp_plain" in which:
                    out["plain"] = C.tp_run(
                        torch, dict(spec, layers=C.RANKS_CUT), seed, mask,
                        1, C.TP_SPLIT, "gloo", "tp plain reference, two "
                        "gloo ranks on one card", ref="plain")[0]
                if "tp" in which or "tp_ssm" in which:
                    out["b"] = C.tp_cards(
                        torch, seed, mask, torch.cuda.device_count(),
                        None if "tp" in which else ("MAMBA_TRAIN",
                                                    "JAMBA_TRAIN"))
            finally:
                launch.stop_rank_server()
            name = ("chip_phases_tp.json" if {"tp", "tp_ssm", "tp_a"} &
                    set(which) else f"chip_phases_{'_'.join(which)}.json")
            path = root / "chiprun_out" / name
            path.parent.mkdir(exist_ok=True)
            path.write_text(json.dumps(out, indent=1, default=str))
            if "b" in out:
                C.tp_cards_passed(out["b"])
        print(f"chip_phases: {which} in {time.perf_counter() - t0:.1f} s")
        for report in checks:
            C.fsdp_cards_passed(report)
    finally:
        C.stop_children()
    return 0


# the spawned ranks run this module: nothing outside the guard
if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
