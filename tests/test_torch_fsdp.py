"""FSDP + TP for the plain train, prefill and decode steps
(``train.pjit_step`` on a rank of a (``pod``,) ``data``, ``model`` mesh)
against the JAX package's jitted steps, on the CPU.

The reference runs in two subprocesses with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``): for each
scenario ``jax.jit(make_train_step)`` three AdamW steps with clipping
active, then the prefill (``model.prefill``, the cache padded for the
decode) and four greedy ``make_decode_step`` steps, its parameters
placed by ``PARAM_RULES`` and its batch by ``ACT_RULES`` on the
scenario's mesh; this file is that script too (``python
tests/test_torch_fsdp.py OUT_DIR NAME...``).  The port runs the same
scenario from the same initial parameters as gloo ranks on one thread
each (``launch.train.start_ranks``), each holding its blocks under
``sharding.PARAM_RULES`` and its rows of the batch.  Held: losses within
1e-4 relative; parameters after ``convert.gather_params`` within
1e-4 * (1 + max|p|) a leaf; prefill logits within 1e-4; decode tokens
equal; every rank's gathered tree bitwise rank 0's (the replicated
leaves bitwise across ranks); MoE choices, slots and the kept mask
equal to the reference's routing lines (``repro/models/moe.py:108-122``,
as ``test_torch_moe.py`` runs them) on the global batch, drops present.
Scenarios (f32, reduced configs): llama3.2-1b at (data 2, model 2);
phi3.5-moe at (2, 2), 4 experts, capacity factor 0.5; mamba2-780m at
(2, 2); llama3.2-1b at (pod 2, data 2, model 1).

Beside them, with no reference run of a step: a world-1 mesh bitwise
the one-process step; rank 0's local shapes of params, AdamW state,
batch, token and cache of every decoder-only arch on 16x16, 2x16x16 and
(2, 2) against the reference's ``NamedSharding(mesh, spec).shard_shape``;
the dry-run's production plain cell of a reduced arch (and the skips);
the FSDP step traced on meta against a counted CPU rank step.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_tp import _ref_mesh
from test_torch_trainer import rank_server  # noqa: F401 (its teardown)
from torch_threads import one_thread  # noqa: F401 (one thread)

B, S, DEC = 8, 16, 4
STEPS = 3
# AdamW at the reference's default peak lr, with the clip active.  Its
# update is a gradient over its own scale, so an element whose gradient
# lies near the rounding of the leaf's larger ones moves by up to the lr
# on any change of summation order: the split's gradients agree with one
# process within about 1e-6 of each leaf's largest, and the parameter
# gate of 1e-4 * (1 + max|p|) holds three steps at this lr
OPT = dict(kind="adamw", peak_lr=3e-4, warmup_steps=1, total_steps=10,
           grad_clip=0.5)
# name -> (arch, config overrides, (pod, data, model), seed)
SCENARIOS = {
    "llama_2x2": ("llama3.2-1b", {}, (1, 2, 2), 0),
    "moe_2x2": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.5},
                (1, 2, 2), 1),
    "mamba_2x2": ("mamba2-780m", {}, (1, 2, 2), 2),
    "llama_pod": ("llama3.2-1b", {}, (2, 2, 1), 3),
}


# decode-only scenarios of ``long_500k``'s form: batch 1 on every rank, the
# KV cache's sequence split over ``data`` (``abstract_cache(...,
# long_context=True)``), at LONG_S positions: blocks of 32 at data 4 and
# 64 at data 2, so the reduced window of 32 straddles a block; a seeded
# cache filled below LONG_POS (a block boundary less 2), then LONG_STEPS
# greedy steps across the boundary.  name -> (arch, (pod, data, model),
# seed)
LONG = {
    "gemma_long_4x1": ("gemma3-1b", (1, 4, 1), 4),
    "gemma_long_2x2": ("gemma3-1b", (1, 2, 2), 5),
    "jamba_long_2x2": ("jamba-v0.1-52b", (1, 2, 2), 6),
}
LONG_S, LONG_POS, LONG_STEPS = 128, 62, 4


def long_cfg(get_config, name):
    return dataclasses.replace(get_config(LONG[name][0]).reduced(),
                               dtype="float32")


def cfg_of(get_config, name):
    arch, over, _, _ = SCENARIOS[name]
    cfg = get_config(arch).reduced()
    if "capacity_factor" in over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=over["capacity_factor"]))
    return dataclasses.replace(cfg, dtype="float32")


def host_batch(vocab, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S), np.int32)
    labels = rng.integers(0, vocab, (B, S), np.int32)
    labels[0, :3] = -100
    return tokens, labels


def moe_input(seed):
    return np.random.default_rng(100 + seed).standard_normal(
        (B * S, 64)).astype(np.float32)


# ---------------------------------------------------------------------------
# the reference, in a subprocess
# ---------------------------------------------------------------------------

def _reference_main(out_dir, names, opt_kw=None) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs import get_config
    from repro.models import model as RM
    from repro.models import moe as jmoe
    from repro.optim import OptConfig, init_opt_state
    from repro.sharding import (ACT_RULES, PARAM_RULES, make_mesh, set_mesh,
                                spec_for, tree_specs)
    from repro.train import pjit_step as jp

    def flat(params):
        paths = jax.tree_util.tree_flatten_with_path(params)[0]
        return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path): np.asarray(leaf)
                for path, leaf in paths}

    for name in names:
        if name in LONG:
            _reference_long(name, out_dir, flat)
            continue
        arch, _, (pod, data, model), seed = SCENARIOS[name]
        cfg = cfg_of(get_config, name)
        if pod > 1:
            mesh = make_mesh((pod, data, model), ("pod", "data", "model"))
        else:
            mesh = make_mesh((data, model), ("data", "model"))
        params = RM.init(cfg, jax.random.PRNGKey(seed))
        specs = tree_specs(RM.abstract_params(cfg), mesh, PARAM_RULES)
        params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
            specs)
        init = flat(params)
        opt = OptConfig(**(opt_kw or OPT))
        state = init_opt_state(opt, params)
        tokens, labels = host_batch(cfg.vocab_size, seed)
        rows = NamedSharding(mesh, spec_for(("batch", "seq"), mesh, (B, S),
                                            ACT_RULES))
        batch = {"tokens": jax.device_put(tokens, rows),
                 "labels": jax.device_put(labels, rows)}
        out = {"loss": [], "grad_norm": []}
        with set_mesh(mesh):
            step = jax.jit(jp.make_train_step(cfg, opt))
            for i in range(STEPS):
                params, state, m = step(params, state, batch, i)
                out["loss"].append(float(m["loss"]))
                out["grad_norm"].append(float(m["grad_norm"]))
            prefill = jax.jit(lambda p, t: RM.prefill(p, {"tokens": t}, cfg,
                                                      cache_len=S + DEC))
            logits, pcache = prefill(params, batch["tokens"])
            cache = jax.tree.map(
                lambda a: jnp.zeros(a.shape, a.dtype),
                RM.abstract_cache(cfg, B, S + DEC),
                is_leaf=lambda x: hasattr(x, "logical"))
            cache.update(pcache)
            decode = jax.jit(jp.make_decode_step(cfg))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks = []
            for t in range(DEC):
                lg, cache = decode(params, tok, jnp.int32(S + t), cache)
                tok = jnp.argmax(lg, -1).astype(jnp.int32)
                toks.append(np.asarray(tok))
        arrays = {**{f"init/{k}": v for k, v in init.items()},
                  **{f"final/{k}": v for k, v in flat(params).items()},
                  "prefill_logits": np.asarray(logits),
                  "decode_tokens": np.stack(toks)}
        if cfg.moe is not None:
            # the routing lines of the reference's global path on the
            # first MoE layer's router (row 0 of its stack)
            router = [v for k, v in init.items() if k.endswith("router")][0]
            m = cfg.moe
            xt = jnp.asarray(moe_input(seed))
            N, E, K = xt.shape[0], m.num_experts, m.top_k
            lg = jnp.einsum("nd,de->ne", xt, jnp.asarray(router[0]))
            probs = jax.nn.softmax(lg, axis=-1)
            _, idx = jax.lax.top_k(probs, K)
            oh = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(N * K, E)
            slot = ((jnp.cumsum(oh, axis=0) - oh) * oh).sum(-1).reshape(N, K)
            arrays.update(route_idx=np.asarray(idx), route_slot=np.asarray(
                slot), route_keep=np.asarray(slot < jmoe.capacity(cfg, N)))
        np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)
        with open(os.path.join(out_dir, f"{name}.json"), "w") as fh:
            json.dump(out, fh)
    print("REFERENCE_DONE")


def _reference_long(name, out_dir, flat) -> None:
    """A LONG scenario in the reference: ``jax.jit(make_decode_step)`` on
    its mesh, the parameters placed by ``PARAM_RULES``, the seeded cache
    by its ``abstract_cache(cfg, 1, LONG_S, long_context=True)``
    shardings under ``ACT_RULES`` (the sequence over ``data``); the
    initial parameters and cache, each step's logits and greedy token
    and the final cache to ``out_dir/name.npz``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs import get_config
    from repro.models import model as RM
    from repro.sharding import (ACT_RULES, Annotated, PARAM_RULES,
                                make_mesh, set_mesh, spec_for, tree_specs)
    from repro.train import pjit_step as jp

    _, (pod, data, model), seed = LONG[name]
    cfg = long_cfg(get_config, name)
    mesh = make_mesh((data, model), ("data", "model"))
    params = RM.init(cfg, jax.random.PRNGKey(seed))
    specs = tree_specs(RM.abstract_params(cfg), mesh, PARAM_RULES)
    params = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs)
    rng = np.random.default_rng(seed)

    def seeded(a):
        x = rng.standard_normal(a.shape).astype(np.float32).astype(a.dtype)
        if len(a.shape) == 4 and a.logical[2] == "decode_seq":
            x[:, :, LONG_POS:] = 0                       # k, v: the prompt
        return jax.device_put(x, NamedSharding(mesh, spec_for(
            a.logical, mesh, a.shape, ACT_RULES)))

    cache = jax.tree.map(seeded, RM.abstract_cache(cfg, 1, LONG_S,
                                                   long_context=True),
                         is_leaf=lambda x: isinstance(x, Annotated))
    arrays = {**{f"init/{k}": v for k, v in flat(params).items()},
              **{f"cache0/{k}": v for k, v in flat(cache).items()}}
    tok = jnp.asarray([seed + 7], jnp.int32)
    arrays["token"] = np.asarray(tok)
    logits, toks = [], []
    with set_mesh(mesh):
        decode = jax.jit(jp.make_decode_step(cfg))
        for t in range(LONG_STEPS):
            lg, cache = decode(params, tok, jnp.int32(LONG_POS + t), cache)
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            logits.append(np.asarray(lg))
            toks.append(np.asarray(tok))
    arrays.update({f"cachef/{k}": v for k, v in flat(cache).items()},
                  logits=np.stack(logits), tokens=np.stack(toks))
    np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as fh:
        json.dump({}, fh)


@pytest.fixture(scope="module", autouse=True)
def ref_proc(tmp_path_factory):
    """The reference's runs, started when the module starts, so the
    tests that need none run while they compute: two subprocesses of
    two scenarios and one or two LONG scenarios each, their compiles side
    by side."""
    out = tmp_path_factory.mktemp("fsdp_ref")
    names = list(SCENARIOS)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out), *part],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
        for part in (names[:2] + ["jamba_long_2x2"],
                     names[2:] + ["gemma_long_4x1", "gemma_long_2x2"])]
    yield procs, out
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc):
    procs, out = ref_proc
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0 and "REFERENCE_DONE" in stdout, \
            stderr[-4000:]
    res = {}
    for name in [*SCENARIOS, *LONG]:
        with open(out / f"{name}.json") as fh:
            res[name] = (json.load(fh), dict(np.load(out / f"{name}.npz")))
    return res


# ---------------------------------------------------------------------------
# the port, as gloo ranks
# ---------------------------------------------------------------------------

def _template(cfg):
    from repro_torch.models import model as M

    return M.abstract_params(cfg)


def _init_tree(cfg, arrays):
    from repro_torch.core import tree

    tpl = _template(cfg)
    return tree.unflatten(tpl, [
        torch.from_numpy(np.array(arrays[f"init/{p}"]))
        for p, _ in tree.leaves_with_paths(tpl)])


def _rank_main(rank, world, port, out, name, shape, init_path, count, opt):
    """One gloo rank of scenario ``name`` on ``shape`` (pod, data,
    model): the three train steps (AdamW's ``opt``), the prefill and the
    greedy decode on its blocks and rows; its results to
    ``out/rank<r>.pt``.  With ``count`` only the first train step, counted
    (``count_step``): the meta trace of the same mesh is held to it
    (``_meta_and_counted``)."""
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.launch.mesh import make_step_mesh
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import pjit_step
    from repro_torch.train import ranks as R

    torch.set_num_threads(1)
    R.init("gloo", rank, world, init_method=f"tcp://localhost:{port}",
           timeout_s=120)
    pod, data, model = shape
    mesh = R.StepMesh(make_step_mesh(data, model, pod, device_type="cpu"),
                      "cpu")
    cfg = cfg_of(get_config, name)
    pls = convert.placements(cfg, mesh.mesh, rules=sharding.PARAM_RULES)
    params = convert.shard_params(torch.load(init_path), pls)
    opt = OptConfig(**opt)
    state = init_opt_state(opt, params)
    tokens, labels = (torch.from_numpy(a) for a in host_batch(
        cfg.vocab_size, SCENARIOS[name][3]))
    batch = {"tokens": mesh.local_rows(tokens),
             "labels": mesh.local_rows(labels)}
    res = {"loss": [], "grad_norm": []}
    if count:
        from repro_torch.launch.dryrun import count_step

        traced = pjit_step.make_train_step(cfg, opt, impl="torch", mesh=mesh)
        _, res["count"] = count_step(traced, (params, state, batch, 0),
                                     "cpu", group=world)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        dist.destroy_process_group()
        return
    step = pjit_step.make_train_step(cfg, opt, mesh=mesh)
    for i in range(STEPS):
        params, state, m = step(params, state, batch, i)
        res["loss"].append(float(m["loss"]))
        res["grad_norm"].append(float(m["grad_norm"]))
    full = convert.gather_params(params, pls, mesh)
    res["sums"] = R.checksums(full)
    if rank == 0:
        res["params"] = [t.clone() for t in tree.leaves(full)]
    logits, cache = pjit_step.make_prefill_step(cfg, mesh=mesh)(
        params, {"tokens": batch["tokens"]})
    res["prefill_logits"] = mesh.full_logits(logits, cfg.vocab_size)
    with sharding.set_mesh(mesh):
        padded = M.allocate_cache(cfg, batch["tokens"].shape[0], S + DEC,
                                  "cpu")
    for n in ("k", "v"):
        if n in padded:
            padded[n][:, :, :S] = cache[n]
    decode = pjit_step.make_decode_step(cfg, mesh=mesh)
    tok, toks = res["prefill_logits"].argmax(-1), []
    for t in range(DEC):
        lg, padded = decode(params, mesh.local_rows(tok), S + t, padded)
        tok = mesh.full_logits(lg, cfg.vocab_size).argmax(-1)
        toks.append(tok)
    res["decode_tokens"] = torch.stack(toks)
    if cfg.moe is not None:
        router = [t for p, t in tree.leaves_with_paths(
            convert.shard_params(torch.load(init_path), pls))
            if p.endswith("router")][0][0]
        x = mesh.local_rows(torch.from_numpy(moe_input(SCENARIOS[name][3])))
        with sharding.set_mesh(mesh):
            _, idx, _, slot, keep, C, _ = moe.routing({"router": router},
                                                      x, cfg)
        res["route"] = (idx, slot, keep, C, mesh.batch_index)
    res["counts"] = mesh.counts()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _shard_cache(M, cfg, cache):
    """This rank's block of a whole long-context cache tree (every tensor
    (layers, B, S, ...)) under the ambient mesh, as ``M.allocate_cache(...,
    long_context=True)`` lays it out (views)."""
    from repro_torch import sharding
    from repro_torch.core import tree

    batch = tree.leaves(cache)[0].shape[1]
    seq = cache["k"].shape[2] if "k" in cache else 1
    pls = M.cache_placements(cfg, batch, seq, mesh=sharding.ambient_mesh(),
                             long_context=True)
    return {k: ({n: pl.take(cache[k][n]) for n, pl in v.items()}
                if k == "mamba" else v.take(cache[k]))
            for k, v in pls.items()}


def _long_rank_main(rank, world, port, out, name, inputs_path):
    """One gloo rank of a LONG scenario: its blocks of the parameters
    (``PARAM_RULES``) and of the seeded cache (batch 1 on every rank,
    the sequence over ``data``: ``_shard_cache``), then
    LONG_STEPS greedy ``make_decode_step(..., long_context=True)`` steps;
    the gathered logits, tokens and the rank's final cache (with its
    coordinates) to ``out/rank<r>.pt``."""
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_step_mesh
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.train import pjit_step
    from repro_torch.train import ranks as R

    torch.set_num_threads(1)
    R.init("gloo", rank, world, init_method=f"tcp://localhost:{port}",
           timeout_s=120)
    pod, data, model = LONG[name][1]
    mesh = R.StepMesh(make_step_mesh(data, model, pod, device_type="cpu"),
                      "cpu").for_batch(1)
    cfg = long_cfg(get_config, name)
    inputs = torch.load(inputs_path)
    params = convert.shard_params(inputs["params"], convert.placements(
        cfg, mesh.mesh, rules=sharding.PARAM_RULES))
    with sharding.set_mesh(mesh):
        cache = M.map_params(torch.clone, _shard_cache(
            M, cfg, inputs["cache"]))
    decode = pjit_step.make_decode_step(cfg, mesh=mesh, long_context=True)
    tok, logits, toks = mesh.local_rows(inputs["token"]), [], []
    for t in range(LONG_STEPS):
        lg, cache = decode(params, tok, LONG_POS + t, cache)
        lg = mesh.full_logits(lg, cfg.vocab_size)
        tok = lg.argmax(-1)
        logits.append(lg)
        toks.append(tok)
    torch.save({"logits": torch.stack(logits), "tokens": torch.stack(toks),
                "cache": cache, "coords": mesh.coords,
                "counts": mesh.counts()},
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_long(name, inputs, tmp_path) -> list:
    from repro_torch.launch.train import free_port, start_ranks

    pod, data, model = LONG[name][1]
    world = pod * data * model
    path = str(tmp_path / f"{name}_inputs.pt")
    torch.save(inputs, path)
    start_ranks(_long_rank_main, (world, free_port(), str(tmp_path), name,
                                  path), world)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


def gather_long_cache(cfg, name, results):
    """The ranks' final caches laid back into the whole tree
    (``cache_placements`` at each rank's coordinates); a block that
    several ranks hold must hold the same bits on each."""
    from repro_torch.models import model as M
    from repro_torch.sharding import MeshShape

    _, (pod, data, model), _ = LONG[name]
    ms = MeshShape(("pod", "data", "model"), (pod, data, model))
    full = M.map_params(lambda leaf: torch.full(leaf[0], float("nan"),
                                                dtype=leaf[1]),
                        M.cache_layout(cfg, 1, LONG_S))
    for r in results:
        pls = M.cache_placements(cfg, 1, LONG_S, ms, r["coords"],
                                 long_context=True)
        for k, v in pls.items():
            pairs = [(pl, full[k][n], r["cache"][k][n]) for n, pl in
                     v.items()] if k == "mamba" else [(v, full[k],
                                                        r["cache"][k])]
            for pl, whole, local in pairs:
                held = whole[pl.slices]
                seen = ~torch.isnan(held)
                assert torch.equal(held[seen], local[seen]), (k, r["coords"])
                held.copy_(local)
    return full


def run_ranks(name, init_tree, tmp_path, shape=None, count=False,
              opt=None) -> list:
    from repro_torch.launch.train import free_port, start_ranks

    shape = shape or SCENARIOS[name][2]
    world = shape[0] * shape[1] * shape[2]
    init_path = str(tmp_path / f"{name}_init.pt")
    torch.save(init_tree, init_path)
    start_ranks(_rank_main, (world, free_port(), str(tmp_path), name, shape,
                             init_path, count, opt or OPT), world)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


# ---------------------------------------------------------------------------
# no reference run needed: these run while the reference computes
# ---------------------------------------------------------------------------

SHAPE_MESHES = {"16x16": (("data", "model"), (16, 16)),
                "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
                "2x2": (("data", "model"), (2, 2))}


def _decoder_only():
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.models.transformer import uses_context

    return [a for a in ASSIGNED if not uses_context(get_config(a))]


def _shard_shape(amesh, spec, shape):
    from jax.sharding import NamedSharding, PartitionSpec

    return tuple(NamedSharding(amesh, PartitionSpec(*spec)).shard_shape(
        tuple(shape)))


@pytest.mark.parametrize("mesh", sorted(SHAPE_MESHES))
@pytest.mark.parametrize("arch", _decoder_only())
def test_rank0_shapes_are_the_references_shard_shapes(arch, mesh):
    """``specs.input_specs(..., mesh=)``: rank 0's params, AdamW state,
    batch, decode token and cache (``train_4k``, ``decode_32k``) have
    the reference's ``NamedSharding(mesh, spec).shard_shape`` of each
    leaf, its specs from ``PARAM_RULES`` (``ACT_RULES`` for the batch,
    the token and the cache)."""
    import jax
    from jax.sharding import AbstractMesh

    from repro import sharding as RS
    from repro.configs import SHAPES as RSHAPES
    from repro.configs import get_config as r_get_config
    from repro.models import model as RM
    from repro.optim import OptConfig as ROpt
    from repro.optim import abstract_opt_state as r_opt_state
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import tree
    from repro_torch.launch.specs import input_specs
    from repro_torch.optim import OptConfig
    from repro_torch.sharding import MeshShape

    names, sizes = SHAPE_MESHES[mesh]
    duck, amesh = _ref_mesh(names, sizes), AbstractMesh(sizes, names)
    rc = r_get_config(arch)

    def want(ann, rules):
        leaves = jax.tree.leaves(ann, is_leaf=lambda x: isinstance(
            x, RS.Annotated))
        return [_shard_shape(amesh, RS.spec_for(a.logical, duck, a.shape,
                                                rules), a.shape)
                for a in leaves]

    def act(logical, shape):
        return _shard_shape(amesh, RS.spec_for(logical, duck, shape,
                                               RS.ACT_RULES), shape)

    pm = MeshShape(names, sizes)
    cfg = get_config(arch)
    train = input_specs(cfg, SHAPES["train_4k"], OptConfig(), mesh=pm)
    shapes = [tuple(t.shape) for t in tree.leaves(train["params"])]
    assert shapes == want(RM.abstract_params(rc), RS.PARAM_RULES)
    assert [tuple(t.shape) for t in tree.leaves(train["opt_state"])] == \
        want(r_opt_state(ROpt(), RM.abstract_params(rc)), RS.PARAM_RULES)
    tr = RSHAPES["train_4k"]
    for k in ("tokens", "labels"):
        assert tuple(train["batch"][k].shape) == act(
            ("batch", "seq"), (tr.global_batch, tr.seq_len))
    dec = input_specs(cfg, SHAPES["decode_32k"], mesh=pm)
    ds = RSHAPES["decode_32k"]
    assert tuple(dec["token"].shape) == act(("batch",), (ds.global_batch,))
    assert [tuple(t.shape) for t in tree.leaves(dec["cache"])] == want(
        RM.abstract_cache(rc, ds.global_batch, ds.seq_len), RS.ACT_RULES)
    assert all(t.is_meta for t in tree.leaves(dec["cache"]))
    if cfg.sub_quadratic:
        # long_500k: batch 1 replicated, the KV cache's sequence on data
        long = input_specs(cfg, SHAPES["long_500k"], mesh=pm)
        ls = RSHAPES["long_500k"]
        assert tuple(long["token"].shape) == act(("batch",),
                                                 (ls.global_batch,)) == (1,)
        assert [tuple(t.shape) for t in tree.leaves(long["cache"])] == want(
            RM.abstract_cache(rc, ls.global_batch, ls.seq_len,
                              long_context=True), RS.ACT_RULES)


def test_world_one_mesh_is_the_one_process_step(tmp_path):
    """A (1, 1) mesh in one gloo rank: the three train steps (losses and
    parameters) and the prefill's logits bitwise the one-process
    steps'."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import pjit_step

    cfg = cfg_of(get_config, "llama_2x2")
    init = M.init_train(cfg, 5, "cpu")
    res = run_ranks("llama_2x2", init, tmp_path, shape=(1, 1, 1))[0]
    params = tree.tree_map(torch.clone, init)
    opt = OptConfig(**OPT)
    state = init_opt_state(opt, params)
    tokens, labels = (torch.from_numpy(a) for a in host_batch(
        cfg.vocab_size, 0))
    losses = []
    step = pjit_step.make_train_step(cfg, opt)
    for i in range(STEPS):
        params, state, m = step(params, state, {"tokens": tokens,
                                                "labels": labels}, i)
        losses.append(float(m["loss"]))
    assert res["loss"] == losses
    assert all(torch.equal(a, b) for a, b in zip(res["params"],
                                                 tree.leaves(params)))
    logits, _ = pjit_step.make_prefill_step(cfg)(params, {"tokens": tokens})
    assert torch.equal(res["prefill_logits"], logits)


def _meta_and_counted(name, tmp_path):
    """Rank 0's train step of scenario ``name`` traced on meta and
    counted in a gloo rank on the CPU, held equal: FLOPs, bytes, the
    collectives of each axis and their result bytes."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig
    from repro_torch.sharding import MeshShape

    cfg = cfg_of(get_config, name)
    card = run_ranks(name, M.init_train(cfg, 0, "cpu"), tmp_path,
                     count=True)[0]["count"]
    meta = D.lower_compile(cfg, ShapeConfig("t", S, B, "train"),
                           OptConfig(**OPT), mesh=MeshShape(
                               ("data", "model"), SCENARIOS[name][2][1:]),
                           impl="torch")
    for key in ("flops", "bytes", "collective_by_axis",
                "collective_result_bytes", "collective_counts"):
        assert meta[key] == card[key], key
    return meta, card


def test_dryrun_fsdp_equals_a_ranks_step(tmp_path):
    """``lower_compile(mesh=)``: rank 0's FSDP + TP train step at (data 2,
    model 2) traced on meta under a ``fake`` group equals a real gloo
    rank's step counted on the CPU (the kernels' plain versions):
    FLOPs, bytes, the collectives of each axis and their result bytes; the
    production plain cell of a reduced arch traces (``run_cell`` keys),
    a ``long_500k``-form decode of reduced gemma3-1b is traced, not
    skipped (its cache's sequence combined over ``data``), and whisper
    and the VLM are skipped with a reason."""
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import MeshShape

    meta, _ = _meta_and_counted("llama_2x2", tmp_path)
    assert meta["collective_by_axis"]["data"] > 0
    assert meta["collective_counts"]["all-to-all"] > 0
    for m in D.PLAIN_PRODUCTION:
        skip = D.run_cell("whisper-tiny", "train_4k", mesh=m)
        assert "item 7b" in skip["skipped"]
    long = SHAPES["long_500k"]
    assert D.long_context(long) and not D.long_context(SHAPES["decode_32k"])
    gemma = get_config("gemma3-1b").reduced()
    for multi in (False, True):
        traced = D.lower_compile(gemma, long, mesh=make_production_mesh(
            multi_pod=multi))
        assert traced["peak_bytes"] > 0 and traced["collective_by_axis"][
            "data"] > 0
    pm = MeshShape(("pod", "data", "model"), (2, 2, 2))
    small = get_config("phi3.5-moe-42b-a6.6b").reduced()
    for kind in ("train", "prefill", "decode"):
        c = D.lower_compile(small, ShapeConfig("t", S, B, kind), mesh=pm)
        assert c["peak_bytes"] > 0 and c["collective_by_axis"]["model"] > 0
        assert set(c["collective_by_axis"]) >= {"data", "model"}


def test_dryrun_fsdp_moe_equals_a_ranks_step(tmp_path):
    """The same for phi3.5-moe at (data 2, model 2), routing as its own
    routing says: the global routing's scan over the data ranks and the
    split experts' dispatch count alike on meta and in a real rank."""
    meta, _ = _meta_and_counted("moe_2x2", tmp_path)
    assert meta["collective_counts"]["all-to-all"] > 0


# ---------------------------------------------------------------------------
# against the reference (last: its subprocess runs meanwhile)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fsdp_steps_match_reference(name, ref, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.core import tree

    out, arrays = ref[name]
    cfg = cfg_of(get_config, name)
    results = run_ranks(name, _init_tree(cfg, arrays), tmp_path)
    r0 = results[0]
    for r in results:
        assert torch.equal(r["sums"], r0["sums"])
        assert r["loss"] == r0["loss"] and r["grad_norm"] == r0["grad_norm"]
    for got, want in zip(r0["loss"], out["loss"]):
        assert abs(got - want) <= 1e-4 * abs(want), (r0["loss"], out["loss"])
    assert min(out["grad_norm"]) > OPT["grad_clip"]      # the clip acts
    np.testing.assert_allclose(r0["grad_norm"], out["grad_norm"], rtol=1e-4)
    paths = [p for p, _ in tree.leaves_with_paths(_template(cfg))]
    for path, leaf in zip(paths, r0["params"]):
        want = arrays[f"final/{path}"]
        err = float(np.abs(leaf.numpy() - want).max())
        assert err <= 1e-4 * (1.0 + float(np.abs(want).max())), (path, err)
    want = arrays["prefill_logits"]
    assert float(np.abs(r0["prefill_logits"].numpy() - want).max()) <= \
        1e-4 * (1.0 + float(np.abs(want).max()))
    np.testing.assert_array_equal(r0["decode_tokens"].numpy(),
                                  arrays["decode_tokens"])
    axes = {a for r in results for a in r["counts"]}
    assert axes == {a for a, n in zip(("pod", "data", "model"),
                                      SCENARIOS[name][2]) if n > 1}
    assert all(r["counts"]["data"]["all_to_all"] > 0 for r in results)
    if cfg.moe is not None:
        n = B * S // (SCENARIOS[name][2][0] * SCENARIOS[name][2][1])
        for r in results:
            idx, slot, keep, C, b = r["route"]
            rows = slice(b * n, (b + 1) * n)
            np.testing.assert_array_equal(idx.numpy(),
                                          arrays["route_idx"][rows])
            np.testing.assert_array_equal(slot.numpy(),
                                          arrays["route_slot"][rows])
            np.testing.assert_array_equal(keep.numpy(),
                                          arrays["route_keep"][rows])
        assert not arrays["route_keep"].all()             # drops present


@pytest.mark.parametrize("name", list(LONG))
def test_long_decode_matches_reference(name, ref, tmp_path):
    """``make_decode_step(..., long_context=True)`` as gloo ranks, batch 1
    on every rank and the KV cache's sequence split over ``data``,
    against the reference's jitted decode under its ``long_context``
    shardings: each step's logits within 1e-4 * (1 + max|logits|), the
    greedy tokens equal, the final cache gathered within 1e-4 * (1 +
    max|cache|), every rank's logits, tokens and replicated cache blocks
    bitwise alike; the decode attention combines the ranks over
    ``data`` (an all-reduce of the max, two ordered sums a layer)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model as M

    _, arrays = ref[name]
    cfg = long_cfg(get_config, name)
    layout = M.cache_layout(cfg, 1, LONG_S)
    cache = {k: ({n: torch.from_numpy(arrays[f"cache0/mamba/{n}"])
                  for n in v} if k == "mamba" else
                 torch.from_numpy(arrays[f"cache0/{k}"]))
             for k, v in layout.items()}
    results = run_long(name, {"params": _init_tree(cfg, arrays),
                              "cache": cache,
                              "token": torch.from_numpy(arrays["token"])},
                       tmp_path)
    r0 = results[0]
    for r in results:
        assert torch.equal(r["logits"], r0["logits"])
        assert torch.equal(r["tokens"], r0["tokens"])
    want = arrays["logits"]
    assert float(np.abs(r0["logits"].numpy() - want).max()) <= \
        1e-4 * (1.0 + float(np.abs(want).max()))
    np.testing.assert_array_equal(r0["tokens"].numpy(), arrays["tokens"])
    full = gather_long_cache(cfg, name, results)
    for path, leaf in tree.leaves_with_paths(full):
        want = arrays[f"cachef/{path}"]
        err = float(np.abs(leaf.numpy() - want).max())
        assert err <= 1e-4 * (1.0 + float(np.abs(want).max())), (path, err)
    assert all(r["counts"]["data"]["all_reduce"] > 0 for r in results)


if __name__ == "__main__":
    # python tests/test_torch_fsdp.py OUT_DIR NAME... [--lr LR]
    args = sys.argv[2:]
    lr = None
    if "--lr" in args:
        at = args.index("--lr")
        lr, args = float(args[at + 1]), args[:at] + args[at + 2:]
    _reference_main(sys.argv[1], args,
                    None if lr is None else dict(OPT, peak_lr=lr))
