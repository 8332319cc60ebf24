"""``chip_smoke.py``'s gates for the bf16 FSDP cells whose split lies a
rounding's width from the one-process run (``FSDP_ANCHORED``), on small
synthetic tensors on the CPU: each measure anchored to the float32 run
(``anchored_updates``, ``anchored_losses``, ``anchored_logits``) passes
a split that lies from the one-process bf16 run by rounding only and
fails its planted control and a split with a fault; the losses' and
logits' plant (``dropped_partial``: the reduce-scatter of the FSDP
leaves' gradients leaves out the last data rank's partial) as gloo
ranks; and ``scripts/chip_phases.py``'s ``round_step``, which forms the
split's gradients in one process, bitwise the one-process step with one
part.
"""
import os
import pathlib
import sys

import pytest
import torch

from test_torch_trainer import rank_server  # noqa: F401 (its teardown)
from torch_threads import one_thread  # noqa: F401 (one thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as C  # noqa: E402


def _sums(init, split, one, prev, f32):
    """``fsdp_anchor_sums``' rows from whole leaves (one rank)."""
    rows = []
    for p0, a, b, b0, c in zip(init, split, one, prev, f32):
        rows.append([float((a - c).square().sum()),
                     float((b - c).square().sum()),
                     float((a - (b - b0) - c).square().sum()),
                     float((c - p0).square().sum())])
    return rows


def _runs(seed=0, n=4096):
    """Three leaves: init, a float32 run's three updates, a bf16 run of
    the same updates quantized to the leaf's grid (what moves under half
    a grid step stays), and the run before its last update."""
    g = torch.Generator().manual_seed(seed)
    init = [torch.randn(n, generator=g) * 0.02 for _ in range(3)]
    steps = [[torch.randn(n, generator=g) * 1e-4 for _ in init]
             for _ in range(3)]
    f32 = [p + sum(s[i] for s in steps) for i, p in enumerate(init)]

    def quantized(k):
        out = []
        for i, p in enumerate(init):
            x = p.to(torch.bfloat16)
            for s in steps[:k]:
                x = (x.float() + s[i]).to(torch.bfloat16)
            out.append(x.float())
        return out

    return init, f32, quantized(3), quantized(2), g


def test_anchored_updates_tell_rounding_from_a_fault():
    """A split that lies from the bf16 run by a rounding (its leaves
    nudged by an ulp here and there) passes; the plant (the split less
    the bf16 run's last update) and a split that took a wrong step fail
    by more than TP_F32_MARGIN."""
    init, f32, one, prev, g = _runs()
    ulp = [(x.abs() * 2 ** -7) for x in one]
    split = [x + u * (torch.rand(x.shape, generator=g) < 0.05)
             for x, u in zip(one, ulp)]
    m = C.anchored_updates(_sums(init, split, one, prev, f32))
    assert m["passed"] and m["planted_caught"], m
    assert m["excess_max"] < C.TP_F32_MARGIN < m["planted_excess_max"]
    wrong = [x + (x - p) for x, p in zip(split, prev)]   # a step twice
    assert not C.anchored_updates(_sums(init, wrong, one, prev, f32))[
        "passed"]
    # a leaf the f32 run does not move is left out of the measure
    still = _sums(init[:1], split[:1], one[:1], prev[:1], init[:1])
    assert still[0][3] == 0.0
    assert C.anchored_updates(still + _sums(init, split, one, prev, f32))[
        "excess"] == m["excess"]


# losses of three train steps: the float32 run, the bf16 one-process run
F32_LOSSES = [10.801097, 6.800273, 5.853013]
ONE_LOSSES = [10.801261, 6.532167, 5.666712]


def test_anchored_losses_tell_rounding_from_a_fault():
    """The split 2.5e-4 from the bf16 run (phi3.5-moe's miss of
    TP_LOSS_REL), on either side, passes; a run whose later losses lie
    1e-2 farther from the f32 run (a data rank's partial lost) fails, as
    the plant and as the split.  The measure reads the distance from the
    anchor only: a run moved toward the f32 run reads no excess."""
    for sign in (1, -1):
        split = [x * (1 + sign * 2.5e-4) for x in ONE_LOSSES]
        # the bf16 run's later losses lie under the f32 run's: farther
        # means lower
        plant = [ONE_LOSSES[0]] + [x * (1 - 1e-2) for x in ONE_LOSSES[1:]]
        m = C.anchored_losses(split, ONE_LOSSES, F32_LOSSES, plant)
        assert m["passed"] and m["planted_caught"], m
        assert m["excess_max"] < C.FSDP_F32_LOSS_MARGIN < \
            m["planted_excess_max"]
        assert not C.anchored_losses(plant, ONE_LOSSES, F32_LOSSES,
                                     plant)["passed"]
    toward = [ONE_LOSSES[0]] + [x * 1.01 for x in ONE_LOSSES[1:]]
    assert C.anchored_losses(toward, ONE_LOSSES, F32_LOSSES, toward)[
        "excess_max"] <= 0


def _serve(first, steps):
    return (first, list(steps), None)


def test_anchored_logits_tell_rounding_from_a_fault():
    """Per step the error from the f32 run's logits over FSDP_LOGITS_REL
    * (1 + max|f32|): a split a rounding off the bf16 run passes, a
    plant whose logits moved by the limit and more fails."""
    g = torch.Generator().manual_seed(1)
    f32 = [torch.randn(2, 512, generator=g) * 4 for _ in range(3)]
    one = [x + torch.randn(x.shape, generator=g) * 0.05 for x in f32]
    split = [x + torch.randn(x.shape, generator=g) * 1e-3 for x in one]
    plant = [x + torch.randn(x.shape, generator=g) for x in one]
    m = C.anchored_logits(_serve(split[0], split[1:]),
                          _serve(one[0], one[1:]), _serve(f32[0], f32[1:]),
                          _serve(plant[0], plant[1:]))
    assert m["passed"] and m["planted_caught"], m
    assert m["excess_max"] < C.FSDP_F32_LOGITS_MARGIN < \
        m["planted_excess_max"]
    far = C.anchored_logits(_serve(plant[0], plant[1:]),
                            _serve(one[0], one[1:]),
                            _serve(f32[0], f32[1:]),
                            _serve(plant[0], plant[1:]))
    assert not far["passed"]


def _gather_rank(rank, world, port, out):
    """One gloo rank on ``data``: a leaf's FSDP gather and the gradient
    its backward reduce-scatters, as is and under ``dropped_partial``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_step_mesh
    from repro_torch.models import parallel
    from repro_torch.train import ranks as R

    torch.set_num_threads(1)
    R.init("gloo", rank, world, init_method=f"tcp://localhost:{port}",
           timeout_s=60)
    ax = R.StepMesh(make_step_mesh(world, device_type="cpu"),
                    "cpu").axes["data"]
    g = torch.Generator().manual_seed(7)
    whole = torch.randn(8, 3, generator=g)
    upstream = torch.randn(world, 8, 3, generator=g)     # each rank's
    res = []
    for plant in (False, True):
        leaf = whole.chunk(world)[rank].clone().requires_grad_()
        with C.dropped_partial() if plant else torch.enable_grad():
            full = parallel.fsdp_gather(leaf, 0, ax)
            (full * upstream[rank]).sum().backward()
        res.append(leaf.grad)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_dropped_partial_leaves_out_the_last_ranks_share(tmp_path):
    """Two data ranks: a gathered leaf's gradient is each rank's slice of
    the sum of both ranks' partials; under the plant, of the first
    rank's only."""
    from repro_torch.launch.train import free_port, start_ranks

    start_ranks(_gather_rank, (2, free_port(), str(tmp_path)), 2)
    g = torch.Generator().manual_seed(7)
    torch.randn(8, 3, generator=g)
    upstream = torch.randn(2, 8, 3, generator=g)
    for r in range(2):
        whole_grad, planted = torch.load(tmp_path / f"rank{r}.pt")
        rows = slice(4 * r, 4 * r + 4)
        assert torch.equal(whole_grad, (upstream[0] + upstream[1])[rows])
        assert torch.equal(planted, upstream[0][rows])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi3.5-moe-42b-a6.6b"])
def test_round_step_with_one_part_is_the_step(arch):
    """``round_step(1)`` (one part: no rounding added), from one forward
    or from the part's own (``micro``), trains two steps bitwise as
    ``pjit_step.make_train_step`` does in bf16; with two parts it moves
    the parameters (the rounding it adds), and with the last part
    dropped further."""
    from chip_phases import round_step

    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import pjit_step

    cfg = get_config(arch).reduced()
    opt = OptConfig(kind="adamw", peak_lr=1e-3, warmup_steps=1,
                    total_steps=10)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                              dtype=torch.int32) for k in ("tokens",
                                                           "labels")}
    finals = {}
    for name, make in (("step", pjit_step.make_train_step),
                       ("one", round_step(1)),
                       ("micro", round_step(1, micro=True)),
                       ("two", round_step(2)),
                       ("drop", round_step(2, drop=True))):
        params = M.init_train(cfg, 0, "cpu")
        state = init_opt_state(opt, params)
        step = make(cfg, opt)
        for i in range(2):
            params, state, _ = step(params, state, batch, i)
        finals[name] = tree.leaves(params)
    for name in ("one", "micro"):
        assert all(torch.equal(a, b) for a, b in zip(finals["step"],
                                                     finals[name]))

    def dist_to_step(name):
        return sum(float((a.float() - b.float()).norm())
                   for a, b in zip(finals[name], finals["step"]))

    assert 0 < dist_to_step("two") < dist_to_step("drop")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi3.5-moe-42b-a6.6b"])
def test_model_halves_is_the_model_up_to_rounding(arch):
    """``model_halves(2)`` forms the products as two model ranks would,
    with nothing split: in float32 the loss and every gradient lie within
    f32 rounding of the plain model's, in bf16 they move (the rounding a
    model axis adds), and the patched functions are given back."""
    import dataclasses

    from chip_phases import model_halves

    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import attention as A
    from repro_torch.models import model as M

    base = get_config(arch).reduced()
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, base.vocab_size, (2, 16), generator=g,
                              dtype=torch.int32) for k in ("tokens",
                                                           "labels")}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        params = M.init_train(cfg, 0, "cpu")

        def loss_and_grads():
            req = [p.detach().requires_grad_() for p in tree.leaves(params)]
            loss, _ = M.train_loss(tree.unflatten(params, req), batch, cfg)
            return loss.detach(), torch.autograd.grad(loss, req)

        plain, plain_g = loss_and_grads()
        real = A.self_attention
        with model_halves(2):
            halves, halves_g = loss_and_grads()
        assert A.self_attention is real
        rel = max(float((a.float() - b.float()).abs().max())
                  / float(b.float().abs().max()) for a, b in zip(
                      halves_g, plain_g) if bool(b.any()))
        if dtype == "float32":
            assert abs(float(halves - plain)) < 1e-5 * abs(float(plain))
            assert rel < 1e-5
        else:
            assert rel > 1e-3
