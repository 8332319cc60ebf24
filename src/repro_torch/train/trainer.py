"""Host-side BFT trainer: dispatches the fast / check / identify steps
as the randomized reactive-redundancy protocol says.

Port of ``repro.train.trainer``.  Per iteration (paper §4.2):
  1. q_t from the protocol (fixed q, or the adaptive closed form of §4.3
     on the previous iteration's loss);
  2. coin < q_t  ->  check iteration (replicated assignment, detection);
       fault detected -> reactive identify iteration ON THE SAME BATCH
       (r = 2f_t+1, majority vote), Byzantine workers eliminated, exact
       gradient applied;
     else          ->  fast iteration (plain parallelized SGD);
  3. efficiency accounting (Definition 2), checkpointing, elastic remaps.

Modes: randomized (paper), deterministic (paper §4.1), draco (baseline:
permanent 2f+1 voting), filter (gradient-filter baselines), none
(vanilla parallelized SGD).  The reference's per-signature jit cache has
no counterpart, the step functions are called directly.

Layouts: with ``mesh=None`` the n workers run one after another in this
process on one device (the card unless ``device="cpu"``).  With a
``launch.mesh.make_worker_mesh`` (W ranks on ``data`` times ``model``)
every rank runs this same trainer: it builds the same full parameters
(the same seed, or the same ``params``) on its ``device`` and keeps its
shard (``convert.shard_params`` by ``sharding.tree_shardings`` of the
annotated tree under ``tp_only_rules``: replicated over ``data``,
split over ``model``), draws the same global batch, runs its n/W
workers and meets the other ranks in the steps' collectives
(``train.ranks``), the reference's ``worker_axes=("data",)``.  At
``model`` = 1 every leaf is whole and nothing changes.  The host
control runs identically on every rank, since its inputs (flags, votes,
the all-reduced loss) are the same bits everywhere.  A checkpoint has
the one-process layout: the ranks of data coordinate 0 gather their
shards over ``model`` and rank 0 writes, the others wait at a barrier;
every rank restores the full tree and keeps its shard, so a run
restarts at any ``model``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.core import prngkey
from repro_torch.core.assignment import Assignment, group_members
from repro_torch.core.randomized import BFTConfig, ProtocolState
from repro_torch.data import global_batch_for_step, worker_batches
from repro_torch.core import tree
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.transformer import require_splittable
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.train.ranks import Ranks
from repro_torch.train.steps import (
    AttackConfig,
    StepConfig,
    make_check_step,
    make_fast_step,
    make_filter_step,
    make_identify_step,
)


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 128
    global_batch: int = 64
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    filter_name: str = "median"       # for mode == "filter"
    log_every: int = 10


class Trainer:
    """``Trainer(cfg, opt, bft, tc).run(steps)``.  ``params``: initial
    parameters in the stacked training layout (``models.init_train``,
    or ``convert.from_jax_train_params``); by default random, from
    ``tc.seed``.  ``impl="torch"`` runs the kernels' plain versions on
    the card.  ``mesh``: the worker mesh whose ``data`` ranks share the
    n workers and whose ``model`` ranks split each (None: all n in this
    process); ``params`` are the full tree either way."""

    def __init__(self, cfg, opt: OptConfig, bft: BFTConfig, tc: TrainerConfig,
                 attack: AttackConfig | None = None,
                 sc: StepConfig | None = None,
                 true_byzantine: np.ndarray | None = None, *, device=None,
                 params=None, impl: str | None = None, mesh=None):
        self.cfg, self.opt, self.bft, self.tc = cfg, opt, bft, tc
        self.sc = sc or StepConfig()
        self.attack = attack or AttackConfig(kind="none")
        self.impl = impl
        n = bft.n
        self.state = ProtocolState.create(bft)
        self.true_byz = (
            np.zeros(n, bool) if true_byzantine is None
            else np.asarray(true_byzantine, bool))
        self.ckpt = (
            CheckpointManager(tc.checkpoint_dir, tc.checkpoint_every)
            if tc.checkpoint_dir else None)
        self.last_loss: float = 1.0
        self.history: list[dict] = []
        self.device = M.resolve_device(device)
        self.ranks = None if mesh is None else Ranks.of(mesh, self.device)
        self.placements = None
        if self.ranks is not None:
            self.ranks.block(n)         # raises unless W divides n
            if self.ranks.model is not None:
                require_splittable(cfg, self.ranks.model.world)
                self.placements = convert.placements(cfg, mesh)
                self.ranks.model.placements = tree.leaves(self.placements)
        if params is None:
            params = M.init_train(cfg, tc.seed, self.device)
        elif M.params_device(params).type != self.device.type:
            raise ValueError(f"params lie on {M.params_device(params)}, the "
                             f"trainer runs on {self.device}")
        self.params = self._shard(params)
        self.opt_state = init_opt_state(opt, self.params)
        self.key = prngkey.PRNGKey(tc.seed + 1)

    # ------------------------------------------------------------------
    def _step_fn(self, mode: str, assignment: Assignment):
        kw = dict(impl=self.impl, ranks=self.ranks)
        args = (self.cfg, self.opt, self.sc, self.attack)
        if mode == "fast":
            return make_fast_step(*args, **kw)
        if mode == "check":
            return make_check_step(*args, num_groups=assignment.num_shards,
                                   **kw)
        if mode == "identify":
            return make_identify_step(
                *args, np.stack(group_members(assignment)), **kw)
        if mode == "filter":
            return make_filter_step(*args, self.tc.filter_name, self.bft.f,
                                    **kw)
        raise ValueError(mode)

    def _dispatch(self, mode: str, assignment: Assignment, batch) -> dict:
        wb = worker_batches(batch, assignment)
        byz = self.true_byz & self.state.active
        step_args = (self.params, self.opt_state, wb, assignment.weight, byz)
        if mode == "check":
            step_args = step_args + (assignment.group_of_worker,)
        step_args = step_args + (self.key, self.state.step)
        self.params, self.opt_state, metrics = self._step_fn(
            mode, assignment)(*step_args)
        return metrics

    # ------------------------------------------------------------------
    def train_step(self) -> dict:
        st = self.state
        batch = global_batch_for_step(
            self.cfg, global_batch=self.tc.global_batch,
            seq_len=self.tc.seq_len, step=st.step, seed=self.tc.seed)
        record: dict[str, Any] = {"step": st.step}

        mode = self.bft.mode
        if mode in ("deterministic", "randomized") and st.decide_check(
                self.last_loss):
            a = st.assignment_check()
            m = self._dispatch("check", a, batch)
            used = a.num_shards
            computed = a.gradients_computed()
            identified = False
            if m["any_fault"]:
                ai = st.assignment_identify()
                mi = self._dispatch("identify", ai, batch)
                byz = mi["byz"]
                st.on_identified(np.flatnonzero(byz))
                used += ai.num_shards
                computed += ai.gradients_computed()
                identified = True
                record["identified"] = np.flatnonzero(byz).tolist()
                m = mi
            else:
                st.on_clean_check(np.flatnonzero(a.group_of_worker >= 0))
            eff = st.meter.record(used, computed, checked=True,
                                  identified=identified)
        elif mode == "draco":
            a = st.assignment_identify()
            m = self._dispatch("identify", a, batch)
            newly = np.flatnonzero(m["byz"] & ~st.identified)
            if len(newly):
                st.on_identified(newly)
                record["identified"] = newly.tolist()
            eff = st.meter.record(a.num_shards, a.gradients_computed(),
                                  checked=True)
        elif mode == "filter":
            a = st.assignment_fast()
            m = self._dispatch("filter", a, batch)
            eff = st.meter.record(a.num_shards, a.gradients_computed())
        else:  # fast path (randomized default / none)
            a = st.assignment_fast()
            m = self._dispatch("fast", a, batch)
            eff = st.meter.record(a.num_shards, a.gradients_computed())

        self.last_loss = float(m["loss"])
        record.update(loss=self.last_loss, efficiency=eff, q=st.last_q,
                      f_t=st.f_t, kappa=st.kappa)
        st.step += 1
        if self.ckpt:
            self._save(st)
        self.history.append(record)
        return record

    def _shard(self, full):
        """This rank's shard of a full parameter-shaped tree."""
        if self.placements is None:
            return full
        return convert.shard_params(full, self.placements)

    def _map_state(self, fn, state):
        """``fn(tree)`` over the parameter-shaped trees of an optimizer
        state (``{}``, ``{"mu"}`` or ``{"mu", "nu"}``)."""
        return {k: fn(v) for k, v in state.items()}

    def _gather(self, tree):
        """A parameter-shaped tree whole: gathered over the model axis
        (every rank of it calls this), or the tree itself at ``model`` =
        1."""
        if self.placements is None:
            return tree
        return convert.gather_params(tree, self.placements, self.ranks.model)

    def full_params(self):
        """The parameters whole (``_gather``)."""
        return self._gather(self.params)

    def full_state(self):
        """(params, opt_state) whole (``_gather``)."""
        return self.full_params(), self._map_state(self._gather,
                                                   self.opt_state)

    def _save(self, st) -> None:
        """Rank 0 (or the one process) writes; with ranks, every rank
        waits for it at a barrier after a checkpoint step.  With a model
        axis the ranks of data coordinate 0 gather the whole tree first."""
        if self.ckpt.every <= 0 or st.step % self.ckpt.every:
            return
        if self.ranks is None or self.ranks.rank == 0:
            params, opt_state = self.full_state()
            if self.ranks is None or self.ranks.model is None or \
                    self.ranks.model.rank == 0:
                self.ckpt.maybe_save(
                    st.step, params=params, opt_state=opt_state,
                    protocol_state=st, extra={"last_loss": self.last_loss})
            del params, opt_state
        if self.ranks is not None:
            self.ranks.world_barrier()

    def run(self, steps: int) -> list[dict]:
        for _ in range(steps):
            rec = self.train_step()
            if self.tc.log_every and rec["step"] % self.tc.log_every == 0 \
                    and (self.ranks is None or self.ranks.rank == 0):
                print(
                    f"step {rec['step']:5d} loss {rec['loss']:.4f} "
                    f"eff {rec['efficiency']:.3f} q {rec['q']:.3f} "
                    f"κ {rec['kappa']}",
                    flush=True,
                )
        return self.history

    # -- elasticity -----------------------------------------------------
    def inject_crash(self, workers) -> None:
        self.state.on_crash(np.asarray(workers))

    def recover(self, workers) -> None:
        self.state.on_recover(np.asarray(workers))

    # -- restart ----------------------------------------------------------
    def restore_latest(self) -> int | None:
        if not self.tc.checkpoint_dir:
            return None
        step = latest_step(self.tc.checkpoint_dir)
        if step is None:
            return None
        params, opt_state, extra = restore(
            self.tc.checkpoint_dir, step,
            params_template=self.params, opt_template=self.opt_state,
            protocol_state=self.state)
        self.params = self._shard(params)
        self.opt_state = self._map_state(self._shard, opt_state)
        self.last_loss = extra.get("last_loss", 1.0)
        return step
