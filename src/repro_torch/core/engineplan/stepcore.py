"""The protocol step loop, under host or device control, on every data
plane.

Port of ``repro.core.engineplan.stepcore.step_core``: ``scan`` for
``control="host"`` (``stepcore.py:71-245`` and ``:415-587``),
``device_scan`` for ``control="device"`` (``:248-413``).  Honest
replicas are copies and every attack is affine, so the whole "shard
gradients -> tamper -> aggregate/vote" pipeline folds into per-row
residual coefficients; detection symbols come from sketch tables of the
data rows by linearity.  Three planes share that epilogue:

 * **gram** (``gram=True``): the loop carries only the (B, Ie)
   coefficients C_t of ``W_t = W_0 - C_t @ R`` over the extended rows R
   (data rows, ones row, noise row); residual symbols are
   ``S_0 - C_t @ G`` with G = R R^T precomputed, and d is touched once,
   after the loop.
 * **fused** (``fused=True``): the carry is (W, pending cw); each step
   is one pass of the fused kernel (``ops.fused_step``: apply cw, take
   the residual and the step's sketch table), and one contraction after
   the loop applies the last pending update.
 * **stream** (neither): the carry is the (B, d) iterate; residuals and
   updates are contractions with the data (per trial through
   ``ops.batched_coded_encode`` when trials do not share a problem), the
   sketch tables are the hoisted per-step pre-sketches, and the
   gradient-filter baselines (``has_filter``) run on the materialized
   (B, n, d) gradient stack.

The scan is a Python loop over T.  The vote gates (``vote1``,
``identify``) are branched on from their host numpy copies, so the loop
never waits on the device.  With ``telemetry`` the loop also adds up the
protocol counters (``obs.telemetry.TEL_KEYS``) as (B,) int32 tensors on
the scan's device, exactly as the reference's scan carry does
(``stepcore.py:533-556``).

``device_scan`` makes every control decision inside the loop, on the
device: the adaptive q*_t from the loss, the threefry check and tamper
coins, the masked regroup, the detect verdict, the identify vote and
the eliminations.  The coins and keys are pure functions of (seed, t,
phase, w), so the whole chunk's are drawn before the loop in one
vectorised threefry each.  The reference branches into the identify
round with ``lax.cond(det.any())``; reading ``det`` on the host would
stall the loop on the device every step, so the round runs every step
instead, masked by ``det``: a trial that did not detect adds exactly
zero and flags no one.  The loop returns the decision trace the host
replays the control plane from (``engine.replay_control_from_trace``).
"""
from __future__ import annotations

import torch

from repro_torch.core import adaptive, rngstream
from repro_torch.core.detection import detect_groups_batched
from repro_torch.kernels import ops
from repro_torch.obs.telemetry import TEL_KEYS

TAU_VOTE = 1e-9       # matches majority_vote_np(tau=1e-9) in the engines
TAU_DETECT = 1e-9     # the engines' absolute replica compare


def shard_mask(shard, group, m, n_data: int):
    """(B, n) shard layout -> (B, n, I) f32 row-ownership mask and the
    (B,) rows per shard: row i belongs to worker w iff i // rows ==
    shard[w] (rows = I // m; remainder rows dropped) and w is a group
    member."""
    rows = n_data // torch.clamp(m, min=1)
    i = torch.arange(n_data, dtype=torch.int32, device=shard.device)
    owner = i[None, :] // torch.clamp(rows, min=1)[:, None]
    used = i[None, :] < (m * rows)[:, None]
    mask = (owner[:, None, :] == shard[:, :, None]) \
        & used[:, None, :] & (group >= 0)[:, :, None]
    return mask.to(torch.float32), rows


def apply_affine(g, tam, alpha, beta, nu, noisevec, has_bias: bool):
    """Masked affine Byzantine attacks on a (B, n, d) gradient stack."""
    tam3 = tam[:, :, None]
    out = torch.where(tam3, alpha[:, None, None] * g, g)
    if has_bias:
        add = beta[:, None, None] + nu[:, None, None] * noisevec[None, None]
        out = out + torch.where(tam3, add, 0.0)
    return out


def masked_median(g, act):
    """Coordinate-wise median over each trial's active workers."""
    B = g.shape[0]
    x = torch.where(act[:, :, None], g, torch.inf)
    x = torch.sort(x, dim=1).values
    cnt = act.sum(dim=1)
    lo = torch.clamp((cnt - 1) // 2, min=0)
    hi = torch.clamp(cnt // 2, min=0)
    rows = torch.arange(B, device=g.device)
    return 0.5 * (x[rows, lo] + x[rows, hi])


def masked_krum(g, act, f):
    """KRUM (m=1) over each trial's active workers, inactive rows masked
    out of distances, scores and the argmin.  The pairwise distances are
    the reference's ``((g_i - g_j)^2).sum(-1)``, one first worker i at a
    time so that no (B, n, n, d) difference is held at once."""
    B, n, _ = g.shape
    d2 = torch.stack([((g[:, i:i + 1, :] - g) ** 2).sum(dim=-1)
                      for i in range(n)], dim=1)              # (B, n, n)
    pair_ok = act[:, :, None] & act[:, None, :]
    d2 = torch.where(pair_ok, d2, 1e30) \
        + torch.eye(n, device=g.device) * 1e30
    cnt = act.sum(dim=1)
    kth = torch.clamp(cnt - f - 2, 1, n)
    s = torch.sort(d2, dim=2).values
    csum = torch.cumsum(s, dim=2)
    rows = torch.arange(B, device=g.device)
    scores = csum[rows[:, None], torch.arange(n, device=g.device)[None, :],
                  torch.clamp(kth - 1, max=n - 1)[:, None]]      # (B, n)
    scores = torch.where(act, scores, torch.inf)
    best = torch.argmin(scores, dim=1)
    return g[rows, best]


def masked_mean(g, act):
    cnt = torch.clamp(act.sum(dim=1), min=1)
    return (g * act[:, :, None]).sum(dim=1) / cnt[:, None]


def count_step(tel, x, det, elim, byz) -> None:
    """Add one step to the (B,) int32 counters in place.  The schedule
    already masks every event array by liveness, so the counters are
    straight masked sums of the host recorder's arrays; ``elim`` is the
    identify vote's eliminations, None when no trial voted."""
    i32 = torch.int32
    tel["steps"] += x["live"].to(i32)
    tel["checks"] += x["checks"].to(i32)
    tel["redundant_steps"] += (x["checks"] | x["vote1"]).to(i32)
    tel["detects"] += det.to(i32)
    tel["identify_rounds"] += x["identify"].to(i32)
    tel["vote_rounds"] += (x["identify"] | x["vote1"]).to(i32)
    if elim is not None:
        tel["eliminations"] += elim
    tel["tamper_events"] += (x["tam1"].sum(dim=1, dtype=i32)
                             + x["tam2"].sum(dim=1, dtype=i32))
    tel["byz_active_steps"] += (byz & x["active"] & x["live"][:, None]).sum(
        dim=1, dtype=i32)


class Epilogue:
    """The step epilogue both control planes share: the residual, the
    contraction to an update, the aggregation with the affine attacks
    folded in, the detection symbols and the coefficient-plane fold.

    A, y, noisevec, stat and the flags are as ``scan`` takes them.  The
    coefficient planes (fused, gram) carry per-row residual coefficients
    instead of (B, d) update values, so they share the tuple-valued
    update (row, ones-row coefficient, noise-row coefficient)."""

    def __init__(self, A, y, cw0, stat, noisevec, *, B: int, impl,
                 fused: bool, gram: bool, shared: bool, has_bias: bool):
        self.A, self.y, self.noisevec = A, y, noisevec
        self.n_data = y.shape[-1]
        self.lr, self.alpha = stat["lr"], stat["alpha"]
        self.beta, self.nu = stat["beta"], stat["nu"]
        self.impl, self.gram, self.shared = impl, gram, shared
        self.has_bias = has_bias
        self.coeff = fused or gram
        if gram:
            Ie = A["rows"].shape[0]
            self.Gn = A["G"][:, :self.n_data]   # symbol columns read
            self.S0n = cw0[:, :self.n_data]
        elif fused:
            Ie = A.shape[0]
        if self.coeff:
            self.zpad = torch.zeros((B, Ie - self.n_data - 2),
                                    device=y.device)

    def resid(self, carry):
        """The (B, I) residual of the gram carry C (from the Gram
        factors, no d-sized work) or of the stream plane's W."""
        if self.gram:
            return self.S0n - carry @ self.Gn - self.y[None, :]
        if self.shared:
            return torch.einsum("id,bd->bi", self.A, carry) - self.y[None, :]
        return torch.einsum("bid,bd->bi", self.A, carry) - self.y

    def step_tables(self, com, t: int, pid):
        """Step t's sketch tables: (SA (I, k) or the (B, I, k) gathered
        by ``pid``, sk_one (k,), sk_noise (k,))."""
        SA = com["SA"][t] if self.gram else com["SA"][t][pid]
        return SA, com["sk_one"][t], com["sk_noise"][t]

    def contract(self, cr):
        """(B, I) row weights -> the (B, d) update value."""
        if self.shared:
            return torch.einsum("bi,id->bd", cr, self.A)
        return ops.batched_coded_encode(cr[:, None, :], self.A,
                                        impl=self.impl)[:, 0]

    def agg(self, agg_coeff, tam, mask, cr_base):
        """(B, n) aggregation coefficients -> the update, the affine
        attacks folded in: sum_w coeff_w * attack_w(g_w).  The
        coefficient planes return the update's coefficient row (B, I)
        and its two bias coefficients (ones row, noise row); the stream
        plane the (B, d) update value."""
        alpha, beta, nu = self.alpha, self.beta, self.nu
        aeff = torch.where(tam, alpha[:, None], 1.0) * agg_coeff
        row = torch.einsum("bw,bwi->bi", aeff, mask) * cr_base
        tw = agg_coeff * tam
        if self.coeff:
            return row, (tw * beta[:, None]).sum(dim=1), \
                (tw * nu[:, None]).sum(dim=1)
        upd = self.contract(row)
        if self.has_bias:
            upd = upd + (tw * beta[:, None]).sum(dim=1)[:, None] \
                + (tw * nu[:, None]).sum(dim=1)[:, None] * self.noisevec[None]
        return upd

    def symbols(self, mask, cr_base, tam, SA_b, sk_one, sk_noise):
        """Per-worker detection symbols: the worker's coefficient row
        times the step's sketch table ((I, k) on the coefficient planes,
        the gathered (B, I, k) on the stream plane), attacks applied
        affinely.  One einsum for all workers, so replicas with
        identical rows get bitwise identical symbols."""
        alpha, beta, nu = self.alpha, self.beta, self.nu
        C = mask * cr_base[:, None, :]
        if self.coeff:
            skw = torch.einsum("bwi,ik->bwk", C, SA_b)
        else:
            skw = torch.einsum("bwi,bik->bwk", C, SA_b)
        if self.coeff or self.has_bias:
            add = beta[:, None, None] * sk_one[None, None] \
                + nu[:, None, None] * sk_noise[None, None]
        else:
            add = 0.0
        return torch.where(tam[:, :, None],
                           alpha[:, None, None] * skw + add, skw)

    def acc(self, u, v):
        if self.coeff:
            return (u[0] + v[0], u[1] + v[1], u[2] + v[2])
        return u + v

    def fold_coeff(self, upd, live):
        """(row, b1, b2) -> the (B, Ie) coefficient increment with lr and
        the live mask folded in (a dead trial's row is exactly zero)."""
        row_u, b1, b2 = upd
        scale = torch.where(live, self.lr, 0.0)
        return torch.cat([row_u, b1[:, None], b2[:, None], self.zpad],
                         dim=1) * scale[:, None]


def scan(A, y, W0, cw0, stat, xs, com, noisevec=None, pid=None, *, gates,
         impl, fused: bool = False, gram: bool = False, shared: bool = True,
         has_filter: bool = False, has_bias: bool = True,
         telemetry: bool = False):
    """Run the T protocol steps.  Returns (carry, losses (T, B) f32,
    det (T, B) bool), and with ``telemetry`` the counters {key: (B,)
    int32} as a fourth item; ``finish`` turns the carry into W_T.

    A: gram {"rows": (Ie, d), "G": (Ie, Ie)}; fused the extended rows
    (Ie, d) f32|bf16; stream the data (n_data, d) when ``shared``, else
    the chunk's (B, n_data, d).  y (n_data,) or (B, n_data).  W0 (B, d)
    the starting iterate (fused: overwritten on the CUDA route); cw0
    (B, Ie): fused the pending coefficients (zero: the pipelined
    prologue), gram the starting symbols S_0 = W_0 R^T.  stat {"lr",
    "alpha", "beta", "nu", "fcode", "farr"} (B,); xs the (T, B, ...)
    schedule tensors; com fused {"keys": (T,) uint32 numpy}, gram
    {"SA": (T, n_data, k), "sk_one", "sk_noise"}, stream {"SA":
    (T, P, n_data, k), "sk_one", "sk_noise"} gathered by ``pid`` (B,);
    noisevec (d,) for the stream plane; gates the host (T, B) bool
    arrays "vote1" and "identify".  ``telemetry`` needs stat["byz"], the
    (B, n) Byzantine mask."""
    n_data = y.shape[-1]
    B = xs["live"].shape[1]
    dev = y.device
    lr, alpha, beta, nu = stat["lr"], stat["alpha"], stat["beta"], stat["nu"]
    ep = Epilogue(A, y, cw0, stat, noisevec, B=B, impl=impl, fused=fused,
                  gram=gram, shared=shared, has_bias=has_bias)
    agg, symbols, acc = ep.agg, ep.symbols, ep.acc

    def vote_part(resid, step, shard, group, m, tam, gate, skt=None,
                  mask=None, cr=None, count_elim=False):
        """A majority-vote round (draco's every step, or an identify
        round) folded into an update; the caller skips it when the
        host gate is empty.  ``count_elim`` also returns the (B,) int32
        eliminations: the vote's outvoted workers (the host schedule
        applied them when it built later steps; here they are only
        counted)."""
        if skt is None:
            mask, rows_ = shard_mask(shard, group, m, n_data)
            cr = resid * (2.0 / rows_)[:, None]
            skt = symbols(mask, cr, tam, *step)
        gv = torch.where(gate[:, None], group, -1)
        wc, faulty = ops.batched_vote(skt, gv, tau=TAU_VOTE, impl=impl)
        coeff_w = torch.where(gate[:, None],
                              wc / torch.clamp(m, min=1)[:, None], 0.0)
        out = agg(coeff_w, tam, mask, cr)
        if not count_elim:
            return out
        return out, (gate[:, None] & faulty & (gv >= 0)).sum(
            dim=1, dtype=torch.int32)

    T = xs["live"].shape[0]
    losses = torch.empty((T, B), dtype=torch.float32, device=dev)
    det = torch.empty((T, B), dtype=torch.bool, device=dev)
    if fused:
        W, cw = W0, cw0
    elif gram:
        C = torch.zeros_like(cw0)
    else:
        W = W0
    if telemetry:
        tel = {k: torch.zeros(B, dtype=torch.int32, device=dev)
               for k in TEL_KEYS}
    for t in range(T):
        x = {k: v[t] for k, v in xs.items()}
        if fused:
            # one pass over d: apply cw_{t-1}, take resid_t and the
            # step's sketch table (the pipelined prologue)
            W, resid_e, sk = ops.fused_step(A, W, cw, int(com["keys"][t]),
                                            impl=impl)
            resid = resid_e[:, :n_data] - y[None, :]
            step = (sk[:n_data], sk[n_data], sk[n_data + 1])
        else:
            # gram: no d-sized work, residual symbols from the Gram factors
            resid = ep.resid(C if gram else W)
            step = ep.step_tables(com, t, pid)
        losses[t] = (resid * resid).mean(dim=1)

        mask1, rows1 = shard_mask(x["shard1"], x["group1"], x["m1"], n_data)
        cr1 = resid * (2.0 / rows1)[:, None]
        upd = agg(x["aggw"], x["tam1"], mask1, cr1)

        skt1 = symbols(mask1, cr1, x["tam1"], *step)
        fault, _ = detect_groups_batched(skt1, x["group1"], tau=TAU_DETECT)
        det[t] = x["checks"] & fault

        if gates["vote1"][t].any():
            upd = acc(upd, vote_part(resid, step, x["shard1"], x["group1"],
                                     x["m1"], x["tam1"], x["vote1"],
                                     skt=skt1, mask=mask1, cr=cr1))
        elim = None
        if gates["identify"][t].any():
            upd2 = vote_part(resid, step, x["shard2"], x["group2"], x["m2"],
                             x["tam2"], x["identify"], count_elim=telemetry)
            if telemetry:
                upd2, elim = upd2
            upd = acc(upd, upd2)

        if has_filter:
            # the gradient-filter baselines need the real (B, n, d) stack
            Cw = mask1 * cr1[:, None, :]
            if shared:
                g1 = torch.einsum("bwi,id->bwd", Cw, A)
            else:
                g1 = torch.einsum("bwi,bid->bwd", Cw, A)
            gt1 = apply_affine(g1, x["tam1"], alpha, beta, nu, noisevec,
                               has_bias)
            del g1
            act = x["active"] & x["live"][:, None]
            fcode = stat["fcode"]
            fupd = torch.where((fcode == 1)[:, None], masked_median(gt1, act),
                               masked_mean(gt1, act))
            fupd = torch.where((fcode == 2)[:, None],
                               masked_krum(gt1, act, stat["farr"]), fupd)
            upd = torch.where((fcode >= 0)[:, None], fupd, upd)

        if fused:
            cw = ep.fold_coeff(upd, x["live"])
        elif gram:
            C = C + ep.fold_coeff(upd, x["live"])
        else:
            W = torch.where(x["live"][:, None], W - lr[:, None] * upd, W)
        if telemetry:
            count_step(tel, x, det[t], elim, stat["byz"])
    carry = (W, cw) if fused else (C if gram else W)
    if telemetry:
        return carry, losses, det, tel
    return carry, losses, det


def device_scan(A, y, W0, cw0, stat, com, noisevec=None, pid=None, *,
                impl, gram: bool = False, shared: bool = True,
                has_bias: bool = True, telemetry: bool = False):
    """Run the T protocol steps with the control plane on the device
    (``stepcore.py:248-413`` of the reference).  Returns (carry, losses
    (T, B) f32, q (T, B) f32, check (T, B) bool, det (T, B) bool,
    faulty2 (T, B, n) bool), with ``telemetry`` the counters {key: (B,)
    int32} as a seventh item; ``finish`` turns the carry into W_T.

    A, y, W0, cw0, com, noisevec and pid are as ``scan`` takes them on
    the gram and stream planes (T is com["SA"]'s first dimension).  stat
    adds the per-trial statics of the device plane: "p" (f32),
    "qfix" (f32), "qcode" (0 none, 1 deterministic, 2 randomized,
    3 adaptive), "f0", "onset", "steps" (int32), "byz" and "act0"
    (B, n) bool, and the stream key words "dk0", "dk1", "tk0", "tk1",
    "pk0", "pk1" (int64)."""
    n_data = y.shape[-1]
    B, n = stat["byz"].shape
    T = com["SA"].shape[0]
    dev = y.device
    ep = Epilogue(A, y, cw0, stat, noisevec, B=B, impl=impl, fused=False,
                  gram=gram, shared=shared, has_bias=has_bias)
    p32, lr = stat["p"], stat["lr"]

    # the chunk's coins and keys, one threefry each; then the parts of
    # the decisions that do not depend on the loop's values
    u_dec = rngstream.decide_uniforms_torch(stat["dk0"], stat["dk1"], T)
    tam_coin = rngstream.uniform01(rngstream.phase_worker_torch(
        stat["tk0"], stat["tk1"], T, n)) < p32[None, None, :, None]
    pkeys = rngstream.phase_worker_torch(stat["pk0"], stat["pk1"], T, n)
    tix = torch.arange(T, dtype=torch.int32, device=dev)[:, None]
    live_all = tix < stat["steps"][None]                     # (T, B)
    elig = stat["byz"][None] \
        & (live_all & (tix >= stat["onset"][None]))[:, :, None]
    tam1_all = elig & tam_coin[:, 0]                         # (T, B, n)
    tam2_coin = elig & tam_coin[:, 1]
    del tam_coin, elig

    losses = torch.empty((T, B), dtype=torch.float32, device=dev)
    q_tr = torch.empty((T, B), dtype=torch.float32, device=dev)
    check_tr = torch.empty((T, B), dtype=torch.bool, device=dev)
    det_tr = torch.empty((T, B), dtype=torch.bool, device=dev)
    faulty2_tr = torch.empty((T, B, n), dtype=torch.bool, device=dev)
    carry = torch.zeros_like(cw0) if gram else W0      # C_t, or W_t
    active = stat["act0"]
    kappa = torch.zeros(B, dtype=torch.int32, device=dev)
    if telemetry:
        tel = {k: torch.zeros(B, dtype=torch.int32, device=dev)
               for k in TEL_KEYS}
    for t in range(T):
        live, tam1 = live_all[t], tam1_all[t]
        resid = ep.resid(carry)
        step = ep.step_tables(com, t, pid)
        loss = (resid * resid).mean(dim=1)
        losses[t] = loss

        # -- q*_t and the check coin (DECIDE)
        f_t = torch.clamp(stat["f0"] - kappa, min=0)          # (B,) i32
        qad = adaptive.q_star_arr(f_t, p32, adaptive.lam_from_loss_arr(loss))
        qvec = torch.where(stat["qcode"] == 1, 1.0, stat["qfix"])
        qvec = torch.where(f_t > 0, qvec, 0.0)
        q_t = torch.where(stat["qcode"] == 3, qad,
                          torch.where(stat["qcode"] == 0, 0.0, qvec))
        check = live & (u_dec[t] < q_t)

        # -- the check layout: the masked regroup when checking, else
        #    the fast layout (every active worker its own shard)
        r1 = torch.clamp(f_t, min=1) + 1
        sh_c, gr_c, m_c = ops.batched_regroup(pkeys[t, 0], active, r1)
        rank = torch.cumsum(active, dim=1, dtype=torch.int32) - 1
        n_act = active.sum(dim=1, dtype=torch.int32)
        chk = check[:, None]
        shard1 = torch.where(chk, sh_c, torch.where(active, rank, 0))
        group1 = torch.where(chk, gr_c, torch.where(active, rank, -1))
        group1 = torch.where(live[:, None], group1, -1)
        m1 = torch.where(check, m_c, n_act)
        mask1, rows1 = shard_mask(shard1, group1, m1, n_data)
        cr1 = resid * (2.0 / rows1)[:, None]

        # -- the detect verdict on sketch symbols
        skt1 = ep.symbols(mask1, cr1, tam1, *step)
        fault, _ = detect_groups_batched(skt1, group1, tau=TAU_DETECT)
        det = check & fault

        # -- aggregation (fast and clean-check trials; detecting ones
        #    take the identify round's vote instead)
        w_per = 1.0 / torch.clamp(m1 * torch.where(check, r1, 1),
                                  min=1).to(torch.float32)
        aggw = torch.where(group1 >= 0, w_per[:, None], 0.0)
        aggw = torch.where(det[:, None], 0.0, aggw)
        upd = ep.agg(aggw, tam1, mask1, cr1)

        # -- the identify round at 2 max(f_t, 1) + 1, masked by det: the
        #    regroup on the phase-1 keys, the vote (K3), the eliminations
        tam2 = det[:, None] & tam2_coin[t]
        r2 = 2 * torch.clamp(f_t, min=1) + 1
        sh2, gr2, m2 = ops.batched_regroup(pkeys[t, 1], active, r2)
        gr2 = torch.where(det[:, None], gr2, -1)
        mask2, rows2 = shard_mask(sh2, gr2, m2, n_data)
        cr2 = torch.where(det[:, None], resid * (2.0 / rows2)[:, None], 0.0)
        skt2 = ep.symbols(mask2, cr2, tam2, *step)
        wc, faulty = ops.batched_vote(skt2, gr2, tau=TAU_VOTE, impl=impl)
        coeff_w = torch.where(det[:, None],
                              wc / torch.clamp(m2, min=1)[:, None], 0.0)
        upd = ep.acc(upd, ep.agg(coeff_w, tam2, mask2, cr2))
        faulty2 = det[:, None] & faulty & (gr2 >= 0)

        if gram:
            carry = carry + ep.fold_coeff(upd, live)
        else:
            carry = torch.where(live[:, None], carry - lr[:, None] * upd,
                                carry)
        if telemetry:
            # as the reference's device carry: redundancy, votes and
            # identify rounds all trace back to the check coin; tamper
            # coins count only on workers active at the step's start;
            # byz_active_steps counts after the eliminations
            i32 = torch.int32
            tel["steps"] += live.to(i32)
            tel["checks"] += check.to(i32)
            tel["redundant_steps"] += check.to(i32)
            tel["detects"] += det.to(i32)
            tel["identify_rounds"] += det.to(i32)
            tel["vote_rounds"] += det.to(i32)
            tel["eliminations"] += faulty2.sum(dim=1, dtype=i32)
            tel["tamper_events"] += ((tam1 & active).sum(dim=1, dtype=i32)
                                     + (tam2 & active).sum(dim=1, dtype=i32))
        active = active & ~faulty2
        kappa = kappa + faulty2.sum(dim=1, dtype=torch.int32)
        if telemetry:
            tel["byz_active_steps"] += (stat["byz"] & active
                                        & live[:, None]).sum(dim=1,
                                                             dtype=i32)
        q_tr[t] = torch.where(live, q_t, 0.0)
        check_tr[t] = check
        det_tr[t] = det
        faulty2_tr[t] = faulty2
    out = (carry, losses, q_tr, check_tr, det_tr, faulty2_tr)
    if telemetry:
        return out + (tel,)
    return out


def finish(A, W0, carry, *, fused: bool = False, gram: bool = False):
    """The carry -> W_T.  Gram: the only d-sized work of the run,
    W_T = W_0 - C_T @ R; fused: the last step's pending update,
    W - cw @ rows; stream: the carry is W_T."""
    if gram:
        return W0 - carry @ A["rows"]
    if fused:
        W, cw = carry
        return W - cw @ A.to(torch.float32)
    return carry


def step_core(A, y, W0, cw0, stat, xs, com, noisevec=None, pid=None, *,
              gates, impl, fused: bool = False, gram: bool = False,
              shared: bool = True, has_filter: bool = False,
              has_bias: bool = True):
    """A whole run under host control: ``scan`` then ``finish``.
    Returns (W_T (B, d), losses (T, B), det (T, B))."""
    carry, losses, det = scan(
        A, y, W0, cw0, stat, xs, com, noisevec, pid, gates=gates, impl=impl,
        fused=fused, gram=gram, shared=shared, has_filter=has_filter,
        has_bias=has_bias)
    return finish(A, W0, carry, fused=fused, gram=gram), losses, det
