"""The protocol step loop on the gram data plane under host control.

Port of ``repro.core.engineplan.stepcore.step_core`` for ``gram=True,
control="host"`` (``stepcore.py:71-245`` and ``:415-587``).  Every
iterate is ``W_t = W_0 - C_t @ R`` over the extended rows R (data rows,
ones row, noise row), so the loop carries only the (B, Ie) coefficients
C_t: residual symbols are ``S_0 - C_t @ G`` with G = R R^T precomputed,
detection symbols come from the per-step sketch tables by linearity,
honest replicas are copies and every attack is affine, so the whole
"shard gradients -> tamper -> aggregate/vote" pipeline folds into
coefficient rows.  d is touched once, after the loop: ``W_T = W_0 -
C_T @ R``.

The scan is a Python loop over T.  The vote gates (``vote1``,
``identify``) are branched on from their host numpy copies, so the loop
never waits on the device.
"""
from __future__ import annotations

import torch

from repro_torch.core.detection import detect_groups_batched
from repro_torch.kernels import ops

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


def scan(A, y, cw0, stat, xs, com, *, gates, impl):
    """Run the T protocol steps in coefficient space.

    A = {"rows": (Ie, d), "G": (Ie, Ie)}; y (n_data,); cw0 (B, Ie) the
    starting symbols S_0 = W_0 R^T; stat {"lr", "alpha", "beta", "nu"}
    (B,) f32; xs the (T, B, ...) schedule tensors; com the sketch tables
    {"SA": (T, n_data, k), "sk_one": (T, k), "sk_noise": (T, k)};
    gates the host (T, B) bool arrays "vote1" and "identify".
    Returns (C_T (B, Ie), losses (T, B) f32, det (T, B) bool)."""
    n_data = y.shape[-1]
    B, Ie = cw0.shape
    dev = cw0.device
    lr, alpha, beta, nu = stat["lr"], stat["alpha"], stat["beta"], stat["nu"]
    Gn = A["G"][:, :n_data]            # symbol columns the loop reads
    S0n = cw0[:, :n_data]
    zpad = torch.zeros((B, Ie - n_data - 2), device=dev)

    def agg(agg_coeff, tam, mask, cr_base):
        """(B, n) aggregation coefficients -> the update's coefficient row
        (B, I) and its two bias coefficients (ones row, noise row), the
        affine attacks folded in: sum_w coeff_w * attack_w(g_w)."""
        aeff = torch.where(tam, alpha[:, None], 1.0) * agg_coeff
        row = torch.einsum("bw,bwi->bi", aeff, mask) * cr_base
        tw = agg_coeff * tam
        return row, (tw * beta[:, None]).sum(dim=1), \
            (tw * nu[:, None]).sum(dim=1)

    def symbols(mask, cr_base, tam, SA_b, sk_one, sk_noise):
        """Per-worker detection symbols: the worker's coefficient row
        times the step's sketch table, attacks applied affinely.  One
        einsum for all workers, so replicas with identical rows get
        bitwise identical symbols."""
        C = mask * cr_base[:, None, :]
        skw = torch.einsum("bwi,ik->bwk", C, SA_b)
        add = beta[:, None, None] * sk_one[None, None] \
            + nu[:, None, None] * sk_noise[None, None]
        return torch.where(tam[:, :, None],
                           alpha[:, None, None] * skw + add, skw)

    def acc(u, v):
        return (u[0] + v[0], u[1] + v[1], u[2] + v[2])

    def fold_coeff(upd, live):
        """(row, b1, b2) -> the (B, Ie) coefficient increment with lr and
        the live mask folded in (a dead trial's row is exactly zero)."""
        row_u, b1, b2 = upd
        scale = torch.where(live, lr, 0.0)
        return torch.cat([row_u, b1[:, None], b2[:, None], zpad],
                         dim=1) * scale[:, None]

    def vote_part(resid, step, shard, group, m, tam, gate, skt=None,
                  mask=None, cr=None):
        """A majority-vote round (draco's every step, or an identify
        round) folded into an update; the caller skips it when the
        host gate is empty."""
        if skt is None:
            mask, rows_ = shard_mask(shard, group, m, n_data)
            cr = resid * (2.0 / rows_)[:, None]
            skt = symbols(mask, cr, tam, *step)
        gv = torch.where(gate[:, None], group, -1)
        wc, _ = ops.batched_vote(skt, gv, tau=TAU_VOTE, impl=impl)
        coeff = torch.where(gate[:, None],
                            wc / torch.clamp(m, min=1)[:, None], 0.0)
        return agg(coeff, tam, mask, cr)

    T = xs["live"].shape[0]
    losses = torch.empty((T, B), dtype=torch.float32, device=dev)
    det = torch.empty((T, B), dtype=torch.bool, device=dev)
    C = torch.zeros_like(cw0)
    for t in range(T):
        x = {k: v[t] for k, v in xs.items()}
        step = (com["SA"][t], com["sk_one"][t], com["sk_noise"][t])
        # no d-sized work: residual symbols of W_t from the Gram factors
        resid = S0n - C @ Gn - y[None, :]
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
        if gates["identify"][t].any():
            upd = acc(upd, vote_part(resid, step, x["shard2"], x["group2"],
                                     x["m2"], x["tam2"], x["identify"]))
        C = C + fold_coeff(upd, x["live"])
    return C, losses, det


def post_scan(W0, C, rows):
    """The only d-sized work of the run: W_T = W_0 - C_T @ R."""
    return W0 - C @ rows


def step_core(A, y, W0, cw0, stat, xs, com, *, gates, impl):
    """The whole gram-plane run under host control: ``scan`` then
    ``post_scan``.  Returns (W_T (B, d), losses (T, B), det (T, B))."""
    C, losses, det = scan(A, y, cw0, stat, xs, com, gates=gates, impl=impl)
    return post_scan(W0, C, A["rows"]), losses, det
