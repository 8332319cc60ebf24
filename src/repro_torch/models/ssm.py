"""Mamba2 (SSD, state-space duality) block, chunked algorithm.

Port of ``repro.models.ssm``.  Prefill and training split the sequence
into chunks of length Q: the intra-chunk term is a masked quadratic
(attention-like) product, the inter-chunk term a recurrence over
per-chunk states (the reference's ``lax.scan``, a Python loop here).
Decode is O(1) a token through the (B, H, N, P) state and a causal conv
buffer of the previous d_conv - 1 raw projected inputs.

Precision follows the reference: the projections and the out projection
in the config's dtype; the conv outputs, SiLU, softplus, dt, A, the
decays, the states and y in f32; the gated y * silu(z) in f32, cast to
the dtype before the RMSNorm.  The SSM state is f32, the conv caches
are in the dtype.  No kernel: the reference computes these products as
einsums outside any Pallas kernel.

Split over the ambient ``model`` axis (the reference's ``ssm_inner``
and ``ssm_heads`` on ``model``, ``sharding.tree_shardings`` under
``tp_only_rules``), each rank holds H / model heads: the columns of
in_z, in_x (and conv_x) and in_dt, its A_log, dt_bias and D, and the
rows of the row-parallel out, whose output is summed over ``model``.
The chunked SSD is per head and stays local.  in_B, in_C, conv_B,
conv_C and norm are replicated: every rank projects B and C whole and
reads its slice of norm, so their gradients are partial and go through
``parallel.copy``, as the block's input does.  The gated RMSNorm runs
over the split d_inner: its sum of squares is summed over ``model`` in
f32 (``layers.rmsnorm``'s ``width``).  One group (n_groups = 1) and
d_inner split with the heads (``split_error``).  Decode splits the same
way (``mamba_decode_step``).  Under FSDP (the plain steps) the layer's
d_model dims are gathered over ``data`` before the mixer runs
(``transformer.fsdp_layer``), so in_* and out arrive as the split
above reads them; B and C stay whole over ``model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import parallel
from repro_torch.models.layers import dtype_of, init_weight, rmsnorm


def dims(cfg):
    """(d_inner, heads, groups, d_state)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.n_groups, s.d_state


def init_mamba(cfg, gen: torch.Generator, device):
    """The reference's ``abstract_mamba`` leaves, drawn with its
    distributions (``layers.materialize``): matrices (and the (d_conv, C)
    conv weights, std 0.5) truncated normal times 1/sqrt(shape[-2]);
    A_log = log U(1, 16) and dt_bias = softplus^-1 of U(1e-3, 1e-1), in
    f32; D (f32) and norm ones."""
    dt = dtype_of(cfg)
    D, d_conv = cfg.d_model, cfg.ssm.d_conv
    d_inner, H, G, N = dims(cfg)

    def w(*shape):
        return init_weight(shape, dt, gen, device)

    def uniform(lo, hi):
        u = torch.empty(H, dtype=torch.float32, device=device)
        return u.uniform_(lo, hi, generator=gen)

    u = uniform(1e-3, 1e-1)
    return {
        "in_z": w(D, d_inner), "in_x": w(D, d_inner),
        "in_B": w(D, G * N), "in_C": w(D, G * N), "in_dt": w(D, H),
        "conv_x": w(d_conv, d_inner), "conv_B": w(d_conv, G * N),
        "conv_C": w(d_conv, G * N),
        "A_log": torch.log(uniform(1.0, 16.0)),
        "dt_bias": u + torch.log(-torch.expm1(-u)),
        "D": torch.ones(H, dtype=torch.float32, device=device),
        "norm": torch.ones(d_inner, dtype=dt, device=device),
        "out": w(d_inner, D),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by shifted adds.  x: (B, T, C), w: (W, C)."""
    W, T = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :T]
        out = out + shifted * w[W - 1 - i]
    return out


def split_error(cfg, model: int) -> str | None:
    """Why a mamba mixer cannot split over a model axis of ``model``
    ranks (None when it can): ``spec_for``'s divisibility fallback would
    split d_inner (``ssm_inner``) without the heads (``ssm_heads``), or
    the heads without d_inner; or the heads span n_groups > 1 groups of
    B and C."""
    d_inner, H, G, _ = dims(cfg)
    if model <= 1 or (d_inner % model and H % model):
        return None
    if d_inner % model or H % model:
        return (f"{cfg.name}: d_inner {d_inner} and {H} ssm heads over a "
                f"model axis of {model} split apart (a misaligned ssm "
                f"split)")
    if G != 1:
        return (f"{cfg.name}: {G} ssm groups; the port splits the mamba "
                f"mixer of one group")
    return None


def heads_split(params, cfg) -> bool:
    """Whether the mixer's heads are split over the model axis (its
    A_log holds fewer than the config's heads)."""
    return params["A_log"].shape[-1] != dims(cfg)[1]


def _split_view(params, cfg):
    """A split mixer's leaves as this rank reads them: the replicated
    ones through ``parallel.copy`` (their gradients are partial), norm's
    slice of the rank's d_inner."""
    ax = parallel.require_axis()
    err = split_error(cfg, ax.world)
    if err:
        raise ValueError(err)
    p = dict(params)
    for name in ("in_B", "in_C", "conv_B", "conv_C"):
        p[name] = parallel.copy(params[name], ax)
    n = params["in_x"].shape[-1]
    p["norm"] = parallel.copy(params["norm"], ax).narrow(0, ax.rank * n, n)
    return p, ax


def _ssd_inputs(params, xin: torch.Tensor, cfg):
    """The prefill's projections: (z, x (B,T,H,P), B (B,T,G,N), C, dt),
    H the heads ``params`` hold."""
    _, _, G, N = dims(cfg)
    H = params["A_log"].shape[-1]
    Bsz, T, _ = xin.shape
    z = xin @ params["in_z"]
    x = xin @ params["in_x"]
    Bp = xin @ params["in_B"]
    Cp = xin @ params["in_C"]
    dtp = xin @ params["in_dt"]
    x = F.silu(_causal_conv(x, params["conv_x"]).float())
    Bp = F.silu(_causal_conv(Bp, params["conv_B"]).float())
    Cp = F.silu(_causal_conv(Cp, params["conv_C"]).float())
    dt = F.softplus(dtp.float() + params["dt_bias"])
    return (z, x.reshape(Bsz, T, H, -1), Bp.reshape(Bsz, T, G, N),
            Cp.reshape(Bsz, T, G, N), dt)


def _gate_out(params, y: torch.Tensor, z: torch.Tensor, cfg,
              ax=None) -> torch.Tensor:
    """Gated RMSNorm and the out projection: y f32 (..., d_inner), or
    this rank's slice of it under the model axis ``ax`` (the norm over
    the whole d_inner, the out product summed over ``model``)."""
    y = y * F.silu(z.float())
    y = rmsnorm({"scale": params["norm"]}, y.to(dtype_of(cfg)), cfg.norm_eps,
                width=None if ax is None else dims(cfg)[0])
    out = y @ params["out"]
    return out if ax is None else parallel.reduce(out, ax)


def mamba(params, xin: torch.Tensor, cfg, initial_state=None,
          return_state: bool = False):
    """xin: (B, T, D) -> (B, T, D), the chunked SSD; with
    ``return_state`` also the final (B, H, N, P) f32 state.  Split over
    the model axis when the heads are (``heads_split``): H is then this
    rank's heads."""
    ax = None
    if heads_split(params, cfg):
        params, ax = _split_view(params, cfg)
        xin = parallel.copy(xin, ax)
    _, _, G, N = dims(cfg)
    H, d_inner = params["A_log"].shape[-1], params["in_x"].shape[-1]
    HG = H // G
    Bsz, T, _ = xin.shape
    Q = min(cfg.ssm.chunk, T)
    if T % Q:
        raise ValueError(f"seq len {T} not a multiple of chunk {Q}")
    nC = T // Q

    z, x, Bp, Cp, dt = _ssd_inputs(params, xin, cfg)
    P = x.shape[-1]
    A = -torch.exp(params["A_log"])                             # (H,) < 0
    log_a = dt * A                                              # (B, T, H)

    xc = x.reshape(Bsz, nC, Q, H, P)
    Bc = Bp.reshape(Bsz, nC, Q, G, N)
    Cc = Cp.reshape(Bsz, nC, Q, G, N)
    dtc = dt.reshape(Bsz, nC, Q, H)
    L = torch.cumsum(log_a.reshape(Bsz, nC, Q, H), dim=2)       # inclusive

    # intra-chunk: G[b,c,h,q,s] = (C_q . B_s) exp(L_q - L_s) dt_s, s <= q.
    # The clamp keeps exp finite above the diagonal (L_q - L_s > 0 there
    # reaches hundreds at full width): an inf would turn into NaN in the
    # backward pass even where the mask zeroes the forward.
    # Each group's C.B is broadcast over its HG heads (the reference's
    # repeat, without the copy).
    cb = torch.einsum("bcqgn,bcsgn->bcgqs", Cc, Bc)[:, :, :, None]
    dec = L[:, :, :, None, :] - L[:, :, None, :, :]             # (B,C,Q,Q,H)
    dec = torch.exp(torch.clamp(dec, max=0.0)).permute(0, 1, 4, 2, 3)
    mask = torch.ones(Q, Q, dtype=torch.bool, device=xin.device).tril()
    g = torch.where(mask, (cb * dec.unflatten(2, (G, HG))).flatten(2, 3),
                    0.0)                                        # (B,C,H,Q,Q)
    g = g * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", g, xc)

    # per-chunk local states: sum_s exp(L_last - L_s) dt_s B_s x_s
    wdec = torch.exp(L[:, :, -1:, :] - L)                       # (B,C,Q,H)
    Bh = Bc.repeat_interleave(HG, dim=3)                        # (B,C,Q,H,N)
    wb = Bh * (wdec * dtc)[..., None]
    S_local = torch.einsum("bcshn,bcshp->bchnp", wb, xc)        # (B,C,H,N,P)

    # the inter-chunk recurrence
    chunk_decay = torch.exp(L[:, :, -1, :])                     # (B, C, H)
    S = (torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=xin.device)
         if initial_state is None else initial_state)
    prevs = []
    for c in range(nC):
        prevs.append(S)
        S = S * chunk_decay[:, c, :, None, None] + S_local[:, c]
    S_prevs = torch.stack(prevs, dim=1)                         # (B,C,H,N,P)

    # y_inter[q] = exp(L_q) C_q . S_prev
    cg = Cc.repeat_interleave(HG, dim=3)                        # (B,C,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", cg, S_prevs)
    y_inter = y_inter * torch.exp(L)[..., None]

    y = (y_intra + y_inter).reshape(Bsz, T, H, P)
    y = y + params["D"][None, None, :, None] * x
    out = _gate_out(params, y.reshape(Bsz, T, d_inner), z, cfg, ax)
    return (out, S) if return_state else out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def mamba_cache_layout(cfg, batch: int, num_layers: int) -> dict:
    """{name: (shape, dtype)} of the decode cache (the reference's
    ``abstract_mamba_cache``): state (L_m, B, H, N, P) f32, conv_x (L_m,
    B, d_conv-1, d_inner) and conv_B, conv_C (L_m, B, d_conv-1, G*N) in
    the config's dtype."""
    d_inner, H, G, N = dims(cfg)
    W, dt = cfg.ssm.d_conv - 1, dtype_of(cfg)
    return {
        "state": ((num_layers, batch, H, N, cfg.ssm.head_dim),
                  torch.float32),
        "conv_x": ((num_layers, batch, W, d_inner), dt),
        "conv_B": ((num_layers, batch, W, G * N), dt),
        "conv_C": ((num_layers, batch, W, G * N), dt),
    }


def allocate_mamba_cache(cfg, batch: int, num_layers: int, device):
    """Zero decode cache in ``mamba_cache_layout``."""
    return {n: torch.zeros(shape, dtype=dt, device=device)
            for n, (shape, dt) in mamba_cache_layout(cfg, batch,
                                                     num_layers).items()}


def _conv_step(x_new: torch.Tensor, conv_cache: torch.Tensor,
               w: torch.Tensor):
    """x_new: (B, C); conv_cache: (B, W-1, C) of the previous raw inputs.
    Returns (y (B, C), the new cache): the window's products summed in
    f32 and rounded once, as the reference's einsum (a dot) does."""
    window = torch.cat([conv_cache, x_new[:, None, :]], dim=1)  # (B, W, C)
    y = (window.float() * w.float()).sum(dim=1).to(x_new.dtype)
    return y, window[:, 1:]


def mamba_decode_step(params, xin: torch.Tensor, cache, cfg):
    """One token.  xin: (B, D); cache: {state, conv_x, conv_B, conv_C} of
    one layer.  Returns (out (B, D), new cache): new tensors, the input
    cache untouched (a replayed step starts from the same state).  Split
    over the model axis as ``mamba``: conv_x holds this rank's d_inner
    (``ACT_RULES``' ``ssm_inner``), the state every head (``ACT_RULES``
    places no ``ssm_heads``): the rank updates its heads' slice and the
    new state is gathered over ``model``."""
    ax = None
    if heads_split(params, cfg):
        params, ax = _split_view(params, cfg)
    _, _, G, N = dims(cfg)
    H, d_inner = params["A_log"].shape[-1], params["in_x"].shape[-1]
    HG = H // G
    state = cache["state"]
    if ax is not None:
        state = state.narrow(1, ax.rank * H, H)
    z = xin @ params["in_z"]
    x, ncx = _conv_step(xin @ params["in_x"], cache["conv_x"],
                        params["conv_x"])
    Bp, ncb = _conv_step(xin @ params["in_B"], cache["conv_B"],
                         params["conv_B"])
    Cp, ncc = _conv_step(xin @ params["in_C"], cache["conv_C"],
                         params["conv_C"])
    dtp = xin @ params["in_dt"]
    x = F.silu(x.float()).reshape(-1, H, cfg.ssm.head_dim)
    Bh = F.silu(Bp.float()).reshape(-1, G, N).repeat_interleave(HG, dim=1)
    Ch = F.silu(Cp.float()).reshape(-1, G, N).repeat_interleave(HG, dim=1)
    dt = F.softplus(dtp.float() + params["dt_bias"])            # (B, H)
    a = torch.exp(dt * -torch.exp(params["A_log"]))             # (B, H)
    S = state * a[:, :, None, None] + torch.einsum(
        "bhn,bhp,bh->bhnp", Bh, x, dt)
    y = torch.einsum("bhn,bhnp->bhp", Ch, S) + params["D"][None, :, None] * x
    out = _gate_out(params, y.reshape(-1, d_inner), z, cfg, ax)
    if ax is not None:
        S = ax.gather_dim(S, 1)
    return out, {"state": S, "conv_x": ncx, "conv_B": ncb, "conv_C": ncc}

