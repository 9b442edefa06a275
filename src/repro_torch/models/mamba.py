"""Mamba-2 mixer via the SSD (state-space duality) chunked algorithm.

Port of the JAX package's ``models/mamba.py`` (arXiv:2405.21060).  A
prompt runs the chunked SSD form: within a chunk a masked-decay
quadratic form, across chunks a small recurrence over (H, P, N) states;
decode is the O(1)-per-token recurrence.

Shapes: d_inner = expand·d_model, H = d_inner/P heads, G groups for B/C,
N state dim.  Cache = {"conv": (B, W-1, d_conv_ch), "ssm": (B, H, P, N)}.

With ``ops.use_pallas()`` on, :func:`_ssd_chunked` computes the
intra-chunk outputs and the per-chunk states of every chunk with one
launch of the SSD kernel (:func:`repro_torch.kernels.ops.ssd_chunk`,
B10), then runs the inter-chunk recurrence as a loop over chunks in
plain PyTorch: the split ``kernels/ssd_pallas.py`` prescribes.  With it
off, or on a differentiated call (the training loss: the kernel has no
backward), every chunk runs the JAX package's plain step.  On fake
tensors (the dry run's) that plain scan takes a shape-only route: its
op-by-op count is taken once per signature on meta tensors and replayed
(``roofline/counting.py::counted_call``).

:func:`mamba_apply_tp` is the mixer over the ``model`` ranks of a
:class:`repro_torch.models.parallel.Group`: the training loss's, and,
with a cache sharded over the ranks, the serving mesh's prompt (B10 per
rank) and one-token step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels._common import differentiated, is_fake
from repro_torch.models import layers as L
from repro_torch.models.parallel import held, work
from repro_torch.roofline.counting import counted_call


def mamba_init(gen, cfg, *, device=None):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.num_heads(d)
    gn = s.num_groups * s.d_state
    conv_ch = di + 2 * gn
    dt = L.dtype_of(cfg.param_dtype)
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = L.dense_init(gen, d, 2 * di + 2 * gn + H,
                           dtype=cfg.param_dtype, device=device)
    conv_w = (torch.randn((s.conv_width, conv_ch), generator=gen, **f32)
              / np.sqrt(s.conv_width)).to(dt)
    # dt bias: softplus^-1 of dt ~ logU[1e-3, 0.1] (the mamba2 init)
    u = torch.rand((H,), generator=gen, **f32)
    dt0 = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": dt_bias,
        "gated_norm": L.rmsnorm_init(di, dtype=cfg.param_dtype,
                                     device=device),
        "out_proj": L.dense_init(gen, di, d, dtype=cfg.param_dtype,
                                 device=device),
    }


def init_mamba_cache(cfg, batch: int, dtype=None, device=None):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.num_heads(d)
    gn = s.num_groups * s.d_state
    dtype = L.dtype_of(dtype or cfg.compute_dtype)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, di + 2 * gn),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def _causal_conv(u, w, b):
    """Depthwise causal conv via shifted adds (the width is tiny)."""
    W = w.shape[0]
    out = u * w[-1].to(u.dtype)
    for i in range(1, W):
        shifted = F.pad(u[:, :-i], (0, 0, i, 0))
        out = out + shifted * w[W - 1 - i].to(u.dtype)
    return out + b.to(u.dtype)


def _split_in_proj(p, x, cfg):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gn = s.num_groups * s.d_state
    zxbcdt = L.dense(p["in_proj"], x)
    return (zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * gn],
            zxbcdt[..., 2 * di + 2 * gn:])


def _intra_chunk_plain(xg, csg, bc, cc, mask):
    """One chunk's (y_diag, state), the JAX package's plain step.

    xg (b,Q,G,R,P), csg (b,Q,G,R), bc/cc (b,Q,G,N) -> ((b,Q,G,R,P),
    (b,G,R,P,N)).
    """
    att = torch.einsum("bqgn,blgn->bgql", cc.float(), bc.float())
    diff = csg[:, :, :, :, None] - torch.movedim(csg, 1, -1)[:, None]
    ldec = torch.where(mask[None], torch.exp(diff), torch.zeros_like(diff))
    m = torch.einsum("bgql,bqgrl->bqgrl", att, ldec)
    y_diag = torch.einsum("bqgrl,blgrp->bqgrp", m, xg)
    decay_last = torch.exp(csg[:, -1:] - csg)
    state = torch.einsum("bqgn,bqgr,bqgrp->bgrpn", bc.float(), decay_last,
                         xg)
    return y_diag, state


def _ssd_chunked(xh, dt, A, Bm, Cm, cfg, h0):
    """Chunked SSD scan.

    xh (b,s,H,P), dt (b,s,H) post-softplus, A (H,) negative, Bm/Cm
    (b,s,G,N).  Returns (y (b,s,H,P) f32, h_final (b,H,P,N) f32).  Fake
    tensors on the plain path (no kernel) replay its op-by-op count
    (``counting.counted_call``).
    """
    if is_fake(xh) and not (ops.use_pallas()
                            and not differentiated(xh, dt, A, Bm, Cm)):
        return counted_call(
            "ssd_chunked",
            lambda xh, dt, A, Bm, Cm, h0: _ssd_scan(xh, dt, A, Bm, Cm,
                                                    cfg, h0),
            (xh, dt, A, Bm, Cm, h0), key=(cfg.ssm.chunk_size,))
    return _ssd_scan(xh, dt, A, Bm, Cm, cfg, h0)


def _ssd_scan(xh, dt, A, Bm, Cm, cfg, h0):
    """:func:`_ssd_chunked`'s scan, op by op (or B10's launch)."""
    s_cfg = cfg.ssm
    b, S, H, P = xh.shape
    G, N = Bm.shape[2:]
    R = H // G
    Q = min(s_cfg.chunk_size, S)
    pad = (-S) % Q
    if pad:
        # dt pads with ZEROS (post-softplus): a padded step neither decays
        # the carried state (exp(dt*A) = 1) nor injects input (dt*B*x = 0),
        # so the final state handed to decode stays right
        def pz(a):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        xh, dt, Bm, Cm = pz(xh), pz(dt), pz(Bm), pz(Cm)
    Sp = S + pad
    c = Sp // Q

    xdt = xh * dt[..., None]                                  # (b,Sp,H,P)
    dA = (dt * A).reshape(b, c, Q, H).float()                 # negative
    cs = torch.cumsum(dA, dim=2)                              # (b,c,Q,H)
    x_g = xdt.reshape(b, c, Q, G, R, P).float()
    cs_g = cs.reshape(b, c, Q, G, R)
    Bc = Bm.reshape(b, c, Q, G, N)
    Cc = Cm.reshape(b, c, Q, G, N)

    # one read of the process-wide toggle serves both branches below; a
    # differentiated call (the training loss) takes the plain path, as
    # the kernel has no backward (the reference's training reaches no
    # Pallas kernel either)
    kernel = ops.use_pallas() and not differentiated(xdt, cs, Bc, Cc)
    if kernel:
        # every chunk's intra-chunk half in one kernel launch
        y_diag_all, states = ops.ssd_chunk(
            xdt.reshape(b, c, Q, H, P).float().contiguous(), cs.contiguous(),
            Bc.contiguous(), Cc.contiguous())
        y_diag_all = y_diag_all.reshape(b, c, Q, G, R, P)
        states = states.reshape(b, c, G, R, P, N)
    else:
        mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                     device=xh.device))[:, None, None, :]

    h = (torch.zeros((b, G, R, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    ys = []
    for ci in range(c):
        csg = cs_g[:, ci]
        cc = Cc[:, ci]
        if kernel:
            y_diag, state = y_diag_all[:, ci], states[:, ci]
        else:
            y_diag, state = _intra_chunk_plain(x_g[:, ci], csg, Bc[:, ci],
                                               cc, mask)
        y_off = torch.einsum("bqgn,bgrpn,bqgr->bqgrp", cc.float(), h,
                             torch.exp(csg))
        chunk_decay = torch.exp(csg[:, -1])                   # (b,G,R)
        h = h * chunk_decay[..., None, None] + state
        ys.append(y_diag + y_off)
    y = torch.stack(ys, 1).reshape(b, Sp, H, P)
    if pad:
        y = y[:, :S]
    return y, h.reshape(b, H, P, N)


def _conv_continue(tail, xbc, w, b):
    """The causal conv of a prompt ``xbc`` (B, S, ch) that continues a
    cached tail (B, W-1, ch) of earlier inputs: the prompt's outputs,
    after SiLU."""
    out = _causal_conv(torch.cat([tail, xbc], dim=1), w, b)
    return F.silu(out)[:, tail.shape[1]:]


def _conv_step(tail, xbc, w, b, cdt):
    """One token's conv (B, ch), after SiLU: the tail (B, W-1, ch) and
    the token's inputs ``xbc`` (B, 1, ch) against ``w`` (W, ch)."""
    window = torch.cat([tail, xbc], dim=1)
    return F.silu(torch.einsum("bwc,wc->bc", window, w.to(cdt)) + b.to(cdt))


def _roll_tail(tail, xbc, width: int):
    """The conv tail after inputs ``xbc`` (B, S, ch): the last W-1 of the
    tail's and their inputs."""
    keep, S = width - 1, xbc.shape[1]
    return xbc[:, -keep:] if S >= keep else torch.cat([tail[:, S:], xbc],
                                                      dim=1)


def _recurrent_step(h, xh, dt, A, Bh, Ch):
    """One token of the SSM recurrence over heads: state h (B, H, P, N)
    f32, xh (B, H, P), dt (B, H) post-softplus, A (H,), Bh/Ch (B, H, N)
    -> (y (B, H, P) f32, the new state)."""
    decay = torch.exp(dt * A)                                  # (B,H)
    upd = (dt[..., None] * xh).float()                         # (B,H,P)
    h = h * decay[..., None, None] + upd[..., None] * Bh[:, :, None,
                                                         :].float()
    return torch.einsum("bhpn,bhn->bhp", h, Ch.float()), h


def mamba_apply(p, x, cfg, *, cache=None):
    """Mamba2 mixer.  x: (B,S,d) -> (out, new_cache)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.num_heads(cfg.d_model)
    P = s.head_dim
    G, N = s.num_groups, s.d_state
    cdt = L.dtype_of(cfg.compute_dtype)
    x = x.to(cdt)
    B_, S, _ = x.shape

    z, xbc_pre, dt_raw = _split_in_proj(p, x, cfg)
    A = -torch.exp(p["A_log"])                                 # (H,)

    if cache is None or S > 1:
        if cache is not None:
            # continuation: the causal conv needs the previous W-1 inputs
            xbc = _conv_continue(cache["conv"].to(xbc_pre.dtype), xbc_pre,
                                 p["conv_w"], p["conv_b"])
        else:
            xbc = F.silu(_causal_conv(xbc_pre, p["conv_w"], p["conv_b"]))
        xh = xbc[..., :di].reshape(B_, S, H, P)
        Bm = xbc[..., di: di + G * N].reshape(B_, S, G, N)
        Cm = xbc[..., di + G * N:].reshape(B_, S, G, N)
        dt = F.softplus(dt_raw.float() + p["dt_bias"])         # (B,S,H)
        h0 = None
        if cache is not None:
            h0 = cache["ssm"].reshape(B_, G, H // G, P, N)
        y, h_fin = _ssd_chunked(xh, dt, A, Bm, Cm, cfg, h0)
        new_cache = None
        if cache is not None:
            conv_tail = _roll_tail(cache["conv"], xbc_pre, s.conv_width)
            new_cache = {"conv": conv_tail.to(cache["conv"].dtype),
                         "ssm": h_fin}
        xh_full = xh
    else:
        # -- single-token recurrent decode --------------------------------
        tail = cache["conv"].to(cdt)
        xbc = _conv_step(tail, xbc_pre, p["conv_w"], p["conv_b"], cdt)
        xh = xbc[:, :di].reshape(B_, H, P)
        Bm = xbc[:, di: di + G * N].reshape(B_, G, N)
        Cm = xbc[:, di + G * N:].reshape(B_, G, N)
        dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])  # (B,H)
        Bh = torch.repeat_interleave(Bm, H // G, dim=1)        # (B,H,N)
        Ch = torch.repeat_interleave(Cm, H // G, dim=1)
        y, h = _recurrent_step(cache["ssm"], xh, dt, A, Bh, Ch)
        y = y.reshape(B_, 1, H, P)
        new_cache = {"conv": _roll_tail(tail, xbc_pre, s.conv_width).to(
            cache["conv"].dtype), "ssm": h}
        xh_full = xh.reshape(B_, 1, H, P)

    y = y + p["D"][None, None, :, None] * xh_full.to(y.dtype)
    y = y.reshape(B_, S, di).to(cdt)
    y = L.rmsnorm(p["gated_norm"], y * F.silu(z), cfg.norm_eps)
    return L.dense(p["out_proj"], y), new_cache


def mamba_apply_tp(group, ps, xs, cfg, *, caches=None):
    """The Mamba-2 mixer over a group's ranks: ``in_proj``
    column-parallel, ``out_proj`` row-parallel over d_inner.

    Rank j computes the heads that its rows of ``out_proj`` read.  The
    cut of ``in_proj`` crosses the z | xBC | dt boundaries, so its
    output is gathered over the group; the small leaves (``conv_w``,
    ``conv_b``, ``A_log``, ``D``, ``dt_bias``) are gathered too, and
    their gradients go back to their shards.  ``gated_norm``'s RMS runs
    over all of d_inner: the ranks' sums of squares are summed over the
    group.  Per-rank copies of the input (B, S, d) and of the output.

    ``caches``: rank j's shard of the layer's cache, laid out by
    ``models/sharding.py::cache_pspecs`` (``ssm`` (B, H_j, P, N) cut by
    heads, ``conv`` (B, W-1, ch_j) cut contiguously over the channels
    x | B | C, or whole), as :func:`mamba_apply`'s cache path: a prompt
    (S > 1) runs the chunked SSD (the kernel, per rank, where
    :func:`_ssd_chunked` takes it) from the cached state, a token the
    recurrence.  Each rank reads the conv tail whole (B x (W-1) x ch is
    small) and its heads' states, and writes back the slices its shards
    hold, in place.
    """
    s = cfg.ssm
    di, H, P = s.d_inner(cfg.d_model), s.num_heads(cfg.d_model), s.head_dim
    gn = s.num_groups * s.d_state
    width, conv_ch, R = 2 * di + 2 * gn + H, di + 2 * gn, H // s.num_groups
    M = group.size
    cdt = L.dtype_of(cfg.compute_dtype)
    xs = [x.to(cdt) for x in xs]
    spans = [work(j, M, p["out_proj"]["w"].shape[0], di)
             for j, p in enumerate(ps)]
    zxbcdt = L.dense_col(group, [p["in_proj"] for p in ps], xs, width,
                         [sp and (0, width) for sp in spans])

    def whole(key, n, dim=0):
        return group.redistribute(
            [p[key] for p in ps],
            [held(j, M, p[key].shape[dim], n) for j, p in enumerate(ps)],
            [sp and (0, n) for sp in spans], dim)

    conv_w, conv_b = whole("conv_w", conv_ch, 1), whole("conv_b", conv_ch)
    A_log, D, dt_bias = whole("A_log", H), whole("D", H), whole("dt_bias", H)
    hspans = [sp and (sp[0] // P, -(-sp[1] // P)) for sp in spans]
    if caches is not None:
        conv_have = [held(j, M, c["conv"].shape[2], conv_ch)
                     for j, c in enumerate(caches)]
        ssm_have = [held(j, M, c["ssm"].shape[1], H)
                    for j, c in enumerate(caches)]
        tails = group.redistribute([c["conv"] for c in caches], conv_have,
                                   [sp and (0, conv_ch) for sp in spans])
        states = group.redistribute([c["ssm"] for c in caches], ssm_have,
                                    hspans, dim=1)
    ys, sums, new_tails, new_states = [], [], [], []
    for j, sp in enumerate(spans):
        if sp is None:
            for out in (ys, sums, new_tails, new_states):
                out.append(None)
            continue
        zx = zxbcdt[j]
        B_, S = zx.shape[:2]
        h0, h1 = hspans[j]
        nh, c0, c1 = h1 - h0, h0 * P, h1 * P
        w = torch.cat([conv_w[j][:, c0:c1], conv_w[j][:, di:]], dim=1)
        b = torch.cat([conv_b[j][c0:c1], conv_b[j][di:]])
        pre = zx[..., di: 2 * di + 2 * gn]
        xbc = torch.cat([pre[..., c0:c1], pre[..., di:]], dim=-1)
        g0, g1 = h0 // R, (h1 - 1) // R + 1
        if g1 - g0 == 1 or (h0 % R == 0 and h1 % R == 0):
            gidx = None
            ng = g1 - g0
        else:
            # the local heads cut a group: one group per head
            gidx = torch.arange(h0, h1, device=zx.device) // R
            ng = nh
        dt = F.softplus(zx[..., 2 * di + 2 * gn + h0: 2 * di + 2 * gn + h1]
                        .float() + dt_bias[j][h0:h1])
        A = -torch.exp(A_log[j][h0:h1])
        h_in = None
        if caches is not None:
            tail = tails[j].to(cdt)
            tail_loc = torch.cat([tail[..., c0:c1], tail[..., di:]], dim=-1)
            h_in = states[j]
        if caches is not None and S == 1:
            # -- the single-token recurrence --------------------------------
            u = _conv_step(tail_loc, xbc, w, b, cdt)          # (B,ch_j)
            xh = u[:, :nh * P].reshape(B_, nh, P)
            Bm = u[:, nh * P: nh * P + gn].reshape(B_, s.num_groups,
                                                   s.d_state)
            Cm = u[:, nh * P + gn:].reshape(B_, s.num_groups, s.d_state)
            Bh = Bm[:, torch.arange(h0, h1, device=zx.device) // R]
            Ch = Cm[:, torch.arange(h0, h1, device=zx.device) // R]
            y, h = _recurrent_step(h_in, xh, dt[:, 0], A, Bh, Ch)
            y = y.reshape(B_, 1, nh, P)
            xh = xh.reshape(B_, 1, nh, P)
            new_tails.append(_roll_tail(tail, pre, s.conv_width))
            new_states.append(h)
        else:
            if caches is not None:
                u = _conv_continue(tail_loc, xbc, w, b)
            else:
                u = F.silu(_causal_conv(xbc, w, b))
            xh = u[..., :nh * P].reshape(B_, S, nh, P)
            Bm = u[..., nh * P: nh * P + gn].reshape(B_, S, s.num_groups,
                                                     s.d_state)
            Cm = u[..., nh * P + gn:].reshape(B_, S, s.num_groups,
                                              s.d_state)
            if gidx is None:
                Bm, Cm = Bm[:, :, g0:g1], Cm[:, :, g0:g1]
            else:
                Bm, Cm = Bm[:, :, gidx], Cm[:, :, gidx]
            h0_ = None if h_in is None else h_in.reshape(
                B_, ng, nh // ng, P, s.d_state)
            y, h_fin = _ssd_chunked(xh, dt, A, Bm, Cm, cfg, h0_)
            if caches is not None:
                new_tails.append(_roll_tail(tail, pre, s.conv_width))
                new_states.append(h_fin)
        y = y + D[j][h0:h1][None, None, :, None] * xh.to(y.dtype)
        y = y.reshape(B_, S, nh * P).to(cdt) * F.silu(zx[..., c0:c1])
        y = y.narrow(-1, sp[0] - c0, sp[1] - sp[0]).float()
        ys.append(y)
        sums.append((y * y).sum(-1, keepdim=True))
    if caches is not None:
        # each rank's shard takes its slice of the new tail and states
        conv_new = group.redistribute(
            new_tails, [sp and (0, conv_ch) for sp in spans], conv_have)
        ssm_new = group.redistribute(new_states, hspans, ssm_have, dim=1)
        for c, t, h in zip(caches, conv_new, ssm_new):
            c["conv"].copy_(t)
            c["ssm"].copy_(h)
    var = group.all_reduce(sums)
    hs = [None if y is None else
          (y * torch.rsqrt(v / di + cfg.norm_eps)
           * p["gated_norm"]["scale"][sp[0]:sp[1]].float()).to(cdt)
          for y, v, p, sp in zip(ys, var, ps, spans)]
    return L.dense_row(group, [p["out_proj"] for p in ps], hs)
