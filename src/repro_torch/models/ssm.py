"""Mamba-2 (SSD, state-space duality) layer, port of the reference's
``models/ssm.py``: its single-device form and its head-sharded tensor
parallelism on a mesh.

The SSD *chunked* form turns the selective-scan recurrence into dense
products within chunks of ``chunk_size`` tokens plus a short recurrence
over chunk states.  Heads are processed ``head_block`` at a time so the
``[B, nc, hb, Q, Q]`` intra-chunk decay buffer stays bounded whatever the
head count.  Every product the reference accumulates in f32
(``preferred_element_type``) is taken here on f32 copies of its operands
(a bf16 value converts to f32 exactly), and every rounding to the
activation type happens where the reference's does.

Entry points:
  * ``ssd_chunked``      full-sequence forward, returns the final state
  * ``ssd_decode_step``  single-token recurrent update (serving)
  * ``ssd_reference``    token-by-token recurrent oracle, for tests
  * ``apply_ssm`` / ``apply_ssm_decode``  the full layer

On a mesh whose model axis divides the heads (:func:`heads_divide`) the full
layer runs head-sharded, as the reference's ``shard_map`` branch: each rank
takes its heads' slices of the head-indexed leaves (``HEAD_LEAVES``) and
the whole of ``w_bc`` / ``conv_bc`` / ``conv_bc_b`` (shared by the heads),
runs the recurrence on its heads alone, sums the gated norm's squares and
the output projection's partial sums (in f32) over the model axis.  Where
weights are resident (``serve_*``, :func:`resident_heads`) a rank holds only
its head slices, and its SSM state and ``conv_x`` tail too, and the decode
step runs head-sharded the same way.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.models.layers import rms_norm, truncated_normal_init

# the leaves indexed by head, and the dim of each that the heads index
# (their channels d_in = H·P, or H itself), counted from the end so that
# stacked [R, ...] and per-layer leaves alike take it
HEAD_LEAVES = {"w_z": -1, "w_x": -1, "w_dt": -1, "conv_x": -1, "conv_x_b": -1, "A_log": -1,
               "D": -1, "dt_bias": -1, "norm_w": -1, "out_proj": -2}

# ---------------------------------------------------------------------------
# Core SSD math
# ---------------------------------------------------------------------------


def ssd_chunked(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] (post-softplus)
    A: torch.Tensor,  # [H] (negative)
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    *,
    chunk_size: int,
    head_block: int,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, S, H, P] in x's type, final_state [B, H, P, N] f32).
    A sequence longer than ``chunk_size`` must be a whole number of chunks
    (the reference asserts the same)."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk_size, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD chunk {Q}")
    nc = S // Q
    hb = min(head_block, H)
    if H % hb:
        raise ValueError(f"{H} heads do not split into blocks of {hb}")
    heads_per_group = H // G
    f32 = torch.float32

    a = (dt * A).to(f32)  # [B, S, H] log-decay
    # u is rounded to the activation type (dt rounded first), as in the reference
    u = dt.to(x.dtype)[..., None] * x  # [B, S, H, P]

    a_c = a.reshape(B_, nc, Q, H)
    u_c = u.reshape(B_, nc, Q, H, P)
    B_c = Bm.reshape(B_, nc, Q, G, N)
    C_c = Cm.reshape(B_, nc, Q, G, N)

    ca = torch.cumsum(a_c, dim=2)  # [B, nc, Q, H]
    # intra-chunk scores (shared by the heads of a group): C_i . B_j
    scores = torch.einsum("bcqgn,bckgn->bcgqk", C_c.to(f32), B_c.to(f32))  # [B, nc, G, Q, Q]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()

    # per-chunk summary state: S_c = sum_j exp(ca_last - ca_j) B_j u_j^T
    decay_last = torch.exp(ca[:, :, -1:, :] - ca)  # [B, nc, Q, H]
    if G == 1:
        chunk_state = torch.einsum("bcqh,bcqn,bcqhp->bchpn", decay_last,
                                   B_c[:, :, :, 0].to(f32), u_c.to(f32))  # [B, nc, H, P, N]
    else:
        B_heads = B_c.to(f32).repeat_interleave(heads_per_group, dim=3)  # [B, nc, Q, H, N]
        chunk_state = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_last, B_heads,
                                   u_c.to(f32))

    # recurrence over chunk states (the reference's associative scan), in f32
    t_c = torch.exp(ca[:, :, -1, :])  # [B, nc, H] total decay of each chunk
    h = (torch.zeros((B_, H, P, N), dtype=f32, device=x.device) if initial_state is None
         else initial_state.to(f32))
    h_before = []
    for c in range(nc):
        h_before.append(h)
        h = t_c[:, c, :, None, None] * h + chunk_state[:, c]
    final_state = h
    h_before = torch.stack(h_before, dim=1)  # [B, nc, H, P, N] state entering each chunk

    # per-head-block output assembly
    ys = []
    for h0 in range(0, H, hb):
        ca_h = ca[:, :, :, h0:h0 + hb]  # [B, nc, Q, hb]
        u_h = u_c[:, :, :, h0:h0 + hb]  # [B, nc, Q, hb, P]
        h0_h = h_before[:, :, h0:h0 + hb]  # [B, nc, hb, P, N]
        g_idx = torch.arange(h0, h0 + hb, device=x.device) // heads_per_group
        scores_h = scores[:, :, g_idx]  # [B, nc, hb, Q, Q]
        C_h = C_c[:, :, :, g_idx]  # [B, nc, Q, hb, N]
        # decay L[i, j] = exp(ca_i - ca_j), lower-triangular
        ca_t = ca_h.transpose(2, 3)  # [B, nc, hb, Q]
        logL = (ca_t[..., :, None] - ca_t[..., None, :]).masked_fill(~tri, float("-inf"))
        M = scores_h * torch.exp(logL)
        # the decay-masked scores are rounded to u's type before the product
        y_intra = torch.einsum("bchqk,bckhp->bcqhp", M.to(u_h.dtype).to(f32), u_h.to(f32))
        y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", C_h.to(f32), h0_h,
                               torch.exp(ca_h))
        ys.append((y_intra + y_inter).to(x.dtype))  # [B, nc, Q, hb, P]
    y = torch.cat(ys, dim=3)  # [B, nc, Q, H, P]
    return y.reshape(B_, S, H, P), final_state


def ssd_decode_step(
    x: torch.Tensor,  # [B, H, P]
    dt: torch.Tensor,  # [B, H]
    A: torch.Tensor,  # [H]
    Bm: torch.Tensor,  # [B, G, N]
    Cm: torch.Tensor,  # [B, G, N]
    state: torch.Tensor,  # [B, H, P, N] f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's recurrent update: (y [B, H, P] in x's type, new state)."""
    H = x.shape[1]
    heads_per_group = H // Bm.shape[1]
    f32 = torch.float32
    decay = torch.exp((dt * A).to(f32))  # [B, H]
    u = dt[..., None] * x.to(f32)  # [B, H, P], f32 (the chunked form rounds it)
    Bh = Bm.to(f32).repeat_interleave(heads_per_group, dim=1)  # [B, H, N]
    Ch = Cm.to(f32).repeat_interleave(heads_per_group, dim=1)
    new_state = decay[..., None, None] * state + u[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state


def ssd_reference(x, dt, A, Bm, Cm, initial_state=None):
    """Token-by-token recurrent oracle: :func:`ssd_decode_step` over S."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.to(torch.float32))
    ys = []
    for t in range(S):
        y, h = ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (pre-SSM mixing of x, B, C)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, S, C], w [W, C]: depthwise causal convolution (the reference's
    ``conv_general_dilated`` cross-correlation over W - 1 zeros of left
    padding).  The taps are summed in f32 from the weights in x's type, the
    sum rounded to x's type, then the bias added in it."""
    W, S = w.shape[0], x.shape[1]
    wx = w.to(x.dtype).to(torch.float32)
    xp = F.pad(x.to(torch.float32), (0, 0, W - 1, 0))  # [B, W - 1 + S, C]
    out = xp[:, 0:S] * wx[0]
    for k in range(1, W):
        out = out + xp[:, k:k + S] * wx[k]
    return out.to(x.dtype) + b.to(x.dtype)


def conv1d_decode_step(
    x_t: torch.Tensor,  # [B, C]
    conv_state: torch.Tensor,  # [B, W-1, C] (previous inputs)
    w: torch.Tensor,  # [W, C]
    b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token through the conv: the window in f32 against the f32
    weights (not rounded to x's type, unlike :func:`causal_conv1d`)."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)  # [B, W, C]
    out = (window.to(torch.float32) * w.to(torch.float32)).sum(dim=1)
    out = (out + b.to(torch.float32)).to(x_t.dtype)
    return out, window[:, 1:]


# ---------------------------------------------------------------------------
# Full Mamba-2 layer
# ---------------------------------------------------------------------------


def ssm_dims(cfg) -> Tuple[int, int, int]:
    """(d_inner, heads, conv channels)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return d_in, H, conv_ch


def init_ssm(generator: torch.Generator, cfg, dtype: torch.dtype,
             lead: Tuple[int, ...] = ()) -> Dict:
    """The reference's layout: projections stored split (``w_z``/``w_x``
    head-major, ``w_bc`` shared, ``w_dt`` per head), stacked over ``lead``."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, _ = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    dev = generator.device

    def normal(shape):
        return truncated_normal_init(generator, shape, dtype, 1.0, lead)

    def full(vec: torch.Tensor) -> torch.Tensor:
        return vec.to(device=dev, dtype=dtype).expand(lead + vec.shape).clone()

    return {
        "w_z": normal((d, d_in)),
        "w_x": normal((d, d_in)),
        "w_bc": normal((d, 2 * gn)),
        "w_dt": normal((d, H)),
        "conv_x": normal((s.d_conv, d_in)),
        "conv_x_b": full(torch.zeros(d_in)),
        "conv_bc": normal((s.d_conv, 2 * gn)),
        "conv_bc_b": full(torch.zeros(2 * gn)),
        "A_log": full(torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32))),
        "D": full(torch.ones(H)),
        "dt_bias": full(torch.log(torch.expm1(torch.full((H,), 0.01, dtype=torch.float32)))),
        "norm_w": full(torch.zeros(d_in)),
        "out_proj": normal((d_in, d)),
    }


def _conv_with_tail(x_in, w, b, initial, W):
    if initial is not None:
        full = torch.cat([initial.to(x_in.dtype), x_in], dim=1)
        return causal_conv1d(full, w, b)[:, W - 1:]
    return causal_conv1d(x_in, w, b)


def _softplus_dt(dt: torch.Tensor, params: Dict) -> torch.Tensor:
    return F.softplus(dt.to(torch.float32) + params["dt_bias"].to(torch.float32))


def _ssm_core(params: Dict, x: torch.Tensor, cfg, *, initial_state, initial_conv,
              heads_topo=None):
    """The full-sequence body.  Returns (out [B, S, d], (final_state,
    (conv_x tail, conv_bc tail))): the tails are the last ``d_conv - 1``
    pre-conv inputs (fewer when S is shorter).  The head-indexed params may
    be this rank's slices of ``heads_topo``'s model axis, over which the
    gated norm's sum of squares (over the whole d_in) and the output
    projection's partial sums are then summed (the reference's
    ``norm_psum_axis``)."""
    s = cfg.ssm
    B_, S, _ = x.shape
    P_ = s.head_dim
    H = params["w_dt"].shape[1]
    d_in = H * P_

    z = x @ params["w_z"].to(x.dtype)
    xs = x @ params["w_x"].to(x.dtype)
    bc = x @ params["w_bc"].to(x.dtype)
    dt = x @ params["w_dt"].to(x.dtype)

    ic_x, ic_bc = initial_conv if initial_conv is not None else (None, None)
    xs_tail, bc_tail = xs[:, -(s.d_conv - 1):], bc[:, -(s.d_conv - 1):]
    xs = F.silu(_conv_with_tail(xs, params["conv_x"], params["conv_x_b"], ic_x, s.d_conv))
    bc = F.silu(_conv_with_tail(bc, params["conv_bc"], params["conv_bc_b"], ic_bc, s.d_conv))
    gn = s.n_groups * s.d_state
    xh = xs.reshape(B_, S, H, P_)
    Bm = bc[..., :gn].reshape(B_, S, s.n_groups, s.d_state)
    Cm = bc[..., gn:].reshape(B_, S, s.n_groups, s.d_state)
    A = -torch.exp(params["A_log"].to(torch.float32))
    y, final_state = ssd_chunked(
        xh, _softplus_dt(dt, params), A, Bm, Cm,
        chunk_size=s.chunk_size, head_block=min(s.head_block, H),
        initial_state=initial_state,
    )
    y = y.to(torch.float32) + params["D"].to(torch.float32)[None, None, :, None] * xh.to(
        torch.float32)
    y = y.reshape(B_, S, d_in).to(x.dtype)
    g = y * F.silu(z)
    # gated RMSNorm over d_in: a sum of squares over its width
    gf = g.to(torch.float32)
    ss = gf.square().sum(dim=-1, keepdim=True)
    n_tot = d_in
    if heads_topo is not None:
        # every rank's heads read the one sum: its gradient sums back too
        group = heads_topo.model_group
        ss = coll.fanout([coll.psum(ss, group)], group)[0]
        n_tot = d_in * heads_topo.ep_size
    gn_ = gf * torch.rsqrt(ss / n_tot + cfg.norm_eps)
    gn_ = gn_ * (1.0 + params["norm_w"].to(torch.float32))
    out = gn_.to(x.dtype) @ params["out_proj"].to(x.dtype)
    if heads_topo is not None:
        out = coll.psum(out.to(torch.float32), heads_topo.model_group).to(x.dtype)
    return out, (final_state, (xs_tail, bc_tail))


def heads_divide(H: int, topo) -> bool:
    """``topo`` has a model axis of more than one rank that divides ``H``
    heads."""
    if topo is None or topo.mesh_shape is None or topo.model_axis is None:
        return False
    return topo.ep_size > 1 and H % topo.ep_size == 0


def resident_heads(cfg, topo) -> bool:
    """A rank holds only its head slices of the SSM leaves (and its state
    and ``conv_x`` tail): weights resident (no FSDP) on a mesh where the
    layer runs head-sharded."""
    return heads_divide(ssm_dims(cfg)[1], topo) and not topo.fsdp


def resident_slices(layer: Dict, topo) -> Dict:
    """An SSM layer's params (whole, stacked or not) as a rank holds them
    on ``topo``: its head slices of the head-indexed leaves where weights
    are resident and the model axis divides the heads (the heads counted
    from ``A_log``), else as they are.  Views, no collective."""
    H = layer["A_log"].shape[-1]
    if not (heads_divide(H, topo) and not topo.fsdp) or layer["w_dt"].shape[-1] != H:
        return layer
    out = dict(layer)
    for k, dim in HEAD_LEAVES.items():
        v = layer[k]
        c = v.shape[dim] // topo.ep_size  # this rank's channels (or heads)
        out[k] = v.narrow(dim % v.dim(), topo.model_index * c, c)
    return out


def _heads(params: Dict, topo, fn) -> Dict:
    """``fn(leaf, group, dim=...)`` (a split or a gather over the model
    axis) on each head-indexed leaf along its heads' dim."""
    return {k: fn(v, topo.model_group, dim=HEAD_LEAVES[k]) if k in HEAD_LEAVES else v
            for k, v in params.items()}


def _local(params: Dict, cfg) -> bool:
    return params["w_dt"].shape[-1] != ssm_dims(cfg)[1]


def apply_ssm(params: Dict, x: torch.Tensor, cfg, *,
              initial_state: Optional[torch.Tensor] = None, initial_conv=None,
              return_state: bool = False, topo=None, train: bool = False):
    """Full-sequence Mamba-2 layer x [B, S, d] -> [B, S, d]; with
    ``return_state`` also (final_state [B, H, P, N] f32, (conv_x tail,
    conv_bc tail)).

    On a mesh ``topo`` it runs head-sharded under the reference's condition
    (:func:`heads_divide`, a batch the data axes divide: always in training
    (``train``), where ``x`` is this rank's batch shard; serving hands the
    whole batch; no initial state or conv).  ``params`` may be whole (this
    rank's heads are cut from them) or this rank's head slices (the train
    step's compute layout, resident serving weights); the state comes back
    in the params' layout.  Each rank consumes ``x`` and the shared leaves
    on its own heads, so they pass ``collectives.fanout``."""
    H = ssm_dims(cfg)[1]
    local = _local(params, cfg)
    use_tp = (heads_divide(H, topo) and (train or x.shape[0] % topo.dp_size == 0)
              and initial_state is None and initial_conv is None)
    if not use_tp:
        whole = _heads(params, topo, coll.all_gather) if local else params
        out, (fs, (cx, cbc)) = _ssm_core(whole, x, cfg, initial_state=initial_state,
                                         initial_conv=initial_conv)
        if local and return_state:  # the state in the params' layout
            fs, cx = (coll.split(t, topo.model_group, dim=dim) for t, dim in ((fs, 1), (cx, -1)))
        return (out, (fs, (cx, cbc))) if return_state else out
    group = topo.model_group
    p = params if local else _heads(params, topo, coll.split)  # gradients come back whole
    shared = ("w_bc", "conv_bc", "conv_bc_b")
    x, *rep = coll.fanout([x] + [p[k] for k in shared], group)
    p = {**p, **dict(zip(shared, rep))}
    out, (fs, (cx, cbc)) = _ssm_core(p, x, cfg, initial_state=None, initial_conv=None,
                                     heads_topo=topo)
    if not return_state:
        return out
    if not local:
        fs, cx = (coll.all_gather(t, group, dim=dim) for t, dim in ((fs, 1), (cx, -1)))
    return out, (fs, (cx, cbc))


def apply_ssm_decode(
    params: Dict,
    x: torch.Tensor,  # [B, 1, d]
    cfg,
    ssm_state: torch.Tensor,  # [B, H, P, N] f32
    conv_state,  # (conv_x [B, W-1, d_in], conv_bc [B, W-1, 2gn])
    topo=None,
):
    """One token through the layer: (out [B, 1, d], (new ssm state,
    (new conv_x, new conv_bc))).  With this rank's head slices of the
    params (:func:`resident_heads`) the state and ``conv_x`` are its heads'
    too, and the gated norm's sum of squares and the output's partial sums
    are summed over the model axis of ``topo``."""
    s = cfg.ssm
    local = _local(params, cfg)
    H = params["w_dt"].shape[-1]
    d_in = H * s.head_dim
    gn = s.n_groups * s.d_state
    B_ = x.shape[0]
    x0 = x[:, 0]
    z = x0 @ params["w_z"].to(x.dtype)
    xs_t = x0 @ params["w_x"].to(x.dtype)
    bc_t = x0 @ params["w_bc"].to(x.dtype)
    dt = x0 @ params["w_dt"].to(x.dtype)
    cx, cbc = conv_state
    xs, new_cx = conv1d_decode_step(xs_t, cx, params["conv_x"], params["conv_x_b"])
    bc, new_cbc = conv1d_decode_step(bc_t, cbc, params["conv_bc"], params["conv_bc_b"])
    xs, bc = F.silu(xs), F.silu(bc)
    xh = xs.reshape(B_, H, s.head_dim)
    Bm = bc[..., :gn].reshape(B_, s.n_groups, s.d_state)
    Cm = bc[..., gn:].reshape(B_, s.n_groups, s.d_state)
    A = -torch.exp(params["A_log"].to(torch.float32))
    y, new_state = ssd_decode_step(xh, _softplus_dt(dt, params), A, Bm, Cm, ssm_state)
    y = y.to(torch.float32) + params["D"].to(torch.float32)[None, :, None] * xh.to(
        torch.float32)
    y = y.reshape(B_, d_in).to(x.dtype)
    if not local:
        y = rms_norm(y * F.silu(z), params["norm_w"], cfg.norm_eps)
        out = (y @ params["out_proj"].to(x.dtype))[:, None]
        return out, (new_state, (new_cx, new_cbc))
    group = topo.model_group
    gf = (y * F.silu(z)).float()
    ss = coll.psum(gf.square().sum(dim=-1, keepdim=True), group)
    gf = gf * torch.rsqrt(ss / (d_in * topo.ep_size) + cfg.norm_eps)
    y = (gf * (1.0 + params["norm_w"].float())).to(x.dtype)
    out = coll.psum((y @ params["out_proj"].to(x.dtype)).float(), group).to(x.dtype)
    return out[:, None], (new_state, (new_cx, new_cbc))
