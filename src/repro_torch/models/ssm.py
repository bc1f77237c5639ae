"""Mamba2 block — SSD (state-space duality, arXiv:2405.21060) in torch
(the reference's ``models/ssm.py``).

Prefill uses the chunked SSD algorithm: quadratic attention-like
computation inside chunks + an O(S/Q) state pass between chunks. Decode
uses the exact recurrent step (O(1) state). The two paths are
numerically equivalent (tests/test_torch_ssm.py).

The reference computes both in jnp outside any Pallas kernel, so they
are plain torch here. Where the reference scans over chunks, the port
computes every chunk's intra-chunk part in one batched product and runs
only the state pass (one multiply-add per chunk) as a loop.

Single B/C group, head-level dt, scalar-per-head A — the standard Mamba2
parameterization.

On a training mesh (``par``: ``train/parallel.py`` ``MeshShard``) where
d_inner and the heads split over "model", :func:`ssm_chunked` runs one
rank's heads: its widths are the shards' (``wx``'s columns, ``wdt``'s
heads), B and C are computed whole on every rank (their leaves are
:data:`MODEL_SUMMED`), and the gated norm's statistic over the whole
d_inner is the sum of the ranks' sums of squares (``par.norm_sum``).
Decode and prefill stay unsharded, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dot, rmsnorm
from repro_torch.models.params import spec
from repro_torch.utils import resolve_device

NEG_INF = -1.0e30

#: leaves replicated over "model" that every rank uses whole but only for
#: its own heads where d_inner splits: their gradients sum over "model"
MODEL_SUMMED = ("wB", "wC", "conv_B", "conv_C")


def ssm_spec(cfg):
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv
    return {
        "wz": spec((d, di), ("embed", "ssm_inner")),
        "wx": spec((d, di), ("embed", "ssm_inner")),
        "wB": spec((d, ds), ("embed", None)),
        "wC": spec((d, ds), ("embed", None)),
        "wdt": spec((d, nh), ("embed", "ssm_heads")),
        "conv_x": spec((w, di), (None, "ssm_inner"), scale=w ** -0.5),
        "conv_B": spec((w, ds), (None, None), scale=w ** -0.5),
        "conv_C": spec((w, ds), (None, None), scale=w ** -0.5),
        "A_log": spec((nh,), ("ssm_heads",), init="zeros"),
        "dt_bias": spec((nh,), ("ssm_heads",), init="zeros"),
        "D": spec((nh,), ("ssm_heads",), init="ones"),
        "norm": spec((di,), ("ssm_inner",), init="ones"),
        "wo": spec((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. u (B,S,C), w (W,C)."""
    W, S = w.shape[0], u.shape[1]
    out = u * w[W - 1]
    for k in range(1, W):
        shifted = F.pad(u, (0, 0, k, 0))[:, :S]
        out = out + shifted * w[W - 1 - k]
    return out


def _conv_step(conv_state: torch.Tensor, u_t: torch.Tensor,
               w: torch.Tensor):
    """conv_state (B, W-1, C) holds previous inputs; u_t (B, 1, C). The
    window takes the state's dtype (f32 state, bf16 weights: f32, as
    the reference's promotion)."""
    full = torch.cat([conv_state, u_t], dim=1)               # (B, W, C)
    y = torch.einsum("bwc,wc->bc", full,
                     w.to(full.dtype))[:, None]               # (B, 1, C)
    return y, full[:, 1:]


def _inputs(p, x):
    """Shared projections for both paths. x (B,S,d)."""
    z = dot(x, p["wz"])
    px = dot(x, p["wx"])
    pB = dot(x, p["wB"])
    pC = dot(x, p["wC"])
    dt = F.softplus(dot(x, p["wdt"]).float() + p["dt_bias"].float())
    return z, px, pB, pC, dt


def _out(p, y, z, x, cfg, par=None):
    """Gate, norm and output projection: y (B,S,di) f32 -> (B,S,d). At a
    cut of d_inner (``par.inner_split``) y is the rank's slice and the
    output its partial sum (the caller's ``par.ssm_out`` adds them)."""
    y = y * F.silu(z.float())
    cut = par is not None and par.inner_split
    y = rmsnorm({"scale": p["norm"]}, y, cfg.norm_eps,
                sum_sq=par.norm_sum if cut else None, width=cfg.d_inner)
    return y.to(x.dtype) @ p["wo"]     # the block's last product: unmarked


def ssm_chunked(p, x, cfg, *, chunk: int = 128, initial_state=None,
                return_state: bool = False, par=None):
    """Full-sequence SSD. x (B,S,d) -> (B,S,d); with ``return_state``
    also (ssm state (B,nh,hd,ds), conv state (B,W-1,C)) for decode.
    S % chunk need not hold. ``par``: a training mesh's share (module
    doc); the widths are the shards' either way."""
    B, S, d = x.shape
    di, nh = p["wx"].shape[1], p["wdt"].shape[1]
    ds, hd = cfg.ssm_state, cfg.ssm_headdim
    z, px, pB, pC, dt = _inputs(p, x)
    xc = F.silu(_causal_conv(px, p["conv_x"]))
    Bc = F.silu(_causal_conv(pB, p["conv_B"]))
    Cc = F.silu(_causal_conv(pC, p["conv_C"]))

    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:      # padded steps have dt = 0: no decay, no input
        xc, Bc, Cc, dt = (F.pad(a, (0, 0, 0, pad)) for a in (xc, Bc, Cc, dt))
    Sp = S + pad
    nc = Sp // Q

    A = -torch.exp(p["A_log"].float())                        # (nh,)
    loga = dt * A                                             # (B,Sp,nh) <= 0
    xh = xc.float().reshape(B, Sp, nh, hd)
    # every chunk at once: (B, nc, Q, ...)
    x_c = xh.reshape(B, nc, Q, nh, hd)
    B_c = Bc.float().reshape(B, nc, Q, ds)
    C_c = Cc.float().reshape(B, nc, Q, ds)
    dt_c = dt.reshape(B, nc, Q, nh)
    La = torch.cumsum(loga.reshape(B, nc, Q, nh), dim=2)     # non-increasing

    # intra-chunk (attention-like, masked lower-triangular): step j's
    # contribution to output i (j <= i) decays by exp(La_i - La_j)
    iq = torch.arange(Q, device=x.device)
    lower = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    seg = La[:, :, :, None, :] - La[:, :, None, :, :]        # (B,nc,Qi,Qj,nh)
    decay = torch.exp(torch.where(lower, seg, NEG_INF))
    cb = torch.einsum("bcin,bcjn->bcij", C_c, B_c)
    scores = cb[..., None] * decay * dt_c[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, x_c)

    # state pass between chunks: each chunk decays the carried state and
    # injects every step's B x outer product
    w = dt_c * torch.exp(La[:, :, -1:, :] - La)               # (B,nc,Q,nh)
    inject = torch.einsum("bcjh,bcjn,bcjhp->bchpn", w, B_c, x_c)
    chunk_decay = torch.exp(La[:, :, -1, :])[..., None, None]  # (B,nc,nh,1,1)
    if initial_state is None:
        state = x.new_zeros((B, nh, hd, ds), dtype=torch.float32)
    else:
        state = initial_state.float()
    carried = []
    for c in range(nc):
        carried.append(state)
        state = state * chunk_decay[:, c] + inject[:, c]
    carried = torch.stack(carried, dim=1)                     # (B,nc,nh,hd,ds)
    # inter-chunk contribution from the state carried into each chunk
    y = y + torch.einsum("bcin,bchpn->bcihp", C_c, carried) \
        * torch.exp(La)[..., None]

    y = y.reshape(B, Sp, nh, hd)[:, :S]
    y = y + p["D"].float()[None, None, :, None] * xh[:, :S]
    out = _out(p, y.reshape(B, S, di), z, x, cfg, par)
    if return_state:
        return out, (state, _tail_conv_state(px, pB, pC, cfg))
    return out


def _tail_conv_state(px, pB, pC, cfg):
    """Last W-1 pre-conv inputs, concatenated channelwise, for decode."""
    w = cfg.ssm_conv
    cat = torch.cat([px, pB, pC], dim=-1)                     # (B,S,di+2ds)
    padded = F.pad(cat, (0, 0, max(w - 1 - cat.shape[1], 0), 0))
    return padded[:, -(w - 1):]


def state_shapes(cfg, batch: int):
    """Shapes of the decode state: ssm (B,nh,hd,ds), conv (B,W-1,C)."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return ((batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
            (batch, cfg.ssm_conv - 1, conv_ch))


def init_ssm_state(cfg, batch: int, dtype=torch.float32, device="cuda"):
    device = resolve_device(device)
    return tuple(torch.zeros(s, dtype=dtype, device=device)
                 for s in state_shapes(cfg, batch))


def ssm_step(p, x, state, cfg):
    """Recurrent decode. x (B,1,d); state=(ssm (B,nh,hd,ds), conv
    (B,W-1,C)). Returns (out (B,1,d), new state). Exactly equivalent to
    ssm_chunked processed one token at a time."""
    B = x.shape[0]
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    ssm_state, conv_state = state
    z, px, pB, pC, dt = _inputs(p, x)
    cat = torch.cat([px, pB, pC], dim=-1)
    wcat = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    y_cat, conv_state = _conv_step(conv_state, cat, wcat)
    y_cat = F.silu(y_cat)
    xc = y_cat[..., :di]
    Bc = y_cat[..., di:di + ds]
    Cc = y_cat[..., di + ds:]

    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[:, 0] * A[None, :])                      # (B,nh)
    xh = xc.float().reshape(B, nh, hd)
    st = ssm_state.float() * a[..., None, None] \
        + torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bc[:, 0].float(), xh)
    y = torch.einsum("bn,bhpn->bhp", Cc[:, 0].float(), st)
    y = y + p["D"].float()[None, :, None] * xh
    out = _out(p, y.reshape(B, 1, di), z, x, cfg)
    return out, (st.to(ssm_state.dtype), conv_state)
