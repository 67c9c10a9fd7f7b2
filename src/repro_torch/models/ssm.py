"""State-space layers: Mamba2 (chunked SSD) and RWKV6 (Finch).

Mirrors ``repro.models.ssm`` function for function on the same parameter
layout (weights applied as ``x @ w``) and with the same casts: Mamba2's
log-decays, cumulative sums, decays and SSM state are f32, ``C B^T`` is
formed in the compute dtype and then widened, ``y`` is cast back before
the ``D`` skip; RWKV6's r, k, v are widened to f32 for the time scan, its
decay ``w`` is f32 and its bonus ``u`` promotes to f32.

Mamba2 runs the SSD chunked form over a sequence (within a chunk a masked
``C B^T`` quadratic form, across chunks a loop carrying the (B, heads,
head_dim, state) f32 state) and the O(1) recurrence with a rolling conv
cache at decode.  One difference from the JAX version, which is a fault
of the reference (ROADMAP §3): JAX forms ``exp(cums_i - cums_j)`` over the
whole chunk and selects the lower triangle after the ``exp``.  Above the
diagonal the difference is a sum of up to ``chunk - 1`` positive
log-decay magnitudes, which overflows f32 at the default chunk of 128;
the forward's ``where`` picks 0 there, but its backward is ``0 * inf =
NaN``.  Here the upper triangle is set to ``-inf`` before the ``exp``:
every forward value is JAX's, and every gradient is JAX's wherever JAX's
is finite.

RWKV6's WKV recurrence is a Python loop over time (JAX's ``lax.scan``).
Where autograd records (training) and S is a multiple of ``time_chunk``
greater than it (JAX's condition), the loop runs in chunks of
``time_chunk`` steps under ``torch.utils.checkpoint``, as JAX checkpoints
them, so the backward keeps one state per chunk rather than one per step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import Maker, rms_norm

# ===========================================================================
# Mamba2
# ===========================================================================


def mamba_init(mk: Maker, cfg, *, stack: int | None = None):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    st = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    kk = cfg.ssm_conv
    conv_ch = d_in + 2 * st
    return {
        "wz": mk.make((d, d_in), (mk.ax("data", d), mk.ax("model", d_in)),
                      stack=stack),
        "wx": mk.make((d, d_in), (mk.ax("data", d), mk.ax("model", d_in)),
                      stack=stack),
        "wB": mk.make((d, st), (mk.ax("data", d), None), stack=stack),
        "wC": mk.make((d, st), (mk.ax("data", d), None), stack=stack),
        "wdt": mk.make((d, nh), (mk.ax("data", d), mk.ax("model", nh)),
                       stack=stack),
        "conv_w": mk.make((kk, conv_ch), (None, None), scale=0.5,
                          stack=stack),
        "conv_b": mk.make((conv_ch,), (None,), init="zeros", stack=stack),
        "A_log": mk.make((nh,), (mk.ax("model", nh),), init="zeros",
                         stack=stack),
        "D": mk.make((nh,), (mk.ax("model", nh),), init="ones", stack=stack),
        "dt_bias": mk.make((nh,), (mk.ax("model", nh),), init="zeros",
                           stack=stack),
        "norm": mk.make((d_in,), (mk.ax("model", d_in),), init="ones",
                        stack=stack),
        "wo": mk.make((d_in, d), (mk.ax("model", d_in), mk.ax("data", d)),
                      stack=stack),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv over time as a sum of shifted copies, in the
    JAX version's order.  x: (B, S, C); w: (K, C)."""
    k, s = w.shape[0], x.shape[1]
    out = b
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :s, :]
        out = out + xi * w[i]
    return out


def _mamba_in(p, x, cfg):
    """The input projections: z, the conv's input [x ‖ B ‖ C], dt."""
    z = x @ p["wz"]
    conv_in = torch.cat([x @ p["wx"], x @ p["wB"], x @ p["wC"]], dim=-1)
    dt = F.softplus(x @ p["wdt"] + p["dt_bias"])
    return z, conv_in, dt


def mamba_fwd(p, x, cfg, *, chunk: int = 128, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d). Chunked SSD.

    return_state=True additionally returns the final {ssm (B, nh, hd, st)
    f32, conv (B, K-1, C)} state (for prefill)."""
    b, s, d = x.shape
    d_in = cfg.ssm_expand * d
    st = cfg.ssm_state
    hd = cfg.ssm_head_dim
    nh = d_in // hd
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {chunk}")
    f32 = torch.float32

    z, conv_in, dt = _mamba_in(p, x, cfg)
    conv_tail = conv_in[:, -(cfg.ssm_conv - 1):, :]  # rolling cache
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xin = conv_out[..., :d_in]
    bb = conv_out[..., d_in:d_in + st]
    cc = conv_out[..., d_in + st:]

    a = -torch.exp(p["A_log"].to(f32))                      # (nh,) negative
    la = dt.to(f32) * a                                     # (B,S,nh)
    xh = xin.reshape(b, s, nh, hd) * dt[..., None].to(xin.dtype)

    nc = s // chunk
    cums = torch.cumsum(la.reshape(b, nc, chunk, nh), dim=2)  # (B,nc,c,nh)
    xc = xh.reshape(b, nc, chunk, nh, hd).to(f32)
    bc = bb.reshape(b, nc, chunk, st)
    ccc = cc.reshape(b, nc, chunk, st)

    # intra-chunk: y[i] = sum_{j<=i} exp(cums_i - cums_j) (C_i.B_j) xbar_j;
    # masked before the exp (the module docstring: JAX's order overflows)
    cb = torch.einsum("bnis,bnjs->bnij", ccc, bc).to(f32)   # (B,nc,c,c)
    li = cums[:, :, :, None, :] - cums[:, :, None, :, :]    # (B,nc,c,c,nh)
    mask = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(torch.where(mask[None, None, :, :, None], li,
                                 float("-inf")))
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", cb[..., None] * lmat, xc)

    # inter-chunk: a loop carrying the state (B,nh,hd,st)
    decay_out = torch.exp(cums)                             # (B,nc,c,nh)
    decay_tot = torch.exp(cums[:, :, -1, :])                # (B,nc,nh)
    decay_in = torch.exp(cums[:, :, -1:, :] - cums)         # (B,nc,c,nh)
    chunk_state = torch.einsum("bcjh,bcjhp,bcjs->bchps", decay_in, xc,
                               bc.to(f32))                  # (B,nc,nh,hd,st)
    cc32 = ccc.to(f32)
    state = torch.zeros(b, nh, hd, st, dtype=f32, device=x.device)
    y_inter = []
    for n in range(nc):
        # y_inter[i] = exp(cums_i) * C_i . state
        y_inter.append(torch.einsum("bis,bhps,bih->bihp", cc32[:, n], state,
                                    decay_out[:, n]))
        state = state * decay_tot[:, n, :, None, None] + chunk_state[:, n]
    y = y_intra + torch.stack(y_inter, dim=1)
    y = y.reshape(b, s, nh, hd).to(x.dtype)
    # D skip uses the raw (conv'd) x, not the dt-scaled xbar
    y = y + xin.reshape(b, s, nh, hd) * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(b, s, d_in)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = y @ p["wo"]
    if return_state:
        return out, {"ssm": state, "conv": conv_tail}
    return out


def mamba_init_state(cfg, batch: int, dtype=torch.float32, device=None):
    d_in = cfg.ssm_expand * cfg.d_model
    st = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    conv_ch = d_in + 2 * st
    return {
        "ssm": torch.zeros(batch, nh, cfg.ssm_head_dim, st,
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, conv_ch, dtype=dtype,
                            device=device),
    }


def mamba_decode_step(p, x, state, cfg):
    """x: (B, 1, d) -> (y (B, 1, d), new state). O(1) in context length."""
    b, _, d = x.shape
    d_in = cfg.ssm_expand * d
    st = cfg.ssm_state
    hd = cfg.ssm_head_dim
    nh = d_in // hd
    f32 = torch.float32

    z, conv_in, dt = _mamba_in(p, x, cfg)                   # conv_in (B,1,C)
    window = torch.cat([state["conv"], conv_in], dim=1)     # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :]
    new_conv = window[:, 1:, :]
    xin = conv_out[..., :d_in]
    bb = conv_out[..., d_in:d_in + st]
    cc = conv_out[..., d_in + st:]

    a = -torch.exp(p["A_log"].to(f32))
    decay = torch.exp(dt[:, 0].to(f32) * a)                 # (B,nh)
    xh = (xin.reshape(b, nh, hd) * dt[:, 0, :, None]).to(f32)
    kv = torch.einsum("bhp,bs->bhps", xh, bb[:, 0].to(f32))
    ssm = state["ssm"] * decay[..., None, None] + kv
    y = torch.einsum("bhps,bs->bhp", ssm, cc[:, 0].to(f32))
    y = y.to(x.dtype) + xin.reshape(b, nh, hd) * p["D"][None, :, None]
    y = y.reshape(b, 1, d_in)
    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["wo"], {"ssm": ssm, "conv": new_conv}


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================

def rwkv_layer_init(mk: Maker, cfg, *, stack: int | None = None):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    nh = d // hd
    lora = 64

    def make(shape, spec, **kw):
        return mk.make(shape, spec, stack=stack, **kw)

    dax, fax = mk.ax("data", d), mk.ax("model", cfg.d_ff)
    return {
        "ln1": make((d,), (None,), init="ones"),
        "ln2": make((d,), (None,), init="ones"),
        # time-mix
        "mu": make((5, d), (None, None), scale=0.1),        # r,k,v,g,w shifts
        "wr": make((d, d), (dax, None)),
        "wk": make((d, d), (dax, None)),
        "wv": make((d, d), (dax, None)),
        "wgate": make((d, d), (dax, None)),
        "wo": make((d, d), (None, dax)),
        "w0": make((d,), (None,), init="zeros"),
        "w_lora_a": make((d, lora), (dax, None)),
        "w_lora_b": make((lora, d), (None, None), scale=0.01),
        "u": make((nh, hd), (None, None), scale=0.1),       # bonus
        "gn": make((d,), (None,), init="ones"),             # per-head norm
        # channel-mix
        "mu_ck": make((d,), (None,), scale=0.1),
        "mu_cr": make((d,), (None,), scale=0.1),
        "wck": make((d, cfg.d_ff), (dax, fax)),
        "wcv": make((cfg.d_ff, d), (fax, dax)),
        "wcr": make((d, d), (dax, None)),
    }


def _token_shift(x, x_prev):
    """Shift right by one; x_prev is the last token of the previous call
    (zeros at sequence start). x: (B,S,d), x_prev: (B,1,d)."""
    return torch.cat([x_prev, x[:, :-1, :]], dim=1)


def _rwkv_decay(p, xw):
    w_raw = p["w0"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    # data-dependent decay in (0, 1): w = exp(-exp(w_raw)), clamped
    return torch.exp(-torch.exp(torch.clamp(w_raw.to(torch.float32),
                                            -8.0, 4.0)))


def _wkv_scan(u, state, r, k, v, w):
    """The WKV recurrence over the time axis (dim 1) of r, k, v, w (B, T,
    H, K/V) -> (final state, ys (B, T, H, V))."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state + u[..., None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return state, torch.stack(ys, dim=1)


def rwkv_time_mix(p, x, cfg, state, x_prev, *, time_chunk: int = 256):
    """WKV6 over a sequence. x: (B,S,d); state: (B,H,K,V) f32.  With
    gradients enabled, chunks of ``time_chunk`` steps are checkpointed
    (the module docstring)."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    nh = d // hd
    xs = _token_shift(x, x_prev)
    xr, xk, xv, xg, xw = [x + (xs - x) * p["mu"][i] for i in range(5)]
    f32 = torch.float32
    r = (xr @ p["wr"]).reshape(b, s, nh, hd).to(f32)
    k = (xk @ p["wk"]).reshape(b, s, nh, hd).to(f32)
    v = (xv @ p["wv"]).reshape(b, s, nh, hd).to(f32)
    g = F.silu(xg @ p["wgate"])
    w = _rwkv_decay(p, xw).reshape(b, s, nh, hd)            # (B,S,H,K) f32

    if torch.is_grad_enabled() and s % time_chunk == 0 and s > time_chunk:
        ys = []
        for t0 in range(0, s, time_chunk):
            sl = slice(t0, t0 + time_chunk)
            state, y = checkpoint(_wkv_scan, p["u"], state, r[:, sl],
                                  k[:, sl], v[:, sl], w[:, sl],
                                  use_reentrant=False)
            ys.append(y)
        ys = torch.cat(ys, dim=1)
    else:
        state, ys = _wkv_scan(p["u"], state, r, k, v, w)
    y = ys.reshape(b, s, d).to(x.dtype)
    y = rms_norm(y.reshape(b, s, nh, hd),
                 p["gn"].reshape(nh, hd)).reshape(b, s, d)
    out = (y * g) @ p["wo"]
    return out, state, x[:, -1:, :]


def rwkv_channel_mix(p, x, x_prev):
    xs = _token_shift(x, x_prev)
    xk = x + (xs - x) * p["mu_ck"]
    xr = x + (xs - x) * p["mu_cr"]
    k = torch.square(F.relu(xk @ p["wck"]))
    return (k @ p["wcv"]) * torch.sigmoid(xr @ p["wcr"]), x[:, -1:, :]


def rwkv_layer_fwd(p, x, cfg, state):
    """state: dict(wkv (B,H,K,V), tm_prev (B,1,d), cm_prev (B,1,d))."""
    h, wkv, tm_prev = rwkv_time_mix(
        p, rms_norm(x, p["ln1"]), cfg, state["wkv"], state["tm_prev"])
    x = x + h
    h2, cm_prev = rwkv_channel_mix(p, rms_norm(x, p["ln2"]), state["cm_prev"])
    x = x + h2
    return x, {"wkv": wkv, "tm_prev": tm_prev, "cm_prev": cm_prev}


def rwkv_init_state(cfg, batch: int, dtype=torch.float32, device=None):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    nh = d // hd
    return {
        "wkv": torch.zeros(batch, nh, hd, hd, dtype=torch.float32,
                           device=device),
        "tm_prev": torch.zeros(batch, 1, d, dtype=dtype, device=device),
        "cm_prev": torch.zeros(batch, 1, d, dtype=dtype, device=device),
    }
