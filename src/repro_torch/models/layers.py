"""Shared LM layers, forward only: RMSNorm, RoPE and M-RoPE, GQA attention
(full, q-chunked, decode-merge), the gated and the plain MLP, the
attention projections and the next-token cross-entropy.

Mirrors ``repro.models.layers`` function for function, params-in and
value-out, with the same rounding points: ``rms_norm`` takes its variance
in f32 and multiplies in ``x.dtype``; RoPE's cos / sin are cast to
``x.dtype``; attention logits come out of an einsum in the operand dtype,
are masked with that dtype's ``finfo.min`` and go through an f32 softmax
cast back.  Layouts are the JAX package's: activations (B, S, d), heads
(B, S, H, D), weights applied as ``x @ w``, query head ``h = hkv * g +
g_idx`` grouped over its KV head.

``Maker`` is a seeded initializer on a ``torch.Generator``; with no seed
it is JAX's abstract mode and returns each leaf's sharding spec instead
(a tuple with one entry a dimension: an axis name, a tuple of names or
``None``; JAX's ``PartitionSpec`` as data), by the same calls, so that
init and specs cannot drift.  The port executes no tensor parallelism or
FSDP: the specs only state what a leaf would take a rank under JAX's
layout (``launch.dryrun``).  ``constrain_batch`` / ``constrain_logits``
(GSPMD hints) are left out.
The port's forwards run in the dtype of the parameters they are given
(``serve.lm.load_serving_params`` casts once); ``cast_floats`` is the
training loss's differentiable cast of f32 master weights.  The
embedding lookup is plain indexing: JAX's ``embed_lookup`` computes its
backward as a one-hot product so that GSPMD partitions it over the vocab,
and the index backward sums the same rows (in a fixed order under
``torch.use_deterministic_algorithms``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref


def pspec(*entries) -> tuple:
    """JAX's ``PartitionSpec(*entries)`` as a tuple: one entry a
    dimension, an axis name, a tuple of names or ``None``; a 1-tuple of
    names becomes the name, as ``PartitionSpec`` normalises it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


class Maker:
    """Creates parameters from one ``torch.Generator`` seeded once:
    ``normal`` leaves are N(0, 1) * std, std ``shape[0] ** -0.5`` unless
    given.  Leaves are drawn in f32 on ``device`` and cast to ``dtype``
    (on ``meta`` the generator is a CPU one and nothing is allocated).
    ``stack`` draws ``stack`` layers' copies of a leaf at once, with the
    per-layer default std.  Same distributions as the JAX ``Maker``, not
    the same numbers: tests hand both packages one tree (``convert``).

    ``seed=None`` is the abstract mode: ``make`` returns the leaf's spec
    tuple (``None`` prepended for a stacked leaf, as JAX's
    ``_prepend_none``), and ``ax`` / ``first_ax`` / ``head_ax`` read
    ``mesh_sizes`` with JAX's divisibility fallbacks: a dimension is
    sharded only where the axis size divides it."""

    def __init__(self, seed: int | None, device=None, dtype=torch.float32,
                 mesh_sizes: dict | None = None):
        self.abstract = seed is None
        self.mesh = dict(mesh_sizes or {})
        self.device = torch.device("cpu" if device is None else device)
        self.dtype = dtype
        if not self.abstract:
            gen_dev = "cpu" if self.device.type == "meta" else self.device
            self.gen = torch.Generator(device=gen_dev).manual_seed(seed)

    def ax(self, axis, dim: int):
        """``axis`` (a name or a tuple of names) if its size divides
        ``dim`` and exceeds 1, else ``None``."""
        names = axis if isinstance(axis, tuple) else (axis,)
        size = 1
        for a in names:
            size *= self.mesh.get(a, 1)
        return axis if size > 1 and dim % size == 0 else None

    def first_ax(self, dim: int,
                 candidates=(("data", "model"), "model", "data")):
        """The first candidate that divides ``dim`` (vocab dims)."""
        for cand in candidates:
            if self.ax(cand, dim) is not None:
                return cand
        return None

    def head_ax(self, num_heads: int):
        """``"model"`` for a fused heads x head_dim dim where the head
        count divides the model axis, else ``None``."""
        size = self.mesh.get("model", 1)
        return "model" if size > 1 and num_heads % size == 0 else None

    def make(self, shape, spec: tuple | None = None, *,
             scale: float | None = None, init: str = "normal",
             stack: int | None = None):
        if self.abstract:
            if spec is None:
                raise ValueError(f"no spec for a leaf of shape {shape}")
            return pspec(*spec) if stack is None else pspec(None, *spec)
        full = tuple(shape) if stack is None else (stack, *shape)
        if init == "zeros":
            return torch.zeros(full, dtype=self.dtype, device=self.device)
        if init == "ones":
            return torch.ones(full, dtype=self.dtype, device=self.device)
        std = scale if scale is not None else float(shape[0]) ** -0.5
        w = torch.randn(full, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return w.mul_(std).to(self.dtype)


def cast_floats(tree, dtype: torch.dtype):
    """The tree with every float leaf cast to ``dtype``, differentiably
    (leaves already in it are returned as they are)."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-5):
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def _inv_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _rotate(x, ang):
    """x: (B, S, H, D) rotated by the angles ang (B, S, D/2), cos / sin
    cast to ``x.dtype``."""
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) int -> rotated x."""
    inv = _inv_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * inv)


def apply_mrope(x, positions, sections: tuple[int, ...], theta: float):
    """Qwen2-VL M-RoPE. positions: (B, S, 3) for (t, h, w); ``sections``
    splits the D/2 frequency slots across the three position components."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} do not split "
                         f"head_dim / 2 = {d // 2}")
    inv = _inv_freqs(d, theta, x.device)  # (D/2,)
    comp, off = [], 0
    for i, sec in enumerate(sections):
        comp.append(positions[..., i:i + 1].to(torch.float32)
                    * inv[off:off + sec])
        off += sec
    return _rotate(x, torch.cat(comp, dim=-1))


# ---------------------------------------------------------------------------
# Attention (GQA; full / q-chunked / decode)
# ---------------------------------------------------------------------------

def _gqa_logits(q, k, scale: float):
    """q: (B, Sq, H, D), k: (B, Sk, Hkv, D) -> (B, H, Sq, Sk)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
    return logits.reshape(b, h, sq, k.shape[1])


def _gqa_out(probs, v):
    """probs: (B, H, Sq, Sk), v: (B, Sk, Hkv, D) -> (B, Sq, H, D)."""
    b, h, sq, sk = probs.shape
    hkv = v.shape[2]
    pg = probs.reshape(b, hkv, h // hkv, sq, sk)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pg, v)
    return out.reshape(b, sq, h, out.shape[-1])


def attention_full(q, k, v, *, causal: bool, q_offset: int = 0,
                   kv_len=None):
    """Materializing attention.  kv_len: optional (B,) valid KV length."""
    scale = q.shape[-1] ** -0.5
    logits = _gqa_logits(q, k, scale)  # (B, H, Sq, Sk)
    sq, sk = logits.shape[-2], logits.shape[-1]
    neg = torch.finfo(logits.dtype).min
    dev = logits.device
    if causal and sq > 1:
        rows = torch.arange(sq, device=dev)[:, None] + q_offset
        cols = torch.arange(sk, device=dev)[None, :]
        logits = torch.where(rows >= cols, logits, neg)
    if kv_len is not None:
        mask = torch.arange(sk, device=dev)[None, :] < kv_len[:, None]
        logits = torch.where(mask[:, None, None, :], logits, neg)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return _gqa_out(probs, v)


def attention_decode_merge(q, k_cache, v_cache, k_new, v_new, pos: int):
    """Decode attention over the cache's first ``pos`` entries merged with
    the current token's own k / v by an online-softmax correction (the
    cache need not hold the new token).

    q: (B,1,H,D); k_cache / v_cache: (B,S,Hkv,D); k_new / v_new: (B,1,Hkv,D).
    """
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    scale = d ** -0.5
    logits_c = _gqa_logits(q, k_cache, scale)          # (B,H,1,S)
    neg = torch.finfo(logits_c.dtype).min
    sk = k_cache.shape[1]
    mask = torch.arange(sk, device=q.device)[None, :] < pos    # (1,S)
    logits_c = torch.where(mask[:, None, None, :], logits_c, neg)
    logits_c = logits_c.to(torch.float32)

    qg = q.reshape(b, 1, hkv, g, d)
    l_s = torch.einsum("bqhgd,bqhd->bhgq", qg, k_new) * scale
    l_s = l_s.reshape(b, h, 1).to(torch.float32)       # (B,H,1)

    m_c = logits_c.amax(dim=-1)                        # (B,H,1)
    m = torch.maximum(m_c, l_s)
    p_c = torch.exp(logits_c - m[..., None])
    den_c = p_c.sum(dim=-1)                            # (B,H,1)
    num_c = _gqa_out(p_c.to(q.dtype), v_cache)         # (B,1,H,D)
    beta = torch.exp(l_s - m)                          # (B,H,1)
    v_rep = torch.repeat_interleave(v_new, g, dim=2)   # (B,1,H,D)
    num = num_c + beta.transpose(1, 2)[..., None].to(q.dtype) * v_rep
    den = (den_c + beta).transpose(1, 2)[..., None].to(q.dtype)
    return num / torch.clamp(den, min=1e-30)


def attention_chunked(q, k, v, *, causal: bool, chunk: int = 1024):
    """q-chunked attention: the (Sq x Sk) logits never exist whole; each
    chunk's are (chunk x Sk).  Falls back to ``attention_full`` when Sq is
    not a multiple of ``chunk``, as the JAX version does."""
    b, sq, h, d = q.shape
    if sq % chunk != 0 or sq == 1:
        return attention_full(q, k, v, causal=causal)
    outs = [attention_full(q[:, i:i + chunk], k, v, causal=causal,
                           q_offset=i) for i in range(0, sq, chunk)]
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def gated_mlp_apply(p, x, activation: str, use_pallas: bool = False):
    """SwiGLU / GeGLU ``(act(x@wg) * (x@wu)) @ wd``; ``use_pallas`` runs the
    fused kernel (``kernels.ops.fused_swiglu``; the flag keeps the JAX
    package's name)."""
    if use_pallas:
        shape = x.shape
        out = ops.fused_swiglu(x.reshape(-1, shape[-1]), p["wg"], p["wu"],
                               p["wd"], activation=activation)
        return out.reshape(shape)
    g = x @ p["wg"]
    u = x @ p["wu"]
    return (ref.swiglu_act(g, activation) * u) @ p["wd"]


def gated_mlp_init(mk: Maker, d: int, f: int, *, stack: int | None = None):
    return {"wg": mk.make((d, f), (mk.ax("data", d), mk.ax("model", f)),
                          stack=stack),
            "wu": mk.make((d, f), (mk.ax("data", d), mk.ax("model", f)),
                          stack=stack),
            "wd": mk.make((f, d), (mk.ax("model", f), mk.ax("data", d)),
                          stack=stack)}


def plain_mlp_init(mk: Maker, d: int, f: int, *, stack: int | None = None):
    return {"w1": mk.make((d, f), (mk.ax("data", d), mk.ax("model", f)),
                          stack=stack),
            "b1": mk.make((f,), (mk.ax("model", f),), init="zeros",
                          stack=stack),
            "w2": mk.make((f, d), (mk.ax("model", f), mk.ax("data", d)),
                          stack=stack),
            "b2": mk.make((d,), (None,), init="zeros", stack=stack)}


def plain_mlp_apply(p, x):
    """Whisper's ungated MLP: tanh-GELU between two biased linears."""
    h = torch.nn.functional.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    return h @ p["w2"] + p["b2"]


def cross_entropy(logits, labels):
    """Mean next-token cross-entropy of f32 ``logits`` (B, S, V) against
    ``labels`` (B, S): logsumexp minus the gold logit."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()


# ---------------------------------------------------------------------------
# Attention block params
# ---------------------------------------------------------------------------

def attn_init(mk: Maker, d: int, h: int, hkv: int, hd: int, *,
              qkv_bias: bool = False, qk_norm: bool = False,
              stack: int | None = None):
    dax = mk.ax("data", d)
    p = {
        "wq": mk.make((d, h * hd), (dax, mk.head_ax(h)), stack=stack),
        "wk": mk.make((d, hkv * hd), (dax, mk.head_ax(hkv)), stack=stack),
        "wv": mk.make((d, hkv * hd), (dax, mk.head_ax(hkv)), stack=stack),
        "wo": mk.make((h * hd, d), (mk.head_ax(h), dax), stack=stack),
    }
    if qkv_bias:
        p["bq"] = mk.make((h * hd,), (None,), init="zeros", stack=stack)
        p["bk"] = mk.make((hkv * hd,), (None,), init="zeros", stack=stack)
        p["bv"] = mk.make((hkv * hd,), (None,), init="zeros", stack=stack)
    if qk_norm:
        p["q_norm"] = mk.make((hd,), (None,), init="ones", stack=stack)
        p["k_norm"] = mk.make((hd,), (None,), init="ones", stack=stack)
    return p


def attn_qkv(p, x, cfg, positions):
    """Project + (qk-norm) + rope. Returns q (B,S,H,D), k/v (B,S,Hkv,D)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if positions is not None:
        if cfg.mrope_sections:
            q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v
