"""Roofline of the production cells on the H100 from the port's dry-run
records: PyTorch port of ``repro.analysis.roofline``.

Per (arch x shape x mesh) cell:
    compute term    = FLOPs / (chip peak FLOP/s)          [s/step/chip]
    memory term     = HBM bytes / (chip HBM bandwidth)    [s/step/chip]
    collective term = collective bytes / (chip link BW)   [s/step/chip]

Hardware model: the NVIDIA H100 SXM5 at its 700 W power limit, from the
datasheet, not measured: 989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s of HBM3, 450 GB/s of NVLink 4 in each direction.  A card set
below 700 W runs slower under load.  The production meshes' 16-wide
``"model"`` axis spans two 8-GPU NVLink domains, whose link is the
slower inter-node network, so the collective term is a lower bound.

Sources.  The analytic models below are JAX's, with the same signatures
and the same arithmetic: FLOPs, HBM bytes and collective bytes from the
architecture, per step and chip.  The port compiles no HLO, so there is
no ``cost_analysis()`` to correct against: ``corr`` is 1 and
``hlo_flops_per_chip`` is ``None``.  ``mem_gib`` is the dry run's
argument bytes a rank (parameters, optimizer state, inputs, decode
state); no compiler reports temporaries here.

MODEL_FLOPS = 6 * N * D (dense) or 6 * N_active * D (MoE), D = tokens:
the "useful" fraction MODEL_FLOPS / FLOPs catches remat / redundancy.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math

# H100 SXM5 datasheet peaks at 700 W (not measured)
PEAK_FLOPS = 989e12   # bf16 dense FLOP/s a chip
HBM_BW = 3.35e12      # bytes/s a chip
LINK_BW = 450e9       # bytes/s, NVLink 4, one direction


# ---------------------------------------------------------------------------
# analytic FLOP models
# ---------------------------------------------------------------------------

def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}['{k}']")
    else:
        yield prefix, tree


@functools.cache
def _param_counts(cfg):
    """(total, active, matmul-active-excl-embed-gather) parameter counts,
    from ``param_structs`` on ``meta`` with JAX's key rules (cached: the
    configs are frozen)."""
    from repro_torch.launch.steps import param_structs

    total = active = mm = 0
    for key, leaf in _paths(param_structs(cfg)):
        n = int(math.prod(leaf.shape))
        total += n
        is_embed_gather = "embed" in key and "unembed" not in key
        frac = 1.0
        if cfg.is_moe and ("we_gate" in key or "we_up" in key
                           or "we_down" in key):
            frac = (cfg.moe.top_k * cfg.moe.capacity_factor
                    / cfg.moe.num_experts)
            frac = min(1.0, frac)
        active += int(n * frac)
        if not is_embed_gather or cfg.tie_embeddings:
            mm += int(n * frac)
    return total, active, mm


def _attn_quad_flops(cfg, batch, seq, *, kv_len=None, layers=None):
    """QK^T + AV matmul FLOPs for full (masked) attention."""
    hd = cfg.resolved_head_dim
    h = cfg.num_heads
    kv = kv_len if kv_len is not None else seq
    n_layers = layers if layers is not None else cfg.num_layers
    return 4.0 * batch * seq * kv * h * hd * n_layers


def analytic_flops(cfg, shape) -> dict:
    """Global (all-chip) FLOPs for one step of this cell + MODEL_FLOPS."""
    b, s = shape.batch, shape.seq
    total, active, mm = _param_counts(cfg)

    if shape.kind == "train":
        tokens = b * s
        fwd = 2.0 * mm * tokens
        if cfg.family in ("dense", "moe", "vlm"):
            fwd += _attn_quad_flops(cfg, b, s)
        elif cfg.family == "encdec":
            fwd += _attn_quad_flops(cfg, b, s)                      # enc self
            fwd += _attn_quad_flops(cfg, b, s, layers=cfg.num_decoder_layers)
            fwd += _attn_quad_flops(cfg, b, s, layers=cfg.num_decoder_layers)
        elif cfg.family == "hybrid":
            c = 128  # ssd chunk: intra-chunk quadratic form per token ~ c
            ssd = cfg.num_layers * b * s * 2.0 * c * (
                cfg.ssm_state + cfg.ssm_head_dim)
            sites = cfg.num_layers // cfg.attn_every
            fwd += ssd + _attn_quad_flops(cfg, b, s, layers=sites)
        elif cfg.family == "rwkv":
            nh = cfg.d_model // cfg.rwkv_head_dim
            k = v = cfg.rwkv_head_dim
            fwd += 6.0 * cfg.num_layers * b * s * nh * k * v
        flops = 3.0 * fwd      # fwd + 2x bwd
        # default-policy remat: one extra forward recompute
        flops_with_remat = flops + fwd
        model = 6.0 * active * tokens
        return {"flops": flops_with_remat, "flops_noremat": flops,
                "model_flops": model}

    if shape.kind == "prefill":
        tokens = b * s
        fwd = 2.0 * mm * tokens
        if cfg.family in ("dense", "moe", "vlm"):
            fwd += _attn_quad_flops(cfg, b, s)
        elif cfg.family == "encdec":
            fwd += _attn_quad_flops(cfg, b, s)
        elif cfg.family == "hybrid":
            c = 128
            fwd += cfg.num_layers * b * s * 2.0 * c * (
                cfg.ssm_state + cfg.ssm_head_dim)
            fwd += _attn_quad_flops(cfg, b, s,
                                    layers=cfg.num_layers // cfg.attn_every)
        elif cfg.family == "rwkv":
            nh = cfg.d_model // cfg.rwkv_head_dim
            fwd += 6.0 * cfg.num_layers * b * s * nh * cfg.rwkv_head_dim ** 2
        return {"flops": fwd, "model_flops": 2.0 * active * tokens}

    # decode: one token against a seq-long state
    fwd = 2.0 * mm * b
    if cfg.family in ("dense", "moe", "vlm"):
        fwd += _attn_quad_flops(cfg, b, 1, kv_len=s)
    elif cfg.family == "encdec":
        fwd += _attn_quad_flops(cfg, b, 1, kv_len=s,
                                layers=cfg.num_decoder_layers) * 2
    elif cfg.family == "hybrid":
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        fwd += 6.0 * cfg.num_layers * b * nh * cfg.ssm_head_dim * cfg.ssm_state
        fwd += _attn_quad_flops(cfg, b, 1, kv_len=s,
                                layers=cfg.num_layers // cfg.attn_every)
    elif cfg.family == "rwkv":
        nh = cfg.d_model // cfg.rwkv_head_dim
        fwd += 6.0 * cfg.num_layers * b * nh * cfg.rwkv_head_dim ** 2
    return {"flops": fwd, "model_flops": 2.0 * active * b}


def analytic_collective_bytes(cfg, shape, *, chips, model_par, dp_total,
                              accum: int) -> float:
    """Per-chip collective traffic model [bytes/step], leading terms only,
    under JAX's layout (FSDP over 'data', TP over 'model'):

    train:   FSDP weight all-gathers (per pass) + grad reduce-scatter/
             all-gather (once) + TP activation all-reduces (per layer)
    prefill: TP activation all-reduces + weight gathers (once)
    decode:  TP all-reduces of the (B,1,d) residual per layer
    """
    total, active, mm = _param_counts(cfg)
    b, s = shape.batch, shape.seq
    d = cfg.d_model
    layers = cfg.num_layers + cfg.num_decoder_layers
    w_shard = 2.0 * active / model_par        # bf16 weights per TP shard
    fsdp_frac = (dp_total - 1) / dp_total

    if shape.kind == "train":
        tok_chip = b * s / dp_total
        w_gather = 3.0 * accum * w_shard * fsdp_frac
        grad_sync = 2.0 * 4.0 * total / chips * fsdp_frac * 2.0
        # Megatron TP: ~2 act all-reduces/layer fwd + 2 bwd (x2 ring)
        tp_act = layers * tok_chip * d * 2.0 * 4.0 * 2.0
        return w_gather + grad_sync + tp_act

    if shape.kind == "prefill":
        tok_chip = b * s / dp_total
        tp_act = layers * tok_chip * d * 2.0 * 2.0 * 2.0
        return tp_act + w_shard * fsdp_frac

    b_chip = max(1.0, b / dp_total)
    return layers * b_chip * d * 2.0 * 2.0 * 2.0


def decode_state_bytes(cfg, batch, seq) -> float:
    """Global decode-state bytes (bf16 KV caches + recurrent states)."""
    hd = cfg.resolved_head_dim
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.num_layers * batch * seq * cfg.num_kv_heads * hd * 2 * 2
    if cfg.family == "encdec":
        return 2 * cfg.num_decoder_layers * batch * seq \
            * cfg.num_kv_heads * hd * 2 * 2
    if cfg.family == "hybrid":
        sites = cfg.num_layers // cfg.attn_every
        kv = sites * batch * seq * cfg.num_kv_heads * hd * 2 * 2
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        ssm = cfg.num_layers * batch * nh * cfg.ssm_head_dim \
            * cfg.ssm_state * 4
        return kv + ssm
    if cfg.family == "rwkv":
        nh = cfg.d_model // cfg.rwkv_head_dim
        return cfg.num_layers * batch * nh * cfg.rwkv_head_dim ** 2 * 4
    raise ValueError(cfg.family)


def analytic_bytes(cfg, shape, *, chips, model_par, dp_total,
                   accum: int) -> float:
    """Per-chip HBM traffic model [bytes/step].

    Counted flows (bf16 compute, f32 optimizer):
      - weights: each pass reads the TP-sharded bf16 weights once;
        train = accum x (fwd + bwd + remat-fwd) = 3*accum passes
      - optimizer: p/m/v f32 read + write, grads f32 read (FSDP-sharded)
      - activations: layer carries r/w per microbatch (bf16)
      - logits/CE: f32 logits + one-hot product r/w (vocab TP-sharded)
      - decode/prefill: the state/cache read (+write at prefill)
    """
    total, active, mm = _param_counts(cfg)
    b, s = shape.batch, shape.seq
    v = cfg.padded_vocab
    d = cfg.d_model
    layers = cfg.num_layers + cfg.num_decoder_layers
    w_shard = 2.0 * active / model_par          # bf16 TP shard

    if shape.kind == "train":
        tok_chip = b * s / dp_total
        weights = 3.0 * accum * w_shard
        opt = 5.0 * total * 4.0 / chips  # p,m,v reads + p,m writes (f32)
        acts = layers * tok_chip * d * 2.0 * 2.0 * 2.0  # save+reread, bf16
        logits = tok_chip * (v / model_par) * 4.0 * 4.0
        return weights + opt + acts + logits

    if shape.kind == "prefill":
        tok_chip = b * s / dp_total
        weights = w_shard
        acts = layers * tok_chip * d * 2.0 * 2.0
        cache = decode_state_bytes(cfg, b, s) / chips
        return weights + acts + cache

    # decode: weights + full state read (+ tiny write)
    cache = decode_state_bytes(cfg, b, s) / chips
    return w_shard + cache


def roofline_terms(cfg, shape, *, chips, model_par, dp_total,
                   accum: int) -> dict:
    """The three terms of one cell [s/step/chip] and the dominant one."""
    flops = analytic_flops(cfg, shape)["flops"] / chips
    terms = {
        "compute": flops / PEAK_FLOPS,
        "memory": analytic_bytes(cfg, shape, chips=chips,
                                 model_par=model_par, dp_total=dp_total,
                                 accum=accum) / HBM_BW,
        "collective": analytic_collective_bytes(
            cfg, shape, chips=chips, model_par=model_par,
            dp_total=dp_total, accum=accum) / LINK_BW,
    }
    terms["dominant"] = max(("compute", "memory", "collective"),
                            key=lambda k: terms[k])
    return terms


def roofline_accum(cfg, shape, dp_total: int) -> int:
    """The accum steps the roofline charges a cell (JAX's ``build_rows``
    rule: the override or the default, clamped to the per-DP batch)."""
    from repro_torch.launch.steps import CELL_OVERRIDES, default_accum_steps

    if shape.kind != "train":
        return 1
    accum = CELL_OVERRIDES.get((cfg.name, shape.name), {}).get(
        "accum_steps") or default_accum_steps(cfg, shape, dp_total)
    return max(1, min(accum, shape.batch // dp_total))


# ---------------------------------------------------------------------------
# roofline table
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_per_chip: float | None    # no HLO in the port: None
    analytic_flops_per_chip: float
    corr: float                         # 1: nothing to correct against
    useful_frac: float          # MODEL_FLOPS / analytic total
    mem_gib: float              # argument bytes a rank
    status: str

    def bottleneck_sentence(self) -> str:
        moves = {
            "compute": "faster tensor-core kernels / lower remat would "
                       "cut it",
            "memory": "smaller dtypes, better fusion or larger per-chip "
                      "batch raises arithmetic intensity",
            "collective": "resharding to cut all-gathers (more DP, less TP) "
                          "or overlap would hide it",
        }
        return moves[self.dominant]


def build_rows(dryrun_records, get_config, shapes) -> list[RooflineRow]:
    rows = []
    for rec in dryrun_records:
        if rec["status"] != "ok":
            continue
        if rec["shape"] not in shapes:
            continue  # extra cells (e.g. the chgnet production cell)
        cfg = get_config(rec["arch"])
        shape = shapes[rec["shape"]]
        multi = rec["mesh"] == "2x16x16"
        chips = 512 if multi else 256
        model_par = 16
        dp_total = chips // model_par
        accum = roofline_accum(cfg, shape, dp_total)
        ana = analytic_flops(cfg, shape)
        terms = roofline_terms(cfg, shape, chips=chips, model_par=model_par,
                               dp_total=dp_total, accum=accum)
        rows.append(RooflineRow(
            arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
            chips=chips, compute_s=terms["compute"],
            memory_s=terms["memory"], collective_s=terms["collective"],
            dominant=terms["dominant"],
            model_flops=ana["model_flops"],
            hlo_flops_per_chip=None,
            analytic_flops_per_chip=ana["flops"] / chips,
            corr=1.0,
            useful_frac=ana["model_flops"] / max(ana["flops"], 1.0),
            mem_gib=rec["memory"]["argument_bytes"] / 2**30,
            status=rec["status"],
        ))
    return rows


def to_markdown(rows: list[RooflineRow]) -> str:
    out = ["| arch | shape | mesh | compute s | memory s | coll s | "
           "dominant | useful (6ND/total) | roofline frac | arg GiB |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r.arch, r.shape, r.mesh)):
        bound = max(r.compute_s, r.memory_s, r.collective_s)
        frac = r.compute_s / bound if bound > 0 else 0.0
        out.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.2e} | "
            f"{r.memory_s:.2e} | {r.collective_s:.2e} | {r.dominant} | "
            f"{r.useful_frac:.2f} | {frac:.2f} | {r.mem_gib:.1f} |")
    return "\n".join(out)


def load_and_build(dryrun_path: str):
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES

    with open(dryrun_path) as f:
        recs = json.load(f)
    return build_rows(recs, get_config, SHAPES), recs
