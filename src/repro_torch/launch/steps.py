"""LM step builders of the port: PyTorch port of ``repro.launch.steps``.

``lm_grads`` splits the batch into ``accum_steps`` microbatches
(microbatch-major, as ``build_cell``'s ``to_micro``), sums their
gradients and divides by K.  ``make_lm_train_step`` then optionally
rounds those gradients through bf16 (the compressed all-reduce's
rounding), clips them by their global norm (``optim.grad.
clip_by_global_norm``'s scale, applied in place) and takes one Adam step
in place.  The step is eager: the JAX version's donation of parameters
and moments is the in-place update here.

``build_cell`` builds one (arch x shape) cell's step as JAX's does, with
``param_structs``, ``CELL_OVERRIDES`` and ``default_accum_steps``: the
step function, its arguments as ``meta`` tensors (``configs.shapes``),
their spec tuples under JAX's mesh layout, the donated argument indices
and the outputs' specs.  The steps run eagerly on real tensors that the
caller places on one device (the card or the CPU): the port shards
nothing, and the specs are data for the dry run (``launch.dryrun``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.shapes import (
    Shape,
    decode_state_structs,
    input_specs,
    to_meta,
)
from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models.api import family_fns
from repro_torch.models.config import LMConfig
from repro_torch.models.layers import cast_floats
from repro_torch.optim.adam import adam_init, adam_update
from repro_torch.optim.grad import global_norm
from repro_torch.optim.tree import leaves


def lm_grads(cfg: LMConfig, params, inputs, accum_steps: int = 1,
             **loss_kw):
    """``(loss, grads)``: the mean loss over ``accum_steps`` microbatches
    of ``inputs`` (the family's: tokens or whisper's frames, labels, and
    positions where the family has them), a 0-d f32 tensor, and the
    gradients of ``params``' leaves (in ``leaves`` order; the leaves are
    set to require gradients) summed over the microbatches and divided
    by K.  ``loss_kw`` goes to the family's loss (``ssd_chunk``)."""
    loss_fn = family_fns(cfg).loss
    b = inputs[0].shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps} "
                         "microbatches")
    micro = [x.reshape(accum_steps, b // accum_steps, *x.shape[1:])
             for x in inputs]
    flat = [p.requires_grad_() for p in leaves(params)]
    gsum, loss_sum = None, torch.zeros((), device=flat[0].device)
    for i in range(accum_steps):
        loss = loss_fn(cfg, params, *(m[i] for m in micro), **loss_kw)
        grads = list(torch.autograd.grad(loss, flat))
        if gsum is None:
            gsum = grads
        else:
            torch._foreach_add_(gsum, grads)
        loss_sum = loss_sum + loss.detach()
        del grads
    # in place from here: at LM scale each copy of the gradients is
    # 4 bytes a parameter (6 GB for 1.5 B)
    with torch.no_grad():
        torch._foreach_div_(gsum, float(accum_steps))
    return loss_sum / accum_steps, gsum


def make_lm_train_step(cfg: LMConfig, *, accum_steps: int = 1,
                       lr: float = 1e-4, grad_clip: float = 1.0,
                       compress_grads: bool = False, **loss_kw):
    """``train_step(params, opt_state, *inputs) -> (params, opt_state,
    loss)``, ``inputs`` the family's (``lm_grads``): ``params`` (f32
    master weights) and ``opt_state`` (``adam_init``) are updated in
    place, ``loss`` is the microbatches' mean loss, a 0-d f32 tensor on
    the parameters' device.  ``grad_clip=math.inf`` leaves the gradients
    unclipped; ``loss_kw`` goes to the family's loss (the hybrid's
    ``ssd_chunk``)."""

    def train_step(params, opt_state, *inputs):
        loss, grads = lm_grads(cfg, params, inputs, accum_steps, **loss_kw)
        with torch.no_grad():
            if compress_grads:
                for g in grads:
                    g.copy_(g.to(torch.bfloat16))
            torch._foreach_mul_(grads, torch.clamp(
                grad_clip / (global_norm(grads) + 1e-12), max=1.0))
        params, opt_state = adam_update(grads, opt_state, params, lr)
        return params, opt_state, loss

    return train_step


# ---------------------------------------------------------------------------
# (arch x shape) cells
# ---------------------------------------------------------------------------

def param_structs(cfg: LMConfig, dtype=None):
    """The family's parameter tree as ``meta`` tensors (no storage),
    floating leaves in ``dtype`` where given."""
    tree = family_fns(cfg).init(cfg, 0, device="meta")
    if dtype is not None:
        d = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        tree = cast_floats(tree, d)
    return tree


# Per-cell memory-policy overrides of the JAX package's perf iterations
# (its EXPERIMENTS.md): nested-scan remat + deeper gradient accumulation
# for the deepest / largest model.
CELL_OVERRIDES: dict[tuple[str, str], dict] = {
    ("qwen1.5-110b", "train_4k"): {"accum_steps": 16, "layer_block": 8},
    # accum 8 -> 4 halves the per-step FSDP weight gathers
    ("llama3-8b", "train_4k"): {"accum_steps": 4},
}


def default_accum_steps(cfg: LMConfig, shape: Shape, dp_total: int,
                        target_tokens_per_dev: int = 8192) -> int:
    """Microbatch count: keep ~target tokens per device per microbatch
    (activation-memory control; same total FLOPs)."""
    per_dev = max(1, shape.batch // dp_total)
    want = max(1, (per_dev * shape.seq) // target_tokens_per_dev)
    accum = min(per_dev, want)
    while per_dev % accum != 0:  # must divide the per-device batch
        accum -= 1
    return max(1, accum)


_PALLAS_FAMILIES = ("dense", "moe", "vlm", "hybrid")


def build_cell(cfg: LMConfig, shape: Shape, mesh, *, multi_pod: bool,
               attn_chunk: int = 1024, lr: float = 1e-4,
               grad_clip: float = 1.0, accum_steps: int | None = None,
               serve_dtype="bfloat16", compress_grads: bool = False,
               use_pallas: bool = False):
    """One (arch x shape) cell: ``(step, args, specs, donate,
    out_specs)``, as ``repro.launch.steps.build_cell`` returns ``(step,
    args, in_shardings, donate, out_shardings)``.

    ``mesh`` is a ``launch.mesh`` mesh (its sizes set the specs and the
    DP extent).  ``args`` are ``meta`` tensors: the parameters (f32 to
    train, ``serve_dtype`` to serve), Adam's state to train, then the
    cell's inputs (``configs.shapes.input_specs``).  The train step is
    ``make_lm_train_step`` at the cell's accum steps (``step.
    accum_steps``) and returns ``(params, opt_state, loss)``, updated in
    place; prefill returns the greedy next token and the decode state
    (whisper: JAX's placeholder token 0); decode returns the greedy token
    and the new state.  ``use_pallas`` runs the gated MLPs of the serving
    steps on the fused SwiGLU kernel (dense / MoE / VLM / hybrid).  JAX's
    GSPMD anchors (batch, vocab and expert axes) and the ``layer_block``
    remat policy have no counterpart: the forwards get ``attn_mode`` and
    ``chunk`` where JAX's do."""
    sizes = mesh_sizes(mesh)
    fns = family_fns(cfg)
    specs = fns.specs(cfg, sizes)
    p_structs = param_structs(
        cfg, dtype=None if shape.kind == "train" else serve_dtype)
    io = input_specs(cfg, shape, multi_pod=multi_pod, mesh_sizes=sizes)
    dp_total = 1
    for a in (("pod", "data") if multi_pod else ("data",)):
        dp_total *= sizes.get(a, 1)
    if accum_steps is None:
        accum_steps = CELL_OVERRIDES.get((cfg.name, shape.name), {}).get(
            "accum_steps")
    if shape.kind == "train":
        if accum_steps is None:
            accum_steps = default_accum_steps(cfg, shape, dp_total)
        # the microbatch must stay divisible by the DP extent, and K must
        # divide the batch
        accum_steps = max(1, min(accum_steps, shape.batch // dp_total))
        while shape.batch % accum_steps != 0:
            accum_steps -= 1
    fw = {}
    if cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
        fw = {"attn_mode": "chunked", "chunk": attn_chunk}
    compute = getattr(torch, cfg.compute_dtype)
    pallas = {"use_pallas": use_pallas} \
        if cfg.family in _PALLAS_FAMILIES else {}

    if shape.kind == "train":
        opt_structs = to_meta(adam_init(p_structs))
        opt_specs = {"mu": specs, "nu": specs, "count": ()}
        train_step = make_lm_train_step(
            cfg, accum_steps=accum_steps, lr=lr, grad_clip=grad_clip,
            compress_grads=compress_grads, **fw)
        train_step.accum_steps = accum_steps
        args = (p_structs, opt_structs) + io["args"]
        return (train_step, args, (specs, opt_specs) + io["specs"], (0, 1),
                (specs, opt_specs, ()))

    _, state_spec = decode_state_structs(
        cfg, shape.batch, shape.seq, multi_pod=multi_pod, mesh_sizes=sizes)
    if shape.kind == "prefill":
        max_len = shape.seq
        kw = {} if cfg.family == "rwkv" else {"chunk": attn_chunk}

        @torch.no_grad()
        def prefill_step(params, *inputs):
            params = cast_floats(params, compute)
            x, pos = inputs[0], (inputs[1] if len(inputs) > 1 else None)
            logits, cache = fns.prefill(cfg, params, x, pos, max_len,
                                        **kw, **pallas)
            return torch.argmax(logits[..., -1, :], dim=-1), cache

        return (prefill_step, (p_structs,) + io["args"],
                (specs,) + io["specs"], (), ((), state_spec))

    @torch.no_grad()
    def decode_step(params, tokens, state, *rest):
        params = cast_floats(params, compute)
        if isinstance(state.get("pos"), torch.Tensor):
            state = dict(state, pos=int(state["pos"]))
        logits, new_state = fns.decode_step(cfg, params, tokens, state,
                                            *rest, **pallas)
        return torch.argmax(logits, dim=-1), new_state

    # the state is donated (index 2: params 0, tokens 1, state 2)
    return (decode_step, (p_structs,) + io["args"], (specs,) + io["specs"],
            (2,), ((), state_spec))
