"""Mixed-precision policy and loss scaling (DESIGN.md §4), PyTorch port of
``repro.precision``.

  - ``PrecisionPolicy``: a frozen 4-dtype contract (``param_dtype``
    storage, ``compute_dtype`` GEMM and kernel operands, ``accum_dtype``
    reductions, LayerNorm statistics and kernel accumulators,
    ``output_dtype`` public model outputs), selected by
    ``CHGNetConfig.precision`` (``"f32" | "bf16" | "mixed"``) through
    ``resolve_policy``.  The dtypes are stored as names, so the policy is
    hashable; its properties return ``torch.dtype``s.
  - ``LossScaleConfig`` and the loss scaler: static and dynamic variants
    with the inf/nan skip-and-halve update.  The scaler state is a dict of
    two 0-d CPU tensors that lives in the optimizer state
    (``opt_state["loss_scale"]``), host bookkeeping like Adam's step
    count: the trainer decides a skip on the host (``train.trainer``).

Cast boundaries, as in the JAX package: parameters are stored in
``param_dtype`` and cast to ``compute_dtype`` at their use sites; the
geometry and the bases (envelopes, RBF, Fourier) stay in ``accum_dtype``;
every edge -> node and per-crystal reduction accumulates in
``accum_dtype``; public outputs are cast to ``output_dtype``.  The port
casts explicitly at these boundaries and never uses ``torch.autocast``,
which casts at other places (LayerNorm) and keeps some products in f32.
"""
from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Frozen dtype contract; dtypes are stored as names."""

    name: str = "f32"
    param_dtype: str = "float32"    # parameter storage (master weights)
    compute_dtype: str = "float32"  # GEMM / kernel operand dtype
    accum_dtype: str = "float32"    # reductions, LN stats, kernel accums
    output_dtype: str = "float32"   # public model outputs

    @property
    def param(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def compute(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def accum(self) -> torch.dtype:
        return _DTYPES[self.accum_dtype]

    @property
    def output(self) -> torch.dtype:
        return _DTYPES[self.output_dtype]

    @property
    def low_precision_compute(self) -> bool:
        return self.compute != torch.float32

    @property
    def needs_master_weights(self) -> bool:
        """True when parameters are stored below f32 and the optimizer
        keeps an f32 master copy (``optim.adam.adam_init``)."""
        return self.param != torch.float32


def cast_float_tree(tree, dtype: torch.dtype):
    """Every floating leaf of a tree of tensors cast to ``dtype``, integer
    and bool leaves passed through.  Always makes new tensors, even where
    the cast is a no-op, as the JAX package does: the result backs master
    weights that Adam updates in place beside the parameters they were
    cast from (the f32-pinned ``rbf_freqs`` under the bf16 policy)."""
    if isinstance(tree, dict):
        return {k: cast_float_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_float_tree(v, dtype) for v in tree]
    if tree.is_floating_point():
        return tree.detach().to(dtype, copy=True)
    return tree


F32 = PrecisionPolicy(name="f32")
# bf16 storage and compute; accumulation stays f32
BF16 = PrecisionPolicy(name="bf16", param_dtype="bfloat16",
                       compute_dtype="bfloat16")
# the recommended training policy: f32 master parameters and
# accumulation, bf16 GEMM and kernel operands
MIXED = PrecisionPolicy(name="mixed", compute_dtype="bfloat16")

POLICIES = {"f32": F32, "bf16": BF16, "mixed": MIXED}


def resolve_policy(precision: str | PrecisionPolicy) -> PrecisionPolicy:
    """``"f32" | "bf16" | "mixed"`` (or an explicit policy) -> policy."""
    if isinstance(precision, PrecisionPolicy):
        return precision
    try:
        return POLICIES[precision]
    except KeyError:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of "
            f"{sorted(POLICIES)} or a PrecisionPolicy") from None


# ---------------------------------------------------------------------------
# Loss scaling: static and dynamic (inf/nan skip-and-halve) variants
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LossScaleConfig:
    """Loss-scaler recipe.  ``kind``:

    - ``"auto"``   : dynamic when the policy computes below f32, else none
    - ``"none"``   : no scaling, no skip logic (the f32 path)
    - ``"static"`` : fixed ``init_scale``; non-finite grads still skip the
                     update, the scale never moves
    - ``"dynamic"``: skip-and-halve on inf/nan grads, double after
                     ``growth_interval`` consecutive finite steps
    """

    kind: str = "auto"
    init_scale: float = 2.0 ** 12
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 200
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 16

    def resolved_kind(self, policy: PrecisionPolicy | str) -> str:
        if self.kind != "auto":
            return self.kind
        return "dynamic" if resolve_policy(policy).low_precision_compute \
            else "none"


def loss_scale_init(cfg: LossScaleConfig) -> dict:
    """Scaler state: the scale (f32) and the run of finite steps (int32),
    0-d CPU tensors."""
    return {"scale": torch.tensor(cfg.init_scale, dtype=torch.float32),
            "good_steps": torch.zeros((), dtype=torch.int32)}


def scale_loss(loss: torch.Tensor, state: dict) -> torch.Tensor:
    return loss * state["scale"].to(loss.dtype)


def loss_scale_update(state: dict, grads_finite, cfg: LossScaleConfig,
                      kind: str) -> dict:
    """The skip-and-halve state machine; a no-op for the static variant.
    ``grads_finite`` is a bool or a 0-d bool tensor."""
    if kind == "static":
        return state
    finite = torch.as_tensor(grads_finite, dtype=torch.bool)
    scale, good = state["scale"], state["good_steps"]
    good = torch.where(finite, good + 1, torch.zeros_like(good))
    grow = good >= cfg.growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grow, torch.clamp(scale * cfg.growth_factor,
                                      max=cfg.max_scale), scale),
        torch.clamp(scale * cfg.backoff_factor, min=cfg.min_scale))
    good = torch.where(grow, torch.zeros_like(good), good)
    return {"scale": new_scale, "good_steps": good}
