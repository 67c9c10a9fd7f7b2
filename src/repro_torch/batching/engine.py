"""The batching engine: bucket selection + a per-shape step cache.

One ``BatchingEngine`` owns

  - a ``CapacityLadder`` (bucket selection, never truncating), and
  - a ``StepCache`` keyed on ``(name, bucket, batch_size, config)``.

PyTorch runs eagerly, so nothing is compiled: the cache memoizes the
step callables per padded shape so that the number of distinct shapes a
server has stepped stays visible (hits/misses), as the JAX package's
compile cache makes it.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.neighbors import Crystal, GraphIndices

from .capacity import BatchCapacities, CapacityLadder
from .pack import batch_crystals, padding_waste


class StepCache:
    """Memo of built step functions, keyed per padded shape and config."""

    def __init__(self):
        self._fns: dict = {}
        self.hits = 0
        self.misses = 0

    def get(self, key, build: Callable[[], Callable]) -> Callable:
        fn = self._fns.get(key)
        if fn is not None:
            self.hits += 1
            return fn
        self.misses += 1
        fn = self._fns[key] = build()
        return fn

    def __len__(self) -> int:
        return len(self._fns)


class BatchingEngine:
    """Packs crystal lists into bucketed padded batches + caches step fns.

    Tracks padding-waste statistics so the padding cost of bucketing stays
    measurable.
    """

    def __init__(self, ladder: CapacityLadder, *,
                 validate_layout: bool = True):
        self.ladder = ladder
        self.cache = StepCache()
        # sorted-segment layout check on every packed batch (DESIGN.md §1);
        # the kernels walk CSR rows and rely on it
        self.validate_layout = validate_layout
        self.batches_packed = 0
        self._waste_sum = 0.0

    def select(self, crystals: list[Crystal],
               graphs: list[GraphIndices]) -> BatchCapacities:
        """Smallest ladder bucket that fits the batch totals."""
        return self.ladder.bucket_for(
            sum(c.num_atoms for c in crystals),
            sum(g.num_bonds for g in graphs),
            sum(g.num_angles for g in graphs),
        )

    def pack(
        self,
        crystals: list[Crystal],
        graphs: list[GraphIndices],
        *,
        caps: BatchCapacities | None = None,
        num_crystal_slots: int | None = None,
    ):
        """Pack into the smallest fitting bucket; returns (CPU batch, bucket)."""
        caps = caps if caps is not None else self.select(crystals, graphs)
        batch = batch_crystals(
            crystals, graphs, caps, num_crystal_slots=num_crystal_slots,
            validate=self.validate_layout,
        )
        self.batches_packed += 1
        self._waste_sum += padding_waste(batch)
        return batch, caps

    def step(self, name: str, caps: BatchCapacities, batch_size: int,
             config_key, build: Callable[[], Callable]) -> Callable:
        """Memoized step function for ``(name, bucket, batch_size, config)``."""
        return self.cache.get((name, caps, batch_size, config_key), build)

    @property
    def mean_padding_waste(self) -> float:
        return self._waste_sum / self.batches_packed if self.batches_packed else 0.0

    def stats(self) -> dict:
        return {
            "batches_packed": self.batches_packed,
            "mean_padding_waste": self.mean_padding_waste,
            "compile_cache_entries": len(self.cache),
            "compile_cache_hits": self.cache.hits,
            "compile_cache_misses": self.cache.misses,
        }
