"""Fault types of the PyTorch port (``repro.runtime.fault``).

Only ``TransientSampleError`` is here, the exception the ``Prefetcher``
retries and quarantines; ``DivergenceSentinel``, ``GracefulShutdown``,
``run_with_restarts`` and the rest come with ROADMAP 'Modules to port'
item 12.
"""
from __future__ import annotations


class TransientSampleError(RuntimeError):
    """A transiently-bad sample/batch fetch in the data pipeline.

    Carries the offending index so ``data.pipeline.Prefetcher`` can
    quarantine it (log + skip, bounded retry-with-backoff) instead of
    killing the run.  Raisers must leave their iterator resumable: the
    retry re-enters ``__next__`` on the same object.
    """

    def __init__(self, index: int | None = None, msg: str | None = None):
        super().__init__(msg or f"transient sample failure (index={index})")
        self.index = index
