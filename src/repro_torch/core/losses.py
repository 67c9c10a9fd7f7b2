"""Loss weights of the CHGNet objective (paper Eq. 15).

Only the weights are ported so far, for ``configs.chgnet_mptrj.LOSS``;
the Huber losses come with the training step (ROADMAP 'Modules to port'
item 3).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LossWeights:
    energy: float = 2.0
    force: float = 1.5
    stress: float = 0.1
    magmom: float = 0.1
    huber_delta: float = 0.1
