"""Training data scheduling: port of `proportional_schedule`
(flash_vstream_tpu/train/data.py:358). The LLaVA datasets and collators of
that module are not part of the port (ROADMAP A16)."""
from __future__ import annotations

from typing import Dict, List


def proportional_schedule(sizes: Dict, total_steps: int) -> List:
    """Deterministic largest-remainder interleaving: each step draws from one
    group, groups picked in proportion to their size (a 9:1 dataset trains
    its groups 9:1). Keys keep their insertion order for tie-breaking."""
    keys = list(sizes)
    total = sum(sizes.values())
    credit = {k: 0.0 for k in keys}
    schedule = []
    for _ in range(total_steps):
        for k in keys:
            credit[k] += sizes[k] / total
        pick = max(keys, key=lambda k: credit[k])
        credit[pick] -= 1.0
        schedule.append(pick)
    return schedule
