"""A party's local devices, the device list that within-party sharding
(gwas/matmult.py: mat_mult_sharded, set_pipeline_devices) spreads a
product over.

The JAX package keeps within-party sharding inside one process: arrays are
placed on a party's chips and combined on the first one, with no collective
library.  Here the same is plain torch over a list of devices.
"""

from __future__ import annotations

from typing import List

import torch


def local_devices(kind: str = "cuda") -> List[torch.device]:
    """Every local device of a kind: cuda:0 .. cuda:n-1 for "cuda" (none
    without a card), [cpu] for "cpu"."""
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]
