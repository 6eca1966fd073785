"""Constant-bound lookup filter for the query executor.

Query plans filter candidate rows by constant equality / set membership:
the constants are sorted and each candidate is tested with the
``sorted_member`` kernel (its plain version for tensors on the CPU), so
the executor has a single entry point.
"""

from __future__ import annotations

import torch

from . import ops
from .sorted_member import sorted_member

__all__ = ["in_set"]


def in_set(values: torch.Tensor, constants) -> torch.Tensor:
    """Boolean mask ``values[i] in constants``, on ``values``' device.

    ``constants`` is a tensor or a sequence of ids.  On a card the call
    launches ``sorted_member`` and is metered in the registry
    (``kernels.in_set.*``, as :mod:`.ops` meters the facade); on the CPU
    it takes the plain version and is not metered."""
    values = values.to(torch.int64).contiguous()
    constants = torch.as_tensor(constants, dtype=torch.int64, device=values.device)
    if values.shape[0] == 0 or constants.shape[0] == 0:
        return torch.zeros(values.shape[0], dtype=torch.bool, device=values.device)
    mask = sorted_member(values, torch.sort(constants.reshape(-1)).values)
    ops.metered("in_set", values.numel(), values)
    return mask
