"""The package's default device for tables and ray bundles.

Entry points that build tensors (`System.table`, `System.tables`,
`ops.tables.make_table`, `table_from_numpy`, `parallel.grad.
bundles_from_system`, `bundles_from_numpy`, `optimize_system`) take
`device=None`, and None means `default_device()`.  The default is the
CUDA card, whatever the machine has: on a machine without CUDA such a
call raises torch's own error unless the caller asks for the CPU, with
`set_default_device("cpu")` or `device="cpu"`.  No CPU fallback hides
a missing card.
"""

import torch

_default = torch.device("cuda")


def default_device():
    """The device that entry points use when they are given none."""
    return _default


def set_default_device(device):
    """Make `device` (a torch.device or a string such as "cpu" or
    "cuda:1") the default; returns the previous default."""
    global _default
    old, _default = _default, torch.device(device)
    return old


def resolve_device(device):
    """`device` as a torch.device, or the default for None."""
    return _default if device is None else torch.device(device)
