"""Hand-written CUDA kernels of the port and their plain torch versions.

Each kernel module keeps a plain integer ``launches``, the launches of its
CUDA kernel in this process. The helpers below read and move all of them
together, for a caller that shows which kernels a run went through.
"""

from __future__ import annotations

import importlib

KERNELS = ("a12_accum", "gather_sum")


def _module(name: str):
    return importlib.import_module(f".{name}", __name__)


def launch_counts() -> dict[str, int]:
    """{kernel module: launches so far}."""
    return {name: _module(name).launches for name in KERNELS}


def set_launch_counts(counts: dict[str, int]) -> None:
    for name, n in counts.items():
        _module(name).launches = n


def add_launches(delta: dict[str, int]) -> None:
    for name, n in delta.items():
        _module(name).launches += n


def reset_launch_counts() -> None:
    set_launch_counts({name: 0 for name in KERNELS})
