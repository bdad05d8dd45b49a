"""Shard placement: the counterpart of the JAX package's parallel/mesh.py.

A ``Mesh`` is the ordered list of devices the node dimension is sharded
over: shard i owns global rows [i * rows_loc, (i + 1) * rows_loc) of the
[rows, 128] layout and lives on ``mesh.devices[i]``. Nothing is inferred:
by default shard i goes to ``cuda:i`` and ``make_mesh`` raises when fewer
cards are visible, as the JAX ``make_mesh`` does; an explicit ``devices``
list places the shards as named, which is how several shards share one
device (``["cuda:0"] * 4`` on one card, ``["cpu"] * 4`` in the CPU tests:
the counterpart of the JAX tests' forced host devices).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shard i's device is ``devices[i]``."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def _resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"shard device {dev} named, but no CUDA device "
                               "is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"shard device {dev} named, but "
                             f"{torch.cuda.device_count()} CUDA device(s) visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported shard device {dev}; expected cuda or cpu")
    return dev


def make_mesh(n_devices: int, devices: Optional[Sequence] = None,
              platform: str = "cuda") -> Mesh:
    """The placement of ``n_devices`` shards. ``devices`` names each
    shard's device (its length must be ``n_devices``); without it shard i
    goes to device i of ``platform``, and there must be ``n_devices`` of
    them (one CPU device is visible, so the CPU needs the explicit list)."""
    if devices is not None:
        if len(devices) != n_devices:
            raise ValueError(
                f"devices names {len(devices)} device(s) for n_devices={n_devices}"
            )
        return Mesh(tuple(_resolve(d) for d in devices))
    visible = (torch.cuda.device_count() if platform == "cuda"
               and torch.cuda.is_available() else int(platform == "cpu"))
    if n_devices < 1 or n_devices > visible:
        raise ValueError(
            f"n_devices={n_devices} out of range; {visible} {platform} device(s) "
            "visible (name the shards' devices to place several on one device)"
        )
    return Mesh(tuple(torch.device(platform, i) if platform == "cuda"
                      else torch.device("cpu") for i in range(n_devices)))


def put_rows(mesh: Mesh, rows_loc: int,
             rows_fn: Callable[[int, int, torch.device], torch.Tensor]) -> list:
    """Per-shard construction of a row-sharded plane: shard i's block is
    ``rows_fn(lo, hi, device)`` for its global rows [lo, hi), built on its
    own device, so no global host array exists (the JAX put_rows)."""
    return [rows_fn(i * rows_loc, (i + 1) * rows_loc, dev).contiguous()
            for i, dev in enumerate(mesh.devices)]


def flat_ids(lo: int, hi: int, lanes: int, device) -> torch.Tensor:
    """int64 [hi - lo, lanes] global flat ids of rows [lo, hi)."""
    return torch.arange(lo * lanes, hi * lanes, dtype=torch.int64,
                        device=device).reshape(hi - lo, lanes)
