"""Mix kinds, one file each, found by a mix's ``kind``: ``vsbench/kinds/<kind>.py``
gives ``run(cell: Cell) -> Outcome``. It sets up what its requests need
(the index, the requests, the warm-up), runs the window (``window.loop``),
reads the device's peak, and judges what the window produced against the
reference once the program's state is freed. A new kind is a new file."""

from __future__ import annotations

import dataclasses
import torch

from vsbench import window


@dataclasses.dataclass
class Cell:
    """What a kind's ``run`` is handed."""

    name: str
    config: dict
    mix: dict
    # the limits of the numbers compared (``spec.limits``)
    limits: dict
    # the index type's adapter (``vsbench/algos/<algo>.py``)
    algo: object
    base: torch.Tensor
    pool: torch.Tensor
    seed: int
    seconds: float
    # requests that run under the profiler (0: untraced)
    trace_n: int
    device: object
    # host clock at the start of the run
    t0: float


@dataclasses.dataclass
class Outcome:
    setup_s: float
    window: window.Window
    peak_bytes: int
    # name -> check.Number
    numbers: dict
    # requests whose answer failed a number
    failed: int
    # scan kernel family -> least seconds of the traced requests' work
    work: dict = dataclasses.field(default_factory=dict)
