"""What a traffic generator hands back from its window."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    index: int
    seed: int
    due: float                      # host clock (perf_counter) it was due
    done: Optional[float] = None    # when its result reached the client
    output: object = None           # (3, H, W) float in [0, 1] or (H, W, 3) uint8
    error: Optional[str] = None

    def image(self) -> torch.Tensor:
        """(3, H, W) float32 in [0, 1] on the host."""
        out = self.output
        if isinstance(out, np.ndarray):
            return torch.from_numpy(out).permute(2, 0, 1).float() / 255.0
        return out.float()


@dataclasses.dataclass
class Outcome:
    t0: float                       # the window's start (perf_counter)
    t1: float                       # its end
    requests: list                  # every request due in the window
    completed_in_window: list       # the requests the rate counts
    steps: int
    guidance: float
    serving: Optional[dict] = None  # the engine's counters over the window
    # a traced run's untraced first part: when it ended, and the engine's
    # counters over it
    t_split: Optional[float] = None
    serving_untraced: Optional[dict] = None
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def untraced(self) -> list:
        """The requests completed in a traced run's untraced part."""
        if self.t_split is None:
            return []
        return [r for r in self.completed_in_window if r.done <= self.t_split]

    @property
    def failed(self) -> list:
        return [r for r in self.requests if r.done is None or r.error]
