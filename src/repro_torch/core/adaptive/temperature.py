"""Hot / warm / cold key classification from decayed write rates
(port of ``repro.core.adaptive.temperature``, DESIGN.md §8).

Cut-points are *relative* to the mean decayed write rate over active keys
(``EngineConfig.temp_hot_mult`` / ``temp_cold_mult``), so classification
adapts to workload intensity without absolute tuning: under a Zipfian
update stream the head keys sit far above the mean (hot) and the long tail
far below (cold); under uniform traffic everything lands warm and the
temperature split degenerates gracefully to one partition.

The classes drive temperature-partitioned vSSTs
(``values/build.py``): hot records group with hot records so their files
turn to garbage together (GC finds little valid data to rewrite), and cold
records stop riding along through rewrite after rewrite.
"""

from __future__ import annotations

import numpy as np

# canonical definitions live in the table substrate (SSTable.temperature);
# re-exported here as the adaptive layer's public names
from ..engine.tables import TEMP_COLD, TEMP_HOT, TEMP_WARM

__all__ = ["TEMP_COLD", "TEMP_WARM", "TEMP_HOT", "TemperatureMap"]

_EPS_RATE = 1e-12       # division guard when no writes have been observed


class TemperatureMap:
    __slots__ = ("tracker", "hot_mult", "cold_mult")

    def __init__(self, tracker, hot_mult: float, cold_mult: float):
        if not (0 <= cold_mult < hot_mult):
            raise ValueError("need 0 <= temp_cold_mult < temp_hot_mult")
        self.tracker = tracker
        self.hot_mult = float(hot_mult)
        self.cold_mult = float(cold_mult)

    def classify(self, keys: np.ndarray) -> np.ndarray:
        """-> int8 array of TEMP_COLD / TEMP_WARM / TEMP_HOT per key."""
        rate = self.tracker.write_rate(keys)
        base = max(self.tracker.mean_write_rate(), _EPS_RATE)
        return np.where(rate >= self.hot_mult * base, TEMP_HOT,
                        np.where(rate <= self.cold_mult * base,
                                 TEMP_COLD, TEMP_WARM)).astype(np.int8)
