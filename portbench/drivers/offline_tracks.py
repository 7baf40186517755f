"""Offline requests of point tracks alone (`tasks` ["track_2d"]): the
offline driver's requests, window and comparison (drivers/offline.py). Its
traced slice wraps the stages such a request runs: the encoder, the stitch
(called with no dense task) and the track stage; no dense head runs."""

from __future__ import annotations

from portbench.drivers import offline

STAGES = ("encode_windows", "stitch_dense_outputs", "run_track_chunked")


class Cell(offline.Cell):
    def traced_slice(self):
        # the offline slice wraps and requires every stage of offline.STAGES; this mix runs three of them
        kept, offline.STAGES = offline.STAGES, STAGES
        try:
            return super().traced_slice()
        finally:
            offline.STAGES = kept
