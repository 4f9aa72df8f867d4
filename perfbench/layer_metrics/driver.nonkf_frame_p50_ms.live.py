"""Median latency of the window's frames that made no keyframe (the
per-frame general step's replay and its host work), from the harness's
own clock around each MonoVO.process call."""

import statistics


def read(obs):
    lat = [t for t, kf in zip(obs.get("latency_ms", []), obs.get("is_keyframe", [])) if not kf]
    return statistics.median(lat) if lat else None
