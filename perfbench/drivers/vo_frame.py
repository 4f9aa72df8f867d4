"""Driver ``vo_frame``: an online caller, such as a robot, that needs each
pose before it sends the next frame: ``MonoVO.process`` one frame at a
time in a closed loop. A frame's latency runs from handing it to
``process`` until its pose is on the host (``process`` returns it as a
numpy matrix). ``vo_frame_p95_ms`` is the 95th percentile of every frame
of the window."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from perfbench import kernel_bounds, vo_common
from perfbench.vo_common import now


# the program's entry points this driver feeds (module:name)
PROGRAM = {"MonoVO": "dr3_tpu_torch.pipelines.vo:MonoVO",
           "Config": "dr3_tpu_torch.utils.config:Config",
           "Pinhole": "dr3_tpu_torch.models.camera:Pinhole"}


def setup(ctx):
    seq = vo_common.Sequence(ctx.config, ctx.traffic, ctx.seed)
    vo = vo_common.make_vo(ctx, seq)
    k = vo_common.warm_up(ctx, vo, seq, lambda k: vo.process(seq.frame(k)), 1)
    return SimpleNamespace(seq=seq, vo=vo, next_frame=k)


def window(state, ctx, seconds: float) -> dict:
    vo, seq = state.vo, state.seq
    k0 = state.next_frame
    k = k0
    lat = []
    vo.monitor = type(vo.monitor)()          # the window's own stage timers
    ctx.sync()
    t0 = now()
    with ctx.count_syncs() as reads:
        while now() - t0 < seconds:
            img = seq.frame(k)
            t = now()
            vo.process(img)
            lat.append(now() - t)
            k += 1
    state.window_start, state.window_end, state.next_frame = k0, k, k
    lat_ms = 1e3 * np.asarray(lat)
    is_kf = np.zeros(len(lat), bool)
    for s in vo.stats:
        if k0 <= s.frame_id < k and s.is_keyframe:
            is_kf[s.frame_id - k0] = True
    ba = vo.monitor.timers.get("local_BA")
    ctx.log(f"vo_frame: {len(lat)} frames, median {np.median(lat_ms):.3f} ms, "
            f"{int(is_kf.sum())} keyframes")
    return dict(
        metrics={"vo_frame_p95_ms": float(np.percentile(lat_ms, 95))},
        attempted=len(lat), failed=0,
        obs=dict(frames=len(lat), host_reads=reads.count, latency_ms=lat_ms.tolist(),
                 is_keyframe=is_kf.tolist(),
                 local_ba_ms=[] if ba is None or ba.n == 0 else [1e3 * ba.average] * ba.n,
                 window_ba=ba.n if ba is not None else 0,
                 relocalizations=vo.n_relocalizations))


def trace_slice(state, ctx) -> None:
    """``trace_frames`` more frames, each under a ``process`` range."""
    vo, seq = state.vo, state.seq
    with kernel_bounds.counting() as ctx.kernel_launches:
        for _ in range(int(ctx.traffic["trace_frames"])):
            with ctx.span("process"):
                vo.process(seq.frame(state.next_frame))
            state.next_frame += 1


def finish(state) -> None:
    vo_common.keep_outputs(state, state.vo)
    state.vo = None


readings = vo_common.readings
