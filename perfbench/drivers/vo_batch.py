"""Driver ``vo_batch``: a recorded sequence through the device-resident
frame loop, as ``run_slam`` runs one (``MonoVO.process_batch``, fed
``chunk_frames`` frames a call). ``vo_fps`` is the frames of the chunks
completed in the window over the time from the window's start to the host
read that ends the last of them (``process_batch`` returns the poses on
the host)."""

from __future__ import annotations

from types import SimpleNamespace

from perfbench import kernel_bounds, vo_common
from perfbench.vo_common import now


# the program's entry points this driver feeds (module:name)
PROGRAM = {"MonoVO": "dr3_tpu_torch.pipelines.vo:MonoVO",
           "Config": "dr3_tpu_torch.utils.config:Config",
           "Pinhole": "dr3_tpu_torch.models.camera:Pinhole"}


def setup(ctx):
    seq = vo_common.Sequence(ctx.config, ctx.traffic, ctx.seed)
    vo = vo_common.make_vo(ctx, seq)
    n = int(ctx.traffic["chunk_frames"])

    def step(k):
        vo.process_batch(seq.chunk(k, n))

    k = vo_common.warm_up(ctx, vo, seq, step, n)
    return SimpleNamespace(seq=seq, vo=vo, next_frame=k, chunk=n)


def window(state, ctx, seconds: float) -> dict:
    vo, seq, n = state.vo, state.seq, state.chunk
    k0 = state.next_frame
    base = dict(cg=vo.n_cg_iters, ba=vo.n_window_ba, closures=vo.n_loop_closures)
    k = k0
    ctx.sync()
    t0 = now()
    with ctx.count_syncs() as reads:
        while now() - t0 < seconds:
            vo.process_batch(seq.chunk(k, n))
            k += n
    t1 = now()
    state.window_start, state.window_end, state.next_frame = k0, k, k
    frames = k - k0
    return dict(
        metrics={"vo_fps": frames / (t1 - t0)},
        attempted=frames, failed=0,
        obs=dict(frames=frames, host_reads=reads.count,
                 cg_iters=vo.n_cg_iters - base["cg"], window_ba=vo.n_window_ba - base["ba"],
                 loop_closures=vo.n_loop_closures - base["closures"],
                 keyframes=sum(1 for s in vo.stats if k0 <= s.frame_id < k and s.is_keyframe),
                 relocalizations=vo.n_relocalizations, db_compactions=vo.n_db_compactions))


def trace_slice(state, ctx) -> None:
    """``trace_frames`` more frames, in chunks, each under a
    ``process_batch`` range."""
    vo, seq = state.vo, state.seq
    n = int(ctx.traffic["trace_chunk"])
    with kernel_bounds.counting() as ctx.kernel_launches:
        for _ in range(int(ctx.traffic["trace_frames"]) // n):
            with ctx.span("process_batch"):
                vo.process_batch(seq.chunk(state.next_frame, n))
            state.next_frame += n


def finish(state) -> None:
    vo_common.keep_outputs(state, state.vo)
    state.vo = None


readings = vo_common.readings
