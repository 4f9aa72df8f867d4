"""The port's driver entry points (dr3_tpu_torch/entry.py) against the
repository's ``__graft_entry__.py`` on the CPU.

``entry()``: the nine example inputs are drawn from the same generator in
the same order, so the numpy-drawn ones are bit-equal and the previous
frame's pyramid (built by each package) agrees to float32 round-off
(1e-6). The step (pyramid -> LK -> pose GN) runs on two cases. On the
example inputs (uniform noise) LK fails on most tracks and which survive
sits on round-off basins, so the case holds the pyramid to 1e-6, the valid
masks equal, the positions of tracks valid in both to 1e-3 px, the pose to
1e-4 and the cost to 1e-4 relative. On two consecutive rendered 1240x376
frames of the lateral path, where most tracks converge, the same step is
held to the tight tolerances: the masks equal, positions to 1e-3 px, the
pose to 1e-5 and the cost to 1e-4 relative, and the pose to the rendered
motion (1e-2). The JAX step is the one ``__graft_entry__.entry()`` builds;
on the CPU its LK takes the jnp path, which K1 is held against.

``dryrun_multichip(2)``: its printed costs against the JAX original's
(run in a subprocess with two virtual CPU devices; the JAX original's
VO-with-mesh part, which compiles the whole scan program, is stubbed out
there — the port's runs in full and holds itself against one device), and
a 2-rank gloo run of ``python -m dr3_tpu_torch.entry --device cpu``."""

import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from torch_parity import nn, tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def both():
    """(JAX step jitted, JAX args, port step, port args on the CPU)."""
    from __graft_entry__ import entry as jax_entry

    from dr3_tpu_torch.entry import entry

    jstep, jargs = jax_entry()
    step, args = entry(device="cpu")
    return jax.jit(jstep), jargs, step, args


def test_entry_args_match_the_jax_entry(both):
    _, jargs, _, args = both
    assert len(args) == len(jargs) == 9
    for name, a, b in zip(("img_cur", "track_px", "track_valid", "track_point", "map_xyz",
                           "map_valid", "pose_wxyz", "pose_t"), jargs[1:], args[1:]):
        a, b = np.asarray(a), nn(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert len(args[0]) == len(jargs[0]) == 4
    for a, b in zip(jargs[0], args[0]):
        np.testing.assert_allclose(nn(b), np.asarray(a), rtol=0, atol=1e-6)
    assert args[1].device.type == "cpu"


def _compare(jout, out, pos_tol, pose_tol):
    """Hold the port's step outputs against JAX's; returns the valid mask."""
    for a, b in zip(jout[0], out[0]):
        np.testing.assert_allclose(nn(b), np.asarray(a), rtol=0, atol=1e-6)
    jv, v = np.asarray(jout[2]), nn(out[2])
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_allclose(nn(out[1])[v], np.asarray(jout[1])[v], rtol=0, atol=pos_tol)
    np.testing.assert_allclose(nn(out[3]), np.asarray(jout[3]), rtol=0, atol=pose_tol)
    np.testing.assert_allclose(nn(out[4]), np.asarray(jout[4]), rtol=0, atol=pose_tol)
    np.testing.assert_allclose(float(out[5]), float(jout[5]), rtol=1e-4)
    return v


def test_entry_step_matches_jax_on_the_example_inputs(both):
    jstep, jargs, step, args = both
    v = _compare(jstep(*jargs), step(*args), 1e-3, 1e-4)
    # uniform noise: LK keeps few tracks (10 of 546 in both packages)
    assert 0 < v.sum() < 100


def test_entry_step_matches_jax_on_a_rendered_pair(both):
    import jax.numpy as jnp

    from dr3_tpu.ops import pyramid as jpyr
    from dr3_tpu_torch.ops import pyramid
    from dr3_tpu_torch.utils import synth
    from dr3_tpu_torch.utils.config import Config

    jstep, _, step, _ = both
    frames, host, T1 = synth.entry_pair()
    n = host[0].shape[0]
    levels = Config().klt_levels
    jout = jstep(tuple(jpyr.build_pyramid(jnp.asarray(frames[0]), levels)),
                 jnp.asarray(frames[1]), *[jnp.asarray(a) for a in host])
    out = step(tuple(pyramid.build_pyramid(tt(frames[0]), levels)), tt(frames[1]),
               *[tt(a) for a in host])
    v = _compare(jout, out, 1e-3, 1e-5)
    assert v.sum() > 0.9 * n
    # the pose GN recovers the rendered motion
    np.testing.assert_allclose(nn(out[4]), T1.t, atol=1e-2)


_JAX_DRYRUN = """
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
import __graft_entry__ as g
g._dryrun_vo_with_mesh = lambda mesh, n: None
g.dryrun_multichip(2)
"""

_COSTS = re.compile(r"cost (-?[0-9.]+) -> (-?[0-9.]+) OK")


def _costs(text: str) -> list:
    return [tuple(float(x) for x in m) for m in _COSTS.findall(text)]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2", **extra)
    return env


@pytest.fixture(scope="module")
def port_dryrun_costs():
    """The port's dryrun_multichip(2) on the CPU (one process, 2 point
    shards on the CPU), run here: its printed lines' costs."""
    import contextlib
    import io

    from dr3_tpu_torch.entry import dryrun_multichip

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(2, device="cpu")
    text = buf.getvalue()
    assert "VO-with-mesh (2 shards)" in text and text.count(" OK") == 3, text
    return _costs(text)


def test_dryrun_multichip_matches_the_jax_original(port_dryrun_costs):
    out = subprocess.run([sys.executable, "-c", _JAX_DRYRUN], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=2"))
    assert out.returncode == 0, out.stderr[-3000:]
    want = _costs(out.stdout)
    assert len(want) == 2 and len(port_dryrun_costs) == 2, (out.stdout, port_dryrun_costs)
    # flat and 2-level mesh: initial and final cost after one LM step,
    # printed to 3 decimals; float32 round-off across packages (1e-5 relative)
    np.testing.assert_allclose(np.asarray(port_dryrun_costs), np.asarray(want), rtol=1e-5,
                               atol=2e-3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_entry_main_over_two_gloo_ranks(port_dryrun_costs):
    """``python -m dr3_tpu_torch.entry --device cpu`` as 2 ranks (torchrun's
    environment, gloo over localhost): the step, then dryrun_multichip(2)
    with one shard per rank and the 2-level mesh's host axis on the ranks;
    both ranks print the one-process run's costs (to float32 round-off)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dr3_tpu_torch.entry", "--device", "cpu"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                 RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank failed:\n{out[-2000:]}\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out in outs:
        assert "entry() run OK; cost =" in out
        assert "2-level mesh (2x1)" in out and "VO-with-mesh (2 shards)" in out, out
        np.testing.assert_allclose(np.asarray(_costs(out)), np.asarray(port_dryrun_costs),
                                   rtol=1e-5, atol=2e-3)
    assert outs[0] == outs[1]
