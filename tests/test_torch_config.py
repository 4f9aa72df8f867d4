"""Port skeleton: Config parity, the no-jax import rule, and the averaging
nanmedian the port needs where jnp.nanmedian and torch.nanmedian differ."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr3_tpu.utils import config as jax_config
from dr3_tpu_torch.utils.config import Config
from dr3_tpu_torch.utils.stats import nanmedian

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_fields_and_defaults_match():
    ref = [(f.name, f.type, f.default) for f in dataclasses.fields(jax_config.Config)]
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(Config)]
    assert got == ref
    assert dataclasses.asdict(Config()) == dataclasses.asdict(jax_config.Config())


def test_config_overrides_match():
    argv = ["--klt-iters=7", "--loop_closure=false", "--kf_disparity=12.5",
            "--ba_solver=pcg"]
    assert dataclasses.asdict(Config.from_cli(argv)) == \
        dataclasses.asdict(jax_config.Config.from_cli(argv))
    with pytest.raises(ValueError):
        Config.from_dict({"no_such_field": 1})


def test_port_imports_neither_jax_nor_dr3_tpu():
    """Every module of dr3_tpu_torch, and chip_smoke.py, import cleanly in a
    fresh interpreter without pulling in jax or dr3_tpu; the port's entry
    points (entry.py's step, bench.py's window problem, which import
    inside their functions) run there without pulling in them or the
    repository's root entry points, bench.py and __graft_entry__.py."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import numpy as np\n"
        "import dr3_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dr3_tpu_torch.__path__, 'dr3_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "from dr3_tpu_torch import bench, entry\n"
        "step, args = entry.entry(device='cpu')\n"
        "step(*args)\n"
        "bench._window_problem(np.random.default_rng(0), n_cams=3, n_pts=40, n_tracks=20)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dr3_tpu' or m.startswith('dr3_tpu.') or m in ('bench', '__graft_entry__')]\n"
        "assert not bad, bad\n"
        "assert 'dr3_tpu_torch.entry' in names and 'dr3_tpu_torch.bench' in names\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_long_sequence_run_imports_neither_jax_nor_dr3_tpu():
    """A whole run of the long-sequence entry point (its imports inside the
    functions included) in a fresh interpreter, on the CPU at 320x240,
    leaves jax and dr3_tpu unimported."""
    code = (
        "import sys\n"
        "from dr3_tpu_torch.tools import run_long_sequence as t\n"
        "assert t.main(['--frames', '8', '--device', 'cpu']) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dr3_tpu' or m.startswith('dr3_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'dr3_tpu_torch.pipelines.vo' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"frames": 8' in out.stdout.splitlines()[-1]


def test_port_sources_import_no_jax_pallas_or_compile():
    """The acceptance grep: no jax / dr3_tpu / root bench.py or
    __graft_entry__.py import, no Pallas, no
    torch.compile, no fused attention operator in the port or its smoke."""
    import re

    banned_import = re.compile(r"^\s*(import jax|from jax|import dr3_tpu\b|from dr3_tpu\b"
                               r"|import bench\b|from bench\b|import __graft_entry__"
                               r"|from __graft_entry__)")
    pallas_import = re.compile(r"^\s*(import|from)\s+\S*pallas")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "dr3_tpu_torch")):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    for path in files:
        for line in open(path):
            assert not banned_import.match(line), (path, line)
            assert not pallas_import.match(line), (path, line)
            assert "torch.compile(" not in line, (path, line)
            assert "scaled_dot_product_attention" not in line, (path, line)


@pytest.mark.parametrize("case", ["even", "odd", "with_nan_even", "with_nan_odd",
                                  "all_nan", "single"])
def test_nanmedian_averages_like_jnp(case, rng):
    """jnp.nanmedian averages the two middle values of an even count;
    torch.nanmedian takes the lower one. The port's helper must match jnp
    (float32 round-off of the average: rtol 1e-6)."""
    x = rng.normal(size=10).astype(np.float32)
    if case == "odd":
        x = x[:9]
    elif case == "with_nan_even":
        x[[1, 4]] = np.nan          # 8 finite values
    elif case == "with_nan_odd":
        x[[1, 4, 7]] = np.nan       # 7 finite values
    elif case == "all_nan":
        x[:] = np.nan
    elif case == "single":
        x = x[:1]
    want = float(jnp.nanmedian(jnp.asarray(x)))
    got = float(nanmedian(torch.as_tensor(x)))
    if np.isnan(want):
        assert np.isnan(got)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    if case == "even":
        assert got != float(torch.nanmedian(torch.as_tensor(x)))
