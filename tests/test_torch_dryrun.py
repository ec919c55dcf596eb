"""The dry run (`python -m repro_torch.launch.dryrun`) as a subprocess: on
the (32, 8) production mesh of a fake group of 256 ranks, with no
device, it writes the JAX dry run's record keys for qwen3-0.6b at full
width, skips whisper-tiny x long_500k as JAX's `shape_plan` does, and
keeps a record that fails with its error.  The module and the roofline
and mesh modules it runs load no JAX and nothing of `repro`."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the keys of a record of src/repro/launch/dryrun.py's run_one
JAX_KEYS = {"arch", "shape", "mesh", "chips", "flops_per_chip",
            "bytes_per_chip", "coll_bytes_per_chip", "coll_by_op",
            "model_flops_total", "peak_memory_bytes", "t_compute",
            "t_memory", "t_collective", "bottleneck", "useful_ratio",
            "step_lower_bound", "status", "compile_s", "argument_bytes",
            "output_bytes", "temp_bytes", "cost_method"}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    return env


def _dryrun(out, *args):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
           str(out), *args]
    res = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout, json.loads((out / "dryrun_32x8.json").read_text())


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    return _dryrun(tmp_path_factory.mktemp("dry"), "--arch", "qwen3-0.6b",
                   "--shape", "decode_32k,long_500k")


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_dryrun_records_carry_jax_keys(qwen, shape):
    out, recs = qwen
    rec = recs[f"qwen3-0.6b|{shape}"]
    assert rec["status"] == "ok", rec.get("error")
    assert JAX_KEYS <= set(rec)
    assert rec["mesh"] == "32x8" and rec["chips"] == 256
    assert 0 < rec["useful_ratio"] <= 1
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["step_lower_bound"] == max(
        rec["t_compute"], rec["t_memory"], rec["t_collective"]) > 0
    assert rec["cost_method"].startswith("counted at full depth (L=28")
    # decode: every collective on a known mesh dim
    assert rec["coll_bytes_per_chip"] == sum(rec["coll_by_op"].values())
    assert all(k.split("@")[1] in ("data", "model")
               for k in rec["coll_by_op"])
    assert rec["peak_memory_bytes"] == (rec["argument_bytes"]
                                        + rec["output_bytes"]
                                        + rec["temp_bytes"])
    assert f"[32x8] qwen3-0.6b x {shape}: ok" in out


def test_dryrun_skips_and_keeps_failures(tmp_path):
    """whisper-tiny x long_500k is skipped (a full-attention 448-token
    decoder); an unknown shape's record is kept with its error, and a
    second run with --skip-existing leaves the skipped record alone."""
    out, recs = _dryrun(tmp_path, "--arch", "whisper-tiny", "--shape",
                        "long_500k")
    rec = recs["whisper-tiny|long_500k"]
    assert rec["status"] == "skipped" and "reason" in rec
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(tmp_path), "--arch", "whisper-tiny", "--shape",
         "long_500k,nope", "--skip-existing"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = json.loads((tmp_path / "dryrun_32x8.json").read_text())
    assert recs["whisper-tiny|nope"]["status"] == "FAIL"
    assert "KeyError" in recs["whisper-tiny|nope"]["error"]
    assert "whisper-tiny x long_500k" not in res.stdout


def test_dryrun_loads_no_jax():
    code = ("import sys; import repro_torch.launch.dryrun, "
            "repro_torch.core.roofline, repro_torch.launch.mesh; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]


def test_env_for_is_jax_envs():
    from repro_torch.core import sharding as SH
    from repro_torch.launch.dryrun import env_for
    assert env_for("train") is SH.TRAIN_ENV
    assert env_for("train", sp=True) is SH.TRAIN_SP_ENV
    for kind in ("prefill", "decode", "decode_cb"):
        assert env_for(kind) is SH.DP_TP_ENV
        assert env_for(kind, sp=True) is SH.DP_TP_SP_ENV
