"""The elastic LM launcher, `repro_torch.launch.train.train([...,
"--elastic", ...])`, against the JAX package's `elastic_lm_loop` at
tests/test_elastic.py's launcher settings (qwen3-0.6b SMOKE, fp32, the
same JAX `init_model` weights, the same sharded data pipelines).

The JAX launcher itself dies under its own mesh on this tree (ROADMAP.md
queue 3), so its loop is called as the launcher calls it, with the
launcher's jitted train step and optimizer and no mesh.

Exact: the recoveries (wall, worker, cause, lost steps), final_alive,
the transition log and the checkpoint steps left on disk.  Losses: rtol
1e-5, the fp32 train step's own parity figure (`test_torch_train.py`),
with `--optimizer sgd` and with AdamW alike.  AdamW's first steps are
sign-sensitive (ROADMAP.md queue 3: an element whose gradient is at fp32
noise level may step either way), but over these runs the losses stayed
within 1.5e-7 relative of JAX's (sync with AdamW 1.47e-7, async_ps
1.43e-7, local_sgd with SGD 7.1e-8; a sync run with SGD 2.8e-7).
local_sgd is cut from the JAX test's 10 steps to 5 (the death at wall 4,
a round on the survivor): its JAX rounds compile per worker count.
"""
import argparse
import json

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import make_pipeline as jax_pipeline  # noqa: E402
from repro.elastic import driver as JD  # noqa: E402
from repro.launch.steps import batch_abstract  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402

import test_torch_bridge as TP  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
# tests/test_elastic.py's launcher settings: mode -> (workers, steps,
# ckpt_every, failure step)
SETTINGS = {"sync": (4, 16, 4, 6), "local_sgd": (2, 5, 5, 4),
            "async_ps": (2, 10, 5, 4)}
B, S, LR = 4, 32, 3e-3


def _jax_run(mode, optimizer, ckpt_dir, trace_path):
    """JAX `_train`'s elastic hand-off, without the mesh."""
    workers, steps, every, _ = SETTINGS[mode]
    jcfg, _ = TP.configs(param_dtype="float32", compute_dtype="float32")
    opt = JO.get_optimizer(optimizer, JO.warmup_cosine(LR, 20, steps))
    params = JMD.init_model(jcfg, jax.random.PRNGKey(0))
    args = argparse.Namespace(
        arch="qwen3-0.6b", mode=mode, workers=workers, steps=steps,
        batch=B, seq=S, lr=LR, ckpt_dir=str(ckpt_dir), ckpt_every=every,
        keep_last=2, async_ckpt=True, failure_trace=str(trace_path),
        transport="sim", flight_dir=None, staleness=2, log_every=100)
    batch_abs = batch_abstract(jcfg, B, S)
    return JD.elastic_lm_loop(
        args=args, cfg=jcfg, step_fn=jax.jit(jax_train_step(jcfg, opt)),
        params=params, opt_state=jax.jit(opt.init)(params),
        bshard={k: None for k in batch_abs}, batch_abs=batch_abs,
        pipe_factory=lambda shard, num: jax_pipeline(
            jcfg.vocab_size, B, S, shard_id=shard, num_shards=num, seed=0),
        step0=0, opt=opt, loss_fn=lambda p, b: JMD.lm_loss(p, jcfg, b))


def _port_run(mode, optimizer, ckpt_dir, trace_path, monkeypatch):
    """The port's launcher, its weights the JAX package's."""
    from repro_torch.launch.train import train
    workers, steps, every, _ = SETTINGS[mode]
    jcfg, _ = TP.configs()
    _, tp = TP.params(jcfg)
    monkeypatch.setattr(TMD, "init_model",
                        lambda cfg, gen: tree_map(torch.clone, tp))
    return train(["--smoke", "--device", "cpu", "--steps", str(steps),
                  "--batch", str(B), "--seq", str(S), "--lr", str(LR),
                  "--optimizer", optimizer, "--log-every", "100",
                  "--elastic", "--mode", mode, "--workers", str(workers),
                  "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(every),
                  "--keep-last", "2", "--failure-trace", str(trace_path)])


def _recs(rs):
    return [(r.wall_step, r.worker, r.cause, r.lost_steps) for r in rs]


@pytest.mark.parametrize("mode,optimizer", [
    ("sync", "adamw"), ("local_sgd", "sgd"), ("async_ps", "adamw")])
def test_elastic_launcher_equals_jax_loop(mode, optimizer, tmp_path,
                                          monkeypatch):
    workers, steps, _, fail_at = SETTINGS[mode]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps([{"step": fail_at, "kind": "fail",
                                  "worker": 1}]))
    jout = _jax_run(mode, optimizer, tmp_path / "j", trace)
    tout = _port_run(mode, optimizer, tmp_path / "t", trace, monkeypatch)
    assert _recs(tout["recoveries"]) == _recs(jout["recoveries"])
    assert tuple(tout["final_alive"]) == tuple(jout["final_alive"])
    assert tout["transitions"] == jout["transitions"]
    assert (sorted(p.name for p in (tmp_path / "t").glob("step_*")) ==
            sorted(p.name for p in (tmp_path / "j").glob("step_*")))
    assert len(tout["losses"]) == len(jout["losses"]) == steps
    np.testing.assert_allclose(tout["losses"], jout["losses"], **TOL)
    # the JAX test's own criteria, on the port
    if mode == "sync":
        assert _recs(tout["recoveries"]) == [(6, 1, "fail", 2)]
        assert tout["final_alive"] == (0, 2, 3)
    else:
        assert [r.lost_steps for r in tout["recoveries"]] == [0]
        assert tout["final_alive"] == (0,)


def test_elastic_sync_requires_ckpt_dir():
    from repro_torch.launch.train import train
    with pytest.raises(SystemExit):
        train(["--smoke", "--device", "cpu", "--elastic", "--steps", "1"])


def test_elastic_launcher_refuses_without_cuda(monkeypatch, tmp_path):
    from repro_torch.launch.train import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(["--smoke", "--elastic", "--mode", "local_sgd", "--steps",
               "1"])
