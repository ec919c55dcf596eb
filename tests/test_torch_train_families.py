"""Port parity for training the hybrid, ssm, audio, vlm and MoE families:
zamba2-1.2b (cut to 2 layers, one shared block), rwkv6-1.6b, whisper-tiny,
phi-3-vision-4.2b and qwen3-moe-30b-a3b at their SMOKE configs in fp32,
with the port's seeded weights carried to both packages.

Two steps of the port's `make_train_step` with natural-compressed
gradients, each from JAX's state bridged to the port, against the JAX
package's `make_train_step` under `jax.jit` (no mesh: the JAX launcher
fails under its own, ROADMAP "Found in the reference"), the same batches,
modality inputs and compression uniforms: the loss at rtol 1e-4, params
and the AdamW first moments as `test_torch_train._close_but_few` holds
them (all but 1 in 10^4 elements within rtol 1e-4 / atol 1e-5, every one
within the peak learning rate).  The second moments are not held: they
square the gradients' fp32 differences, ~1e-4 of a moment.  Run freely,
the two packages' states drift apart through the few elements whose
compression uniform lies within their fp32 gradient difference of a
rounding threshold (`test_torch_train` explains it); step by step they
agree.  The launcher's in-place update (`apply_grads`) is held against
JAX's clip and update for each optimizer, whole and sliced.  Then the
port's launcher trains each family for 3 steps with --compress-grads
--async-ckpt --trace-out, and a resumed run continues an uninterrupted
one bit for bit.
"""
import json

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402

import test_torch_bridge as TP  # noqa: E402
from test_torch_train import _close_but_few  # noqa: E402

# arch -> the SMOKE config's cut (zamba2: 2 layers, its shared block
# after the second; the others are 2 layers already)
ARCHS = {"zamba2-1.2b": dict(num_layers=2),
         "rwkv6-1.6b": {},
         "whisper-tiny": {},
         "phi-3-vision-4.2b": {},
         "qwen3-moe-30b-a3b": {}}
B, S = 2, 32           # S a whole number of zamba2's 32-token SSD chunks
PEAK_LR = 3e-3


def _configs(arch):
    kw = ARCHS[arch]
    return (jax_get_config(arch, smoke=True).with_(**kw),
            torch_get_config(arch, smoke=True).with_(**kw))


def _batches(cfg, n, seed):
    """n batches of tokens, labels and the modality input, from numpy."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, cfg.vocab_size, size=(B, S + 1)).astype(
            np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.arch_type == "vlm":
            b["extra_embeds"] = rng.randn(B, cfg.num_patches, 1024).astype(
                np.float32)
        elif cfg.arch_type == "audio":
            b["extra_embeds"] = rng.randn(B, cfg.encoder_seq,
                                          cfg.d_model).astype(np.float32)
        out.append(b)
    return out


def _jax_step(cfg, opt, params):
    """JAX's compressed train step under one jit, which also returns the
    step's compression draw (one key per leaf in flatten order, one
    uniform per element: what `natural_compress` draws)."""
    step = jax_train_step(cfg, opt, compress_grads=True)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    shapes = [leaf.shape for leaf in leaves]

    @jax.jit
    def run(params, state, batch, key):
        keys = jax.random.split(key, len(shapes))
        u = [jax.random.uniform(k, s) for k, s in zip(keys, shapes)]
        return (*step(params, state, batch, key),
                jax.tree_util.tree_unflatten(treedef, u))
    return run


def _to_torch(tree):
    return TP.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                "cpu")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_two_compressed_train_steps_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    # the port's seeded weights carried to JAX (JAX's eager init draws
    # each leaf under its own compile; the weights only need be shared)
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(
        TMD.init_model(tcfg, torch.Generator().manual_seed(0))))
    jopt = JO.adamw(JO.warmup_cosine(PEAK_LR, 1, 4))
    topt = TO.adamw(TO.warmup_cosine(PEAK_LR, 1, 4))
    js = jopt.init(jp)
    jstep = _jax_step(jcfg, jopt, jp)
    tstep = make_train_step(tcfg, topt, compress_grads=True)
    for i, batch in enumerate(_batches(jcfg, 2, seed=5)):
        # each step starts both packages from JAX's state
        tp = _to_torch(jp)
        ts = {"mu": _to_torch(js["mu"]), "nu": _to_torch(js["nu"]),
              "step": torch.tensor(int(js["step"]), dtype=torch.int32)}
        key = jax.random.PRNGKey(200 + i)
        jp, js, jm, u = jstep(jp, js, jax.tree_util.tree_map(jnp.asarray,
                                                             batch), key)
        noise = _to_torch(u)
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, noise)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        assert np.isfinite(float(tm["gnorm"]))
        assert int(ts["step"]) == int(js["step"]) == i + 1
        _close_but_few(tp, jp, PEAK_LR)
        _close_but_few(ts["mu"], js["mu"], PEAK_LR)


def _launch(arch, *extra):
    from repro_torch.launch.train import train
    return train(["--arch", arch, "--smoke", "--device", "cpu",
                  "--compress-grads", "--batch", "2", "--seq", "32",
                  "--warmup", "8", "--log-every", "100", *extra])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_launcher_trains_traces_and_resumes_bit_for_bit(arch, tmp_path):
    """3 steps with an asynchronous final save and a trace, then one
    resumed step: the same losses and params as 4 steps straight (fewer
    steps than the warmup keeps the learning rate independent of
    --steps)."""
    d, trace = str(tmp_path / "ck"), tmp_path / "trace.json"
    first = _launch(arch, "--steps", "3", "--ckpt-dir", d, "--async-ckpt",
                    "--trace-out", str(trace))
    assert latest_step(d) == 3
    assert len(first["losses"]) == 3 and all(np.isfinite(first["losses"]))
    evs = [e for e in json.loads(trace.read_text())["traceEvents"]
           if e["ph"] != "M"]
    steps = [e["args"]["step"] for e in evs if e["name"] == "train.step"]
    assert steps == [0, 1, 2]
    names = {e["name"] for e in evs}
    assert {"ckpt.snapshot", "ckpt.write", "ckpt.commit"} <= names
    resumed = _launch(arch, "--steps", "1", "--ckpt-dir", d, "--resume",
                      "--no-async-ckpt")
    straight = _launch(arch, "--steps", "4")
    assert first["losses"] + resumed["losses"] == straight["losses"]
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(straight["params"])):
        assert torch.equal(a, b)


def _update_tree(seed, scale=1.0):
    """Leaves that UPDATE_CHUNK 1000 cuts into slices of rows: a matrix
    (2 slices of 3 and 1 rows) and a vector (3 slices), and one leaf
    under the chunk."""
    r = np.random.RandomState(seed)
    return {"blocks": {"w": (r.randn(4, 300) * scale).astype(np.float32)},
            "embed": (r.randn(2500) * scale).astype(np.float32),
            "norm": (r.randn(2, 3, 5) * scale).astype(np.float32)}


def _moments(state):
    return {k: v for k, v in state.items() if k != "step"}


@pytest.mark.parametrize("chunk", [None, 1000])
@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_in_place_update_matches_jax(name, chunk, monkeypatch):
    """The launcher's update, `apply_grads` (params and moments
    overwritten in place, a leaf at a time, AdamW's and SGD's in slices
    of the leading dim, Adafactor's factored moments a leaf whole),
    against the JAX step's `clip_by_global_norm` and `opt.update` over two
    steps whose gradients the clip scales down: params and moments at
    `test_torch_optim`'s fp32 tolerance (rtol 1e-6 / atol 1e-7), the
    global norm at rtol 1e-6.  `chunk` 1000 cuts every leaf of more than
    1000 elements into slices."""
    from repro_torch.launch import steps
    if chunk:
        monkeypatch.setattr(steps, "UPDATE_CHUNK", chunk)
        assert len(steps.leaf_slices(torch.zeros(4, 300), True)) == 2
        assert len(steps.leaf_slices(torch.zeros(2500), True)) == 3
        assert steps.leaf_slices(torch.zeros(4, 300), False) == [...]
    jopt = JO.get_optimizer(name, JO.warmup_cosine(PEAK_LR, 1, 4))
    topt = TO.get_optimizer(name, TO.warmup_cosine(PEAK_LR, 1, 4))
    jp = jax.tree_util.tree_map(jnp.asarray, _update_tree(0))
    tp = TP.params_from_numpy(_update_tree(0), "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    leaves = tree_leaves({"p": tp, "s": ts})
    for i in range(2):
        g = _update_tree(10 + i, scale=0.5)
        jg, jn = JO.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, g), 1.0)
        assert float(jn) > 1.0
        jp, js = jopt.update(jg, js, jp)
        out = steps.apply_grads(topt, tp, ts, TP.params_from_numpy(g, "cpu"))
        assert out[0] is tp and out[1] is ts
        np.testing.assert_allclose(float(out[2]), float(jn), rtol=1e-6)
    assert all(a is b for a, b in zip(leaves, tree_leaves({"p": tp,
                                                           "s": ts})))
    for t, j in ((tp, jp), (_moments(ts), _moments(js))):
        t, j = tree_leaves(params_to_numpy(t)), jax.tree_util.tree_leaves(j)
        assert len(t) == len(j)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 2

