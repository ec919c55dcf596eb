"""Serving under a mesh: `repro_torch.launch.serve --data D --model M`
spawns D*M gloo ranks under DP_TP_ENV (as the JAX launcher runs every
mode under its mesh), and its greedy streams equal the unsharded
launcher's and the JAX launcher's on the same weights (JAX's, drawn from
seed 0).  At (1, 4) qwen3-0.6b SMOKE's 2 KV heads do not divide the 4
model ranks: each is stored once a rank that reads it (4 heads).

One more 4-rank world (`tests/_torch_serve_mesh_worker.py`, no JAX in
it) holds, on a (2, 2) and a (1, 4) mesh, the sharded prefill's and
decode ticks' logits to the unsharded port's at 1e-5, a tight pool's
preemptions, a drain whose KV migrates to a second sharded engine, and
the pools' placements to `cache_pspecs(serve=True)`.

The unsharded and the (2, 2) runs record --trace-out: rank 0's trace
holds the unsharded run's events (names, cats, phases, args), one
`request` span a request beside the engine's `serve.*` events.

`--replicas 2 --transport proc --paged` on the (2, 2) mesh with replica
1 killed: the tokens of the 1x1 proc and sim runs, and only rank 0's
transport starts worker processes (one a replica)."""
import collections
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

JAX_ARGS = ["--smoke", "--continuous", "--paged", "--page-size", "4",
            "--requests", "6", "--batch", "2", "--prompt-len", "16",
            "--gen", "8"]
ARGS = JAX_ARGS + ["--device", "cpu"]
MESHES = [(2, 2), (1, 4)]
IDS = ["2x2", "1x4"]


def _jax_weights():
    import jax
    from repro.configs import get_config
    from repro.models import model as JMD
    cfg = get_config("qwen3-0.6b", smoke=True).with_(
        param_dtype="float32", compute_dtype="float32")
    return jax.tree_util.tree_map(
        np.asarray, JMD.init_model(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """JAX's launcher, then the port's unsharded and on both meshes, all
    on JAX's seed-0 weights; the unsharded and (2, 2) runs traced."""
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch.serve import serve, summary
    jout = jax_serve(JAX_ARGS)
    weights = _jax_weights()
    jax_tokens = {str(f.rid): list(map(int, f.tokens))
                  for f in jout["finished"]}
    tmp = tmp_path_factory.mktemp("serve_traces")
    traces = {shape: tmp / f"{shape[0]}x{shape[1]}.json"
              for shape in [(1, 1)] + MESHES}
    plain = summary(serve(ARGS + ["--trace-out", str(traces[(1, 1)])],
                          params=weights))
    meshes = {shape: serve(ARGS + ["--data", str(shape[0]), "--model",
                                   str(shape[1])] + (
                               ["--trace-out", str(traces[shape])]
                               if shape == (2, 2) else []),
                           params=weights)
              for shape in MESHES}
    return jax_tokens, plain, meshes, traces


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_mesh_serve_streams_equal_unsharded_and_jax(launched, shape):
    jax_tokens, plain, meshes = launched[:3]
    assert plain["tokens"] == jax_tokens
    out = meshes[shape]
    assert out["tokens"] == plain["tokens"]
    assert out["stats"] == plain["stats"]
    assert out["stats"]["generated_tokens"] == sum(
        len(t) for t in jax_tokens.values())


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_mesh_serve_pools_placed_by_cache_pspecs(launched, shape):
    """The k and v pools: DTensors split on their KV heads over "model"
    and replicated over "data", as `cache_pspecs(serve=True)` says; at
    (1, 4) they store 4 heads (each of the 2 KV heads twice)."""
    out = launched[2][shape]
    assert len(out["placements"]) == 2
    for got, want, gshape in out["placements"]:
        assert got == want == "(Replicate(), Shard(dim=3))"
        assert gshape[3] == (4 if shape == (1, 4) else 2)


def test_mesh_serve_static_mode_on_2x2():
    """The static path too: its prefill writes the batch's sharded cache
    and the decode ticks run on it."""
    from repro_torch.launch.serve import serve, summary
    weights = _jax_weights()
    args = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "12", "--gen", "5"]
    plain = summary(serve(args, params=weights))
    mesh = serve(args + ["--data", "2", "--model", "2"], params=weights)
    assert mesh["tokens"] == plain["tokens"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import torch.multiprocessing as mp
    import _torch_serve_mesh_worker as W
    tmp = tmp_path_factory.mktemp("serve_mesh")
    out = tmp / "results.pkl"
    mp.spawn(W.run, args=(4, str(tmp / "store"), _jax_weights(), str(out)),
             nprocs=4, join=True)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_prefill_and_decode_logits(world, shape):
    got, ref = world[shape]["logits"]
    assert len(got) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)
    kv, ref_kv = world[shape]["kv"]
    for n in ("k", "v"):
        np.testing.assert_allclose(kv[n], ref_kv[n], rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_tight_sharded_pool_preempts_as_unsharded(world, shape):
    tokens, ref, pre, ref_pre = world[shape]["tight"]
    assert ref_pre > 0, "the pool must run dry"
    assert pre == ref_pre
    assert tokens == ref


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_migrated_install_on_sharded_pool(world, shape):
    (out, pages, installed, admits), (ref_out, ref_pages, _, ref_admits) = \
        world[shape]["migrate"]
    assert out == ref_out
    assert admits == ref_admits and admits >= 1
    assert sorted(pages) == sorted(ref_pages) == sorted(installed)
    for rid in pages:
        for n in ("k", "v"):
            np.testing.assert_allclose(pages[rid][n], ref_pages[rid][n],
                                       rtol=0, atol=1e-5)
            # what the second engine installed reads back bit-equal
            np.testing.assert_array_equal(installed[rid][n], pages[rid][n])


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_engine_pools_placed_by_cache_pspecs(world, shape):
    for got, want, gshape, is_dt in world[shape]["placements"]:
        assert is_dt and got == want


def _events(path) -> collections.Counter:
    return collections.Counter(
        (e["name"], e.get("cat"), e["ph"],
         json.dumps(e.get("args"), sort_keys=True))
        for e in json.loads(path.read_text())["traceEvents"]
        if e["ph"] != "M")


def test_mesh_serve_trace_holds_the_unsharded_events(launched):
    traces = launched[3]
    assert not traces[(1, 4)].exists()
    mesh, plain = _events(traces[(2, 2)]), _events(traces[(1, 1)])
    assert mesh == plain
    names = collections.Counter()
    for (name, _, _, _), n in mesh.items():
        names[name] += n
    assert names["request"] == 6
    assert names["serve.admit"] == 6 and names["serve.first_token"] == 6


def test_proc_fleet_on_a_2x2_mesh(tmp_path):
    from repro_torch.launch.serve import serve, summary
    weights = _jax_weights()
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps([{"step": 4, "kind": "fail", "worker": 1}]))
    argv = ["--smoke", "--device", "cpu", "--replicas", "2", "--paged",
            "--page-size", "4", "--requests", "6", "--batch", "2",
            "--prompt-len", "16", "--gen", "8", "--failure-trace",
            str(trace)]
    sim = summary(serve(argv, params=weights))
    proc = summary(serve(argv + ["--transport", "proc"], params=weights))
    mesh = serve(argv + ["--transport", "proc", "--data", "2", "--model",
                         "2"], params=weights)
    assert mesh["tokens"] == proc["tokens"] == sim["tokens"]
    assert mesh["stats"]["drains"] == proc["stats"]["drains"] == 1
    assert mesh["stats"] == proc["stats"]
    assert mesh["worker_processes"] == [2, 0, 0, 0]
