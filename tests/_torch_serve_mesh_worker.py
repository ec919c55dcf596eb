"""Rank body for tests/test_torch_serve_mesh.py: one world of 4 gloo ranks
that serves qwen3-0.6b's SMOKE config (fp32) under DP_TP_ENV on a (2,2)
and on a (1,4) mesh, beside the same engines unsharded in the same
process, and hands rank 0's results back.

Imports no JAX: the weights arrive as numpy arrays (JAX's, drawn in the
pytest process).  Each rank runs on one intra-op thread.  For each mesh:

  logits    a prefill of 2 prompts into a sharded cache, then 3 decode
            ticks on it: logits and the cache (made whole) beside the
            unsharded port's
  tight     a paged engine on a pool that must preempt: streams,
            preemptions and the pools' placements against cache_pspecs
  migrate   drain after 4 ticks, harvest, and finish on a second sharded
            engine through ServingDrainReadmit: streams, the harvested
            pages beside the unsharded harvest, and the installed pages
            read back equal to what was harvested
"""
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import sharding as SH
from repro_torch.elastic.recovery import ServingDrainReadmit
from repro_torch.launch.steps import cache_pspecs
from repro_torch.models import model as MD
from repro_torch.models.common import tree_leaves
from repro_torch.serving import Request, ServeEngine

SHAPES = ((2, 2), (1, 4))
PAGE, SLOTS, CACHE = 4, 2, 24
TIGHT_PAGES = 6                  # one slot at full length, not two


def cfg():
    return get_config("qwen3-0.6b", smoke=True).with_(
        param_dtype="float32", compute_dtype="float32")


def stream(vocab, n=6, seed=5, plens=(8, 12, 16), gens=(4, 8)):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, vocab, size=int(rng.choice(plens))),
             int(rng.choice(gens))) for i in range(n)]


def _reqs(spec):
    return [Request(rid=i, prompt=p, max_new_tokens=g) for i, p, g in spec]


def _engine(params, c, num_pages=None):
    return ServeEngine(params, c, num_slots=SLOTS, cache_len=CACHE,
                       page_size=PAGE, num_pages=num_pages, device="cpu")


def _run(params, c, spec, num_pages=None):
    eng = _engine(params, c, num_pages)
    fins = eng.run(_reqs(spec))
    return {f.rid: list(map(int, f.tokens)) for f in fins}, eng


def _logits(params, c, sharded):
    """Prefill logits, then 3 decode ticks' logits, and the cache."""
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, c.vocab_size, size=(2, 12)))
    logits, _, cache = MD.forward(params, c, toks, return_cache=True,
                                  cache_len=16, sharded_cache=sharded)
    out = [SH.whole(logits[:, -1])]
    tok = toks[:, -1:]
    pos = torch.tensor([12, 12], dtype=torch.int32)
    for _ in range(3):
        lg, cache = MD.decode_step(params, c, tok, pos, cache)
        lg = SH.whole(lg)
        out.append(lg[:, -1])
        tok = lg[:, -1].argmax(-1, keepdim=True)
        pos = pos + 1
    kv = {n: MD.harvest(cache[n], (slice(None),), c.num_kv_heads).numpy()
          for n in ("k", "v")}
    return [t.numpy() for t in out], kv


def _drain_resume(params, c, spec, ticks=4):
    a = _engine(params, c)
    for q in _reqs(spec):
        a.submit(q)
    for _ in range(ticks):
        a.tick()
    drained = a.drain()
    policy = ServingDrainReadmit()
    b = _engine(params, c)
    out = {f.rid: list(map(int, f.tokens)) for f in a.finished}
    conts = policy.readmit(drained)
    rid_of = {id(q.kv_seed): q.rid for q in conts if q.kv_seed is not None}
    installed = {}
    install = b.program.install

    def recording(cache, regs, slot, page_ids, kv, *rest):
        install(cache, regs, slot, page_ids, kv, *rest)
        n = kv.pages["k"].shape[1]
        installed[rid_of[id(kv)]] = {
            name: MD.harvest(cache[name], (slice(None), page_ids[:n]),
                             c.num_kv_heads).numpy()
            for name in kv.pages}
    b.program.install = recording
    for f in b.run(conts):
        s = policy.stitch(f)
        out[s.rid] = list(map(int, s.tokens))
    pages = {d.request.rid: {n: t.numpy() for n, t in d.kv.pages.items()}
             for d in drained if d.kv is not None}
    return out, pages, installed, b.migrated_admits


def _placements(eng):
    specs = tree_leaves(cache_pspecs(eng.cfg, eng.cache, serve=True,
                                     paged=eng.paged))
    mesh = next(iter(eng.cache.values())).device_mesh
    return [(repr(t.placements), repr(SH.placements(sp, mesh)),
             tuple(t.shape), SH.is_dtensor(t))
            for t, sp in zip(tree_leaves(eng.cache), specs)]


def _checks(c, params, mesh):
    spec = stream(c.vocab_size)
    res = {}
    with torch.no_grad():
        ref_logits, ref_kv = _logits(params, c, False)
        tight_spec = stream(c.vocab_size, plens=(8, 9), gens=(8,))
        ref_tight, ref_eng = _run(params, c, tight_spec, TIGHT_PAGES)
        ref_mig = _drain_resume(params, c, spec)
        with SH.axis_env(SH.DP_TP_ENV):
            dparams = MD.distribute_params(params, c, mesh)
            with SH.use_mesh(mesh):
                logits, kv = _logits(dparams, c, True)
                tight, eng = _run(dparams, c, tight_spec, TIGHT_PAGES)
                res["placements"] = _placements(eng)
                mig = _drain_resume(dparams, c, spec)
    res["logits"] = (logits, ref_logits)
    res["kv"] = (kv, ref_kv)
    res["tight"] = (tight, ref_tight, eng.preemptions, ref_eng.preemptions)
    res["migrate"] = (mig, ref_mig)
    return res


def run(rank, world, store, weights, out_path):
    import logging
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    try:
        c = cfg()
        params = params_from_numpy(weights, "cpu")
        res = {shape: _checks(c, params, init_device_mesh(
            "cpu", shape, mesh_dim_names=("data", "model")))
            for shape in SHAPES}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(res, f)
