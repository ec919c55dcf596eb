"""Rank body for tests/test_torch_mesh.py: one world of 4 gloo ranks that
runs every mesh check of the port and hands rank 0's results back.

Imports no JAX: the JAX references are computed in the pytest process
and arrive here as numpy arrays (`refs`); this side returns numpy arrays
(each DTensor made whole, which every rank must take part in) and the
test module holds them to the references.  Each rank runs on one
intra-op thread.

  dp, tp, dp_tp, fsdp  train step of tests/_par_worker.py's tiny CFG on
                       (4,1), (1,4), (2,2), (2,2) under DP_ENV, DP_TP_ENV,
                       DP_TP_ENV, TRAIN_ENV, and the port's own unsharded
                       step from the same weights
  dp_tp_nc             the compressed dp_tp step and the unsharded one
                       from the same generator, and each's gradients
                       before and after the wire
  pp                   pipeline_apply over a (4,) stage mesh, M = 4
  smdp                 all_reduce of per-rank gradients / W
  moe, hybrid, ssm     SMOKE forwards under dp_tp on (2,2) and unsharded
  ckpt_<env>           dp_tp and fsdp state after an AdamW step saved
                       blocking and asynchronously, the files against the
                       state saved whole, and a restore into the layout
  adafactor_<env>      two Adafactor steps under dp_tp and fsdp and the
                       unsharded ones, with each step's gradients
  launch_<env>         the launcher's loop (`launch.train._train`) on a
                       (2,2) mesh under each env with --optimizer
                       adafactor, --ckpt-dir, --async-ckpt and
                       --trace-out, and unsharded
  elastic_<mode>_<t>   `elastic_lm_loop` on (2,2) under dp_tp in each
                       mode over the sim transport (sync and async_ps
                       also over proc) with one death, and the same loop
                       unsharded on every rank (each its own checkpoint
                       directory): losses, recoveries, final_alive,
                       transitions and the checkpoint steps on disk
  control_<where>      rank 0's inner transport raising in `start` and in
                       `role_call` behind `RankZeroTransport`: what each
                       rank raised, and how soon

Each train check also counts the ops whose local output holds whole
vocab rows of the logits, (rows, S, V): a vocab-parallel loss makes none
where the vocab is split.
"""
import contextlib
import datetime
import os
import pathlib
import pickle
import traceback

import torch
import torch.distributed as dist

from repro_torch.bridge import params_from_numpy
from repro_torch.core.compression import wire_roundtrip
from repro_torch.core import sharding as SH
from repro_torch.core.pipeline import pipeline_apply
from repro_torch.core.sharding import whole
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.launch.steps import (apply_grads, loss_and_grads,
                                      make_train_step)
from repro_torch.models import mlp as M
from repro_torch.models import model as MD
from repro_torch.models.common import tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import get_optimizer

CFG = ModelConfig(name="tiny", arch_type="dense", num_layers=2,
                  d_model=128, num_heads=8, num_kv_heads=4, d_ff=256,
                  vocab_size=512, param_dtype="float32",
                  compute_dtype="float32", remat="none")
TRAIN = [("dp", "DP_ENV", (4, 1)), ("tp", "DP_TP_ENV", (1, 4)),
         ("dp_tp", "DP_TP_ENV", (2, 2)), ("fsdp", "TRAIN_ENV", (2, 2))]


def _np(tree):
    return tree_map(lambda t: whole(t).detach().numpy().copy(), tree)


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _batch(refs, mesh=None):
    batch = {k: torch.from_numpy(v) for k, v in refs["batch"].items()}
    if mesh is None:
        return batch
    return {k: SH.distribute(v, SH.logical("batch", None), mesh)
            for k, v in batch.items()}


LR = 1e-2


def _opt():
    return get_optimizer("adamw", lambda s: LR)


class _WholeVocab(TorchDispatchMode):
    """Counts the ops whose output (a DTensor's local shard) is 3-D with
    (S, V) trailing dims: whole vocab rows of the logits or of their
    gradient."""

    def __init__(self, S, V):
        super().__init__()
        self.SV, self.hits = (S, V), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                t = getattr(t, "_local_tensor", t)
                self.hits += t.dim() == 3 and tuple(t.shape[1:]) == self.SV
        return out


def _step(params, batch, watch=False):
    """lm_loss gradients and one AdamW update (no clip, as the JAX
    worker's step), in place; gnorm of the unclipped gradients.  With
    `watch`, the loss and gradients count their whole-vocab-row ops."""
    opt = _opt()
    st = opt.init(params)
    counter = _WholeVocab(batch["tokens"].shape[1], CFG.vocab_size)
    with counter if watch else contextlib.nullcontext():
        loss, grads = loss_and_grads(params, CFG, batch)
    g_np = _np(grads)
    params, st, gnorm = apply_grads(opt, params, st, grads,
                                    max_norm=float("inf"))
    return {"loss": float(whole(loss)), "grads": g_np,
            "params": _np(params), "nu": _np(st["nu"]),
            "gnorm": float(whole(gnorm)), "whole_vocab_ops": counter.hits}


def check_train(refs, env, shape):
    mesh = _mesh(shape)
    with SH.axis_env(getattr(SH, env)):
        params = MD.distribute_params(
            params_from_numpy(refs["params"], "cpu"), CFG, mesh)
        with SH.use_mesh(mesh):
            out = _step(params, _batch(refs, mesh), watch=True)
            out["placements"] = {
                k: str(tuple(v.placements)) for k, v in
                (("embed", params["embed"]), ("wq", params["blocks"][
                    "attn"]["wq"]))}
    out["unsharded"] = _step(params_from_numpy(refs["params"], "cpu"),
                             _batch(refs))
    return out


def check_compressed(refs):
    """The compressed dp_tp step and the unsharded one, each from the
    same weights and a generator seeded alike; also each run's gradients
    before and after the wire, and the sharded run's gradients (made
    whole) through the unsharded wire with the same uniforms."""
    mesh = _mesh((2, 2))
    opt = _opt()
    step = make_train_step(CFG, opt, compress_grads=True)
    out = {}
    for name in ("sharded", "unsharded"):
        on = mesh if name == "sharded" else None
        with SH.axis_env(SH.DP_TP_ENV), (
                SH.use_mesh(on) if on else contextlib.nullcontext()):
            def fresh():
                p = params_from_numpy(refs["params"], "cpu")
                return MD.distribute_params(p, CFG, mesh) if on else p
            _, grads = loss_and_grads(fresh(), CFG, _batch(refs, on))
            wired = wire_roundtrip(grads, torch.Generator().manual_seed(5))
            params = fresh()
            st = opt.init(params)
            params, st, m = step(params, st, _batch(refs, on),
                                 torch.Generator().manual_seed(5))
        out[name] = {"params": _np(params), "mu": _np(st["mu"]),
                     "nu": _np(st["nu"]), "loss": float(m["loss"]),
                     "gnorm": float(m["gnorm"]), "grads": _np(grads),
                     "wired": _np(wired)}
    whole_grads = tree_map(torch.from_numpy, out["sharded"]["grads"])
    out["rewired"] = _np(wire_roundtrip(whole_grads,
                                        torch.Generator().manual_seed(5)))
    return out


def _files(d):
    d = pathlib.Path(d)
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _all_ranks(ok: bool) -> bool:
    flag = torch.tensor([int(ok)])
    dist.all_reduce(flag, dist.ReduceOp.MIN)
    return bool(flag.item())


def check_ckpt(refs, env, tmp):
    """The mesh state after an AdamW step (params, moments) saved by
    every rank, blocking and through AsyncCheckpointer; rank 0 saves the
    same state made whole; each rank restores into the mesh layout."""
    from repro_torch.checkpoint import (AsyncCheckpointer,
                                        restore_checkpoint, save_checkpoint)
    from repro_torch.models.common import tree_leaves
    mesh = _mesh((2, 2))
    opt = _opt()
    tmp = os.path.join(tmp, env)
    with SH.axis_env(getattr(SH, env)):
        params = MD.distribute_params(
            params_from_numpy(refs["params"], "cpu"), CFG, mesh)
        st = opt.init(params)
        with SH.use_mesh(mesh):
            _, grads = loss_and_grads(params, CFG, _batch(refs, mesh))
            apply_grads(opt, params, st, grads)
    tree = {"params": params, "opt": st}
    save_checkpoint(f"{tmp}/mesh", 1, tree, {"step": 1})
    with AsyncCheckpointer(f"{tmp}/async") as ck:
        ck.save(1, tree, {"step": 1})
    made_whole = tree_map(whole, tree)
    if dist.get_rank() == 0:
        save_checkpoint(f"{tmp}/whole", 1, made_whole, {"step": 1})
    dist.barrier()
    like = tree_map(torch.zeros_like, tree)
    back, meta = restore_checkpoint(f"{tmp}/mesh", like)
    same = all(
        SH.is_dtensor(a) == SH.is_dtensor(b)
        and (not SH.is_dtensor(a) or a.placements == b.placements)
        and torch.equal(SH.local(a), SH.local(b))
        for a, b in zip(tree_leaves(back), tree_leaves(tree)))
    out = {"restored_bit_equal": _all_ranks(same), "meta": meta,
           "split": sum(SH.local(t).numel() < t.numel()
                        for t in tree_leaves(tree))}
    if dist.get_rank() == 0:
        files = {k: _files(f"{tmp}/{k}/step_00000001")
                 for k in ("mesh", "async", "whole")}
        out["n_files"] = len(files["whole"])
        out["blocking_equal"] = files["mesh"] == files["whole"]
        out["async_equal"] = files["async"] == files["whole"]
    return out


class _WholeLeaf(TorchDispatchMode):
    """Counts the ops whose output (a DTensor's local shard) has the
    whole `shape` of the leaf being updated."""

    def __init__(self, shape):
        super().__init__()
        self.shape, self.hits = tuple(shape), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                t = getattr(t, "_local_tensor", t)
                self.hits += tuple(t.shape) == self.shape
        return out


def _watched_update(opt, params, st, grads):
    """One update (no clip) a leaf at a time, each under a `_WholeLeaf`
    watch of its own shape: the same update as `apply_grads` on the
    whole tree.  Returns (split leaves watched, ops that made a split
    leaf whole)."""
    from repro_torch.launch.steps import _at, _leaf_paths
    step, split, hits = st["step"], 0, 0
    moments = [k for k in st if k != "step"]
    for path in _leaf_paths(params):
        p = _at(params, path)
        one = {k: {"x": _at(st[k], path)} for k in moments}
        one["step"] = step.clone()
        watch = _WholeLeaf(p.shape)
        with watch:
            apply_grads(opt, {"x": p}, one, {"x": _at(grads, path)},
                        max_norm=float("inf"))
        if SH.local(p).numel() < p.numel():
            split += 1
            hits += watch.hits
    step.add_(1)
    return split, hits


def check_adafactor(refs, env):
    """Two Adafactor steps (no clip) under `env` on (2,2) and unsharded,
    from the same weights on the same batch: params and statistics,
    each step's gradients, and whether the statistics are placed as
    `state_specs` says.  The sharded run's second update goes a leaf at
    a time under a watch for ops that make a split leaf whole."""
    from repro_torch.models.common import tree_leaves
    mesh = _mesh((2, 2))
    opt = get_optimizer("adafactor", lambda s: LR)
    out = {}
    for name in ("sharded", "unsharded"):
        on = mesh if name == "sharded" else None
        with SH.axis_env(getattr(SH, env)), (
                SH.use_mesh(on) if on else contextlib.nullcontext()):
            params = params_from_numpy(refs["params"], "cpu")
            if on:
                params = MD.distribute_params(params, CFG, mesh)
            st = opt.init(params)
            grads_np = []
            for i in range(2):
                _, grads = loss_and_grads(params, CFG, _batch(refs, on))
                grads_np.append(_np(grads))
                if on and i:
                    out["watched"] = _watched_update(opt, params, st, grads)
                else:
                    apply_grads(opt, params, st, grads,
                                max_norm=float("inf"))
            if on:
                specs = opt.state_specs(MD.model_pspecs(CFG))["f"]
                out["placed_as_specs"] = all(
                    t.placements == SH.placements(sp, mesh)
                    for t, sp in zip(tree_leaves(st["f"]),
                                     _spec_leaves(specs)))
                out["split_stats"] = sum(
                    SH.local(t).numel() < t.numel()
                    for t in tree_leaves(st["f"]))
        out[name] = {"grads": grads_np, "params": _np(params),
                     "f": _np(st["f"]), "step": int(st["step"])}
    return out


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [tree]


def check_launcher(env, tmp):
    """`launch.train._train` on the (2,2) mesh under `env` with Adafactor,
    an asynchronous save every step and rank 0's trace, then unsharded
    with the same flags: losses, the saved steps and the trace's
    events."""
    import json

    from repro_torch.launch import train as T
    argv = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "8",
            "--seq", "32", "--optimizer", "adafactor", "--ckpt-every",
            "1", "--async-ckpt", "--log-every", "100", "--env", env]
    tmp = os.path.join(tmp, "launch_" + env)
    args = T.parse_args(argv + ["--data", "2", "--model", "2",
                                "--ckpt-dir", f"{tmp}/mesh", "--trace-out",
                                f"{tmp}/mesh.json"])
    from repro_torch.obs import recorder as obs
    recording = []

    def run():
        recording.append(obs.get().enabled)
        return T._train(args, mesh=_mesh((2, 2)))
    out = {"losses": {"mesh": T.cli.run_traced(args, run)["losses"]},
           "rank_0_records": _all_ranks(recording == [dist.get_rank() == 0])}
    if dist.get_rank() == 0:         # the unsharded run writes alone
        args = T.parse_args(argv + ["--ckpt-dir", f"{tmp}/plain",
                                    "--trace-out", f"{tmp}/plain.json"])
        out["losses"]["plain"] = T.cli.run_traced(
            args, lambda: T._train(args))["losses"]
        out["steps"] = sorted(os.listdir(f"{tmp}/mesh"))
        out["events"] = [
            sorted((e["name"], e.get("cat"),
                    json.dumps(e.get("args"), sort_keys=True))
                   for e in json.loads(pathlib.Path(
                       f"{tmp}/{n}.json").read_text())["traceEvents"]
                   if e["ph"] != "M") for n in ("mesh", "plain")]
    return out


ELASTIC = {"sync": (4, 2, 3), "local_sgd": (2, 1, 1), "easgd": (2, 1, 1),
           "async_ps": (3, 2, 1), "ssp": (3, 2, 1)}   # steps, every, death
EL_W, EL_B, EL_S, EL_LR = 2, 8, 32, 3e-3


def elastic_args(mode, transport, ckpt_dir, trace_path):
    """The launcher's flags for `elastic_lm_loop` (test_torch_mesh's JAX
    reference builds the same)."""
    import argparse
    steps, every, _ = ELASTIC[mode]
    return argparse.Namespace(
        arch="tiny", mode=mode, workers=EL_W, steps=steps, batch=EL_B,
        seq=EL_S, lr=EL_LR, ckpt_dir=ckpt_dir, ckpt_every=every,
        keep_last=2, async_ckpt=True, failure_trace=trace_path,
        transport=transport, flight_dir=None, staleness=2, log_every=100)


def check_elastic(refs, mode, transport, tmp):
    """`elastic_lm_loop` on (2,2) under dp_tp, then unsharded, from the
    JAX weights, worker 1 killed at the mode's death step; each run's
    losses, recoveries, final_alive, transitions and checkpoint steps."""
    import json

    from repro_torch.data import make_pipeline
    from repro_torch.elastic import elastic_lm_loop
    from repro_torch.elastic.driver import lm_batch
    from repro_torch.launch.train import _split_batch
    from repro_torch.optim.optimizers import warmup_cosine
    steps, _, death = ELASTIC[mode]
    tmp = os.path.join(tmp, f"elastic_{mode}_{transport}")
    rank = dist.get_rank()
    trace = os.path.join(tmp, f"trace{rank}.json")
    os.makedirs(tmp, exist_ok=True)
    with open(trace, "w") as f:
        json.dump([{"step": death, "kind": "fail", "worker": 1}], f)
    opt = get_optimizer("adamw", warmup_cosine(EL_LR, 20, steps))
    out = {}
    for name in ("mesh", "plain"):
        on = _mesh((2, 2)) if name == "mesh" else None
        # the plain run goes on every rank: each writes its own files
        ckpt = os.path.join(tmp, name if on else f"plain{rank}")
        args = elastic_args(mode, transport, ckpt, trace)
        with SH.axis_env(SH.DP_TP_ENV), (
                SH.use_mesh(on) if on else contextlib.nullcontext()):
            params = params_from_numpy(refs["params"], "cpu")
            if on:
                params = MD.distribute_params(params, CFG, on)

            def place(b):
                batch = lm_batch(CFG, b, "cpu")
                return batch if on is None else _split_batch(
                    batch, CFG, on, SH.DP_TP_ENV)
            res = elastic_lm_loop(
                args=args, cfg=CFG, step_fn=make_train_step(CFG, opt),
                params=params, opt_state=opt.init(params),
                pipe_factory=lambda shard, num: make_pipeline(
                    CFG.vocab_size, EL_B, EL_S, shard_id=shard,
                    num_shards=num, seed=0),
                opt=opt, loss_fn=lambda p, b: MD.lm_loss(p, CFG, b),
                device="cpu", mesh=on, place=place)
        out[name] = {
            "losses": res["losses"], "final_alive": tuple(res["final_alive"]),
            "transitions": res["transitions"],
            "recoveries": [(r.wall_step, r.worker, r.cause, r.lost_steps)
                           for r in res["recoveries"]],
            "steps": sorted(p for p in os.listdir(ckpt)
                            if p.startswith("step_"))}
    return out


def check_control_plane(where):
    """Rank 0's inner transport raises in `start` (a worker that fails
    to start) or in `role_call` (its host died): every rank must raise
    the same error, soon, rather than wait in a collective."""
    import time

    from repro_torch.cluster.coordinator import Coordinator
    from repro_torch.cluster.sim import SimTransport
    from repro_torch.cluster.transport import RankZeroTransport, RoleHostDied
    from repro_torch.elastic.membership import FailureTrace

    class Faulty(SimTransport):
        def start(self, num_workers):
            if where == "start":
                raise RuntimeError("worker 1 did not start")

        def role_call(self, host, verb, payload=None):
            raise RoleHostDied(host, verb)

    t0 = time.perf_counter()
    raised = None
    try:
        t = RankZeroTransport.build(lambda: Faulty(FailureTrace()),
                                    dist.new_group(backend="gloo"))
        coord = Coordinator(t, 2)
        try:
            coord.transport.role_call(2, "ps_pull")
        finally:
            coord.close()
    except Exception as e:        # noqa: BLE001 - what each rank raised
        raised = (type(e).__name__, str(e),
                  getattr(e, "host", None), getattr(e, "verb", None))
    took = time.perf_counter() - t0
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (raised, took))
    return {"raised": [r for r, _ in every],
            "seconds": max(s for _, s in every)}


def check_pp(refs):
    mesh = _mesh((4,), ("stage",))
    stack = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in refs["pp_stack"].items()}
    x = torch.from_numpy(refs["pp_x"])

    def block_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    y = pipeline_apply(block_fn, stack, x, mesh, num_microbatches=4)
    g = torch.autograd.grad((y ** 2).sum(), [stack["b"], stack["w"]])
    return {"y": y.detach().numpy(), "grads": {"b": g[0].numpy(),
                                               "w": g[1].numpy()}}


def check_smdp(refs):
    from repro_torch.core.data_parallel import per_worker_grads, worker_mean
    W = dist.get_world_size()
    r = dist.get_rank()
    w0 = torch.from_numpy(refs["sm_w0"])
    xw, yw = (torch.from_numpy(refs[k]) for k in ("sm_xw", "sm_yw"))

    def loss_fn(w, b):
        return torch.mean((b["x"] @ w - b["y"]) ** 2)

    w = w0.clone().requires_grad_(True)
    g = torch.autograd.grad(loss_fn(w, {"x": xw[r], "y": yw[r]}), w)[0]
    dist.all_reduce(g)                       # the survey's Fig. 2
    _, gw = per_worker_grads(loss_fn, w0, {"x": xw, "y": yw})
    return {"allreduce": (g / W).numpy(), "dp_mean": worker_mean(gw).numpy()}


def check_family(refs, arch):
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True).with_(param_dtype="float32",
                                             compute_dtype="float32")
    params = params_from_numpy(refs[f"fam_{arch}"], "cpu")
    tokens = torch.from_numpy(refs["fam_tokens"])
    mesh = _mesh((2, 2))
    record = []
    top_k = M.top_k

    def recording(x, k):             # each MoE layer's (local) choices
        vals, idx = top_k(x, k)
        record.append(idx)
        return vals, idx
    M.top_k = recording
    try:
        with SH.axis_env(SH.DP_TP_ENV):
            dparams = MD.distribute_params(params, cfg, mesh)
            with SH.use_mesh(mesh), torch.no_grad():
                tok = SH.distribute(tokens, SH.logical("batch", None), mesh)
                logits, aux, _ = MD.forward(dparams, cfg, tok)
                out = {"logits": whole(logits).numpy(),
                       "aux": float(whole(aux))}
                # every rank's choices, whole (group dim split like batch)
                choices = [whole(_like_groups(i, mesh)).numpy()
                           for i in record]
    finally:
        M.top_k = top_k
    sharded_choices = choices
    record.clear()
    M.top_k = recording
    try:
        with torch.no_grad():
            logits0, aux0, _ = MD.forward(params, cfg, tokens)
    finally:
        M.top_k = top_k
    out["plain_logits"] = logits0.numpy()
    out["plain_aux"] = float(aux0)
    out["flips"] = int(sum((a != b.numpy()).sum()
                           for a, b in zip(sharded_choices, record)))
    out["layers_routed"] = len(record)
    if out["flips"]:
        # hold the plain forward to the sharded run's expert choices
        forced = iter(torch.from_numpy(c) for c in sharded_choices)

        def forcing(x, k):
            idx = next(forced)
            return x.gather(-1, idx), idx
        M.top_k = forcing
        try:
            with torch.no_grad():
                out["forced_logits"] = MD.forward(params, cfg,
                                                  tokens)[0].numpy()
        finally:
            M.top_k = top_k
    return out


def _like_groups(idx_local, mesh):
    from torch.distributed.tensor import DTensor
    pl = SH.placements(SH.logical("batch", None, None), mesh)
    return DTensor.from_local(idx_local, mesh, pl, run_check=False)


def run(rank, world, store, refs, out_path):
    torch.set_num_threads(1)
    import logging
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    results = {}
    checks = [(name, (lambda e=env, s=shape: check_train(refs, e, s)))
              for name, env, shape in TRAIN]
    tmp = os.path.dirname(out_path)
    for env in ("DP_TP_ENV", "TRAIN_ENV"):
        checks += [(f"ckpt_{env}", lambda e=env: check_ckpt(refs, e, tmp)),
                   (f"adafactor_{env}",
                    lambda e=env: check_adafactor(refs, e))]
    checks += [(f"launch_{env}", lambda e=env: check_launcher(e, tmp))
               for env in ("dp", "tp", "dp_tp", "fsdp")]
    checks += [(f"elastic_{mode}_{t}",
                lambda m=mode, t=t: check_elastic(refs, m, t, tmp))
               for mode in ELASTIC for t in ("sim", "proc")
               if t == "sim" or mode in ("sync", "async_ps")]
    checks += [(f"control_{w}", lambda w=w: check_control_plane(w))
               for w in ("start", "role_call")]
    checks += [("dp_tp_nc", lambda: check_compressed(refs)),
               ("pp", lambda: check_pp(refs)),
               ("smdp", lambda: check_smdp(refs))]
    checks += [(arch, (lambda a=arch: check_family(refs, a)))
               for arch in refs["families"]]
    try:
        for name, fn in checks:
            try:
                results[name] = fn()
            except Exception:
                results[name] = {"error": traceback.format_exc()}
                print(f"rank {rank}: {name} failed\n{results[name]['error']}",
                      flush=True)
    finally:
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()
