"""The roofline on the H100 (`repro_torch.core.roofline`): model_flops and
param_count equal the JAX package's for every arch and kind at full
width; the terms, the bottleneck and the bound at the H100's published
rates, a "model" collective priced at NVLink's and a "data" one at the
network's; the `Counter` on a fake process group (per-chip FLOPs of a
split matmul, the bytes of an all-reduce and of an all-gather, no
collective on a (1, 1) mesh, no B x V gather in a decode step); the
kernel wrappers' records on meta tensors; the production meshes.

The fake group is process-global: each test joins its own fake world
and leaves it before it ends, so no other test sees it."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro_torch.core import roofline as RL  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402

ARCHS = ["qwen3-0.6b", "qwen3-1.7b", "deepseek-7b", "nemotron-4-340b",
         "qwen3-moe-30b-a3b", "arctic-480b", "zamba2-1.2b", "rwkv6-1.6b",
         "whisper-tiny", "phi-3-vision-4.2b"]


@contextlib.contextmanager
def fake_mesh(shape, names=("data", "model")):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.dryrun import join_fake_world
    n = int(np.prod(shape))
    join_fake_world(n)
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _dt(mesh, shape, placements, dtype=torch.float32):
    from torch.distributed.tensor import DTensor, Shard
    loc = list(shape)
    for size, pl in zip(mesh.shape, placements):
        if isinstance(pl, Shard):
            loc[pl.dim] //= size
    return DTensor.from_local(torch.empty(loc, dtype=dtype, device="meta"),
                              mesh, placements, run_check=False)


def test_the_arch_list_is_the_registry():
    from repro_torch.configs import ARCH_IDS
    assert sorted(ARCHS) == sorted(ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_param_count_equal_jax(arch):
    from repro.configs import get_config as jget
    from repro.core.roofline import model_flops as jflops
    from repro.models.config import param_count as jcount
    from repro_torch.configs import get_config
    from repro_torch.models.config import param_count
    cfg, jcfg = get_config(arch), jget(arch)
    assert param_count(cfg) == jcount(jcfg)
    for kind in ("train", "prefill", "decode"):
        assert RL.model_flops(cfg, 4096, 256, kind) == jflops(
            jcfg, 4096, 256, kind)


def test_roofline_terms_at_the_h100_rates():
    r = RL.Roofline(arch="a", shape="s", mesh="m", chips=256,
                    flops_per_chip=989e12,         # 1 s of compute
                    bytes_per_chip=3.35e12 * 2.0,  # 2 s of memory
                    coll_bytes_per_chip=0.0,
                    coll_by_op={"all-reduce@model": int(450e9 / 4),
                                "all-gather@data": int(50e9 / 2)},
                    model_flops_total=989e12 * 256 * 0.5)
    assert (LM.PEAK_FLOPS_BF16, LM.HBM_BW, LM.NVLINK_BW, LM.NET_BW) == (
        989e12, 3.35e12, 450e9, 50e9)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 2.0) < 1e-9
    # 2x a quarter second on NVLink, plus half a second on the network
    assert abs(r.t_collective - 1.0) < 1e-9
    assert r.bottleneck == "memory"
    assert abs(r.step_time_lower_bound - 2.0) < 1e-9
    assert abs(r.useful_ratio - 0.5) < 1e-9
    d = r.to_dict()
    assert d["step_lower_bound"] == r.step_time_lower_bound
    assert RL.weighted_coll_bytes(r.coll_by_op) == 2 * int(450e9 / 4) + int(
        50e9 / 2)
    # no collective: the collective term falls back to the total
    r2 = RL.Roofline("a", "s", "m", 1, 0.0, 0.0, 50e9, {}, 1.0)
    assert abs(r2.t_collective - 1.0) < 1e-9


@pytest.mark.parametrize("S,T,causal,window", [
    (7, 7, True, None), (5, 9, True, None), (9, 9, True, 4),
    (3, 11, True, 5), (6, 6, False, None), (8, 8, True, 20)])
def test_attended_pairs_counts_the_mask(S, T, causal, window):
    from repro_torch.models.attention import causal_mask
    m = (causal_mask(S, T, T - S, window) if causal
         else torch.ones(S, T, dtype=torch.bool))
    assert RL.attended_pairs(S, T, causal, window) == int(m.sum())


def test_counter_splits_a_matmul_by_its_output():
    from torch.distributed.tensor import Replicate, Shard
    with fake_mesh((1, 4)) as mesh:
        x = _dt(mesh, (128, 256), [Replicate(), Replicate()])
        w = _dt(mesh, (256, 1024), [Replicate(), Shard(1)])
        with RL.Counter(mesh) as c:
            x @ w
        assert c.flops == 2 * 128 * 256 * 1024 // 4
        assert c.coll == {}
        wr = _dt(mesh, (256, 1024), [Replicate(), Replicate()])
        with RL.Counter(mesh) as c:
            x @ wr
        assert c.flops == 2 * 128 * 256 * 1024


def test_counter_prices_an_all_reduce_and_an_all_gather():
    from torch.distributed.tensor import Partial, Replicate, Shard
    with fake_mesh((1, 4)) as mesh:
        p = _dt(mesh, (128, 256), [Replicate(), Partial()])
        with RL.Counter(mesh) as c:
            p.redistribute(mesh, [Replicate(), Replicate()])
        assert c.coll == {"all-reduce@model": 128 * 256 * 4}
        r = RL.Roofline("a", "s", "m", 4, 0.0, 0.0, c.coll_bytes, c.coll,
                        1.0)
        assert r.t_collective == 2 * 128 * 256 * 4 / LM.NVLINK_BW
        s = _dt(mesh, (128, 256), [Replicate(), Shard(0)])
        with RL.Counter(mesh) as c:
            s.redistribute(mesh, [Replicate(), Replicate()])
        assert c.coll == {"all-gather@model": 128 * 256 * 4}
        # one inside an op: x split on its contraction dim meets a
        # column-split weight, so DTensor gathers x first
        x = _dt(mesh, (128, 256), [Replicate(), Shard(1)])
        w = _dt(mesh, (256, 1024), [Replicate(), Shard(1)])
        with RL.Counter(mesh) as c:
            x @ w
        assert c.coll == {"all-gather@model": 128 * 256 * 4}


def test_counter_on_a_one_chip_plan_has_no_collective():
    from repro_torch.configs import InputShape, get_config
    from repro_torch.core import sharding as SH
    from repro_torch.launch.steps import build_plan, cost_plan
    cfg = get_config("qwen3-0.6b", smoke=True)
    with fake_mesh((1, 1)) as mesh, SH.axis_env(SH.TRAIN_ENV):
        c = cost_plan(build_plan(cfg, InputShape("t", 32, 2, "train"), mesh,
                                 serve_layout=True), mesh)
    assert c["coll_bytes"] == 0 and c["coll_by_op"] == {}
    assert c["flops"] > RL.model_flops(cfg, 32, 2, "train") > 0
    assert c["bytes"] > c["argument_bytes"] > 0
    assert c["temp_bytes"] > 0


def test_decode_plan_keeps_the_vocab_sharded():
    """sharded_argmax reduces (B,) partials over "model": no collective in
    a decode step moves B x V elements."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.core import sharding as SH
    from repro_torch.launch.steps import build_plan, cost_plan
    cfg = get_config("qwen3-0.6b", smoke=True)
    B = 4
    with fake_mesh((2, 2)) as mesh, SH.axis_env(SH.DP_TP_ENV):
        for kind in ("decode", "decode_cb"):
            plan = build_plan(cfg, InputShape("d", 16, B, kind), mesh,
                              serve_layout=True)
            c = cost_plan(plan, mesh)
            assert c["coll_bytes"] > 0
            # the largest collective result: the embedding's all-reduce
            # of this data rank's (B/2, 1, d) rows; gathered logits
            # would hold (B/2) x V (d 128, V 512 in SMOKE)
            assert c["largest_coll"] == B // 2 * cfg.d_model
            assert c["largest_coll"] < B // 2 * cfg.vocab_size


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kernel_calls():
    from repro_torch.kernels import ops
    q, k = _meta(1, 64, 8, 32), _meta(1, 64, 4, 32)
    pq, pool = _meta(2, 8, 32), _meta(9, 4, 4, 32)
    bt = _meta(2, 4, dtype=torch.int32)
    pos = _meta(2, dtype=torch.int32)
    xe, loga = _meta(1, 96, 4, 16), _meta(1, 96, 4, dtype=torch.float32)
    b = _meta(1, 96, 8)
    g, u = _meta(1000), _meta(1000, dtype=torch.float32)
    return {
        "flash_attention": (lambda: ops.flash_attention(q, k, k,
                                                        window=16),
                            dict(q=q.shape, k=k.shape, dtype=q.dtype,
                                 causal=True, window=16), q.shape),
        "paged_attention": (lambda: ops.paged_attention(
            pq, pool, pool, bt, pos, logical_len=12),
            dict(q=pq.shape, pool=pool.shape, tables=(2, 3),
                 dtype=pq.dtype, resident=2 * 12), pq.shape),
        "ssd_scan": (lambda: ops.ssd_scan(xe, loga, b, b, chunk=32),
                     dict(xe=xe.shape, b=b.shape, chunk=32,
                          xe_dtype=xe.dtype, b_dtype=b.dtype), xe.shape),
        "nc_pack": (lambda: ops.nc_pack(g, u),
                    dict(n=1000, in_dtype=g.dtype), g.shape),
        "nc_unpack": (lambda: ops.nc_unpack(_meta(1000, dtype=torch.uint8),
                                            torch.bfloat16),
                      dict(n=1000, out_dtype=torch.bfloat16), g.shape),
    }


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                  "ssd_scan", "nc_pack", "nc_unpack"])
def test_kernel_wrappers_record_their_work_on_meta(name, monkeypatch):
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as _ref
    call, cost, shape = _kernel_calls()[name]

    def refuse(*a, **k):
        raise AssertionError("a plain version ran under the counter")
    for fn in ("attention_ref", "paged_attention_ref", "ssd_scan_ref"):
        monkeypatch.setattr(_ref, fn, refuse)
    monkeypatch.setattr(ops._nc, "pack_reference", refuse)
    monkeypatch.setattr(ops._nc, "unpack_reference", refuse)
    ops.reset_launches()
    with RL.Counter() as c:
        out = call()
    out = out[0] if isinstance(out, tuple) else out
    assert out.is_meta and tuple(out.shape) == tuple(shape)
    flops, nbytes = RL.kernel_cost(name, **cost)
    assert nbytes > 0
    assert c.kernels == {name: {"calls": 1, "flops": flops,
                                "bytes": nbytes}}
    assert getattr(ops, name).launches == 0
    with pytest.raises(RuntimeError, match="meta tensors run only under"):
        call()


def test_kernel_cost_of_flash_matches_the_bound_formula():
    """PERF.md's Bound column: 4 B Hq dh per attended pair; q, k, v and
    the output each moved once."""
    f, b = RL.kernel_cost("flash_attention", q=(1, 512, 16, 128),
                          k=(1, 512, 8, 128), dtype=torch.bfloat16,
                          causal=True)
    assert f == 4 * 16 * 128 * (512 * 513 // 2)
    assert b == 2 * (2 * 512 * 16 * 128 + 2 * 512 * 8 * 128)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_production_mesh_on_a_fake_world(multi):
    import torch.distributed as dist
    from repro_torch.launch.dryrun import join_fake_world
    shape, names = LM.PRODUCTION[multi]
    join_fake_world(int(np.prod(shape)))
    try:
        m = LM.make_production_mesh(multi_pod=multi, device_type="cpu")
        assert tuple(m.shape) == ((2, 32, 8) if multi else (32, 8))
        assert m.mesh_dim_names == names
        with pytest.raises(ValueError, match="needs"):
            LM.make_production_mesh(multi_pod=not multi, device_type="cpu")
    finally:
        dist.destroy_process_group()
