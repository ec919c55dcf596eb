"""The parity harness: the JAX package's init_model weights carried to the
port through `repro_torch.bridge`, one leaf to one tensor.  The other
port test files import `configs` and `params` from here, so every parity
test feeds both packages the same weights."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402

ARCH = "qwen3-0.6b"


def configs(**kw):
    """(jax cfg, torch cfg) for the qwen3-0.6b SMOKE config in fp32."""
    return (jax_get_config(ARCH, smoke=True).with_(**kw),
            torch_get_config(ARCH, smoke=True).with_(**kw))


def params(jcfg, seed=0):
    """JAX init_model weights and the same weights carried to the port."""
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


# config fields of the port alone: kernel flags the JAX package lacks
PORT_ONLY_FIELDS = {"use_ssd_kernel": False}


def test_config_copy_matches_jax():
    """The port's copies of CONFIG and SMOKE (every ported arch) equal
    the JAX ones field by field, apart from the port's own kernel flags
    (off by default), and param_count agrees."""
    from repro.models.config import param_count as jax_count
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.config import param_count
    for arch in ARCH_IDS:
        for smoke in (False, True):
            j = jax_get_config(arch, smoke=smoke)
            t = torch_get_config(arch, smoke=smoke)
            own = {k: v for k, v in t.__dict__.items()
                   if k not in PORT_ONLY_FIELDS}
            assert j.__dict__ == own
            for k, v in PORT_ONLY_FIELDS.items():
                assert getattr(t, k) == v
            assert param_count(t) == jax_count(j)


def test_params_round_trip_is_exact():
    jcfg, _ = configs()
    jp, tp = params(jcfg)
    back = dict(_flat(params_to_numpy(tp)))
    for name, leaf in _flat(jax.tree_util.tree_map(np.asarray, jp)):
        assert back[name].dtype == np.float32
        np.testing.assert_array_equal(back[name], leaf)


def test_params_from_numpy_bf16_and_cast():
    """ml_dtypes bfloat16 leaves arrive as torch.bfloat16 with the same
    values; `dtype=` casts every leaf."""
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    tree = {"a": np.asarray(jnp.asarray(x, jnp.bfloat16)), "b": {"c": x}}
    t = params_from_numpy(tree, "cpu")
    assert t["a"].dtype == torch.bfloat16 and t["b"]["c"].dtype == torch.float32
    np.testing.assert_array_equal(t["a"].float().numpy(),
                                  tree["a"].astype(np.float32))
    c = params_from_numpy(tree, "cpu", torch.bfloat16)
    assert c["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(c["a"], t["a"])


def test_params_from_numpy_needs_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"a": np.zeros(2, np.float32)})
