"""Port parity for natural compression: the plain versions of the nc_pack /
nc_unpack kernels and `repro_torch.core.compression`, against the JAX
package's Pallas kernels (interpret mode) and its `core.compression`, fed
the uniforms of JAX's own draws.

Tolerances: pack codes exactly equal; unpack exactly 2^(code-70), and
within rtol 4e-6 of JAX's: XLA's exp2 on the CPU misses some integer
powers of two, by up to 2.03e-6 relative (17 ulp) over the 127 codes
(measured, jax 0.9.0); natural_compress within the same rtol of JAX's on
the wire's range (the same exp2)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import compression as JC  # noqa: E402
from repro.kernels import nat_compress as JK  # noqa: E402
from repro_torch.core import compression as TC  # noqa: E402
from repro_torch.kernels import nat_compress as NC  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

LO, HI = 2.0 ** -69, 2.0 ** 57      # the wire's range: codes 1..127
EXP2_RTOL = 4e-6
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_torch(x: jax.Array, dtype: str) -> torch.Tensor:
    return torch.tensor(np.asarray(x.astype(jnp.float32))).to(TDT[dtype])


def _wire_range_values(n, seed):
    """Signed magnitudes log-uniform over [2^-69, 2^57), with zeros."""
    r = np.random.RandomState(seed)
    x = np.exp2(r.uniform(-69, 57, n)) * r.choice([-1.0, 1.0], n)
    x[r.choice(n, n // 10, replace=False)] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,scale", [((1000,), 1e-3), ((256, 129), 1.0),
                                         ((3, 5, 7), 1e3)])
def test_nc_pack_codes_equal_jax(shape, scale, dtype):
    """The port's plain pack gives exactly the codes of the Pallas kernel
    and of `core.compression.nc_pack`, with the uniforms of their draw."""
    kx, ku = jax.random.split(jax.random.PRNGKey(len(shape)))
    x = (jax.random.normal(kx, shape) * scale).astype(getattr(jnp, dtype))
    u = jax.random.uniform(ku, (int(np.prod(shape)),), jnp.float32)
    j_kernel = np.asarray(JK.nc_pack(x, ku, interpret=True))
    j_core = np.asarray(JC.nc_pack(x, ku))
    t = ops.nc_pack(_to_torch(x, dtype),
                    torch.tensor(np.asarray(u)).reshape(shape))
    assert t.dtype == torch.uint8 and tuple(t.shape) == shape
    np.testing.assert_array_equal(t.numpy(), j_kernel)
    np.testing.assert_array_equal(t.numpy(), j_core)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nc_unpack_exact_and_near_jax(dtype):
    every = np.arange(256, dtype=np.uint8)
    t = ops.nc_unpack(torch.from_numpy(every), TDT[dtype])
    assert t.dtype == TDT[dtype]
    code = every.astype(np.int64) & 127
    exact = np.where(code == 0, 0.0, np.exp2((code - 70).astype(np.float64)))
    exact = np.where(every >= 128, -exact, exact)
    np.testing.assert_array_equal(t.double().numpy(), exact)
    for j in (JK.nc_unpack(jnp.asarray(every), getattr(jnp, dtype),
                           interpret=True),
              JC.nc_unpack(jnp.asarray(every), getattr(jnp, dtype))):
        np.testing.assert_allclose(t.double().numpy(),
                                   np.asarray(j.astype(jnp.float32)),
                                   rtol=EXP2_RTOL if dtype == "float32"
                                   else 1e-2,
                                   atol=0)


def test_pack_exponent_exact_at_powers_of_two():
    """2^k and its float predecessor for every normal and subnormal k:
    the code is floor(log2|x|) + 70 (clipped), read from the bit fields.
    u = 0 rounds every non-power up, so the predecessor of 2^k packs to
    code k + 70 and 2^k itself to k + 70 too."""
    k = np.arange(-149, 128)
    p2 = np.exp2(k.astype(np.float64)).astype(np.float32)
    pred = np.nextafter(p2, np.float32(0))
    zeros = torch.zeros(len(k))
    for x, want in ((p2, k + 70), (pred, k + 70)):
        codes = ops.nc_pack(torch.from_numpy(x), zeros).numpy().astype(int)
        want = np.clip(want, 1, 127)
        want[x == 0] = 0
        np.testing.assert_array_equal(codes, want)
    # with u just below 1 the predecessor rounds down: code k - 1 + 70
    below_one = torch.full((len(k),), 1.0 - 2.0 ** -24)
    codes = ops.nc_pack(torch.from_numpy(pred), below_one).numpy().astype(int)
    want = np.clip(k + 69, 1, 127)
    want[pred == 0] = 0
    np.testing.assert_array_equal(codes, want)


def test_natural_compress_matches_jax_on_wire_range():
    """On [2^-69, 2^57) and 0, natural_compress equals JAX's (to exp2's
    ulp), and equals the wire round trip exactly."""
    x = _wire_range_values(4000, seed=0)
    key = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(key, x.shape))
    j = np.asarray(JC.natural_compress(jnp.asarray(x), key))
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    t = TC.natural_compress(xt, ut)
    np.testing.assert_allclose(t.numpy(), j, rtol=EXP2_RTOL, atol=0)
    assert torch.equal(t, ops.nc_roundtrip(xt, ut))


def test_wire_format_saturates_outside_its_range():
    """Below 2^-69 the wire rounds up to +-2^-69, at or above 2^57 it gives
    +-2^57 (codes 1 and 127, as JAX's pack); natural_compress does not
    clip."""
    x = np.array([2.0 ** -80, -1e-30, 2.0 ** -70, 2.0 ** 57, -2.0 ** 60,
                  3e30], np.float32)
    u = np.full(x.shape, 0.5, np.float32)
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    codes = ops.nc_pack(xt, ut).numpy()
    np.testing.assert_array_equal(codes & 127, [1, 1, 1, 127, 127, 127])
    np.testing.assert_array_equal(
        codes, np.asarray(JK.nc_pack(jnp.asarray(x), jax.random.PRNGKey(0),
                                     interpret=True)))
    rt = ops.nc_roundtrip(xt, ut).numpy()
    np.testing.assert_array_equal(np.abs(rt), [LO, LO, LO, HI, HI, HI])
    np.testing.assert_array_equal(np.sign(rt), np.sign(x))
    nat = TC.natural_compress(xt, ut).numpy()
    np.testing.assert_array_equal(nat[:2], [2.0 ** -80, -(2.0 ** -100)])
    assert nat[4] == -(2.0 ** 60)


def test_natural_compress_is_unbiased():
    """E_u[C(x)] = x: the mean of 4096 draws within 3% of |x| (the
    standard error is at most 0.36 |x| / 64, so 3% is over 5 of them)."""
    x = torch.from_numpy(_wire_range_values(64, seed=1))
    x = x[x != 0]
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([ops.nc_roundtrip(x, torch.rand(x.shape, generator=g))
                         for _ in range(4096)]).double()
    err = (draws.mean(0) - x.double()).abs()
    assert bool((err <= 0.03 * x.double().abs()).all())
    ratio = draws / x.double()
    assert bool(((ratio >= 0.5) & (ratio <= 2.0)).all())


def test_compress_tree_and_wire_bytes():
    r = np.random.RandomState(2)
    tree = {"b": {"w": r.randn(4, 3).astype(np.float32)},
            "a": r.randn(5).astype(np.float32)}
    tt = {"b": {"w": torch.from_numpy(tree["b"]["w"])},
          "a": torch.from_numpy(tree["a"])}
    g = torch.Generator().manual_seed(1)
    u = TC.draw_uniforms(tt, g)
    out = TC.compress_tree(tt, u)
    assert torch.equal(out["a"], TC.natural_compress(tt["a"], u["a"]))
    assert torch.equal(out["b"]["w"],
                       TC.natural_compress(tt["b"]["w"], u["b"]["w"]))
    # leaves drawn in sorted-key order ("a" first), as JAX flattens
    g2 = torch.Generator().manual_seed(1)
    assert torch.equal(u["a"], torch.rand(5, generator=g2))
    assert torch.equal(u["b"]["w"], torch.rand(4, 3, generator=g2))
    # a generator as noise draws the same numbers leaf by leaf
    rt = TC.wire_roundtrip(tt, torch.Generator().manual_seed(1))
    assert torch.equal(rt["b"]["w"], ops.nc_roundtrip(tt["b"]["w"],
                                                      u["b"]["w"]))
    for compressed in (False, True):
        assert TC.wire_bytes(tt, compressed) == JC.wire_bytes(
            jax.tree_util.tree_map(jnp.asarray, tree), compressed)


def test_nc_wrappers_take_plain_path_on_cpu():
    ops.reset_launches()
    x = torch.randn(100)
    b = ops.nc_pack(x, torch.rand(100))
    ops.nc_unpack(b)
    assert ops.nc_pack.launches == 0 and ops.nc_unpack.launches == 0
    with pytest.raises(ValueError, match="not on"):
        NC.nc_pack(x, torch.rand(100))
    with pytest.raises(ValueError, match="uint8"):
        NC.nc_unpack(x)
