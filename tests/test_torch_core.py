"""Port core (rng, vecmath, image) against the JAX package on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.core import rng as jrng
from tpu_pathtracer.core import vecmath as jvm
from tpu_pathtracer.core import image as jimage
from tpu_pathtracer_torch.core import rng as trng
from tpu_pathtracer_torch.core import vecmath as tvm
from tpu_pathtracer_torch.core import image as timage

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))


def _counters():
    # 2^20 counters spread over the whole uint32 range
    return (np.arange(1 << 20, dtype=np.uint64) * 2654435761
            % (1 << 32)).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_wang_hash_reference_values():
    def wang_py(a):
        a = (a ^ 61) ^ (a >> 16)
        a = (a * 9) & 0xFFFFFFFF
        a = a ^ (a >> 4)
        a = (a * 0x27D4EB2D) & 0xFFFFFFFF
        return a ^ (a >> 15)
    xs = [0, 1, 2, 12345, 0xDEADBEEF]
    got = trng.wang_hash(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [wang_py(x) for x in xs]


@pytest.mark.parametrize("fn", ["wang_hash", "pcg_hash"])
def test_hashes_bit_exact_over_2_20_counters(fn):
    x = _counters()
    want = np.asarray(getattr(jrng, fn)(jnp.asarray(x)))
    got = _u32(getattr(trng, fn)(_t(x)))
    np.testing.assert_array_equal(got, want)


def test_sampler_bit_exact_over_2_20_counters():
    x = _counters()
    js = jrng.RaySampler.init(jrng.wang_hash(jnp.uint32(7)), jnp.asarray(x))
    ts = trng.RaySampler.init(trng.wang_hash(7), _t(x))
    np.testing.assert_array_equal(_u32(ts), np.asarray(js))
    js, ju = jrng.RaySampler.next_n(js, 6)
    ts, tu = trng.RaySampler.next_n(ts, 6)
    np.testing.assert_array_equal(_u32(ts), np.asarray(js))
    for a, b in zip(ju, tu):
        assert b.dtype == torch.float32
        # _to_unit_float is exact: equal bits
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert float(torch.stack(tu).max()) < 1.0


def test_sampler_init_with_frame_hash_tensor():
    lanes = np.arange(4096, dtype=np.uint32)
    frames = (np.arange(4096) % 5 + 1).astype(np.uint32)
    js = jrng.RaySampler.init(jrng.wang_hash(jnp.asarray(frames)),
                              jnp.asarray(lanes))
    ts = trng.RaySampler.init(trng.wang_hash(_t(frames)), _t(lanes))
    np.testing.assert_array_equal(_u32(ts), np.asarray(js))


def _vecs(seed, n=4096):
    g = np.random.default_rng(seed)
    v = g.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["normalize", "make_basis", "reflect",
                                  "cosine_sample_hemisphere", "barycentric",
                                  "channel_select", "length", "luminance",
                                  "concentric_sample_disk"])
def test_vecmath_matches_jax(name):
    g = np.random.default_rng(3)
    a, b, c = _vecs(1), _vecs(2), _vecs(4)
    u1 = g.random(4096, dtype=np.float32)
    u2 = g.random(4096, dtype=np.float32)
    if name == "normalize":
        args = (a * 3.0,)
    elif name == "make_basis":
        args = (a,)
    elif name == "reflect":
        args = (a, b)
    elif name == "cosine_sample_hemisphere":
        args = (u1, u2, a)
    elif name == "barycentric":
        args = (a, b, c, a + b)
    elif name in ("length", "luminance"):
        args = (a * 2.5,)
    elif name == "concentric_sample_disk":
        args = (u1, u2)
    else:
        args = (a, g.integers(0, 3, 4096).astype(np.int32))
    want = getattr(jvm, name)(*[jnp.asarray(x) for x in args])
    got = getattr(tvm, name)(*[torch.from_numpy(x) for x in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_channel_select_is_exact():
    c = np.random.default_rng(5).random((999, 3)).astype(np.float32)
    ch = np.arange(999, dtype=np.int32) % 3
    got = tvm.channel_select(torch.from_numpy(c), torch.from_numpy(ch))
    np.testing.assert_array_equal(got.numpy(), c[np.arange(999), ch])


def test_image_tonemap_and_ppm_match(tmp_path):
    acc = np.random.default_rng(6).random((8, 9, 3)).astype(np.float32) * 3
    np.testing.assert_array_equal(timage.tonemap(acc, 2),
                                  jimage.tonemap(acc, 2))
    timage.write_ppm(str(tmp_path / "a.ppm"), acc, 2)
    jimage.write_ppm(str(tmp_path / "b.ppm"), acc, 2)
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()
    np.testing.assert_array_equal(timage.read_ppm(str(tmp_path / "a.ppm")),
                                  jimage.read_ppm(str(tmp_path / "b.ppm")))
    assert timage.rmse(acc, acc + 1) == pytest.approx(1.0)
