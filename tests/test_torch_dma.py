"""The port's row gather / scatter (ops/dma_rows.py) against the JAX
probe's Pallas kernels (tools/probe_dma.py) run with interpret=True.

Pure data movement: every comparison is exact. The JAX tool is loaded
from its file (tools/ is not a package).
"""
import functools
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer_torch.ops import dma_rows
from tpu_pathtracer_torch.tools import probe_dma

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, CHUNK, WINDOW = 512, 256, 8


@functools.lru_cache(maxsize=1)
def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_dma", os.path.join(REPO, "tools", "probe_dma.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(C, kind, seed=0):
    g = np.random.default_rng(seed)
    tab = g.standard_normal(P * 16 if C == 0 else (P, C)).astype(np.float32)
    if kind == "perm":
        idx = g.permutation(P)
    else:                                  # runs of 8 consecutive rows
        idx = (g.permutation(P // 8)[:, None] * 8 + np.arange(8)).reshape(-1)
    return tab, idx.astype(np.int32)


@pytest.mark.parametrize("C,kind,batch", [
    (128, "perm", 1), (0, "perm", 1), (16, "perm", 1), (128, "run8", 8),
    (0, "run8", 8)], ids=["wide", "flat", "c16", "batch8", "flat_batch8"])
def test_gather_matches_jax_interpret(C, kind, batch):
    tab, idx = _inputs(C, kind)
    jg = _jax_probe().make_dma_gather(P, C, chunk=CHUNK, window=WINDOW,
                                      batch=batch, interpret=True)
    want = np.asarray(jg(jnp.asarray(tab), jnp.asarray(idx)))
    got = dma_rows.make_dma_gather(P, C, chunk=CHUNK, window=WINDOW,
                                   batch=batch)(torch.from_numpy(tab),
                                                torch.from_numpy(idx))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C", [128, 16])
def test_scatter_matches_jax_interpret(C):
    tab, idx = _inputs(C, "perm", seed=1)
    js = _jax_probe().make_dma_scatter(P, C, chunk=CHUNK, window=WINDOW,
                                       interpret=True)
    want = np.asarray(js(jnp.asarray(tab), jnp.asarray(idx)))
    got = dma_rows.make_dma_scatter(P, C, chunk=CHUNK, window=WINDOW)(
        torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_gather_follows_the_formula_without_runs():
    """batch=G reads only idx[j*G] and copies G rows from there, whatever
    the other indices say."""
    g = np.random.default_rng(2)
    tab = torch.from_numpy(g.standard_normal((P, 16)).astype(np.float32))
    idx = torch.from_numpy(g.integers(0, P - 4, P).astype(np.int32))
    got = dma_rows.make_dma_gather(P, 16, chunk=CHUNK, batch=4)(tab, idx)
    j = np.arange(P)
    src = idx.numpy()[(j // 4) * 4] + j % 4
    np.testing.assert_array_equal(got.numpy(), tab.numpy()[src])


def test_window_and_chunk_change_nothing():
    tab, idx = _inputs(128, "perm", seed=3)
    tab, idx = torch.from_numpy(tab), torch.from_numpy(idx)
    ref = dma_rows.make_dma_gather(P, 128, chunk=P)(tab, idx)
    for chunk, window in ((64, 1), (128, 32), (512, 16)):
        got = dma_rows.make_dma_gather(P, 128, chunk=chunk,
                                       window=window)(tab, idx)
        assert torch.equal(got, ref)


def _gather(**kw):
    args = dict(P=P, C=16, chunk=CHUNK, window=WINDOW, batch=1)
    args.update(kw)
    return dma_rows.make_dma_gather(**args)


@pytest.mark.parametrize("kw", [
    dict(P=P + 8), dict(chunk=100, batch=8), dict(chunk=0), dict(window=0),
    dict(batch=0), dict(C=-1)],
    ids=["p_mod_chunk", "chunk_mod_batch", "chunk0", "window0", "batch0",
         "negative_c"])
def test_factory_raises(kw):
    with pytest.raises(ValueError):
        _gather(**kw)


def test_scatter_factory_raises():
    with pytest.raises(ValueError):
        dma_rows.make_dma_scatter(P + 1, 16, chunk=CHUNK)
    with pytest.raises(ValueError):
        dma_rows.make_dma_scatter(P, 0, chunk=CHUNK)


@pytest.mark.parametrize("case", [
    "tab_f64", "idx_i64", "tab_shape", "idx_shape", "idx_not_tensor"])
def test_wrapper_raises_on_bad_arguments(case):
    tab = torch.zeros((P, 16))
    idx = torch.arange(P, dtype=torch.int32)
    if case == "tab_f64":
        tab = tab.double()
    elif case == "idx_i64":
        idx = idx.long()
    elif case == "tab_shape":
        tab = torch.zeros((P, 17))
    elif case == "idx_shape":
        idx = idx[:-1]
    else:
        idx = idx.numpy()
    with pytest.raises((ValueError, TypeError)):
        _gather()(tab, idx)
    with pytest.raises((ValueError, TypeError)):
        dma_rows.make_dma_scatter(P, 16, chunk=CHUNK)(tab, idx)


@pytest.mark.parametrize("bad", [-1, P])
def test_wrapper_raises_on_indices_out_of_range(bad):
    tab = torch.zeros((P, 16))
    idx = torch.arange(P, dtype=torch.int32)
    idx[17] = bad
    with pytest.raises(IndexError):
        _gather()(tab, idx)
    with pytest.raises(IndexError):
        dma_rows.make_dma_scatter(P, 16, chunk=CHUNK)(tab, idx)


def test_batch_gather_raises_on_a_run_past_the_end():
    tab = torch.zeros((P, 16))
    idx = torch.zeros(P, dtype=torch.int32)
    idx[8] = P - 4                        # rows P-4 .. P+3: past the end
    with pytest.raises(IndexError):
        _gather(batch=8)(tab, idx)
    idx[8] = P - 8                        # the last whole run is fine
    _gather(batch=8)(tab, idx)


def test_cpu_wrapper_launches_nothing():
    before = dict(dma_rows.LAUNCHES)
    tab, idx = _inputs(16, "perm")
    _gather()(torch.from_numpy(tab), torch.from_numpy(idx))
    dma_rows.make_dma_scatter(P, 16, chunk=CHUNK)(torch.from_numpy(tab),
                                                  torch.from_numpy(idx))
    assert dma_rows.LAUNCHES == before


def test_bare_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        dma_rows.gather_rows_cuda(torch.zeros((8, 16)),
                                  torch.zeros(8, dtype=torch.int32))


def test_byte_bound_of_the_pool_row():
    """(1,048,576 x 16) f32 by a permutation: 64 MiB read + 64 MiB written
    + 4 MiB of indices = 138.4 MB, 41.3 us at 3.35 TB/s."""
    idx = probe_dma.indices(1 << 20, "perm")
    b = probe_dma.bound_bytes(idx, 0, 1)
    assert b == 138_412_032
    assert b / probe_dma.HBM_BYTES_PER_S * 1e6 == pytest.approx(41.3, abs=0.05)
    # a constant index reads one row only
    assert probe_dma.bound_bytes(probe_dma.indices(4096, "const"), 16, 1) \
        == (1 + 4096) * 64 + 4096 * 4


def test_probe_dma_cpu_run(capsys):
    assert probe_dma.main(["--device", "cpu", "--rows", "4096"]) == 0
    out = capsys.readouterr().out
    for name, *_ in probe_dma.CASES:
        assert name in out
    assert "not measured" in out


def test_probe_dma_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert probe_dma.main(["--device", "cuda"]) == 1
