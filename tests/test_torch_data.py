"""The port's latent datasets and batch loader against the JAX package's:
the same files, seed and epochs give the same batches bit for bit (the
per-epoch shuffle, the crops, short songs tiled, ``drop_last``, ``shard``),
on the numpy path and on the native engine (``native/``), which equals
both the numpy path and the JAX package's native path.  The native library
that cannot be built makes ``BatchLoader(native=True)`` raise."""

import threading

import numpy as np
import pytest

from jatsr_tpu.data import dataset as jds
from jatsr_torch.data import dataset as tds
from jatsr_torch.data import native_loader as tnl

C, TARGET = 32, 64
# Song lengths: longer than the crop, shorter (tiled), exactly the crop.
TRAIN_FRAMES = (120, 50, 64, 200, 97)
VAL_FRAMES = (150, 40, 64)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("latents")
    rs = np.random.RandomState(0)
    for split, lengths in (("train", TRAIN_FRAMES), ("val", VAL_FRAMES)):
        d = root / split
        d.mkdir()
        for i, n in enumerate(lengths):
            hr = rs.randn(n, C).astype(np.float16)
            np.save(d / f"s{i}.hr.npy", hr)
            np.save(d / f"s{i}.lr.npy",
                    (0.8 * hr + 0.1 * rs.randn(n, C)).astype(np.float16))
    return root


def _epochs(loader, epochs=(0, 1)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out.append([(np.asarray(hr), np.asarray(lr)) for hr, lr in loader])
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch)
        for (gh, gl), (wh, wl) in zip(g_epoch, w_epoch):
            assert gh.dtype == wh.dtype == np.float32
            np.testing.assert_array_equal(gh, wh)
            np.testing.assert_array_equal(gl, wl)


def _pair(mod, data_dir, split, seed=3, multiplier=3, **kw):
    if split == "train":
        ds = mod.LatentDataset(str(data_dir), "train", TARGET, multiplier,
                               seed=seed)
    else:
        ds = mod.ValidationDataset(str(data_dir), "val", TARGET, multiplier)
    return mod.BatchLoader(ds, kw.pop("batch_size", 4), seed=seed, **kw)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, drop_last=True),
    dict(shuffle=True, drop_last=False),
    dict(shuffle=False, drop_last=True, prefetch=0),
    dict(shuffle=True, drop_last=True, shard=(1, 2)),
    dict(shuffle=True, drop_last=True, shard=(0, 4), batch_size=8)],
    ids=["shuffle", "keep_last", "in_order", "shard_1_of_2", "shard_0_of_4"])
def test_training_batches_equal_jax_over_two_epochs(data_dir, kw):
    got = _epochs(_pair(tds, data_dir, "train", **kw))
    want = _epochs(_pair(jds, data_dir, "train", **kw))
    _assert_same(got, want)
    assert got[0][0][0].shape[1:] == (TARGET, C)
    # The shuffle and the crops move with the epoch.
    assert not np.array_equal(got[0][0][0], got[1][0][0])


@pytest.mark.parametrize("multiplier", [1, 3])
def test_validation_batches_equal_jax(data_dir, multiplier):
    kw = dict(shuffle=False, drop_last=False, multiplier=multiplier)
    _assert_same(_epochs(_pair(tds, data_dir, "val", **kw)),
                 _epochs(_pair(jds, data_dir, "val", **kw)))


def test_crop_plans_equal_jax(data_dir):
    """``sample_plan`` is a pure function of (seed, epoch, index)."""
    for seed in (0, 42):
        a = tds.LatentDataset(str(data_dir), "train", TARGET, 6, seed=seed)
        b = jds.LatentDataset(str(data_dir), "train", TARGET, 6, seed=seed)
        for epoch in (0, 7):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert [a.sample_plan(i) for i in range(len(a))] == \
                [b.sample_plan(i) for i in range(len(b))]


@pytest.mark.parametrize("split", ["train", "val"])
def test_native_path_equals_the_numpy_path_and_jax_native(data_dir, split):
    kw = dict(drop_last=False, multiplier=3)
    got = _epochs(_pair(tds, data_dir, split, native=True, **kw))
    _assert_same(got, _epochs(_pair(tds, data_dir, split, **kw)))
    _assert_same(got, _epochs(_pair(jds, data_dir, split, native=True, **kw)))


def test_native_loader_raises_when_the_library_cannot_build(
        data_dir, tmp_path, monkeypatch):
    (tmp_path / "Makefile").write_text("all:\n\tfalse\n")
    monkeypatch.setattr(tnl, "_NATIVE_DIR", tmp_path)
    monkeypatch.setattr(tnl, "_LIB_PATH", tmp_path / "build" / "none.so")
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "_build_error", None)
    with pytest.raises(RuntimeError, match="native loader requested"):
        _pair(tds, data_dir, "train", native=True)
    assert not tnl.is_available() and tnl.build_error()


def test_transform_runs_on_the_prefetch_thread(data_dir):
    threads = set()

    def transform(hr, lr):
        threads.add(threading.get_ident())
        return hr * 2, lr

    plain = _epochs(_pair(tds, data_dir, "train"), (0,))
    moved = _epochs(_pair(tds, data_dir, "train", transform=transform), (0,))
    assert threads and threading.get_ident() not in threads
    np.testing.assert_array_equal(moved[0][1][0], 2 * plain[0][1][0])


def test_an_early_stop_ends_the_prefetch_thread(data_dir):
    loader = _pair(tds, data_dir, "train", batch_size=1, prefetch=1)
    before = threading.active_count()
    it = iter(loader)
    next(it)
    assert threading.active_count() == before + 1
    it.close()
    assert threading.active_count() == before


def test_a_failing_batch_raises_in_the_consumer(data_dir):
    def transform(hr, lr):
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(_pair(tds, data_dir, "train", transform=transform))
