"""The port's copy of the training data module against ``fav_tpu/data/cifar.py``.

Tolerance class: exact. The same arguments give the same bytes: the
synthetic images and labels of draws 0 and 1, the shuffled index and batch
streams, and the pickle reader on a small archive in the CIFAR-10 layout.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

from fav_tpu.data import cifar as jcifar
from fav_tpu_torch.data import cifar as tcifar


@pytest.mark.parametrize("draw", [0, 1])
def test_synthetic_cifar10_same_bytes(draw):
    seed, recipe = tcifar.DRAWS[draw]
    assert (seed, tuple(recipe)) == (jcifar.DRAWS[draw][0], tuple(jcifar.DRAWS[draw][1]))
    got = tcifar.synthetic_cifar10(train_size=64, test_size=16, seed=seed, recipe=recipe)
    want = jcifar.synthetic_cifar10(train_size=64, test_size=16, seed=seed, recipe=jcifar.DRAWS[draw][1])
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
        else:
            assert g == w


def test_draws_and_recipe_defaults_equal_fav_tpu():
    assert sorted(tcifar.DRAWS) == sorted(jcifar.DRAWS)
    for k in tcifar.DRAWS:
        assert tcifar.DRAWS[k][0] == jcifar.DRAWS[k][0]
        assert tcifar.DRAWS[k][1]._asdict() == jcifar.DRAWS[k][1]._asdict()


@pytest.mark.parametrize("n,batch,drop", [(100, 16, True), (100, 16, False), (64, 64, True)])
def test_index_iterator_same_stream(n, batch, drop):
    got = tcifar.index_iterator(n, batch, seed=3, epochs=3, drop_remainder=drop)
    want = jcifar.index_iterator(n, batch, seed=3, epochs=3, drop_remainder=drop)
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_iterator_same_batches():
    ds = tcifar.synthetic_cifar10(train_size=40, test_size=8, hardness=0.0)
    got = list(tcifar.batch_iterator(ds.train_images, ds.train_labels, 8, seed=1, epochs=2))
    want = list(jcifar.batch_iterator(ds.train_images, ds.train_labels, 8, seed=1, epochs=2))
    assert len(got) == len(want) == 10
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()


def _write_archive(root, rng):
    d = root / tcifar.CIFAR_DIRNAME
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                 b"labels": rng.integers(0, 10, 4).tolist()}
        with open(d / name, "wb") as f:
            pickle.dump(batch, f)
    return d


def test_load_cifar10_reads_the_pickle_layout(tmp_path):
    _write_archive(tmp_path, np.random.default_rng(0))
    got = tcifar.load_cifar10(str(tmp_path))
    want = jcifar.load_cifar10(str(tmp_path))
    assert got.source == want.source == "cifar10"
    assert got.train_images.shape == (20, 32, 32, 3) and got.test_images.shape == (4, 32, 32, 3)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_load_cifar10_without_an_archive(tmp_path, monkeypatch):
    monkeypatch.delenv("FAV_CIFAR_DIR", raising=False)
    with pytest.raises(FileNotFoundError):
        tcifar.load_cifar10(str(tmp_path), allow_synthetic=False)
    monkeypatch.setenv("FAV_SYNTH_DRAW", "9")
    with pytest.raises(ValueError, match="no recipe"):
        tcifar.load_cifar10(str(tmp_path))
