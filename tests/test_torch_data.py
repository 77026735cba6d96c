"""The port's input pipeline against the JAX package's: transforms, the
caption datasets (per item and batched), ``ShardedLoader`` (order, shards,
``set_epoch``, thread workers), ``build_dataloader``, and the native .npy
reader, on the same temporary ``.npy`` files under the same seeds. Both are
numpy on the host, so every batch must be equal exactly."""

import os
import pickle

import numpy as np
import pytest

from text_to_sound_synthesis_tpu.data import datasets as jds
from text_to_sound_synthesis_tpu.data import loader as jloader
from text_to_sound_synthesis_tpu.data import transforms as jtf
from text_to_sound_synthesis_tpu import native as jnative
from text_to_sound_synthesis_torch.data import datasets as tds
from text_to_sound_synthesis_torch.data import loader as tloader
from text_to_sound_synthesis_torch.data import transforms as ttf
from text_to_sound_synthesis_torch import native as tnative

N_CLIPS = 11


@pytest.fixture
def caps_root(tmp_path):
    """An AudioCaps-layout tree: manifests, caption files, mels of two widths."""
    rng = np.random.default_rng(0)
    root = tmp_path / "caps"
    for phase, mel_phase in (("train", "train"), ("test", "val")):
        names = [f"clip{i:02d}" for i in range(N_CLIPS)]
        (root / phase).mkdir(parents=True)
        with open(root / phase / "filenames.pickle", "wb") as f:
            pickle.dump(names, f)
        (root / "text" / phase).mkdir(parents=True)
        mel_dir = root / "features" / mel_phase / "melspec_10s_22050hz"
        mel_dir.mkdir(parents=True)
        for i, n in enumerate(names):
            caps = [f"A sound number {i} take {c}" for c in range(1 + i % 3)]
            (root / "text" / phase / f"{n}.txt").write_text("\n".join(caps) + "\n")
            dt = np.float32 if i % 2 else np.float64
            np.save(mel_dir / f"{n}_mel.npy", rng.random((10, 30 + i % 4)).astype(dt))
    return str(root)


def _equal_batches(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert list(a[k]) == list(b[k]), k


def _caps(mod, root, random_crop, phase="train"):
    return mod.CapsDataset(data_root=root, phase=phase, mel_num=8, spec_len=30,
                           spec_crop_len=24, random_crop=random_crop)


@pytest.mark.parametrize("random_crop", [False, True])
def test_caps_dataset_items_and_batches_match_jax(caps_root, random_crop):
    t, j = _caps(tds, caps_root, random_crop), _caps(jds, caps_root, random_crop)
    assert len(t) == len(j) == N_CLIPS
    for i in range(N_CLIPS):
        _equal_batches(t.__getitem__(i, rng=np.random.default_rng(i)),
                       j.__getitem__(i, rng=np.random.default_rng(i)))
    idx = [3, 0, 7, 10]
    _equal_batches(t.load_batch(idx, rng=np.random.default_rng(5)),
                   j.load_batch(idx, rng=np.random.default_rng(5)))


@pytest.mark.parametrize("workers", [0, 2])
def test_sharded_loader_matches_jax(caps_root, workers):
    """Two epochs of two shards: the same batches as the JAX loader's."""
    for shard in range(2):
        kw = dict(batch_size=2, seed=3, num_shards=2, shard_index=shard, num_workers=workers)
        t = tloader.ShardedLoader(_caps(tds, caps_root, True), **kw)
        j = jloader.ShardedLoader(_caps(jds, caps_root, True), **kw)
        assert len(t) == len(j) == (N_CLIPS // 2) // 2
        for epoch in (0, 4):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            tb, jb = list(t), list(j)
            assert len(tb) == len(jb) == len(t)
            for a, b in zip(tb, jb):
                _equal_batches(a, b)


def test_shards_are_disjoint_equal_and_follow_set_epoch(caps_root):
    ds = _caps(tds, caps_root, False)
    ids = []
    for shard in range(3):
        ld = tloader.ShardedLoader(ds, 1, seed=0, num_shards=3, shard_index=shard)
        ld.set_epoch(2)
        ids.append([b["text"][0] for b in ld])
    assert len({len(x) for x in ids}) == 1 and len(ids[0]) == N_CLIPS // 3
    assert not set(ids[0]) & set(ids[1]) and not set(ids[1]) & set(ids[2])
    ld = tloader.ShardedLoader(ds, 1, seed=0, num_shards=3, shard_index=0)
    ld.set_epoch(2)
    assert [b["text"][0] for b in ld] == ids[0]            # set_epoch pins the order
    ld.set_epoch(3)
    assert [b["text"][0] for b in ld] != ids[0]


def test_loader_defaults_to_a_single_shard_without_a_group(caps_root):
    ld = tloader.ShardedLoader(_caps(tds, caps_root, False), 2)
    assert (ld.num_shards, ld.shard_index) == (1, 0)


def test_build_dataloader_matches_jax(caps_root):
    ds_cfg = {"target": "text_to_sound_synthesis_tpu.data.CapsDataset",
              "params": dict(data_root=caps_root, phase="train", mel_num=8, spec_len=30,
                             spec_crop_len=24)}
    cfg = {"dataloader": {"batch_size": 2, "num_workers": 0, "train_datasets": [ds_cfg],
                          "validation_datasets": [dict(ds_cfg, params=dict(ds_cfg["params"],
                                                                          phase="test"))]}}
    got = tloader.build_dataloader(cfg, seed=1)
    want = jloader.build_dataloader(cfg, seed=1)
    assert got["train_iterations"] == want["train_iterations"] == N_CLIPS // 2
    for a, b in zip(got["train_loader"], want["train_loader"]):
        _equal_batches(a, b)
    for a, b in zip(got["validation_loader"], want["validation_loader"]):
        _equal_batches(a, b)


def test_transforms_match_jax():
    rng = np.random.default_rng(2)
    spec = rng.random((12, 40)).astype(np.float32)
    for random_crop in (False, True):
        a = ttf.CropSpec([8, 30], random_crop)(spec, np.random.default_rng(1))
        b = jtf.CropSpec([8, 30], random_crop)(spec, np.random.default_rng(1))
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttf.to_model_range(spec), jtf.to_model_range(spec))
    np.testing.assert_array_equal(ttf.from_model_range(spec), jtf.from_model_range(spec))
    norm = ttf.StandardNormalize(spec.mean(1), spec.std(1) + 1)
    np.testing.assert_array_equal(norm(spec),
                                  jtf.StandardNormalize(spec.mean(1), spec.std(1) + 1)(spec))
    with pytest.raises(ValueError, match="smaller than crop"):
        ttf.CropSpec([20, 30])(spec)


def test_native_reader_matches_numpy_and_jax(tmp_path):
    """The port's C++ reader (built into build/native) against the numpy path
    and the JAX package's reader, f4 and f8 files, given and centred crops."""
    if not tnative.native_available():
        pytest.skip("no g++ to build the native reader")
    rng = np.random.default_rng(4)
    paths, arrays = [], []
    for i, (shape, dt) in enumerate([((20, 50), np.float32), ((24, 60), np.float64),
                                     ((20, 44), np.float32)]):
        a = rng.random(shape).astype(dt)
        paths.append(str(tmp_path / f"m{i}.npy"))
        np.save(paths[-1], a)
        arrays.append(a)
        assert tnative.npy_shape(paths[-1]) == shape
    tops, lefts = [0, 3, -1], [5, 11, -1]
    out = tnative.load_mel_batch(paths, 16, 40, tops, lefts)
    for i, a in enumerate(arrays):
        t = tops[i] if tops[i] >= 0 else (a.shape[0] - 16) // 2
        l = lefts[i] if lefts[i] >= 0 else (a.shape[1] - 40) // 2
        np.testing.assert_array_equal(out[i], ttf.to_model_range(
            a[t:t + 16, l:l + 40]).astype(np.float32))
    if jnative.native_available():
        np.testing.assert_array_equal(out, jnative.load_mel_batch(paths, 16, 40, tops, lefts))
    built = os.listdir(os.path.dirname(tnative.npy_loader._cache_dir() + "/"))
    assert any(f.startswith("libt2s_npy_") and f.endswith(".so") for f in built)
    with pytest.raises(ValueError, match="one entry per path"):
        tnative.load_mel_batch(paths, 16, 40, [0], [0])
    with pytest.raises(IOError):
        tnative.load_mel_batch([str(tmp_path / "missing.npy")], 16, 40)


def test_numpy_path_when_the_native_reader_is_off(caps_root, monkeypatch):
    """``T2S_NATIVE_LOADER=0``: the datasets read with numpy, the same values."""
    ds = _caps(tds, caps_root, True)
    fast = ds.load_batch([1, 2, 5], rng=np.random.default_rng(9))
    monkeypatch.setenv("T2S_NATIVE_LOADER", "0")
    assert not tnative.native_available()
    slow = ds.load_batch([1, 2, 5], rng=np.random.default_rng(9))
    _equal_batches(fast, slow)
