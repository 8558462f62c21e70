"""The port's device loaders against its ``HostLoader`` and the JAX
package's, on the CPU (``device="cpu"``).

``DeviceLoader`` and ``CachedDeviceLoader`` give the batches of the
port's and of the JAX ``HostLoader`` (same order, same pixels, labels,
landmarks and quality scores) epoch after epoch and after a
``set_epoch`` resume; ``create_dataloaders`` builds them from ``device``
and ``cache="device"``; an abandoned ``DeviceLoader`` iterator releases
its producer thread; a producer's error reaches the consumer; the cache
refuses a process group of more than one rank.
"""

import threading

import numpy as np
import pytest
import torch

from deepfake_vit_tpu.data.dataset import HostLoader as JaxHostLoader
from deepfake_vit_tpu.data.dataset import PreprocessedFaceDataset as JaxDataset
from deepfake_vit_tpu_torch.data import dataset as td
from deepfake_vit_tpu_torch.tools.synth_processed import write_processed

KEYS = ("image", "label", "landmarks", "quality_score")


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    return write_processed(tmp_path_factory.mktemp("proc"), (11, 5, 5), size=32, seed=3)


def _np(batch):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in
            batch.items() if k in KEYS}


def _assert_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert set(g) == set(w) == set(KEYS)
        for k in KEYS:
            np.testing.assert_array_equal(g[k], w[k].astype(g[k].dtype), err_msg=k)


def _loaders(processed, split="train", **kw):
    csv = processed / "splits" / f"{split}.csv"
    host = td.HostLoader(td.PreprocessedFaceDataset(csv, processed), **kw)
    jax_host = JaxHostLoader(JaxDataset(csv, processed), **kw)
    dev = td.DeviceLoader(td.HostLoader(td.PreprocessedFaceDataset(csv, processed), **kw), "cpu")
    cached = td.CachedDeviceLoader(td.PreprocessedFaceDataset(csv, processed), device="cpu", **kw)
    return host, jax_host, dev, cached


@pytest.mark.parametrize("kw", [dict(batch_size=4, shuffle=True, drop_last=True, seed=7),
                                dict(batch_size=2, shuffle=False, drop_last=False)])
def test_device_loaders_match_host_loaders(processed, kw):
    host, jax_host, dev, cached = _loaders(processed, **kw)
    for _ in range(3):  # epochs advance at each iteration
        want = list(jax_host)
        _assert_batches(list(host), want)
        _assert_batches(list(dev), want)
        _assert_batches(list(cached), want)
    assert len(dev) == len(cached) == len(host) == len(jax_host)
    for loader in (host, jax_host, dev, cached):  # resume at epoch 1
        loader.set_epoch(1)
    want = list(jax_host)
    for loader in (host, dev, cached):
        _assert_batches(list(loader), want)
    batch = next(iter(dev))
    assert batch["label"].dtype == torch.int64 and "image_id" not in batch


def test_create_dataloaders_device_and_cache(processed):
    loaders = td.create_dataloaders(processed, batch_size=4, num_workers=2, seed=1,
                                    image_size=32, device="cpu")
    assert set(loaders) == {"train", "val", "test"}
    assert all(isinstance(v, td.DeviceLoader) for v in loaders.values())
    cached = td.create_dataloaders(processed, batch_size=4, num_workers=2, seed=1,
                                   image_size=32, cache="device", device="cpu")
    assert all(isinstance(v, td.CachedDeviceLoader) for v in cached.values())
    host = td.create_dataloaders(processed, batch_size=4, num_workers=2, seed=1, image_size=32)
    assert all(type(v) is td.HostLoader for v in host.values())
    for split in ("train", "test"):
        want = list(host[split])
        _assert_batches(list(loaders[split]), want)
        _assert_batches(list(cached[split]), want)


def test_device_loader_abandoned_and_failing(processed):
    _, _, dev, _ = _loaders(processed, batch_size=2)
    it = iter(dev)
    next(it)
    it.close()  # abandoned after one batch: the producer is released and joined
    assert not [t for t in threading.enumerate() if t.name == "DeviceLoader producer"]

    class Broken(td.HostLoader):
        def _fetch(self, indices):
            if indices[0] >= 4:
                raise OSError("unreadable")
            return super()._fetch(indices)

    broken = td.DeviceLoader(Broken(dev.dataset, batch_size=2), "cpu")
    with pytest.raises(OSError, match="unreadable"):
        list(broken)


def test_cache_refuses_more_than_one_rank(processed, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    ds = td.PreprocessedFaceDataset(processed / "splits" / "val.csv", processed)
    with pytest.raises(RuntimeError, match="one process"):
        td.CachedDeviceLoader(ds, batch_size=2, device="cpu")
