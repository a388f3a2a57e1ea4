"""The port's data streams and loaders.  The numpy streams must equal the
reference's bit for bit for a seed (the port keeps its own copy because
``repro.data`` imports JAX); the loaders keep order, close cleanly and
re-raise a source's exception."""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.steps import reshape_for_replicas
from repro_torch.data import pipeline, preprocess, synthetic

try:
    from repro.core import steps as jax_steps
    from repro.data import preprocess as jax_prep
    from repro.data import synthetic as jax_syn
except ImportError:
    jax_syn = None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_blob_images_and_mean_are_the_references():
    a = synthetic.blob_images(10, 4, 20, seed=3)
    b = jax_syn.blob_images(10, 4, 20, seed=3)
    for _ in range(3):
        x, y = next(a), next(b)
        assert x["images"].tobytes() == y["images"].tobytes()
        assert x["labels"].tobytes() == y["labels"].tobytes()
    m = synthetic.mean_image(synthetic.blob_images(10, 4, 20, seed=1), 2)
    mj = jax_syn.mean_image(jax_syn.blob_images(10, 4, 20, seed=1), 2)
    assert m.dtype == mj.dtype and m.tobytes() == mj.tobytes()


def test_preprocess_is_the_references():
    mean = jax_syn.mean_image(jax_syn.blob_images(10, 6, 24, seed=1), 2)
    ours = preprocess.make_image_preprocess(mean, 16, seed=5)
    theirs = jax_prep.make_image_preprocess(mean, 16, seed=5)
    src = jax_syn.blob_images(10, 6, 24, seed=0)
    for _ in range(3):
        batch = next(src)
        got, want = ours(batch), theirs(batch)
        assert got["images"].shape == (6, 16, 16, 3)
        assert got["images"].tobytes() == want["images"].tobytes()
        assert got["labels"].tobytes() == want["labels"].tobytes()
    with pytest.raises(ValueError, match="exceeds"):
        preprocess.random_crop_flip(np.zeros((1, 4, 4, 3)), 5,
                                    np.random.default_rng(0))


def test_reshape_for_replicas_is_the_references():
    batch = {"images": np.arange(48, dtype=np.float32).reshape(6, 2, 4),
             "labels": np.arange(6, dtype=np.int32)}
    got = reshape_for_replicas(batch, 3)
    want = jax_steps.reshape_for_replicas(batch, 3)
    for k in batch:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    with pytest.raises(ValueError, match="does not split"):
        reshape_for_replicas(batch, 4)


def _numbers(n):
    return ({"x": np.full((2,), i, np.float32)} for i in range(n))


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_prefetch_loader_keeps_order_and_ends(prefetch):
    loader = pipeline.PrefetchLoader(
        _numbers(5), prefetch=prefetch,
        preprocess=lambda b: {"x": b["x"] * 2},
        device_put=pipeline.to_device("cpu"))
    got = [float(b["x"][0]) for b in loader]
    assert got == [0.0, 2.0, 4.0, 6.0, 8.0]
    with pytest.raises(StopIteration):
        next(loader)
    loader.fence()
    loader.close()


def test_prefetch_loader_stages_tensors_on_the_device():
    loader = pipeline.make_loader(_numbers(2), staging="queue",
                                  device_put=pipeline.to_device("cpu"))
    b = next(loader)
    assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
    loader.close()


def test_prefetch_loader_closes_its_thread():
    def forever():
        i = 0
        while True:
            yield {"x": np.zeros(1, np.float32) + i}
            i += 1

    before = threading.active_count()
    loader = pipeline.PrefetchLoader(forever(), prefetch=2,
                                     device_put=pipeline.to_device("cpu"))
    next(loader)
    loader.close()
    assert threading.active_count() == before
    with pytest.raises(RuntimeError, match="closed"):
        next(loader)


def test_prefetch_loader_reraises_the_source_error():
    def bad():
        yield {"x": np.zeros(1, np.float32)}
        raise KeyError("broken source")

    loader = pipeline.PrefetchLoader(bad(), prefetch=2,
                                     device_put=pipeline.to_device("cpu"))
    next(loader)
    with pytest.raises(KeyError, match="broken source"):
        next(loader)
    with pytest.raises(RuntimeError, match="worker exited"):
        next(loader)
    loader.close()


def test_prefetch_loader_defaults_to_the_entry_points_device():
    """Without ``device_put`` batches stage on ``device_of(None)``, the
    card (the reference's ``jax.device_put``); where CUDA is absent that
    raises instead of staging on the CPU."""
    if torch.cuda.is_available():
        loader = pipeline.PrefetchLoader(_numbers(1), prefetch=0)
        assert next(loader)["x"].device.type == "cuda"
        loader.close()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipeline.PrefetchLoader(_numbers(1), prefetch=0)


def test_pinned_staging_refuses_a_cpu_device():
    with pytest.raises(ValueError, match="CUDA device"):
        pipeline.make_loader(_numbers(2), staging="pinned", device="cpu")
    with pytest.raises(ValueError, match="staging must be"):
        pipeline.make_loader(_numbers(2), staging="disk")


@pytest.mark.cuda
def test_pinned_loader_fences_slot_reuse(cuda):
    loader = pipeline.make_loader(_numbers(6), staging="pinned",
                                  device=cuda)
    seen = []
    for b in loader:
        assert b["x"].is_cuda
        seen.append(float(b["x"][0]))    # reads before the fence
        torch.cuda._sleep(1_000_000)      # a step still running
        loader.fence()
    assert seen == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    loader.close()
    stalled = pipeline.make_loader(_numbers(6), staging="pinned",
                                   device=cuda)
    next(stalled)
    next(stalled)
    with pytest.raises(RuntimeError, match="await fences"):
        next(stalled)
    stalled.close()
