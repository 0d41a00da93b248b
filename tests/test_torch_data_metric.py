"""The port's ``metric``, ``gluon.data`` and the two vision examples
against the JAX package's, on the CPU.

- Metrics: Accuracy (on scores and on class ids), TopKAccuracy,
  CrossEntropy, Perplexity (with and without an ignored label), a
  composite and ``create`` by name, on the same numpy inputs as torch
  tensors:
  values within 1e-6 relative (the same float64 host sums; Accuracy
  counts on the tensors' device).
- Samplers: ``RandomSampler`` with a ``RandomState(s)`` gives the JAX
  order after ``np.random.seed(s)``; ``BatchSampler``'s last-batch
  modes; ``DataLoader`` batches equal to the JAX loader's, in order
  and with thread workers.
- The synthetic MNIST, FashionMNIST, CIFAR10 and CIFAR100 arrays equal
  the JAX datasets'; ``ToTensor``, ``Normalize`` and ``Resize`` agree
  with the JAX transforms.
- ``examples/mnist_gluon.py`` and ``examples/train_imagenet.py`` with
  ``--device cpu --quick``; without ``--device`` and without a card
  they raise, and the options that are not ported raise with their
  ROADMAP items; MNIST's ``--save`` writes files that load back.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import metric as jmetric
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jtransforms
from mxnet_tpu_torch import gluon, metric
from mxnet_tpu_torch.examples import mnist_gluon, train_imagenet
from mxnet_tpu_torch.gluon import data
from mxnet_tpu_torch.gluon.data.vision import transforms

torch.set_num_threads(1)


def _probs(rng, n, k):
    p = rng.rand(n, k).astype(np.float32) + 0.05
    return p / p.sum(1, keepdims=True)


METRICS = {
    "acc": (lambda: jmetric.Accuracy(), lambda: metric.Accuracy()),
    "acc-ids": (lambda: jmetric.create("acc"), lambda: metric.create("acc")),
    "top3": (lambda: jmetric.TopKAccuracy(3), lambda: metric.TopKAccuracy(3)),
    "ce": (lambda: jmetric.create("ce"), lambda: metric.create("ce")),
    "perplexity": (lambda: jmetric.Perplexity(ignore_label=2),
                   lambda: metric.Perplexity(ignore_label=2)),
    "perplexity-all": (lambda: jmetric.Perplexity(),
                       lambda: metric.Perplexity()),
    "composite": (lambda: jmetric.create(["acc", "ce",
                                          jmetric.TopKAccuracy(2)]),
                  lambda: metric.create(["acc", "ce",
                                         metric.TopKAccuracy(2)])),
}


def _metric_inputs(name, rng):
    labels = [rng.randint(0, 5, 16).astype(np.float32) for _ in range(2)]
    preds = [_probs(rng, 16, 5) for _ in range(2)]
    if name == "acc-ids":
        preds = [p.argmax(1).astype(np.float32) for p in preds]
    return labels, preds


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_values_match_jax(name):
    """Two updates, then ``get``; a reset gives NaN."""
    rng = np.random.RandomState(len(name))
    labels, preds = _metric_inputs(name, rng)
    make_ref, make = METRICS[name]
    ref, got = make_ref(), make()
    for lab, pr in zip(labels, preds):
        ref.update([mx.nd.array(lab)], [mx.nd.array(pr)])
        got.update([torch.from_numpy(lab)], [torch.from_numpy(pr)])
    (rn, rv), (gn, gv) = ref.get(), got.get()
    assert gn == rn
    np.testing.assert_allclose(gv, rv, rtol=1e-6)
    got.reset()
    value = got.get()[1]
    assert all(np.isnan(v) for v in (value if isinstance(value, list)
                                      else [value]))


def test_metric_registry_and_errors():
    assert isinstance(metric.create("top_k_accuracy", top_k=2),
                      metric.TopKAccuracy)
    assert isinstance(metric.create("ce"), metric.CrossEntropy)
    with pytest.raises(Exception, match="not registered"):
        metric.create("no-such-metric")
    with pytest.raises(ValueError):
        metric.TopKAccuracy(1)


@pytest.mark.parametrize("seed", [0, 7])
def test_random_sampler_order_matches_jax(seed):
    np.random.seed(seed)
    want = list(jdata.RandomSampler(23))
    got = list(data.RandomSampler(23, rng=np.random.RandomState(seed)))
    assert got == want


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_batch_sampler_matches_jax(last_batch):
    ref = jdata.BatchSampler(jdata.SequentialSampler(10, 3), 4, last_batch)
    got = data.BatchSampler(data.SequentialSampler(10, 3), 4, last_batch)
    for _ in range(2):                          # rollover carries over
        assert list(got) == list(ref)
        assert len(got) == len(ref)


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_batches_match_jax(workers):
    rng = np.random.RandomState(3)
    x = rng.rand(21, 1, 4, 4).astype(np.float32)
    y = rng.randint(0, 10, 21).astype(np.float32)
    np.random.seed(5)
    ref = list(jdata.DataLoader(jdata.ArrayDataset(x, y), batch_size=8,
                                shuffle=True, last_batch="keep"))
    got = list(data.DataLoader(data.ArrayDataset(x, y), batch_size=8,
                               shuffle=True, last_batch="keep",
                               num_workers=workers, thread_pool=True,
                               device="cpu", rng=np.random.RandomState(5)))
    assert len(got) == len(ref) == 3
    for (gx, gy), (rx, ry) in zip(got, ref):
        assert gx.dtype == torch.float32 and gx.device.type == "cpu"
        np.testing.assert_array_equal(gx.numpy(), rx.asnumpy())
        np.testing.assert_array_equal(gy.numpy(), ry.asnumpy())


def test_dataloader_rules():
    ds = data.ArrayDataset(np.arange(6.0))
    batches = list(data.DataLoader(ds, batch_size=4, device="cpu"))
    assert [b.dtype for b in batches] == [torch.float32] * 2
    assert [b.tolist() for b in batches] == [[0, 1, 2, 3], [4, 5]]
    with pytest.raises(NotImplementedError, match="process workers"):
        data.DataLoader(ds, batch_size=2, num_workers=2, device="cpu")
    with pytest.raises(ValueError):
        data.DataLoader(ds, batch_size=2, shuffle=True,
                        sampler=data.SequentialSampler(6), device="cpu")


def test_dataloader_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.DataLoader(data.ArrayDataset(np.zeros(4)), batch_size=2)


@pytest.mark.parametrize("name,train", [("MNIST", True), ("MNIST", False),
                                        ("FashionMNIST", True),
                                        ("CIFAR10", True),
                                        ("CIFAR100", False)])
def test_synthetic_datasets_match_jax(tmp_path, name, train):
    ref = getattr(jdata.vision, name)(root=str(tmp_path), train=train)
    got = getattr(data.vision, name)(root=str(tmp_path), train=train)
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got._data, ref._data.asnumpy())
    np.testing.assert_array_equal(got._label, ref._label)
    img, label = got[3]
    assert img.dtype == np.uint8 and label.dtype == np.int32
    with pytest.raises(Exception, match="not found"):
        getattr(data.vision, name)(root=str(tmp_path), train=train,
                                   synthetic_fallback=False)


def test_vision_transforms_match_jax(tmp_path):
    img = data.vision.CIFAR10(root=str(tmp_path))[0][0]
    pipeline = transforms.Compose([transforms.ToTensor(),
                                   transforms.Normalize((0.5, 0.4, 0.3),
                                                        (0.2, 0.25, 0.3))])
    ref = jtransforms.Compose([jtransforms.ToTensor(),
                               jtransforms.Normalize((0.5, 0.4, 0.3),
                                                     (0.2, 0.25, 0.3))])
    np.testing.assert_allclose(pipeline(img).numpy(),
                               ref(mx.nd.array(img)).asnumpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(transforms.Resize((20, 24))(img).numpy(),
                                  jtransforms.Resize((20, 24))(
                                      mx.nd.array(img)).asnumpy())
    crop = transforms.CenterCrop(16)(img)
    np.testing.assert_array_equal(crop.numpy(), img[8:24, 8:24])
    flipped = transforms.RandomFlipLeftRight(rng=np.random.default_rng(0))
    outs = {tuple(flipped(img).numpy()[0, :2, 0]) for _ in range(16)}
    assert outs == {tuple(img[0, :2, 0]), tuple(img[0, -2:, 0][::-1])}
    out = transforms.RandomResizedCrop(12, rng=np.random.default_rng(1))(img)
    assert tuple(out.shape) == (12, 12, 3)


def test_mnist_example_quick_on_the_cpu():
    args = mnist_gluon.parse_args(["--device", "cpu", "--quick"])
    res = mnist_gluon.train(args)
    assert len(res["epochs"]) == 2
    assert res["accuracy"] > 0.8
    assert res["epochs"][-1]["loss"] < res["epochs"][0]["loss"]


def test_imagenet_example_quick_on_the_cpu():
    loss = train_imagenet.main(["--device", "cpu", "--quick"])
    assert np.isfinite(loss)


def test_examples_default_to_the_card_and_refuse_what_is_not_ported(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_imagenet.main(["--quick"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mnist_gluon.main(["--quick"])
    for argv, item in ((["--data-train", "x.rec"], "Vision remainders"),
                       (["--num-devices", "2"], "Multi-GPU"),
                       (["--kv-store", "dist_sync"], "Multi-GPU")):
        with pytest.raises(NotImplementedError, match=item):
            train_imagenet.parse_args(argv)
    # --save writes a .params and a .states file that load back
    prefix = str(tmp_path / "mlp")
    mnist_gluon.main(["--device", "cpu", "--quick", "--save", prefix])
    net = mnist_gluon.build("cpu", seed=1)
    net.load_parameters(prefix + ".params")
    assert sorted(mx.nd.load(prefix + ".params")) == sorted(
        k for k, _ in net.named_parameters())
    trainer = gluon.Trainer(net.collect_params(), "adam")
    trainer.load_states(prefix + ".states")
    assert trainer.optimizer.num_update == 16    # 2 epochs of 8 batches
    args = train_imagenet.parse_args([])
    assert (args.network, args.batch_size, args.image_shape, args.lr,
            args.dtype, args.classes) == ("resnet50_v1", 128, 224, 0.1,
                                          "bfloat16", 1000)
