"""The local pretrained-weight store against the JAX package, on the CPU.

``gluon/model_zoo/model_store.py`` resolves ``{name}-{sha1[:8]}.params``
under a root, checks its SHA-1 against ``model_index.json`` and never
downloads. A seeded ``resnet18_v1`` (10 classes) is saved by the port
and published into a temporary root; both packages'
``resnet18_v1(pretrained=True, root=...)`` load it and give the same
logits on the same numpy-seeded input, within 1e-4 of the logits'
largest magnitude (float32, predict mode: the same ops in another
order). ``vgg11(pretrained=True, root=...)`` loads too. A corrupt file
and a missing one raise, in both packages; nothing is fetched.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import model_store as jstore
from mxnet_tpu_torch import envvars
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import model_store, vision

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _publish(root, name, net, tmp_path):
    src = str(tmp_path / f"{name}.src.params")
    net.save_parameters(src)
    return model_store.publish_model_file(name, src, root=str(root))


def test_resnet18_pretrained_logits_match_the_jax_package(tmp_path):
    root = tmp_path / "store"
    src = vision.resnet18_v1(classes=10, device=CPU)
    src.initialize(seed=3)
    x = np.random.RandomState(0).standard_normal((2, 3, 32, 32)) \
        .astype(np.float32)
    src(torch.from_numpy(x))            # deferred shapes
    path = _publish(root, "resnet18_v1", src, tmp_path)
    sha = model_store.short_hash("resnet18_v1", root=str(root))
    assert os.path.basename(path) == f"resnet18_v1-{sha}.params"
    assert jstore.get_model_file("resnet18_v1", root=str(root)) == path

    net = vision.resnet18_v1(classes=10, pretrained=True, root=str(root),
                             ctx="cpu")
    jnet = jmx.gluon.model_zoo.vision.resnet18_v1(
        classes=10, pretrained=True, root=str(root))
    got = net(torch.from_numpy(x)).detach().numpy()
    want = jnet(jmx.nd.array(x)).asnumpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-4 * scale
    same = src(torch.from_numpy(x)).detach().numpy()
    assert np.array_equal(got, same)


def test_vgg11_pretrained_loads(tmp_path):
    root = tmp_path / "store"
    src = vision.vgg11(classes=4, device=CPU)
    src.initialize(seed=5)
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (1, 3, 32, 32)).astype(np.float32))
    src(x)
    _publish(root, "vgg11", src, tmp_path)
    net = vision.vgg11(classes=4, pretrained=True, root=str(root),
                       device=CPU)
    for (k, a), (_, b) in zip(sorted(src.named_parameters()),
                              sorted(net.named_parameters())):
        assert torch.equal(a, b), k


def test_corrupt_and_missing_files_raise_in_both_packages(tmp_path,
                                                          monkeypatch):
    root = tmp_path / "store"
    src = vision.resnet18_v1(classes=10, device=CPU)
    src.initialize(seed=3)
    src(torch.zeros(1, 3, 32, 32))
    path = _publish(root, "resnet18_v1", src, tmp_path)
    with open(path, "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\x00\x01\x02\x03")
    with pytest.raises(MXNetError, match="checksum mismatch"):
        vision.resnet18_v1(classes=10, pretrained=True, root=str(root),
                           device=CPU)
    with pytest.raises(Exception, match="checksum mismatch"):
        jmx.gluon.model_zoo.vision.resnet18_v1(classes=10, pretrained=True,
                                               root=str(root))
    empty = tmp_path / "empty"
    with pytest.raises(MXNetError, match="publish_model_file"):
        vision.resnet34_v1(pretrained=True, root=str(empty), device=CPU)
    with pytest.raises(Exception, match="publish_model_file"):
        jmx.gluon.model_zoo.vision.resnet34_v1(pretrained=True,
                                               root=str(empty))
    # the default root: $MXNET_TPU_MODEL_STORE, then $MXNET_HOME/models
    monkeypatch.setenv("MXNET_TPU_MODEL_STORE", str(root))
    assert envvars.get("MXNET_TPU_MODEL_STORE") == str(root)
    assert model_store._default_root() == str(root)
    monkeypatch.delenv("MXNET_TPU_MODEL_STORE")
    monkeypatch.setenv("MXNET_HOME", str(tmp_path / "home"))
    assert model_store._default_root() == str(tmp_path / "home" / "models")
    model_store.purge(str(root))
    assert os.listdir(root) == []
