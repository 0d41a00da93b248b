"""SSD-300 over VGG-16 (``examples/ssd.py``) against the JAX package, on
the CPU.

The narrow SSD-300 (every width divided by 16, input 300 x 300, still
8732 anchors) is built in both packages from the same block code
(``ssd.build(mx, div=16)``), the JAX model's Xavier weights carried to
the port through a ``.params`` file (structural names). One training
step of ``example/ssd_detection.py``'s loss on the same batch (two
scenes, labels padded with -1 rows): the loss within 1e-5 relative,
every parameter's gradient within 1e-4 of its scale (the largest
magnitude of the JAX gradient), the class and box targets equal. Then
the port alone: ``hybridize()`` gives eager's loss and gradients, a
few SGD steps through ``ImageDetIter`` lower the loss, and
``detect`` returns the deploy contract. VGG-16 itself is held in
``tests/test_torch_save_load.py`` (its ``.params`` both ways and its
forward at 32 x 32).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples import ssd

torch.set_num_threads(1)


def _batch(n=2, seed=0):
    images, labels = ssd.synthetic_scenes(n, seed=seed)
    x = (np.stack(images).transpose(0, 3, 1, 2).astype(np.float32)
         - 120.0) / 60.0
    lab = -np.ones((n, 4, 5), np.float32)
    for i, l in enumerate(labels):
        lab[i, :min(len(l), 4)] = l[:4]
    return x, lab


def _step(mx, net, x, lab):
    """Loss, targets and anchors of one step of the example's loss,
    without the update (the gradients stay on the parameters)."""
    nd = mx.nd
    loss, _, _ = ssd.forward_backward(mx, net, ssd.make_trainer(mx, net)[0],
                                      x, lab)
    with mx.autograd.pause():
        anchors, cls_p, _ = net(x)
        targets = nd.contrib.MultiBoxTarget(anchors, lab, cls_p,
                                            **ssd.TARGET)
    return loss, targets, anchors


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    x, lab = _batch()
    with jmx.cpu():
        jmx.random.seed(0)
        jnet = ssd.build(jmx, div=16)
        jnet.initialize(init=jmx.initializer.Xavier())
        jnet.hybridize()          # one XLA program: the cheaper compile
        jloss, jt, janchors = _step(jmx, jnet, jmx.nd.array(x),
                                    jmx.nd.array(lab))
    path = str(tmp_path_factory.mktemp("ssd") / "ssd.params")
    jnet.save_parameters(path)
    jgrads = {k: p.grad().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    return x, lab, path, {"loss": float(jloss.asnumpy()),
                          "targets": [t.asnumpy() for t in jt],
                          "anchors": janchors.asnumpy(), "grads": jgrads}


def _port(path, hybridize=False):
    with tmx.cpu():
        net = ssd.build(tmx, div=16)
    net.load_parameters(path)
    if hybridize:
        net.hybridize()
    return net


def test_step_matches_jax(pair):
    x, lab, path, ref = pair
    net = _port(path)
    loss, targets, anchors = _step(tmx, net, torch.from_numpy(x),
                                   torch.from_numpy(lab))
    assert anchors.shape == (1, ssd.ANCHORS, 4)
    np.testing.assert_allclose(anchors.numpy(), ref["anchors"], rtol=0,
                               atol=1e-6)
    for got, want in zip(targets, ref["targets"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(targets[2].numpy(), ref["targets"][2])
    assert abs(float(loss.detach()) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert sorted(grads) == sorted(ref["grads"])
    for k, want in ref["grads"].items():
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_hybridized_step_equals_eager(pair):
    x, lab, path, _ = pair
    res = []
    for hyb in (False, True):
        net = _port(path, hybridize=hyb)
        loss, _, _ = _step(tmx, net, torch.from_numpy(x),
                           torch.from_numpy(lab))
        res.append((float(loss.detach()), {k: p.grad.clone()
                                  for k, p in net.named_parameters()}))
    assert res[0][0] == res[1][0]
    for k, g in res[0][1].items():
        assert torch.equal(g, res[1][1][k]), k


def test_training_through_image_det_iter(tmp_path):
    images, labels = ssd.synthetic_scenes(8, seed=1)
    path, _ = ssd.write_rec(tmx, str(tmp_path / "s.rec"), images, labels)
    it = ssd.det_iter(tmx, path, 4, ctx=tmx.cpu(), seed=1)
    batches = [(b.data[0], b.label[0]) for b in it]
    assert len(batches) == 2 and batches[0][1].shape == (4, 8, 5)
    with tmx.cpu():
        net = ssd.build(tmx, div=16)
        net.initialize(init=tmx.init.Xavier(), seed=1)
    loss_fn, trainer = ssd.make_trainer(tmx, net)
    losses = []
    for i in range(6):
        x, lab = batches[i % 2]
        loss, _, _ = ssd.train_step(tmx, net, loss_fn, trainer, x, lab)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    det = ssd.detect(tmx, net, batches[0][0]).asnumpy()
    assert det.shape == (4, ssd.ANCHORS, 6)
    for rows in det:
        kept = rows[rows[:, 0] >= 0]
        assert 0 < len(kept) <= ssd.DEPLOY["nms_topk"]
        assert (np.diff(kept[:, 1]) <= 0).all()          # score order
        assert (rows[len(kept):] == -1).all()
