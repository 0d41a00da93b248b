"""AlexNet, DenseNet, Inception V3, MobileNet V1/V2 and SqueezeNet
against the JAX package's model zoo, on the CPU.

Both packages build each family with one prefix (the JAX model's) and
carry the same numpy-seeded weights (``torch_zoo_cases.zoo_pair``:
the port's deferred shapes from one forward, the JAX parameters given
those shapes and values). Then:

- the predict-mode forwards agree within 1e-5 of scale (float32, the
  same ops in another order; the JAX model runs hybridized, one jitted
  graph, instead of compiling each op of its first eager call);
- ``export`` gives the JAX package's graph letter for letter and a
  byte-identical ``.params`` file, and the port loads the JAX file
  through ``load_parameters`` (the structural names) to the same
  forward, bit for bit;
- ``get_model`` knows every JAX name (``"mobilenet1.0"``,
  ``"squeezenet1.1"``, ``"inceptionv3"``, ...) and builds the class the
  JAX package builds.

The scale of an output is its largest magnitude.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from torch_zoo_cases import zoo_pair

torch.set_num_threads(1)

FAMILIES = [("alexnet", 64), ("densenet121", 224), ("inception_v3", 299),
            ("squeezenet1_0", 64), ("squeezenet1_1", 64),
            ("mobilenet0_25", 32), ("mobilenet_v2_0_25", 32)]


def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, f"{what}: {gap} > {tol} x {scale}"


@pytest.mark.parametrize("fam,size", FAMILIES, ids=[f for f, _ in FAMILIES])
def test_family_forward_and_export_equal_the_jax_model(fam, size, tmp_path):
    jnet, tnet, x, _ = zoo_pair(fam, size, seed=4, jax_data=True)
    jnet.hybridize()
    with jmx.autograd.predict_mode():
        want = jnet(jmx.nd.array(x)).asnumpy()
    with tmx.cpu():
        got = tnet(torch.tensor(x)).numpy()
        tfiles = tnet.export(str(tmp_path / "port"))
    close(got, want, 1e-5, f"{fam} forward")
    jfiles = jnet.export(str(tmp_path / "jax"))
    tj, jj = open(tfiles[0]).read(), open(jfiles[0]).read()
    if tj != jj:
        na, nb = json.loads(tj)["nodes"], json.loads(jj)["nodes"]
        first = next((i for i, (p, q) in enumerate(zip(na, nb)) if p != q),
                     min(len(na), len(nb)))
        raise AssertionError(f"{fam}: graphs differ at node {first}: "
                             f"{na[first:first + 1]} vs {nb[first:first + 1]}")
    assert open(tfiles[1], "rb").read() == open(jfiles[1], "rb").read()
    # the JAX model's parameter file, by structural names
    jnet.save_parameters(str(tmp_path / "jax.params"))
    with tmx.cpu():
        fresh = getattr(tmx.gluon.model_zoo.vision, fam)(classes=10)
        fresh.load_parameters(str(tmp_path / "jax.params"))
        np.testing.assert_array_equal(fresh(torch.tensor(x)).numpy(), got)


def test_get_model_knows_every_jax_name():
    jzoo, tzoo = jmx.gluon.model_zoo.vision, tmx.gluon.model_zoo.vision
    assert sorted(tzoo._models) == sorted(jzoo._models)
    with tmx.cpu():
        for name in sorted(jzoo._models):
            assert type(tzoo.get_model(name, classes=4)).__name__ == \
                type(jzoo.get_model(name, classes=4)).__name__, name
    with pytest.raises(ValueError, match="not supported"):
        tzoo.get_model("lenet5")


def test_mobilenet_relu6_clips_and_bottleneck_adds_its_input():
    """``RELU6`` is ``clip(x, 0, 6)``; a ``LinearBottleneck`` with
    stride 1 and equal widths adds its input (the JAX blocks'
    ``hybrid_forward``)."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import mobilenet

    x = torch.linspace(-3, 9, 13)
    with tmx.cpu():
        np.testing.assert_array_equal(mobilenet.RELU6()(x).numpy(),
                                      np.clip(x.numpy(), 0, 6))
        blk = mobilenet.LinearBottleneck(4, 4, 2, 1)
        blk.initialize()
        y = torch.randn(1, 4, 5, 5)
        assert blk.use_shortcut
        np.testing.assert_allclose(blk(y).numpy(),
                                   (blk.out(y) + y).numpy(), rtol=0, atol=0)
