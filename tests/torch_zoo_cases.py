"""The model-zoo pairs of the port's CPU vision tests
(``test_torch_onnx.py``, ``test_torch_vision_zoo.py``): the JAX model
and the port's with the same numpy-seeded weights."""
import collections

import numpy as np
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def zoo_pair(fam, size, seed=0, jax_data=False):
    """The JAX model and the port's (same prefix) with the same
    numpy-seeded weights: the port's deferred shapes come from one CPU
    forward and the JAX parameters take those shapes, and with
    ``jax_data`` the values too (no JAX forward: its first eager call
    compiles every op). A BatchNorm with ``fix_gamma`` keeps gamma at
    one, as initialization leaves it (the exporters write gamma as it
    is, and an importer's BatchNorm reads it). Returns (jax net, port
    net, input, {gluon name: weight})."""
    jnet = getattr(jmx.gluon.model_zoo.vision, fam)(classes=10)
    rs = np.random.RandomState(seed)
    x = rs.rand(1, 3, size, size).astype(np.float32)
    with tmx.cpu():
        tnet = getattr(tmx.gluon.model_zoo.vision, fam)(
            classes=10, prefix=jnet.prefix)
        tnet.initialize()
        tnet(torch.tensor(x))
    fixed = {id(m.gamma) for m in tnet.modules()
             if isinstance(m, tmx.gluon.nn.BatchNorm) and m._fix_gamma}
    weights = {}
    for k, p in tnet.gluon_params().items():
        w = rs.randn(*p.shape).astype(np.float32)
        if id(p) in fixed:
            w = np.ones(p.shape, np.float32)
        elif k.endswith(("running_var", "gamma")):
            w = np.abs(w) * 0.5 + 0.5
        elif k.endswith("weight"):
            w *= 1.0 / np.sqrt(max(1, np.prod(p.shape[1:])))
        else:
            w *= 0.1
        weights[k] = w
    tnet.load_gluon_params(weights)
    for k, p in jnet.collect_params().items():
        w = weights[k[len(jnet.prefix):]]
        p.shape = w.shape
        if jax_data:        # the value as the parameter's one replica
            p._data = collections.OrderedDict([(jmx.cpu(0),
                                                jmx.nd.array(w))])
    return jnet, tnet, x, weights
