"""Exporting the built-in layers against the JAX package, on the CPU.

The port's layers carry the JAX layers' ``hybrid_forward`` bodies for
Symbols. Both packages build each model with the same prefix (tests
read the JAX model's ``prefix``: its name counters depend on what ran
before), the JAX weights carried by name, and:

- ``export`` of ``resnet18_v1`` and ``vgg11`` (and ``tojson()`` of
  ``resnet18_v2``, of the space-to-depth stem, of a 2-layer BERT called
  on three ``sym.var``s and of a small transformer encoder, pre-norm and
  post-norm, with and without an additive mask)
  gives the JAX package's string letter for letter, and the
  ``.params`` files are byte-identical;
- each package imports the other's files and its outputs are within
  1e-4 of scale of the exporting model's on the same numpy-seeded
  input (float32: the graph runs the same ops). The port imports
  through ``SymbolBlock.imports`` (eagerly and hybridized: bit for bit
  the same) and ``Module``; the JAX package through ``Symbol.bind``
  with every array given (its ``SymbolBlock`` evaluates with
  ``Symbol._eval``, which gives Dropout no ``_training``, so an
  exported VGG or BERT drops activations there even in predict mode,
  and its ``Module`` cannot infer a Dropout node's shape: a traced
  random key leaks; its executor's walk gives ``_training``) and, for
  the ResNet, also ``SymbolBlock``;
- the item-1 layers (InstanceNorm, GroupNorm, the activation layers):
  forward within 1e-5 of scale of the JAX layers', and their graphs
  equal.

The scale of an output is its largest magnitude.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.gluon import nn

torch.set_num_threads(1)


def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= tol * scale, f"{what}: {gap} > {tol} x {scale}"


def carry(jnet, tnet):
    """The JAX weights into the port's model, by Gluon name."""
    pre = jnet.prefix
    tnet.load_gluon_params({k[len(pre):]: v.data().asnumpy()
                            for k, v in jnet.collect_params().items()})


def jax_bound_predict(path, inputs):
    """The JAX package's executor bound on ``path``'s checkpoint with
    ``inputs`` (``{name: array}``), one predict-mode forward."""
    sym, args, auxs = jmx.model.load_checkpoint(path, 0)
    args = dict(args, **{k: jmx.nd.array(v) for k, v in inputs.items()})
    ex = sym.bind(jmx.cpu(), args, grad_req="null", aux_states=auxs)
    return [o.asnumpy() for o in ex.forward(is_train=False)]


def same_json(a, b):
    """``a == b``, and on a miss the first node that differs."""
    if a != b:
        na, nb = json.loads(a)["nodes"], json.loads(b)["nodes"]
        first = next((i for i, (p, q) in enumerate(zip(na, nb)) if p != q),
                     min(len(na), len(nb)))
        raise AssertionError(f"graphs differ at node {first} of "
                             f"{len(na)}/{len(nb)}: "
                             f"{na[first:first + 1]} vs {nb[first:first + 1]}")


VISION = {
    "resnet18_v1": dict(classes=10),
    "vgg11": dict(classes=10),
}


@pytest.mark.parametrize("model", sorted(VISION))
def test_vision_export_equals_the_jax_package_and_imports_both_ways(
        model, tmp_path):
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    jnet = getattr(jmx.gluon.model_zoo.vision, model)(**VISION[model])
    jnet.initialize()
    jout = jnet(jmx.nd.array(x)).asnumpy()
    with tmx.cpu():
        tnet = getattr(gluon.model_zoo.vision, model)(
            prefix=jnet.prefix, **VISION[model])
        if model == "vgg11":
            tnet.initialize()
            tnet(torch.tensor(x))       # the first Dense's width
        carry(jnet, tnet)
        tout = tnet(torch.tensor(x)).numpy()
        tfiles = tnet.export(str(tmp_path / "port"))
    jfiles = jnet.export(str(tmp_path / "jax"))
    close(tout, jout, 1e-5, "forward")
    same_json(open(tfiles[0]).read(), open(jfiles[0]).read())
    assert open(tfiles[1], "rb").read() == open(jfiles[1], "rb").read()

    # the JAX package imports the port's export
    close(jax_bound_predict(str(tmp_path / "port"), {"data": x})[0], tout,
          1e-4, "jax bound import")
    if model.startswith("resnet"):
        jblock = jmx.gluon.SymbolBlock.imports(tfiles[0], ["data"],
                                               tfiles[1])
        close(jblock(jmx.nd.array(x)).asnumpy(), tout, 1e-4, "jax import")
    # the port imports the JAX export: eagerly, hybridized, and bound
    with tmx.cpu():
        tblock = gluon.SymbolBlock.imports(jfiles[0], ["data"], jfiles[1])
        got = tblock(nd.array(x)).asnumpy()
        tblock.hybridize()
        hyb = tblock(nd.array(x)).asnumpy()
        sym, args, auxs = tmx.model.load_checkpoint(str(tmp_path / "jax"), 0)
        mod = tmx.mod.Module(sym, data_names=["data"], label_names=None)
        mod.bind(data_shapes=[("data", x.shape)], for_training=False)
        mod.set_params(args, auxs)
        bound = mod.predict(tmx.io.NDArrayIter(x, batch_size=2)).asnumpy()
    close(got, jout, 1e-4, "port import")
    np.testing.assert_array_equal(hyb, got)
    close(bound, jout, 1e-4, "Module")
    assert sorted(tblock.collect_params()) == sorted(
        jnet.collect_params())


@pytest.mark.parametrize("model,kw", [("resnet18_v2", {}),
                                      ("resnet18_v1", {"stem": "s2d"})])
def test_resnet_variants_graph_equals_the_jax_package(model, kw):
    """The pre-activation blocks (``BasicBlockV2``, ``ResNetV2``'s
    parameter-free first BatchNorm) and the space-to-depth stem."""
    x = np.zeros((1, 3, 32, 32), np.float32)
    jnet = getattr(jmx.gluon.model_zoo.vision, model)(classes=10, **kw)
    jnet.initialize()
    jnet(jmx.nd.array(x))               # the deferred shapes
    with tmx.cpu():
        tnet = getattr(gluon.model_zoo.vision, model)(
            classes=10, prefix=jnet.prefix, **kw)
    same_json(tnet(tmx.sym.var("data")).tojson(),
              jnet(jmx.sym.var("data")).tojson())


def _bert_pair():
    kw = dict(vocab_size=50, units=16, hidden_size=32, num_layers=2,
              num_heads=2, max_length=16)
    jnet = jmx.gluon.model_zoo.bert.BERTModel(**kw)
    jnet.initialize()
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 50, (3, 9)).astype(np.float32)
    types = rs.randint(0, 2, (3, 9)).astype(np.float32)
    vl = np.array([9, 4, 1], np.float32)
    jout = [o.asnumpy() for o in jnet(jmx.nd.array(ids), jmx.nd.array(types),
                                      jmx.nd.array(vl))]
    with tmx.cpu():
        tnet = gluon.model_zoo.bert.BERTModel(prefix=jnet.prefix,
                                              device="cpu", **kw)
    carry(jnet, tnet)
    return jnet, tnet, (ids, types, vl), jout


def test_bert_graph_equals_the_jax_package_and_imports_both_ways(tmp_path):
    jnet, tnet, (ids, types, vl), jout = _bert_pair()
    names = ["data", "token_types", "valid_length"]
    jsym = jmx.sym.Group(list(jnet(*[jmx.sym.var(n) for n in names])))
    tsym = tmx.sym.Group(list(tnet(*[tmx.sym.var(n) for n in names])))
    same_json(tsym.tojson(), jsym.tojson())
    ops = [n["op"] for n in json.loads(tsym.tojson())["nodes"]]
    assert ops.count("flash_attention") == 2 and ops.count("LayerNorm") == 5

    tsym.save(str(tmp_path / "port-symbol.json"))
    tnet_params = {f"arg:{tnet.prefix}{k}": v.detach()
                   for k, v in tnet.gluon_params().items()}
    tmx.nd.save(str(tmp_path / "port-0000.params"), tnet_params)
    got = jax_bound_predict(str(tmp_path / "port"), dict(
        zip(names, (ids, types, vl))))
    for g, w, what in zip(got, jout, ("seq", "pooled")):
        close(g, w, 1e-4, f"jax import {what}")

    jsym.save(str(tmp_path / "jax-symbol.json"))
    jmx.nd.save(str(tmp_path / "jax-0000.params"),
                {f"arg:{k}": v.data()
                 for k, v in jnet.collect_params().items()})
    with tmx.cpu():
        tblock = gluon.SymbolBlock.imports(
            str(tmp_path / "jax-symbol.json"), names,
            str(tmp_path / "jax-0000.params"))
        args = [nd.array(a) for a in (ids, types, vl)]
        eager = tblock(*args)
        tblock.hybridize()
        hyb = tblock(*args)
        sym, arg_params, aux_params = tmx.model.load_checkpoint(
            str(tmp_path / "jax"), 0)
        mod = tmx.mod.Module(sym, data_names=names, label_names=None)
        mod.bind(data_shapes=[(n, a.shape) for n, a in zip(names, args)],
                 for_training=False)
        mod.set_params(arg_params, aux_params)
        mod.forward(tmx.io.DataBatch(args), is_train=False)
        bound = mod.get_outputs()
    for g, h, b, w, what in zip(eager, hyb, bound, jout, ("seq", "pooled")):
        close(g.asnumpy(), w, 1e-4, f"port import {what}")
        np.testing.assert_array_equal(h.asnumpy(), g.asnumpy())
        close(b.asnumpy(), w, 1e-4, f"Module {what}")


@pytest.mark.parametrize("pre_norm", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_transformer_encoder_graph_equals_the_jax_package(pre_norm,
                                                          with_mask):
    kw = dict(num_layers=1, units=8, hidden_size=16, num_heads=2,
              dropout=0.1, attention_dropout=0.1, pre_norm=pre_norm,
              prefix="enc_")
    jenc = jmx.gluon.nn.TransformerEncoder(**kw)
    jenc.initialize()
    x = np.random.RandomState(3).randn(2, 5, 8).astype(np.float32)
    jenc(jmx.nd.array(x))
    with tmx.cpu():
        tenc = nn.TransformerEncoder(device="cpu", **kw)
    carry(jenc, tenc)
    extra = ["mask"] if with_mask else []
    jsym = jenc(jmx.sym.var("data"), *[jmx.sym.var(n) for n in extra])
    tsym = tenc(tmx.sym.var("data"), *[tmx.sym.var(n) for n in extra])
    same_json(tsym.tojson(), jsym.tojson())
    ops = [n["op"] for n in json.loads(tsym.tojson())["nodes"]]
    assert ("flash_attention" in ops) is not with_mask
    # the port's graph evaluates to the JAX encoder's output
    inputs = {"data": x}
    if with_mask:
        inputs["mask"] = np.where(np.triu(np.ones((5, 5)), 1) > 0, -1e9,
                                  0).astype(np.float32)[None, None]
    want = jenc(*[jmx.nd.array(inputs[k]) for k in ["data"] + extra])
    with tmx.cpu():
        tblock = gluon.SymbolBlock(tsym, [tmx.sym.var(n)
                                          for n in ["data"] + extra],
                                   {f"{tenc.prefix}{k}": v.detach()
                                    for k, v in tenc.gluon_params().items()})
        got = tblock(*[nd.array(inputs[k]) for k in ["data"] + extra])
    close(got.asnumpy(), want.asnumpy(), 1e-4, "encoder")


ITEM1 = {
    "InstanceNorm": (lambda m: m.InstanceNorm(in_channels=4, scale=True),
                     True),
    "GroupNorm": (lambda m: m.GroupNorm(num_groups=2), True),
    "LeakyReLU": (lambda m: m.LeakyReLU(0.1), False),
    "PReLU": (lambda m: m.PReLU(in_channels=4), True),
    "ELU": (lambda m: m.ELU(0.7), False),
    "SELU": (lambda m: m.SELU(), False),
    "GELU-erf": (lambda m: m.GELU(), False),
    "GELU-tanh": (lambda m: m.GELU(approximation="tanh"), False),
    "Swish": (lambda m: m.Swish(beta=1.5), False),
    "SiLU": (lambda m: m.SiLU(), False),
}


@pytest.mark.parametrize("layer", sorted(ITEM1))
def test_item1_layers_against_the_jax_package(layer):
    """The JAX ``PReLU`` layer cannot run (its body passes ``gamma`` to
    ``F.LeakyReLU`` by keyword, which the JAX registry leaves an NDArray
    that its op then multiplies with a jax array), so the port's is
    held to the JAX op given the same slope positionally."""
    make, has_params = ITEM1[layer]
    rs = np.random.RandomState(4)
    x = rs.randn(2, 4, 3, 5).astype(np.float32)
    jnet = jmx.gluon.nn.HybridSequential(prefix="net_")
    with jnet.name_scope():
        jnet.add(make(jmx.gluon.nn))
    jnet.initialize()
    if layer != "PReLU":
        jnet(jmx.nd.array(x))
    if has_params:
        for p in jnet.collect_params().values():
            p.set_data(jmx.nd.array(rs.randn(*p.shape).astype(np.float32)))
    with tmx.cpu():
        tnet = nn.HybridSequential(prefix="net_")
        with tnet.name_scope():
            tnet.add(make(nn))
        tnet.initialize()
        tnet(torch.tensor(x))
    carry(jnet, tnet)
    if layer == "PReLU":
        alpha = jnet.collect_params()["net_prelu0_alpha"].data()
        want = jmx.nd.LeakyReLU(jmx.nd.array(x), alpha, act_type="prelu")
    else:
        want = jnet(jmx.nd.array(x))
    close(tnet(torch.tensor(x)).numpy(), want.asnumpy(), 1e-5, layer)
    same_json(tnet(tmx.sym.var("data")).tojson(),
              jnet(jmx.sym.var("data")).tojson())
