"""The PyTorch port stands alone: it imports neither ``jax`` nor
``mxnet_tpu``, its entry points run on the card unless asked for the
CPU, and its kernels are built only when first launched."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import context
from mxnet_tpu_torch.ops import _build

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / "mxnet_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _imports(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_file_imports_jax_or_the_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


def test_import_scan_covers_every_subpackage():
    scanned = {pathlib.Path(p).parts[1] for p in PORT_FILES
               if p.startswith("mxnet_tpu_torch/") and p.count("/") > 1}
    for sub in ("examples", "gluon", "io", "ndarray", "ops", "serving",
                "telemetry"):
        assert sub in scanned, sub
    assert "mxnet_tpu_torch/gluon/model_zoo/bert.py" in PORT_FILES


def test_import_leaves_jax_out_of_the_process():
    code = (
        "import sys\n"
        "import mxnet_tpu_torch, mxnet_tpu_torch.serving\n"
        "import mxnet_tpu_torch.ops, mxnet_tpu_torch.telemetry\n"
        "import mxnet_tpu_torch.context, mxnet_tpu_torch.envvars\n"
        "import mxnet_tpu_torch.gluon, mxnet_tpu_torch.ndarray\n"
        "import mxnet_tpu_torch.io, mxnet_tpu_torch.initializer\n"
        "import mxnet_tpu_torch.examples.word_lm\n"
        "import mxnet_tpu_torch.examples.train_imagenet\n"
        "import mxnet_tpu_torch.examples.mnist_gluon\n"
        "import mxnet_tpu_torch.metric, mxnet_tpu_torch.gluon.data\n"
        "import mxnet_tpu_torch.gluon.model_zoo.vision\n"
        "import mxnet_tpu_torch.random, mxnet_tpu_torch.engine\n"
        "import mxnet_tpu_torch.name, mxnet_tpu_torch.attribute\n"
        "import mxnet_tpu_torch.util, mxnet_tpu_torch.test_utils\n"
        "import mxnet_tpu_torch.ndarray.register\n"
        "import mxnet_tpu_torch.ndarray.op_impl_basic\n"
        "import mxnet_tpu_torch.ndarray.op_impl_random\n"
        "import mxnet_tpu_torch.ndarray.random\n"
        "import mxnet_tpu_torch.ndarray.linalg\n"
        "import mxnet_tpu_torch.graphs\n"
        "import mxnet_tpu_torch.examples.hybrid_bert\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mxnet_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_run_reference_child_imports_neither_jax_nor_the_jax_package(
        tmp_path):
    """A script that imports ``mxnet_tpu`` through ``run_reference``
    binds the port: the child's ``sys.modules`` holds no ``jax`` and no
    module file of the JAX package."""
    script = tmp_path / "probe.py"
    script.write_text(
        "import sys\n"
        "import mxnet_tpu as mx\n"
        "from mxnet_tpu.gluon import nn\n"
        "from mxnet_tpu.gluon.utils import clip_global_norm\n"
        "assert mx.__name__ == 'mxnet_tpu_torch', mx.__name__\n"
        "assert nn.Dense.__module__.startswith('mxnet_tpu_torch.')\n"
        "files = {n: getattr(m, '__file__', '') or '' "
        "for n, m in list(sys.modules.items())}\n"
        "bad = [n for n, f in files.items() if n.split('.')[0] in "
        "('jax', 'jaxlib') or '/mxnet_tpu/' in f]\n"
        "print('BAD', bad)\n"
        "import mxnet_tpu.symbol\n"
        "assert mx.symbol.__name__ == 'mxnet_tpu_torch.symbol'\n"
        "try:\n"
        "    import mxnet_tpu.profiler\n"
        "except ModuleNotFoundError as e:\n"
        "    print('MISSING', e.name)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.run_reference",
         "--ctx", "cpu", str(script)], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout
    assert "MISSING mxnet_tpu.profiler" in out.stdout
    assert '"launch_counts"' in out.stdout.splitlines()[-1]


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            context.resolve_device(dev)
    assert context.resolve_device("cpu") == torch.device("cpu")


def test_card_precision_is_full_f32_and_cudnn_deterministic(monkeypatch):
    """No TF32, and cuDNN's deterministic algorithms chosen without
    timing: one seed gives one training run on the card."""
    backends = torch.backends
    monkeypatch.setattr(backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(backends.cudnn, "benchmark", True)
    monkeypatch.setattr(backends.cudnn, "deterministic", False)
    context.set_matmul_precision()
    assert not backends.cuda.matmul.allow_tf32
    assert not backends.cudnn.allow_tf32
    assert not backends.cudnn.benchmark
    assert backends.cudnn.deterministic
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_points_raise_without_cuda(monkeypatch):
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
    from mxnet_tpu_torch.serving import (PagedCausalLM, PagedKVPool,
                                         ServingEngine)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedCausalLM(vocab=16, units=8, layers=1, heads=1, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVPool(1, 1, 8, page_size=4, n_pages=2)
    bert = dict(vocab_size=16, units=8, hidden_size=16, num_layers=1,
                num_heads=2, max_length=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BERTModel(**bert)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(lambda *a: None, bucket_lens=(8,))
    from mxnet_tpu_torch.examples.word_lm import WordLM
    from mxnet_tpu_torch.gluon.rnn import LSTM

    with pytest.raises(RuntimeError, match="no CUDA device"):
        LSTM(8, input_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WordLM(16, 4, 8, 1)
    assert WordLM(16, 4, 8, 1, device="cpu").rnn.l0_i2h_weight.device.type \
        == "cpu"
    model = PagedCausalLM(vocab=16, units=8, layers=1, heads=1,
                          max_len=8, device="cpu")
    assert model.device.type == "cpu"
    assert BERTModel(device="cpu", **bert).device.type == "cpu"
    eng = ServingEngine(lambda *a: None, device="cpu", bucket_lens=(8,))
    assert eng.device.type == "cpu"


def test_wrapper_on_cpu_takes_the_plain_version_without_building():
    from mxnet_tpu_torch.ops import launch_counts, paged_attention

    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 2, 1, 8).astype(np.float32))
    k = torch.from_numpy(rng.randn(4, 2, 4, 8).astype(np.float32))
    tbl = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    kvl = torch.tensor([3, 6], dtype=torch.int32)
    before = launch_counts()
    out = paged_attention.paged_flash_attention(q, k, k, tbl, kvl)
    assert out.shape == q.shape
    assert launch_counts() == before
    assert "paged_attention" not in _build._libs   # nothing was loaded
    # a meta q (mx.sym's shape inference): the plain version's shape,
    # nothing launched or built
    meta = paged_attention.paged_flash_attention(
        q.to("meta"), k.to("meta"), k.to("meta"), tbl.to("meta"),
        kvl.to("meta"))
    assert meta.device.type == "meta" and meta.shape == q.shape
    assert launch_counts() == before
    assert "paged_attention" not in _build._libs


def test_k1_and_k3a_wrappers_on_cpu_take_the_plain_version_unbuilt():
    from mxnet_tpu_torch.ops import (flash_attention, launch_counts,
                                     layer_norm)

    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(2, 2, 5, 8).astype(np.float32))
    seg = torch.tensor([[1, 1, 2, 2, 0], [1, 1, 1, 1, 1]],
                       dtype=torch.int32)
    x = torch.from_numpy(rng.randn(3, 4, 16).astype(np.float32))
    g, b = torch.ones(16), torch.zeros(16)
    before = launch_counts()
    assert set(before) == {"paged_attention", "flash_attention",
                           "flash_attention_bwd", "layer_norm",
                           "layer_norm_bwd", "softmax_xent_fwd",
                           "softmax_xent_bwd", "lstm_fwd", "lstm_bwd",
                           "lstm_bwd_dw", "image_resize"}
    o, lse = flash_attention.flash_attention_with_lse(
        q, q, q, kv_lens=(seg > 0).sum(1, dtype=torch.int32),
        segment_ids=seg)
    assert torch.equal(
        o, flash_attention.flash_attention_reference(
            q, q, q, kv_lens=(seg > 0).sum(1, dtype=torch.int32),
            segment_ids=seg)[0])
    assert o[0, :, 4].abs().max().item() == 0.0      # the padding row
    y = layer_norm.layer_norm_fused(x, g, b, 1e-12)
    assert torch.equal(y, layer_norm.layer_norm_reference(x, g, b, 1e-12))
    assert launch_counts() == before
    assert not {"flash_attention", "layer_norm"} & set(_build._libs)
    # meta tensors (mx.sym's shape inference): the plain versions'
    # shapes, nothing launched or built
    qm = q.to("meta")
    assert flash_attention.flash_attention(qm, qm, qm).shape == q.shape
    assert layer_norm.layer_norm_fused(
        x.to("meta"), g.to("meta"), b.to("meta")).shape == x.shape
    assert launch_counts() == before
    assert not {"flash_attention", "layer_norm"} & set(_build._libs)


def test_k6_wrappers_on_cpu_take_the_plain_version_unbuilt():
    from mxnet_tpu_torch.ops import launch_counts, lstm

    rng = np.random.RandomState(2)
    gin = torch.from_numpy(rng.randn(3, 2, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(16, 4).astype(np.float32)).t()
    h0 = c0 = torch.zeros(2, 4)
    before = launch_counts()
    out, cseq, gates = lstm.lstm_forward(gin, w, h0, c0)
    dgin, dh0, dc0, dw = lstm.lstm_backward(gates, cseq, out, w, h0, c0,
                                            out, cseq)
    assert dgin.shape == gin.shape and dw.shape == w.shape
    assert launch_counts() == before
    assert "lstm" not in _build._libs
    # meta tensors (mx.sym's shape inference): the plain version's
    # shapes, nothing launched or built
    out_m = lstm.lstm_layer_fused(gin.to("meta"), w.to("meta"),
                                  h0.to("meta"), c0.to("meta"))
    assert [tuple(t.shape) for t in out_m] == [tuple(t.shape)
                                               for t in (out, cseq)]
    assert launch_counts() == before
    assert "lstm" not in _build._libs


def test_nvcc_missing_is_an_error(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_targets_hopper_from_repo_sources():
    assert _build.ARCH_FLAGS == ("-gencode", "arch=compute_90a,code=sm_90a")
    for name in _build.SOURCES:
        src, lib = _build._target(name)
        assert os.path.isfile(src)
        assert os.path.dirname(lib) == _build.BUILD_DIR
    gitignore = (ROOT / ".gitignore").read_text().split()
    assert "mxnet_tpu_torch/_build/" in gitignore


def test_envvars_share_the_jax_package_names_and_defaults():
    import mxnet_tpu.envvars as jax_env
    from mxnet_tpu_torch import envvars

    for name, var in envvars.ENVVARS.items():
        ref = jax_env.ENVVARS[name]
        assert (var.vtype, var.default) == (ref.vtype, ref.default), name
