"""The JAX package's own example scripts, unmodified, on the port (CPU):
``python -m mxnet_tpu_torch.examples.run_reference --ctx cpu SCRIPT``.

- ``example/mnist_gluon.py --epochs 1 --save PREFIX`` (one full epoch of
  the 60000 synthetic samples; the script asserts accuracy > 0.8) and
  ``example/word_lm.py --quick`` (the script asserts perplexity below
  half the vocabulary) exit 0 in subprocesses;
- ``example/mnist_module.py --quick`` (the symbolic API: ``Module.fit``
  and ``predict``; the script asserts accuracy > 0.8) and
  ``example/rnn_bucketing.py --quick`` (``mx.rnn.LSTMCell`` through
  ``BucketingModule``; the script exits non-zero below accuracy 0.75)
  exit 0 in subprocesses, each bucket's and key's graph entry made
  once;
- neither child imports ``jax`` or a file of the JAX package (the
  runner exits 3 if one does) and each prints its launch counts and
  the graphs captured;
- the ``.params`` the MNIST script wrote load into the JAX package's
  MLP, which gives the port's logits on a fixed batch within 1e-5.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import nn

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(*args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.run_reference",
         "--ctx", "cpu", *args], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert isinstance(last["captures"], int)
    return out.stdout, last["launch_counts"]


def _mlp(lib):
    net = lib.HybridSequential()
    net.add(lib.Flatten(), lib.Dense(256, activation="relu"),
            lib.Dense(128, activation="relu"), lib.Dense(10))
    return net


def test_mnist_script_runs_and_its_params_load_into_the_jax_mlp(tmp_path):
    prefix = str(tmp_path / "mnist")
    stdout, counts = _run("example/mnist_gluon.py", "--epochs", "1",
                          "--save", prefix)
    assert "epoch 0:" in stdout and f"saved to {prefix}" in stdout
    assert not any(counts.values())         # no port kernel on the MLP
    x = np.random.RandomState(3).rand(16, 1, 28, 28).astype(np.float32)
    jnet = _mlp(jnn)
    jnet.initialize()
    jnet.load_parameters(prefix + ".params")
    with tmx.cpu():
        tnet = _mlp(nn)
    tnet.load_parameters(prefix + ".params")
    want = jnet(mx.nd.array(x)).asnumpy()
    got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert os.path.getsize(prefix + ".states") > 0


def test_word_lm_script_quick_runs():
    stdout, counts = _run("example/word_lm.py", "--quick")
    ppl = [float(line.split("perplexity ")[1].split()[0])
           for line in stdout.splitlines() if "perplexity" in line]
    assert len(ppl) == 4                  # the script asserts ppl < 100
    assert set(counts) >= {"lstm_fwd", "lstm_bwd", "lstm_bwd_dw"}


def _captures(stdout):
    return json.loads(stdout.strip().splitlines()[-1])["captures"]


def test_mnist_module_script_quick_runs():
    stdout, counts = _run("example/mnist_module.py", "--quick")
    acc = float(stdout.split("final accuracy: ")[1].split()[0])
    assert acc > 0.8
    assert not any(counts.values())
    # on the CPU an executor's entry stands for its graphs: one for the
    # training key, one for predict's
    assert _captures(stdout) == 2


def test_rnn_bucketing_script_quick_runs():
    stdout, counts = _run("example/rnn_bucketing.py", "--quick")
    accs = [float(line.rsplit("=", 1)[1]) for line in stdout.splitlines()
            if line.startswith("epoch ")]
    assert len(accs) == 4 and accs[-1] >= 0.75
    assert not any(counts.values())
    assert _captures(stdout) == 2           # buckets 3 and 5, one entry each
