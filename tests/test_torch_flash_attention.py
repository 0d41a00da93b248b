"""The PyTorch port's flash attention (forward and backward) against
the JAX package's.

The same numpy inputs go through the JAX Pallas kernel in interpret
mode (``flash_attention_with_lse(..., interpret=True)``, as
tests/test_pallas.py runs it on the CPU) and through the port's
wrapper on CPU tensors, which takes its plain version. ``o`` and
``lse`` agree within 1e-5 in float32 (the same math summed in another
order); rows with no visible key give exact zeros and ``lse = -1e30``
on both sides. bf16 inputs are compared in float32 with atol 2e-2:
both sides round q * scale and o to bf16, and one bf16 ulp at the
outputs' magnitude (< 4) is 1.6e-2. The CUDA kernel itself is held
against the plain version on the card by
tests/test_torch_cuda_kernels.py and ``chip_smoke.py``.

The backward (K2) is held against ``jax.vjp`` of the JAX kernel in
interpret mode, once on its fused single-pass path and once on the
split dq / dk-dv path (``MXNET_TPU_FLASH_SPLIT_BWD=1``), both outputs
carrying a cotangent (the lse's folds into ``delta``). The port's
gradients come through its autograd Function on CPU tensors, which
takes the plain backward: the wiring the card uses. float32 tolerance
2e-5 absolute and relative: the gradients sum up to S products of
magnitude ~1 in another order.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (configures jax for the CPU mesh)
import jax
import jax.numpy as jnp
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import launch_counts

torch.set_num_threads(1)


def _packed_segments(rng, b, s):
    """First-fit-style rows: contiguous segments 1, 2, ... from slot 0,
    then padding (id 0); row 0 is a single full segment."""
    seg = np.zeros((b, s), np.int32)
    seg[0] = 1
    for r in range(1, b):
        pos, sid = 0, 1
        while True:
            n = int(rng.randint(1, max(2, s // 3)))
            if pos + n > s - int(rng.randint(1, 6)):
                break
            seg[r, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    return seg


CASES = {
    # name: (B, H, Sq, Skv, D, kwargs builder)
    "dense": (2, 2, 19, 19, 8, lambda rng: {}),
    "causal_q_offset": (1, 2, 9, 30, 8,
                        lambda rng: dict(causal=True, q_offset=21)),
    "causal_rows_before_keys": (1, 2, 20, 12, 8,
                                lambda rng: dict(causal=True, q_offset=-8)),
    "kv_lens_with_empty_row": (3, 2, 13, 21, 8, lambda rng: dict(
        kv_lens=np.array([0, 5, 21], np.int32))),
    "packed_with_padding": (3, 2, 24, 24, 8, lambda rng: _packed_kw(rng)),
    "scaled": (2, 1, 7, 11, 16, lambda rng: dict(sm_scale=0.3)),
}


def _packed_kw(rng):
    seg = _packed_segments(rng, 3, 24)
    return dict(segment_ids=seg,
                kv_lens=(seg > 0).sum(-1).astype(np.int32))


def _inputs(name):
    b, h, sq, skv, d, kw = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32)
               for n in (sq, skv, skv))
    return q, k, v, kw(rng)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_interpret_kernel(monkeypatch, name, dtype):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    from mxnet_tpu.ops.pallas.flash_attention import (
        flash_attention_with_lse)

    q, k, v, kw = _inputs(name)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jkw = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    want_o, want_lse = flash_attention_with_lse(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), interpret=True, **jkw)
    tkw = {key: (torch.from_numpy(val) if isinstance(val, np.ndarray)
                 else val) for key, val in kw.items()}
    before = launch_counts()
    got_o, got_lse = fa.flash_attention_with_lse(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), **tkw)
    assert launch_counts() == before          # plain version, no launch
    assert got_o.dtype == tdt and got_lse.dtype == torch.float32
    want_o = np.asarray(want_o.astype(jnp.float32))
    want_lse = np.asarray(want_lse)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got_o.float().numpy(), want_o, atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got_lse.numpy(), want_lse,
                               atol=tol, rtol=1e-5)
    empty = want_lse <= -1e29
    assert np.array_equal(got_lse.numpy() <= -1e29, empty)
    assert np.all(got_lse.numpy()[empty] == np.float32(-1e30))
    assert np.all(got_o.float().numpy()[empty] == 0.0)
    if name in ("kv_lens_with_empty_row", "causal_rows_before_keys"):
        assert empty.any()


def test_flash_attention_returns_o_alone():
    q, k, v, _ = _inputs("dense")
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, _ = fa.flash_attention_with_lse(*t, causal=True)
    assert torch.equal(fa.flash_attention(*t, causal=True), o)


def test_cpu_path_refuses_what_the_kernel_refuses():
    q = torch.zeros(1, 1, 4, 8)
    k = torch.zeros(1, 1, 6, 8)
    with pytest.raises(ValueError, match="self-attention"):
        fa.flash_attention(q, k, k,
                           segment_ids=torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(TypeError, match="kv_lens"):
        fa.flash_attention(q, k, k, kv_lens=torch.ones(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(torch.zeros(1, 1, 4, 264),
                           torch.zeros(1, 1, 4, 264),
                           torch.zeros(1, 1, 4, 264))


@pytest.mark.parametrize("skv,d,path", [(128, 64, "fused"),
                                        (129, 64, "split"),
                                        (1, 8, "fused"), (128, 65, "split"),
                                        (512, 64, "split"),
                                        (64, 256, "split")])
def test_backward_takes_one_pass_where_every_key_fits_a_block(skv, d, path):
    """K2's choice, as the JAX kernel's nk <= 2: one pass up to 128 keys
    (K, V, q', do, p and ds in shared memory at D <= 64), the dq and
    dk/dv pair past that."""
    assert fa.backward_path(skv, d) == path


def _grads_port(q, k, v, kw, do, dlse):
    """dq, dk, dv from the port's autograd Function (CPU: the plain
    backward), with cotangents on o and, when given, lse."""
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tkw = {key: (torch.from_numpy(val) if isinstance(val, np.ndarray)
                 else val) for key, val in kw.items()}
    before = launch_counts()
    if dlse is None:
        o = fa.flash_attention(*t, **tkw)
        torch.autograd.backward([o], [torch.from_numpy(do)])
    else:
        o, lse = fa.flash_attention_with_lse(*t, **tkw)
        torch.autograd.backward([o, lse], [torch.from_numpy(do),
                                           torch.from_numpy(dlse)])
    assert launch_counts() == before          # plain versions, no launch
    return [x.grad.numpy() for x in t]


def _grads_jax(q, k, v, kw, do, dlse):
    from mxnet_tpu.ops.pallas.flash_attention import (
        flash_attention, flash_attention_with_lse)

    jkw = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    if dlse is None:
        _, vjp = jax.vjp(lambda a, b, c: flash_attention(
            a, b, c, interpret=True, **jkw), *map(jnp.asarray, (q, k, v)))
        grads = vjp(jnp.asarray(do))
    else:
        _, vjp = jax.vjp(lambda a, b, c: flash_attention_with_lse(
            a, b, c, interpret=True, **jkw), *map(jnp.asarray, (q, k, v)))
        grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    return [np.asarray(g) for g in grads]


# the fused path with cotangents on o and lse; the split path on o alone
@pytest.mark.parametrize("split,with_lse", [(False, True), (True, False)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax_interpret_kernel(monkeypatch, name, split,
                                               with_lse):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MXNET_TPU_FLASH_SPLIT_BWD", "1" if split else "0")
    q, k, v, kw = _inputs(name)
    rng = np.random.RandomState(100 + sorted(CASES).index(name))
    do = rng.randn(*q.shape).astype(np.float32)
    dlse = rng.randn(*q.shape[:3]).astype(np.float32) if with_lse else None
    want = _grads_jax(q, k, v, kw, do, dlse)
    got = _grads_port(q, k, v, kw, do, dlse)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert np.isfinite(g).all(), what
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5,
                                   err_msg=what)


@pytest.mark.parametrize("split", [False, True])
def test_backward_matches_jax_on_a_multi_block_grid(monkeypatch, split):
    """S=200 on 128-wide tiles: two query and two key tiles with a
    ragged edge on the JAX side (its fused path sums dq partials across
    key tiles), causal, as tests/test_pallas.py's fused-vs-split
    golden."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MXNET_TPU_FLASH_BLOCK_Q", "128")
    monkeypatch.setenv("MXNET_TPU_FLASH_BLOCK_K", "128")
    monkeypatch.setenv("MXNET_TPU_FLASH_SPLIT_BWD", "1" if split else "0")
    rng = np.random.RandomState(7)
    q, k, v = ((rng.randn(1, 2, 200, 16) * sc).astype(np.float32)
               for sc in (0.3, 0.3, 1.0))
    do = rng.randn(1, 2, 200, 16).astype(np.float32)
    kw = dict(causal=True, kv_lens=np.array([190], np.int32))
    for g, w in zip(_grads_port(q, k, v, kw, do, None),
                    _grads_jax(q, k, v, kw, do, None)):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)


def test_backward_refuses_mismatched_operands():
    q, k, v, _ = _inputs("dense")
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = fa.flash_attention_with_lse(*t)
    with pytest.raises(ValueError, match="o/do"):
        fa.flash_attention_backward(*t, o, lse, o[:, :, :3])
    with pytest.raises(TypeError, match="lse"):
        fa.flash_attention_backward(*t, o, lse.double(), o)
