"""The PyTorch port's flash attention (forward) against the JAX
package's.

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
"""
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (configures jax for the CPU mesh)
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
        fa.flash_attention(torch.zeros(1, 1, 4, 136),
                           torch.zeros(1, 1, 4, 136),
                           torch.zeros(1, 1, 4, 136))
