"""The port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without a CUDA
device. This file imports nothing of JAX, so it also runs where JAX is
not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import launch_counts
from mxnet_tpu_torch.ops import paged_attention as pa

CASES = [
    (1, (5, 17, 24)),          # steady-state decode, ragged lengths
    (1, (0, 1, 9)),            # a kv_len 0 row and a 1-token history
    (4, (9, 20, 4)),           # chunked prefill, causal within chunk
    (8, (3, 12, 24)),          # chunk rows before the history starts
    (20, (24, 21, 20)),        # two query tiles, the second ragged
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(seed, sq, kvls, d, dev, dtype, p=10, h=4, psize=8, npg=3):
    rng = np.random.RandomState(seed)
    b = len(kvls)
    k = rng.randn(p, h, psize, d).astype(np.float32)
    v = rng.randn(p, h, psize, d).astype(np.float32)
    table = rng.permutation(p)[:b * npg].reshape(b, npg).astype(np.int32)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    f = [torch.tensor(x, dtype=dtype, device=dev) for x in (q, k, v)]
    i = [torch.tensor(x, dtype=torch.int32, device=dev)
         for x in (table, np.asarray(kvls, np.int32))]
    return f + i


@pytest.mark.cuda
@pytest.mark.parametrize("sq,kvls", CASES)
@pytest.mark.parametrize("d", [8, 16, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_attention_kernel_matches_plain(cuda, sq, kvls, d, dtype,
                                              tol):
    args = _case(0, sq, kvls, d, cuda, dtype)
    before = launch_counts()["paged_attention"]
    got = pa.paged_flash_attention(*args)
    want = pa.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert launch_counts()["paged_attention"] == before + 1
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    for r, n in enumerate(kvls):
        if n == 0:
            assert got[r].abs().max().item() == 0.0


@pytest.mark.cuda
def test_paged_attention_kernel_refuses_bad_operands(cuda):
    q, k, v, table, kvl = _case(1, 1, (5, 17, 24), 16, cuda,
                                torch.float32)
    with pytest.raises(TypeError):
        pa.paged_flash_attention(q, k, v, table.long(), kvl)
    with pytest.raises(ValueError):
        pa.paged_flash_attention(q, k.cpu(), v, table, kvl)
