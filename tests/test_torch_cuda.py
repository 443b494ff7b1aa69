"""The port's CUDA kernels against their plain PyTorch versions, on the
card. This file imports neither JAX nor ``repro`` and needs no conftest,
so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips (a CUDA kernel has no CPU mode).
The full-width checks and timings are ``chip_smoke.py``'s; these use
ragged shapes.

Tolerances: topk_select exact; signs may differ only where
|x·Φ_s| ≤ 2·D·2⁻²⁴·‖x‖·‖Φ_s‖ (two f32 sums of D products in different
orders, see tests/test_torch_kernels.py); float outputs rtol = atol = 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.cs_project import project
from repro_torch.kernels.sign import unpack_signs

SHAPES = [(13, 256, 1024, 32), (7, 96, 1000, 9), (130, 128, 512, 16),
          (40, 64, 4096, 80)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (CUDA kernels have no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, s, d, k, dev):
    gen = torch.Generator(device=dev).manual_seed(n * s + d)
    phi = torch.randn(s, d, generator=gen, device=dev) / s ** 0.5
    x = ref.topk_select_ref(torch.randn(n, d, generator=gen, device=dev),
                            k)[0].contiguous()
    y = torch.where(torch.randn(n, s, generator=gen, device=dev) >= 0,
                    1.0, -1.0)
    return phi, x, y


def _hard_flips(phi, x, got, want):
    d = x.shape[1]
    acc = x.double() @ phi.double().T
    lim = 2 * d * 2.0 ** -24 * (torch.linalg.vector_norm(x.double(), dim=1)
                                [:, None]
                                * torch.linalg.vector_norm(phi.double(),
                                                           dim=1)[None])
    return int(((got != want) & (acc.abs() > lim)).sum())


def _close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,d,k", SHAPES)
def test_topk_select_exact(cuda, n, s, d, k):
    x = torch.randn(n, d, device=cuda)
    x[0, k // 2:] = 0.0          # fewer than k nonzeros: the lo fallback
    gv, gm = ops.topk_select(x, k)
    wv, wm = ref.topk_select_ref(x, k)
    assert torch.equal(gm, wm) and torch.equal(gv, wv)
    assert int(gm[0].sum()) == d


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,d,k", SHAPES)
def test_cs_project_epilogues(cuda, n, s, d, k):
    phi, x, y = _inputs(n, s, d, k, cuda)
    _close(ops.cs_project(phi, x), ref.cs_project_ref(phi, x))
    sg = ops.cs_project_sign(phi, x)
    assert _hard_flips(phi, x, sg, ref.cs_project_sign_ref(phi, x)) == 0
    assert torch.equal(unpack_signs(ops.cs_project_pack(phi, x)), sg)
    _close(project(phi, x, mode="residual", y=y),
           ref.cs_project_ref(phi, x, mode="residual", y=y))
    got = project(phi, x, mode="sign_residual", y=y)
    want = ref.cs_project_ref(phi, x, mode="sign_residual", y=y)
    assert _hard_flips(phi, x, y - got, y - want) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,d,k", SHAPES)
def test_backproject(cuda, n, s, d, k):
    phi, x, y = _inputs(n, s, d, k, cuda)
    r = ref.cs_project_ref(phi, x, mode="sign_residual", y=y)
    for tau in (1.0 / s, 1.0):
        _close(ops.backproject(x, r, phi, tau),
               ref.backproject_ref(x, r, phi, tau))


@pytest.mark.cuda
def test_kernels_count_and_refuse(cuda):
    """A CUDA tensor reaches the kernel (the counters move) or the wrapper
    raises; it never falls back to the plain version."""
    phi, x, y = _inputs(13, 256, 1024, 32, cuda)
    build.reset_launch_counts()
    ops.biht(ops.cs_project_sign(phi, x), phi, 32, 3, 1.0)
    assert build.launch_counts() == {"topk_select": 4, "cs_project": 1,
                                     "cs_project_resid": 3,
                                     "backproject": 4}
    for bad in (x.double(), x.T.contiguous().T, x[:, :512]):
        with pytest.raises(ValueError, match="CUDA kernel takes"):
            ops.cs_project_sign(phi, bad)
    with pytest.raises(ValueError, match="CUDA kernel takes"):
        ops.backproject(x, y, phi.double(), 1.0)
