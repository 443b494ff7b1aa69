"""K7: the greedy scheduler's prefix sweep (P2 scheduling).

Port of ``repro/kernels/prefix_eval.py``. For each row of the cap-sorted
(B, U) arrays, prefix j (the j + 1 workers with the largest caps) has
s1 = j + 1 workers, weight mass s2 = K_0 + … + K_j (a running sum) and
min-cap b = caps_j, and

    R(s1, s2, b) = ρ1 (Ktot − s2)/Ktot + A + N/(s2·b)² + s1·E   (eq. 24)

with the per-row scalars packed as coefs (B, 8) = [Ktot, ρ1, A, E, N, 0,
0, 0]. The argmin stays with the caller. The CUDA kernel is
``csrc/prefix_eval.cu``; ``prefix_eval_plain`` is the PyTorch version the
CPU runs and the card checks against. Both round every operation of
``prefix_rt`` on its own, in its order, so where every prefix sum is exact
(whole-number K_i, as in the paper) the two agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

N_COEF = 8    # packed per-row scalar coefficients (5 used)


def prefix_rt(s1, s2, b, *, ktot, rho1, A, E, N):
    """R_t from the prefix sufficient statistics (eq. 24 regrouped), in
    the reference's op order; the square is one product."""
    sb = s2 * b
    return rho1 * (ktot - s2) / ktot + A + N / (sb * sb) + s1 * E


def _check(caps_sorted, k_sorted, coefs):
    B, U = caps_sorted.shape
    if tuple(k_sorted.shape) != (B, U) or tuple(coefs.shape) != (B, N_COEF):
        raise ValueError(f"prefix_eval: caps {tuple(caps_sorted.shape)}, "
                         f"K {tuple(k_sorted.shape)} and coefs "
                         f"{tuple(coefs.shape)} must be (B, U), (B, U) and "
                         f"(B, {N_COEF})")
    return B, U


def prefix_eval_plain(caps_sorted: torch.Tensor, k_sorted: torch.Tensor,
                      coefs: torch.Tensor) -> torch.Tensor:
    """The full-row cumsum and ``prefix_rt`` -> (B, U) f32."""
    _, U = _check(caps_sorted, k_sorted, coefs)
    s2 = torch.cumsum(k_sorted.to(torch.float32), dim=-1)
    s1 = torch.arange(U, dtype=torch.float32, device=s2.device) + 1.0
    c = coefs.to(torch.float32)
    return prefix_rt(s1, s2, caps_sorted.to(torch.float32),
                     ktot=c[:, 0:1], rho1=c[:, 1:2], A=c[:, 2:3],
                     E=c[:, 3:4], N=c[:, 4:5])


def prefix_eval(caps_sorted: torch.Tensor, k_sorted: torch.Tensor,
                coefs: torch.Tensor) -> torch.Tensor:
    """caps_sorted, k_sorted: (B, U) in descending-cap order; coefs:
    (B, 8). Returns the (B, U) prefix-R matrix. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel."""
    B, U = _check(caps_sorted, k_sorted, coefs)
    if caps_sorted.device.type == "cpu":
        return prefix_eval_plain(caps_sorted, k_sorted, coefs)
    build.require(caps_sorted, "caps_sorted", (B, U))
    build.require(k_sorted, "k_sorted", (B, U), device=caps_sorted.device)
    build.require(coefs, "coefs", (B, N_COEF), device=caps_sorted.device)
    out = torch.empty_like(caps_sorted)
    if B == 0 or U == 0:
        return out
    rc = build.lib().prefix_eval_f32(
        caps_sorted.data_ptr(), k_sorted.data_ptr(), coefs.data_ptr(),
        out.data_ptr(), B, U, build.stream_ptr(caps_sorted))
    build.check(rc, "prefix_eval")
    build.count("prefix_eval")
    return out
