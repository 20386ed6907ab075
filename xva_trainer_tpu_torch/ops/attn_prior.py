"""Beta-binomial attention prior computed on the device, inside the step.

Counterpart of ``xva_trainer_tpu/ops/attn_prior.py``. The step receives only
``in_lens`` and ``mel_lens`` and makes the ``(B, mel_len, text_len)`` prior
itself, instead of a host-collated tensor shipped every step. With the
reference's ``scaling=1.0`` every gammaln argument of the pmf is a positive
integer, so the pmf reduces to lookups in one log-factorial table:

    pmf(k; n=P, a=m+1, b=M-m) = C(P,k) · B(k+a, P-k+b) / B(a,b)
    log pmf = lf[P] - lf[k] - lf[P-k]                       (log C)
            + lf[k+m] + lf[P+M-k-m-1] - lf[P+M]             (log B numerator)
            - (lf[m] + lf[M-m-1] - lf[M])                   (log B denominator)

with ``lf[i] = log(i!)``. The table is built in float64 on the host and
cast to float32, as the JAX function builds it: an fp32 cumsum of logs on
the device drifts by about 1e-2 at n ≈ 900, which the final ``exp`` turns
into percent-level error.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _log_factorials(maxn: int) -> np.ndarray:
    """log(i!) for i in [0, maxn], summed in float64, as float32."""
    return np.concatenate([[0.0], np.cumsum(np.log(np.arange(1, maxn + 1, dtype=np.float64)))]
                          ).astype(np.float32)


def beta_binomial_attn_prior(in_lens: torch.Tensor, mel_lens: torch.Tensor, t_x: int, t_y: int,
                             dtype=torch.float32) -> torch.Tensor:
    """(B, t_y, t_x) prior on ``in_lens``' device: prior[b, m, k] =
    betabinom(P, m+1, M-m).pmf(k) for m < M, k < P and 0 elsewhere, with
    P = in_lens[b], M = mel_lens[b] (the host collate's layout,
    ``prior[i, :ml, :tl]``)."""
    dev = in_lens.device
    P = in_lens.to(torch.long)[:, None, None]
    M = mel_lens.to(torch.long)[:, None, None]
    m = torch.arange(t_y, device=dev)[None, :, None]
    k = torch.arange(t_x, device=dev)[None, None, :]
    maxn = t_x + t_y
    lf = torch.from_numpy(_log_factorials(maxn)).to(dev)

    def L(i):
        # out of range only at masked (invalid) points
        return lf[i.clamp(0, maxn)]

    logp = (L(P) - L(k) - L(P - k)
            + L(k + m) + L(P + M - k - m - 1) - L(P + M)
            - (L(m) + L(M - m - 1) - L(M)))
    valid = (k < P) & (m < M)
    return torch.where(valid, torch.exp(logp), 0.0).to(dtype)
