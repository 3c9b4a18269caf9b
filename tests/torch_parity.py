"""Helpers for the parity tests of the PyTorch port against the JAX package.

Inputs are made with numpy and handed to both packages; results come back
as numpy arrays and are compared with a stated tolerance.
"""

import numpy as np
import torch

# default tolerance on f32 scores (abs and rel): both packages take the same
# f32 operations, but reductions may add in a different order
RTOL = 1e-5
ATOL = 1e-5


def t(x, dtype=None):
    """numpy -> CPU tensor (copied, so non-writable arrays are fine)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x):
    """JAX array or tensor -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def all_scores(v, i, rows):
    """``[B, rows]`` reference scores from a top-k taken with k = rows
    (rows the search did not score, id -1, stay -inf)."""
    v, i = n(v), n(i)
    out = np.full((v.shape[0], rows), -np.inf, np.float32)
    b, slot = np.nonzero(i >= 0)
    out[b, i[b, slot]] = v[b, slot]
    return out


def assert_topk_match(ref_v, ref_i, got_v, got_i, rtol=RTOL, atol=ATOL,
                      scores=None):
    """Values agree within tolerance (same -inf slots); ids agree except
    at a near-tie, where the two packages may order tied ids differently:
    a slot whose reference value lies within tolerance of a neighbouring
    slot's, or, given ``scores`` (the reference's ``[B, N]`` score of
    every row), a slot whose id got scores within tolerance of the slot's
    reference value (a runner-up that the list does not show)."""
    ref_v, ref_i, got_v, got_i = map(n, (ref_v, ref_i, got_v, got_i))
    assert ref_v.shape == got_v.shape and ref_i.shape == got_i.shape
    fin = np.isfinite(ref_v)
    np.testing.assert_array_equal(fin, np.isfinite(got_v))
    np.testing.assert_allclose(got_v[fin], ref_v[fin], rtol=rtol, atol=atol)
    tol = atol + rtol * np.abs(np.where(fin, ref_v, 0.0))
    gap = np.abs(np.diff(np.where(fin, ref_v, 0.0), axis=-1))
    inf = np.full(ref_v.shape[:-1] + (1,), np.inf)
    near = (np.minimum(np.concatenate([inf, gap], -1),
                       np.concatenate([gap, inf], -1)) <= 2 * tol)
    if scores is not None:
        scores = n(scores)
        rows = scores.shape[-1]
        assert ((got_i[fin] >= 0) & (got_i[fin] < rows)).all()
        s = np.broadcast_to(scores, got_i.shape[:-1] + (rows,))
        got_s = np.take_along_axis(
            s, np.where(fin, got_i, 0).astype(np.int64), -1)
        near |= np.abs(got_s - np.where(fin, ref_v, 0.0)) <= 2 * tol
    bad = fin & (ref_i != got_i) & ~near
    assert not bad.any(), (
        f"ids differ away from ties at {np.argwhere(bad)[:5].tolist()}: "
        f"ref {ref_i[bad][:5]} got {got_i[bad][:5]}")
