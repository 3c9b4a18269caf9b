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


def ivf_arrays(index):
    """A JAX ``IVFIndex`` as ``convert.ivf_from_jax`` takes it:
    ``(numpy arrays by field name, residual, storage dtype name)``; bf16
    arrays go over as f32 (exact)."""
    def host(a):
        if a is None:
            return None
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a

    of = index.overflow
    arrays = {
        "centroids": host(index.centroids), "values": host(index.values),
        "scales": host(index.scales), "row_ids": host(index.row_ids),
        "overflow_values": host(of.values) if of is not None else None,
        "overflow_scales": host(of.scales) if of is not None else None,
        "overflow_rows": host(index.overflow_rows),
        "sign_plane": host(index.sign_plane),
        "of_sign_plane": host(index.of_sign_plane),
        "of_assign": host(index.of_assign),
    }
    return arrays, index.residual, np.asarray(index.values).dtype.name


# -- knowledge-graph text ----------------------------------------------------

KG_ORGS = ("Northwind", "Contoso", "Fabrikam", "Adatum", "Litware", "Proseware",
           "Tailspin", "Wingtip", "Woodgrove", "Lucerne", "Alpine", "Coho")
KG_SUFFIXES = ("Labs", "Inc", "Systems", "Group", "Foundation", "Bank")
KG_FIRST = ("Alice", "Bruno", "Chen", "Dalia", "Emeka", "Freya", "Goran", "Hana")
KG_LAST = ("Okafor", "Lindqvist", "Moreau", "Tanaka", "Varga", "Quispe")
KG_PLACES = ("Silicon Valley", "Hudson Bay", "Rocky Mountains", "Kent County",
             "Jade Island", "Napa Valley")
KG_PRODUCTS = ("Warehouse Robots", "Tensor Engines", "Cloud Ledgers",
               "Solar Arrays", "Medical Scanners", "Quantum Sensors")


def kg_entities(rng, people: int, orgs: int):
    """Seeded entity names: ``orgs`` organisations (stem + suffix) and
    ``people`` people (first + last name, some with a title)."""
    org_names = [f"{s} {x}" for s in KG_ORGS for x in KG_SUFFIXES]
    person_names = [f"{f} {l}" for f in KG_FIRST for l in KG_LAST]
    org = [org_names[i] for i in rng.permutation(len(org_names))[:orgs]]
    ppl = [("Dr " if rng.random() < 0.2 else "") + person_names[i]
           for i in rng.permutation(len(person_names))[:people]]
    return org, ppl


def kg_sentences(rng, count: int, org, ppl):
    """``count`` sentences that the heuristic extractor turns into triples:
    acquisitions, leadership (a functional relation, so a later leader
    invalidates an earlier one), foundings in the passive, products,
    places, with event years."""
    out = []
    for _ in range(count):
        kind = int(rng.integers(6))
        a, b = (org[int(i)] for i in rng.choice(len(org), 2, replace=False))
        p = ppl[int(rng.integers(len(ppl)))]
        year = int(rng.integers(1995, 2024))
        if kind == 0:
            out.append(f"{a} acquired {b} in {year}.")
        elif kind == 1:
            out.append(f"{p} leads {a} since {year}.")
        elif kind == 2:
            out.append(f"{a} was founded by {p} in {year}.")
        elif kind == 3:
            out.append(f"{a} develops {KG_PRODUCTS[int(rng.integers(6))]} "
                       f"for {b}.")
        elif kind == 4:
            out.append(f"{a} owns offices in "
                       f"{KG_PLACES[int(rng.integers(6))]} since {year}.")
        else:
            out.append(f"{p} supports {a} and {b}.")
    return out
